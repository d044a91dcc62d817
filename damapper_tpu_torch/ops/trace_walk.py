"""The wave engine's trace walk: every lane of a pass in one call.

A pass's pulled pool ((rows, top, 4) int32 pebbles: ptr, diag, diff, mark)
and its lanes' REACH-selected trim points go in; each side's traces come
out flat, one int32 array with an (n + 1) int64 offset array.  ``lib`` is
the native walk (native.trace_lib(), native/trace_walk.cpp), or None for
the plain version: ops.wave's per-lane walk (extract_forward_traces,
extract_reverse_traces), which the oracle keeps using.  Both give the same
arrays element for element, and both raise IndexError on a malformed chain
(the native walk also on a chain that never ends).

``trim`` is the five per-lane arrays (trimx, trimy, trimd, trimha,
trimhb); ``rows`` names each walked lane's row of the pool.
"""

from __future__ import annotations

import numpy as np

from . import wave as _host


def _i32(x):
    return np.ascontiguousarray(x, np.int32)


def _i64(x):
    return np.ascontiguousarray(x, np.int64)


def _pack(lists):
    """Python lists -> (flat int32, (n + 1) int64 offsets)."""
    off = np.zeros(len(lists) + 1, np.int64)
    np.cumsum([len(t) for t in lists], out=off[1:])
    flat = np.fromiter((v for t in lists for v in t), np.int32, int(off[-1]))
    return flat, off


def _raise(rc, rows):
    raise IndexError(
        f"malformed pebble chain in pool row {int(rows[rc - 1])}")


def forward(lib, pool, rows, trim, mida):
    """The forward pass's traces: (atrace, aoff, btrace, boff, low), low
    the first pebble's diagonal of each lane's B chain."""
    n, top = len(rows), pool.shape[1]
    if lib is None:
        ta, tb, low = [], [], np.zeros(n, np.int32)
        for k, (r, x, y, d, ha, hb, m) in enumerate(zip(
                *(np.asarray(v).tolist() for v in (rows, *trim, mida)))):
            low[k], fwd, btr = _host.extract_forward_traces(
                pool[r], ha, hb, x, y, d, m)
            ta.append(fwd.trace)
            tb.append(btr)
        return (*_pack(ta), *_pack(tb), low)
    ta, tb = (np.empty(max(1, 2 * top * n), np.int32) for _ in range(2))
    oa, ob = (np.empty(n + 1, np.int64) for _ in range(2))
    low = np.empty(n, np.int32)
    # the arrays are held here while the call reads their addresses
    args = [np.ascontiguousarray(pool, np.int32), _i64(rows),
            *(_i32(v) for v in (*trim, mida)), ta, oa, tb, ob, low]
    rc = lib.trace_forward(n, top, *(a.ctypes.data for a in args))
    if rc:
        _raise(rc, rows)
    return ta[:oa[-1]], oa, tb[:ob[-1]], ob, low


def reverse(lib, pool, rows, trim, TS, aoffp, boffp, fwd=None):
    """The reverse pass's traces, each lane's prefix followed by its
    forward trace (its first pair edited at the junction): (atrace, aoff,
    btrace, boff).  fwd: (fa, fa_lo, fa_hi, fb, fb_lo, fb_hi), lane k's
    forward traces fa[fa_lo[k]:fa_hi[k]] and fb[fb_lo[k]:fb_hi[k]]; None:
    empty forward traces."""
    n, top = len(rows), pool.shape[1]
    if fwd is None:
        z = np.zeros(n, np.int64)
        fwd = (np.zeros(0, np.int32), z, z, np.zeros(0, np.int32), z, z)
    fa, fa_lo, fa_hi, fb, fb_lo, fb_hi = fwd
    if lib is None:
        ta, tb = [], []
        for r, x, y, d, ha, hb, ao, bo, al, ah, bl, bh in zip(*(
                np.asarray(v).tolist() for v in (
                    rows, *trim, aoffp, boffp, fa_lo, fa_hi, fb_lo, fb_hi))):
            atr, btr = fa[al:ah].tolist(), fb[bl:bh].tolist()
            a_pre, b_pre = _host.extract_reverse_traces(
                pool[r], ha, hb, x, y, d, TS, ao, bo, atr, btr)
            ta.append(a_pre + atr)
            tb.append(b_pre + btr)
        return (*_pack(ta), *_pack(tb))
    fa, fb = _i32(fa), _i32(fb)
    ta = np.empty(max(1, 2 * top * n + int((fa_hi - fa_lo).sum())), np.int32)
    tb = np.empty(max(1, 2 * top * n + int((fb_hi - fb_lo).sum())), np.int32)
    oa, ob = (np.empty(n + 1, np.int64) for _ in range(2))
    # the arrays are held here while the call reads their addresses
    head = [np.ascontiguousarray(pool, np.int32), _i64(rows),
            *(_i32(v) for v in trim)]
    tail = [_i32(aoffp), _i32(boffp), fa, _i64(fa_lo), _i64(fa_hi), fb,
            _i64(fb_lo), _i64(fb_hi), ta, oa, tb, ob]
    rc = lib.trace_reverse(n, top, *(a.ctypes.data for a in head), TS,
                           *(a.ctypes.data for a in tail))
    if rc:
        _raise(rc, rows)
    return ta[:oa[-1]], oa, tb[:ob[-1]], ob


class RoundTraces:
    """One side's traces of a round's lanes, kept flat: the walks' output
    arrays and, for each lane, the array that holds its trace (-1: none,
    an empty trace) and the trace's span in it."""

    def __init__(self, n: int):
        self.parts = []
        self.part = np.full(n, -1, np.int64)
        self.lo = np.zeros(n, np.int64)
        self.hi = np.zeros(n, np.int64)

    def put(self, lanes, flat, off):
        """The traces of ``lanes`` become flat[off[k]:off[k + 1]]."""
        self.part[lanes] = len(self.parts)
        self.lo[lanes], self.hi[lanes] = off[:-1], off[1:]
        self.parts.append(flat)

    def clear(self, lanes):
        """The traces of ``lanes`` become empty."""
        self.part[lanes] = -1

    def lists(self, lanes, rev) -> list:
        """The traces of ``lanes`` as Python lists; the (d, b) pairs of a
        lane whose ``rev`` is set in reverse order (finalize_paths's
        pairwise reversal, align.c:1872-1883)."""
        out = []
        for p, lo, hi, r in zip(self.part[lanes].tolist(),
                                self.lo[lanes].tolist(),
                                self.hi[lanes].tolist(), rev.tolist()):
            t = self.parts[p][lo:hi].tolist() if p >= 0 else []
            if r:
                t[0::2], t[1::2] = t[-2::-2], t[-1::-2]
            out.append(t)
        return out

"""Seed chaining: sweep over hits building best k-mer chains per (read,
contig, orientation), then dominance-filtered mapping candidates.

Semantics-parity redesign of the reference's splay-tree sweep (chain_thread
map.c:1020-1922).  The reference keeps active hits (those within MAX_GAP of
the sweep position in A) in a splay tree keyed on (diag, apos) augmented with
subtree bpos min/max, and for each new hit finds

  pred  = the active node with the smallest key  > (diag,apos) having
          bpos >= bpos - MAX_GAP  (predOf map.c:1262),
  prev  = the largest-apos active node on pred's diagonal with
          bpos >= bpos - MAX_GAP  (leftmost map.c:1279),
  succ  = the active node with the largest key < (diag,apos) having
          bpos <= bpos            (succOf map.c:1303),

extends whichever gives the higher cost (cost += min(kmer, advance); ties
prefer succ, map.c:1823-1826), tracks each chain's best node via orig->orig,
and absorbs the predecessor when the new node is nearly colinear
(|ddiag| <= .2*dapos, map.c:1837,1852).  These are order-statistics queries on
the *set* of active nodes — independent of tree shape — so this implementation
replaces the splay tree with a sorted key list (bisect) with identical
results.  Chains whose cost reaches HITMIN*kmer become candidates, subject to
the MIN_PIECE/0.9-score dominance rule over the read's candidate stack
(map.c:1668-1766), which persists across reference blocks and orientations
(the reads[].coff cache, map.c:1875).
"""

from __future__ import annotations

import os
from bisect import bisect_left, insort
from dataclasses import dataclass, field

import numpy as np

from ..utils import spans

HITMIN = 3        # map.c:34
MAX_GAP = 1000    # map.c:36
MIN_PIECE = 300   # map.c:37

# threads of the native sweep (it takes one a 65,536 hits, at most this
# many): the cores this process may run on, at most 8
SWEEP_THREADS = min(8, len(os.sched_getaffinity(0)))


class _Node:
    __slots__ = ("apos", "bpos", "diag", "cost", "frm", "orig", "best",
                 "absorbed")

    def __init__(self, apos, bpos):
        self.apos = apos
        self.bpos = bpos
        self.diag = apos - bpos
        self.cost = 0
        self.frm = None
        self.orig = self
        self.best = self      # valid only on origin nodes (C's orig->orig)
        self.absorbed = False

    @property
    def key(self):
        return (self.diag, self.apos)


@dataclass
class Candidate:
    score: int
    bread: int      # global contig index (block offset added)
    comp: int
    afirst: int
    alast: int
    bfirst: int
    blast: int
    length: int
    jumps: list = field(default_factory=list)  # (adisp, bdisp) last-to-first


def _chain_length(h: _Node) -> int:
    """Compress same-diagonal steps < 100bp apart; return remaining link count
    (chain_length map.c:1243-1260).  Mutates frm pointers like the original."""
    n = 0
    x = h
    y = x.frm
    while y is not None:
        da = x.apos - y.apos
        if da == x.bpos - y.bpos and da < 100:
            y = x.frm = y.frm
        else:
            n += 1
            x = y
            y = x.frm
    return n


class ChainState:
    """Per-reads-block chaining state persisted across reference blocks:
    the candidate stack per read (reads[].coff equivalent) and the optional
    repeat-profile coverage counters.

    The native path keeps the stacks in C++ (native/chain_sweep.cpp's
    State, made at the first native pass) until ``finish`` exports them as
    ``cands``, which refuses to be read before that.  The Python and device
    paths push into ``cands`` in Python.  ``cover[r]`` is read r's view of
    one flat int32 array, which both pushes write."""

    def __init__(self, nreads: int, kmer: int, profile=False, rlens=None,
                 spacing=100, device=None):
        self.nreads = nreads
        self.device = device    # where process_hits(device=True) sweeps
        self.kmer = kmer
        self.hithr = HITMIN * kmer
        self._cands: list[list[Candidate]] | None = None
        self._lib = self._h = None      # the native library and State
        self.profile = profile
        self.spacing = spacing
        if profile:
            sizes = (np.asarray(rlens[:nreads], np.int64) - 1) // spacing + 2
            self._coff = np.zeros(nreads + 1, np.int64)
            np.cumsum(sizes, out=self._coff[1:])
            self._cover = np.zeros(int(self._coff[-1]), np.int32)
            bounds = self._coff.tolist()
            self.cover = [self._cover[bounds[i]:bounds[i + 1]]
                          for i in range(nreads)]
        else:
            self.cover = None

    @property
    def cands(self) -> list[list[Candidate]]:
        """Each read's candidates, newest first."""
        if self._h is not None:
            raise RuntimeError("the native candidate stacks are live: "
                               "call finish() before reading cands")
        if self._cands is None:
            self._cands = [[] for _ in range(self.nreads)]
        return self._cands

    def ncands(self) -> int:
        """The candidates on the stacks, without exporting native ones."""
        if self._h is not None:
            return self._lib.chain_state_count(self._h)
        return sum(len(c) for c in self._cands or ())

    def finish(self) -> None:
        """Export the native stacks into ``cands`` (span "chain.export",
        counter "chain.cands_kept"); a no-op where no native pass ran or
        they are exported already."""
        if self._h is None:
            return
        lib, h = self._lib, self._h
        self._h = None
        with spans.span("chain.export"):
            try:
                n = lib.chain_state_count(h)
                njumps = lib.chain_state_jumps_len(h) // 2
                counts = np.empty(self.nreads, np.int32)
                meta = np.empty((n, 8), np.int32)
                index = np.empty(njumps, np.int32)
                uniq = np.empty((njumps, 2), np.int32)
                nuniq = lib.chain_state_export(
                    h, counts.ctypes.data, meta.ctypes.data,
                    index.ctypes.data, uniq.ctypes.data)
            finally:
                lib.chain_state_free(h)
            # one tuple a distinct (adisp, bdisp) pair, shared by the jumps
            # that repeat it: a tuple is immutable, so a shared one reads
            # the same, and a block builds a few percent of the tuples
            table = np.fromiter(zip(uniq[:nuniq, 0].tolist(),
                                    uniq[:nuniq, 1].tolist()),
                                object, nuniq)
            pairs = table[index].tolist()
            flat = []
            cur = 0
            for score, bread, comp, ab, ae, bb, be, length in meta.tolist():
                flat.append(Candidate(score, bread, comp, ab, ae, bb, be,
                                      length, pairs[cur:cur + length]))
                cur += length
            ends = np.cumsum(counts).tolist()
            self._cands = [flat[s:e] for s, e in zip([0] + ends[:-1], ends)]
        spans.count("chain.cands_kept", n)

    def __del__(self):
        if getattr(self, "_h", None) is not None:
            self._lib.chain_state_free(self._h)

    # -- one (aread, bread) group -------------------------------------------

    def _sweep_group(self, apos_arr, bpos_arr):
        """Run the chain sweep over one group's hits (ascending apos order).
        Returns the end-of-group scan list: active nodes in decreasing key
        order followed by expired chain-best nodes in REVERSE expiry order
        (the reference prepends each expiring node, map.c:1790-1794, so its
        expired list is LIFO — the order decides which of two equal-span
        LAs survives Handle_Redundancies)."""
        keys: list[tuple] = []      # sorted ascending (diag, apos)
        nodes: dict[tuple, _Node] = {}
        queue: list[_Node] = []
        qhead = 0
        expired: list[_Node] = []

        for apos, bpos in zip(apos_arr, bpos_arr):
            # expire hits out of the MAX_GAP window (map.c:1787-1796)
            while qhead < len(queue) and queue[qhead].apos < apos - MAX_GAP:
                nd = queue[qhead]
                if not nd.absorbed:
                    i = bisect_left(keys, nd.key)
                    del keys[i]
                    del nodes[nd.key]
                    if nd.orig.best is nd:
                        expired.append(nd)
                qhead += 1

            nd = _Node(apos, bpos)
            insort(keys, nd.key)
            nodes[nd.key] = nd

            thresh = bpos - MAX_GAP
            # pred: smallest key > nd.key with bpos >= thresh
            l = None
            i = bisect_left(keys, nd.key) + 1
            while i < len(keys):
                cand = nodes[keys[i]]
                if cand.bpos >= thresh:
                    l = cand
                    break
                i += 1
            if l is not None:
                # leftmost: largest-apos active node on l's diagonal with
                # bpos >= thresh (same-diag larger apos always qualifies)
                j = bisect_left(keys, (l.diag + 1, -1)) - 1
                cand = nodes[keys[j]]
                l = cand if cand.diag == l.diag else l

            # succ: largest key < nd.key with bpos <= bpos
            r = None
            i = bisect_left(keys, nd.key) - 1
            while i >= 0:
                cand = nodes[keys[i]]
                if cand.bpos <= bpos:
                    r = cand
                    break
                i -= 1

            lcost = rcost = 0
            if l is not None:
                lcost = l.cost + (self.kmer if apos >= l.apos + self.kmer
                                  else apos - l.apos)
            if r is not None:
                rcost = r.cost + (self.kmer if bpos >= r.bpos + self.kmer
                                  else bpos - r.bpos)
            if lcost > rcost:
                rcost = 0
            else:
                lcost = 0

            if lcost > 0:
                self._extend(nd, l, lcost, keys, nodes)
            elif rcost > 0:
                self._extend(nd, r, rcost, keys, nodes)
            else:
                nd.frm = None
                nd.cost = self.kmer
                nd.orig = nd

            queue.append(nd)

        # end of group: active set in DECREASING key order + expired LIFO
        # (linearize map.c:1205-1225 yields decreasing (diag,apos), with the
        # prepend-built expired list appended)
        scan = [nodes[k] for k in reversed(keys)]
        scan.extend(reversed(expired))
        return scan

    def _extend(self, nd: _Node, p: _Node, cost: int, keys, nodes):
        nd.frm = p
        nd.cost = cost
        nd.orig = p if p.frm is None else p.orig
        if cost >= nd.orig.best.cost:
            nd.orig.best = nd
            if abs(p.diag - nd.diag) <= .2 * (nd.apos - p.apos):
                i = bisect_left(keys, p.key)
                del keys[i]
                del nodes[p.key]
                p.absorbed = True

    # -- candidate insertion with dominance (map.c:1641-1767) ----------------

    def _consider(self, ar, h: _Node, bread_global, comp):
        ab = h.orig.apos - self.kmer
        bb = h.orig.bpos - self.kmer
        ae = h.apos
        be = h.bpos
        length = _chain_length(h)
        jumps = []
        g = h
        f = h.frm
        while f is not None:
            jumps.append((g.apos - f.apos, g.bpos - f.bpos))
            g = f
            f = f.frm
        self._push_candidate(ar, h.cost, ab, ae, bb, be, length, jumps,
                             bread_global, comp)

    def _push_candidate(self, ar, cost, ab, ae, bb, be, length, jumps,
                        bread_global, comp):
        # the paths that sweep in Python or on the device push here; the
        # native path's push_one (native/chain_sweep.cpp) is the same rule
        if self.profile:
            cnt = self.cover[ar]
            tb = ab // self.spacing
            te = (ae - 1) // self.spacing + 1
            if cnt[tb] < 0x7FFF and cnt[te] > -0xFFFF:
                cnt[tb] += 1
                cnt[te] -= 1

        stack = self.cands[ar]
        d = 0
        dominated = False
        while d < len(stack):
            D = stack[d]
            in_a = D.afirst < ab + MIN_PIECE and D.alast > ae - MIN_PIECE
            in_b = ab < D.afirst + MIN_PIECE and ae > D.alast - MIN_PIECE
            if in_a:
                if in_b:
                    if .9 * D.score >= cost:
                        dominated = True
                        break
                    elif D.score <= .9 * cost:
                        del stack[d]
                    else:
                        d += 1
                else:
                    if .9 * D.score >= cost:
                        dominated = True
                        break
                    d += 1
            else:
                if in_b:
                    if D.score <= .9 * cost:
                        del stack[d]
                    else:
                        d += 1
                else:
                    d += 1
        if dominated:
            return

        stack.insert(0, Candidate(score=cost, bread=bread_global, comp=comp,
                                  afirst=ab, alast=ae, bfirst=bb, blast=be,
                                  length=length, jumps=jumps))

    # -- public entry --------------------------------------------------------

    def process_hits(self, hits, bstart: int, comp: int,
                     native: bool = True, device: bool = False) -> None:
        """Chain all hits of one Match_Filter pass (one ref block, one
        orientation).  hits must be sorted by (aread, bread, apos).

        device=True runs the batched sweep (ops.chain_device) on this
        state's device (None: the card) for groups within its capacity and
        the native sweep for the rest, with identical results.  native=True
        uses the C++ sweep and push (native/chain_sweep.cpp), into the
        native stacks; falls back to the Python sweep if the native library
        cannot be built.  A native pass raises RuntimeError once ``cands``
        exists (after ``finish`` or a pass that pushed in Python).

        Spans (utils.spans) of the native and device sweeps: "chain.sweep"
        (the chains of every group) and "chain.push" (each candidate
        through the dominance stack and the -p cover).  Counters: the
        candidates the sweep emitted ("chain.cands"), those of them the
        native push took ("chain.cands_native")."""
        n = len(hits)
        if n == 0:
            return
        if device:
            self._process_hits_device(hits, bstart, comp)
            return
        if native:
            try:
                self._process_hits_native(hits, bstart, comp)
                return
            except (OSError, ImportError, FileNotFoundError):
                pass
        aread, bread = hits.aread, hits.bread
        apos1 = hits.apos + 1           # 1-based end coords (map.c:1784)
        bpos1 = apos1 - hits.diag
        # group boundaries on (aread, bread)
        brk = np.flatnonzero((np.diff(aread.astype(np.int64)) != 0) |
                             (np.diff(bread.astype(np.int64)) != 0)) + 1
        starts = np.concatenate([[0], brk])
        ends = np.concatenate([brk, [n]])
        ncand = 0
        for s, e in zip(starts, ends):
            ar = int(aread[s])
            br = int(bread[s])
            scan = self._sweep_group(apos1[s:e], bpos1[s:e])
            for h in scan:
                if h.cost >= self.hithr and h.orig.best is h:
                    ncand += 1
                    self._consider(ar, h, br + bstart, comp)
        spans.count("chain.cands", ncand)

    def _process_hits_native(self, hits, bstart: int, comp: int) -> None:
        from ..native import chain_lib

        lib = chain_lib()
        apos1 = hits.apos + 1
        bpos1 = apos1 - hits.diag
        if self._cands is not None:
            raise RuntimeError("a native chain pass after the candidates "
                               "left the native stacks")
        if self._h is None:
            cover = None if self.cover is None else self._cover.ctypes.data
            coff = None if self.cover is None else self._coff.ctypes.data
            self._lib = lib
            self._h = lib.chain_state_new(self.nreads, cover, coff,
                                          self.spacing)
        with spans.span("chain.sweep"):
            res = self._sweep_call(lib, hits.aread, hits.bread, apos1, bpos1)
        try:
            with spans.span("chain.push"):
                n = lib.chain_push(self._h, res, int(bstart), int(comp))
        finally:
            lib.result_free(res)
        spans.count("chain.cands", n)
        spans.count("chain.cands_native", n)

    def _sweep_call(self, lib, aread, bread, apos1, bpos1):
        """The C++ sweep over hits sorted by (aread, bread), 1-based end
        coords: a handle to its result, for lib.result_free."""
        aread = np.ascontiguousarray(aread, np.int32)
        bread = np.ascontiguousarray(bread, np.int32)
        apos1 = np.ascontiguousarray(apos1, np.int32)
        bpos1 = np.ascontiguousarray(bpos1, np.int32)
        return lib.chain_sweep(len(aread),
                               aread.ctypes.data, bread.ctypes.data,
                               apos1.ctypes.data, bpos1.ctypes.data,
                               self.kmer, SWEEP_THREADS)

    def _native_sweep(self, aread, bread, apos1, bpos1) -> list:
        """The C++ sweep (native/chain_sweep.cpp) over hits sorted by
        (aread, bread), 1-based end coords: [(ar, br, cost, ab, ae, bb, be,
        length, jumps), ...] in group order."""
        from ..native import chain_lib

        lib = chain_lib()
        h = self._sweep_call(lib, aread, bread, apos1, bpos1)
        out = []
        try:
            nmeta = lib.result_meta_len(h)
            if nmeta == 0:
                return out
            meta = np.ctypeslib.as_array(lib.result_meta(h),
                                         shape=(nmeta,)).reshape(-1, 8)
            njmp = lib.result_jumps_len(h)
            jarr = np.ctypeslib.as_array(lib.result_jumps(h),
                                         shape=(njmp,)) if njmp else \
                np.zeros(0, np.int32)
            cur = 0
            for row in meta:
                ar, br, cost, ab, ae, bb, be, length = (int(x) for x in row)
                # one (a, b) jump pair per link of the compressed chain
                jumps = [(int(jarr[cur + 2 * p]), int(jarr[cur + 2 * p + 1]))
                         for p in range(length)]
                cur += 2 * length
                out.append((ar, br, cost, ab, ae, bb, be, length, jumps))
        finally:
            lib.result_free(h)
        return out

    def _process_hits_device(self, hits, bstart: int, comp: int) -> None:
        """Batched device sweep for bucketable groups + native sweep for
        oversized ones, candidates pushed in exact group order."""
        from . import chain_device

        aread, bread = hits.aread, hits.bread
        apos1 = np.ascontiguousarray(hits.apos + 1, np.int32)
        bpos1 = np.ascontiguousarray(apos1 - hits.diag, np.int32)
        n = len(apos1)
        brk = np.flatnonzero((np.diff(aread.astype(np.int64)) != 0) |
                             (np.diff(bread.astype(np.int64)) != 0)) + 1
        starts = np.concatenate([[0], brk])
        ends = np.concatenate([brk, [n]])

        with spans.span("chain.sweep"):
            dev = chain_device.sweep_hits_device(apos1, bpos1, starts, ends,
                                                 self.kmer, self.device)

            # native sweep over the concatenation of oversized groups (group
            # order preserved; the native library segments by (aread, bread))
            big = [gi for gi in range(len(starts)) if gi not in dev]
            big_res: dict[int, list] = {}
            if big:
                rows = np.concatenate([np.arange(starts[gi], ends[gi])
                                       for gi in big])
                gi_of = {(int(aread[starts[gi]]), int(bread[starts[gi]])): gi
                         for gi in big}
                for ar, br, *cand in self._native_sweep(
                        aread[rows], bread[rows], apos1[rows], bpos1[rows]):
                    big_res.setdefault(gi_of[(ar, br)], []).append(cand)

            cands = []
            for gi in range(len(starts)):
                s, e = int(starts[gi]), int(ends[gi])
                ar = int(aread[s])
                br = int(bread[s])
                if gi in dev:
                    ems = chain_device.emit_group(dev[gi], apos1[s:e],
                                                  bpos1[s:e], e - s,
                                                  self.kmer, self.hithr)
                else:
                    ems = big_res.get(gi, [])
                cands += [(ar, br, *em) for em in ems if em[0] >= self.hithr]
        spans.count("chain.cands", len(cands))
        with spans.span("chain.push"):
            for ar, br, *cand in cands:
                self._push_candidate(ar, *cand, br + bstart, comp)

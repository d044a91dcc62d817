"""K-mer index build: vectorized extraction + sort + frequency culling.

Equivalent of Sort_Kmers (reference map.c:447-822): every k-mer of every read
as a 2-bit rolling code, skipping soft-masked intervals, sorted by code with
(read, position) order preserved within equal codes (the reference's LSD radix
sort is stable and only keys on the code, map.c:316-444), then k-mers occurring
>= `suppress` times dropped (map.c:590-636).

This module is the host path (numpy + native C++ builder).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class KmerIndex:
    code: np.ndarray   # uint64[n] sorted ascending
    read: np.ndarray   # int32[n]  read index within block
    rpos: np.ndarray   # int32[n]  position of the k-mer's LAST base (0-based)

    def __len__(self):
        return len(self.code)


def _rolling_codes(seq: np.ndarray, kmer: int) -> np.ndarray:
    """codes[j] = 2-bit big-endian code of seq[j : j+kmer], for j in
    [0, len-kmer].  In-place shift/or: temporaries dominate at Mbp scale
    on low-memory-bandwidth hosts."""
    n = len(seq) - kmer + 1
    if n <= 0:
        return np.zeros(0, np.uint64)
    c = np.zeros(n, np.uint64)
    s = seq.astype(np.uint64)
    two = np.uint64(2)
    for x in range(kmer):
        np.left_shift(c, two, out=c)
        np.bitwise_or(c, s[x:x + n], out=c)
    if kmer < 32:
        np.bitwise_and(c, np.uint64((1 << (2 * kmer)) - 1), out=c)
    return c


def extract_kmers(db, kmer: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All k-mers of all reads of a loaded DazzDB in (read, rpos) order.
    Soft-mask track intervals are skipped: k-mers are taken only from windows
    fully outside the merged mask intervals (tuple_thread map.c:481-543).

    Returns (code uint64, read int32, rpos int32) with rpos = last-base index.
    """
    codes, reads, rposs = [], [], []
    track = next(iter(db.tracks.values())) if db.tracks else None
    for i in range(db.nreads):
        s = db.read_seq(i)
        rlen = len(s)
        windows = []
        if track is not None:
            anno, data, _ = track
            seg = data[int(anno[i]):int(anno[i + 1])]
            p = 0
            for j in range(0, len(seg), 2):
                windows.append((p, int(seg[j])))
                p = int(seg[j + 1])
            windows.append((p, rlen))
        else:
            windows.append((0, rlen))
        for (p, q) in windows:
            if p + kmer > q:
                continue
            c = _rolling_codes(s[p:q], kmer)
            m = len(c)
            codes.append(c)
            reads.append(np.full(m, i, np.int32))
            rposs.append(np.arange(p + kmer - 1, q, dtype=np.int32))
    if not codes:
        z = np.zeros(0, np.uint64)
        return z, np.zeros(0, np.int32), np.zeros(0, np.int32)
    return (np.concatenate(codes), np.concatenate(reads),
            np.concatenate(rposs))


def _native_index(db, kmer: int, scratch: dict | None = None,
                  span_off: int | None = None):
    """Fused extract+sort via the native builder (tuple_thread + lex_sort
    equivalent, native/kmer_index.cpp).  Returns None when the
    native path is unavailable or the packing bound is exceeded.

    `scratch` (optional dict, owned by the caller) recycles the output and
    sort-scratch buffers across builds: repeated index builds (ref fwd/comp
    per block) otherwise fault ~30 fresh bytes per k-mer each call, which
    costs as much as the sort itself on this host.  The caller must be done
    with the previous build's KmerIndex before passing the same scratch."""
    import os

    try:
        from ..native import kmer_lib
        lib = kmer_lib()
    except Exception:
        return None
    idx_bits = 64 - 2 * kmer
    if kmer > 32 or db.seq is None:
        return None
    track = next(iter(db.tracks.values())) if db.tracks else None
    nreads = db.nreads
    boffs = np.ascontiguousarray(db.reads["boff"], np.int64)
    rlens = np.ascontiguousarray(db.reads["rlen"], np.int32)
    if track is not None:
        anno = np.ascontiguousarray(track[0], np.int64)
        data = np.ascontiguousarray(track[1], np.int32)
        ap, dp = anno.ctypes.data, data.ctypes.data
    else:
        anno = data = None
        ap = dp = None
    offs = np.empty(nreads + 1, np.int64)
    total = lib.kmer_count(rlens.ctypes.data, nreads, kmer, ap, dp,
                           offs.ctypes.data)
    def _buf(name, dtype):
        if scratch is None:
            return np.empty(total, dtype)
        off = span_off or 0
        b = scratch.get(name)
        if b is None or len(b) < off + total:
            if span_off is not None:
                # partitioned builds slice disjoint spans of pre-sized
                # buffers; growing here would drop earlier partitions
                raise ValueError("scratch under-sized for partition span")
            b = np.empty(int(total * 5 // 4) + 64, dtype)
            scratch[name] = b
        return b[off:off + total]

    codes = _buf("codes", np.uint64)
    reads = _buf("reads", np.int32)
    rposs = _buf("rposs", np.int32)
    tmp = _buf("tmp", np.uint64)
    seq = db.seq
    assert seq.flags["C_CONTIGUOUS"]
    nthreads = min(8, os.cpu_count() or 4)
    # the MSD pair sort (1 DRAM scatter + L2-resident LSD) measures ~35%
    # faster than the packed-rank LSD (5 DRAM passes + a random-gather
    # permute) even when ranks would fit — packed survives as an env
    # escape hatch
    packed = (os.environ.get("DAMAPPER_INDEX_PACKED") == "1"
              and idx_bits > 0 and total < (1 << idx_bits))
    if packed:
        # rank packs into the key's low bits: permute via one u64 sort
        pr = _buf("pr", np.int32)
        pp = _buf("pp", np.int32)
        lib.kmer_index(seq.ctypes.data, boffs.ctypes.data, rlens.ctypes.data,
                       nreads, kmer, ap, dp, offs.ctypes.data,
                       codes.ctypes.data, reads.ctypes.data,
                       rposs.ctypes.data, idx_bits, nthreads,
                       tmp.ctypes.data, pr.ctypes.data, pp.ctypes.data,
                       None, None)
    else:
        # index too large to pack ranks: (key, payload) pair radix
        pay = _buf("pay", np.uint64)
        tmpp = _buf("tmpp", np.uint64)
        lib.kmer_index(seq.ctypes.data, boffs.ctypes.data, rlens.ctypes.data,
                       nreads, kmer, ap, dp, offs.ctypes.data,
                       codes.ctypes.data, reads.ctypes.data,
                       rposs.ctypes.data, -1, nthreads,
                       tmp.ctypes.data, None, None,
                       pay.ctypes.data, tmpp.ctypes.data)
    return codes, reads, rposs


class _ReadRange:
    """View of a contiguous read range of a loaded DazzDB — just enough
    surface for the index builders (reads/seq/tracks/read_seq)."""

    def __init__(self, db, i0: int, i1: int):
        self._db = db
        self.i0 = i0
        self.nreads = i1 - i0
        self.reads = db.reads[i0:i1]
        self.seq = db.seq
        self.tracks = {nm: (anno[i0:i1 + 1], data, alen[i0:i1])
                       for nm, (anno, data, alen) in db.tracks.items()}

    def read_seq(self, i):
        return self._db.read_seq(self.i0 + i)


def _partition_ranges(rlens, max_bases: int) -> list[tuple[int, int]]:
    ranges = []
    i0, acc = 0, 0
    for i, ln in enumerate(rlens):
        if acc and acc + int(ln) > max_bases:
            ranges.append((i0, i))
            i0, acc = i, 0
        acc += int(ln)
    ranges.append((i0, len(rlens)))
    return ranges


def sort_kmers_partitioned(db, kmer: int, max_bases: int,
                           scratch: dict) -> list[tuple[KmerIndex, int]]:
    """Per-read-range sorted indexes: [(KmerIndex, first_read), ...].

    Semantically a finer DBsplit of the block (ranges always break between
    reads): the concatenated entries equal sort_kmers(db)'s, sorted within
    each range instead of globally.  Cache-resident partition sorts are
    several times faster than one block-global sort on bandwidth-bound
    hosts.  Callers must match with merged per-code counts to keep the
    block-level -M/MAXGRAM semantics (seeds.match_seeds_multi) and must
    not use this with -t culling (per-block counts).
    """
    ranges = _partition_ranges(db.reads["rlen"], max_bases)
    try:
        from ..native import kmer_lib
        lib = kmer_lib()
    except Exception:
        lib = None
    if lib is None or db.seq is None or kmer > 32:
        return [(sort_kmers(_ReadRange(db, i0, i1), kmer, 0), i0)
                for i0, i1 in ranges]

    # pre-size the scratch to the whole block so partition builds can
    # slice disjoint spans
    views = [_ReadRange(db, i0, i1) for i0, i1 in ranges]
    totals = []
    for v in views:
        track = next(iter(v.tracks.values())) if v.tracks else None
        rl = np.ascontiguousarray(v.reads["rlen"], np.int32)
        offs = np.empty(v.nreads + 1, np.int64)
        if track is not None:
            anno = np.ascontiguousarray(track[0], np.int64)
            data = np.ascontiguousarray(track[1], np.int32)
            ap, dp = anno.ctypes.data, data.ctypes.data
        else:
            ap = dp = None
        totals.append(lib.kmer_count(rl.ctypes.data, v.nreads, kmer,
                                     ap, dp, offs.ctypes.data))
    grand = int(sum(totals))
    for name, dt in (("codes", np.uint64), ("reads", np.int32),
                     ("rposs", np.int32), ("tmp", np.uint64),
                     ("pay", np.uint64), ("tmpp", np.uint64),
                     ("pr", np.int32), ("pp", np.int32)):
        b = scratch.get(name)
        if b is None or len(b) < grand:
            scratch[name] = np.empty(grand + 64, dt)

    out = []
    off = 0
    for v, tot, (i0, i1) in zip(views, totals, ranges):
        nat = _native_index(v, kmer, scratch, span_off=off)
        assert nat is not None and len(nat[0]) == tot
        out.append((KmerIndex(*nat), i0))
        off += tot
    return out


def sort_kmers(db, kmer: int, suppress: int = 0,
               scratch: dict | None = None) -> KmerIndex:
    """Build the sorted, culled k-mer index of a block (Sort_Kmers map.c:655).
    suppress=0 means no culling (-t absent).  `scratch` recycles native
    build buffers across calls (see _native_index)."""
    nat = _native_index(db, kmer, scratch)
    if nat is not None:
        code, read, rpos = nat
        if suppress and len(code):
            boundaries = np.flatnonzero(np.diff(code)) + 1
            starts = np.concatenate([[0], boundaries])
            ends = np.concatenate([boundaries, [len(code)]])
            counts = ends - starts
            keep = np.repeat(counts < suppress, counts)
            code, read, rpos = code[keep], read[keep], rpos[keep]
        return KmerIndex(code, read, rpos)

    code, read, rpos = extract_kmers(db, kmer)
    n = len(code)
    idx_bits = 64 - 2 * kmer
    if idx_bits >= 63:
        idx_bits = 62
    if n < (1 << idx_bits):
        # pack (code, emission index) into one uint64 and plain-sort
        # (numpy's SIMD sort), all in place: much faster than a stable
        # argsort and identical order (index low bits keep stability)
        key = np.left_shift(code, np.uint64(idx_bits))
        np.bitwise_or(key, np.arange(n, dtype=np.uint64), out=key)
        np.ndarray.sort(key)
        order = np.bitwise_and(key, np.uint64((1 << idx_bits) - 1),
                               out=key).astype(np.int64)
    else:
        order = np.argsort(code, kind="stable")
    code, read, rpos = code[order], read[order], rpos[order]
    if suppress and len(code):
        # drop k-mers with multiplicity >= suppress (strict <, map.c:604)
        boundaries = np.flatnonzero(np.diff(code)) + 1
        starts = np.concatenate([[0], boundaries])
        ends = np.concatenate([boundaries, [len(code)]])
        counts = ends - starts
        keep_group = counts < suppress
        keep = np.repeat(keep_group, counts)
        code, read, rpos = code[keep], read[keep], rpos[keep]
    return KmerIndex(code, read, rpos)

"""Seed matching: sorted k-mer list intersection -> SeedPair hits.

Equivalent of the count/merge passes of Match_Filter (reference map.c:825-1002,
2889-3135): intersect the reads-block index ("a") with the reference-block
index ("b"); a first counting pass builds the hit-count histogram used with
the -M memory limit to derive a multiplicity cap (map.c:2992-3052); groups
whose a-count*b-count >= limit are dropped; surviving groups emit the cross
product of (read k-mer) x (contig k-mer) as SeedPairs, finally sorted by
(aread, bread, apos) with stable order within ties.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .kmers import KmerIndex

MAXGRAM = 10000   # map.c:32


@dataclass
class SeedHits:
    aread: np.ndarray   # int32 read index (block-local)
    bread: np.ndarray   # int32 contig index (block-local)
    apos: np.ndarray    # int32 k-mer end position in read (0-based last base)
    diag: np.ndarray    # int32 apos - bpos

    def __len__(self):
        return len(self.aread)


def _group_ranges(code: np.ndarray):
    """starts/ends of equal-code runs in a sorted code array."""
    if len(code) == 0:
        return (np.zeros(0, np.int64),) * 2
    b = np.flatnonzero(np.diff(code)) + 1
    starts = np.concatenate([[0], b])
    ends = np.concatenate([b, [len(code)]])
    return starts, ends


def match_limit(hitgram: np.ndarray, mem_limit: int, db_bytes: int,
                alen: int, blen: int) -> int:
    """Derive the group-size cap from the histogram and the memory budget
    (map.c:2992-3052).  Returns MAXGRAM when memory is ample."""
    avail = (mem_limit - db_bytes) // 16
    if avail > alen + 2 * blen:
        avail = (avail - alen) // 2
    else:
        avail = avail - (alen + blen)
    avail = int(avail * .98)
    tom = 0
    limit = MAXGRAM
    for j in range(MAXGRAM):
        tom += j * int(hitgram[j])
        if tom > avail:
            limit = j
            break
    if limit <= 1:
        raise MemoryError("Insufficient memory for seed hits; reduce block "
                          "size or raise -M")
    return limit


def _locate_ranges(keys: np.ndarray, q: np.ndarray):
    """(lo, hi) spans of each sorted unique query code in the sorted key
    array: one native linear merge scan (sequential reads) instead of
    per-query binary searches; numpy fallback is equivalent."""
    try:
        from ..native import kmer_lib
        lib = kmer_lib()
    except Exception:
        return (np.searchsorted(keys, q, side="left"),
                np.searchsorted(keys, q, side="right"))
    keys = np.ascontiguousarray(keys, np.uint64)
    q = np.ascontiguousarray(q, np.uint64)
    lo = np.empty(len(q), np.int64)
    hi = np.empty(len(q), np.int64)
    lib.merge_ranges(q.ctypes.data, len(q), keys.ctypes.data, len(keys),
                     lo.ctypes.data, hi.ctypes.data)
    return lo, hi


def match_seeds(aidx: KmerIndex, bidx: KmerIndex,
                mem_limit: int = 0, db_bytes: int = 0) -> SeedHits:
    """Intersect two sorted k-mer indexes and emit seed pairs.

    aidx: the reads block, bidx: the reference block.  Group emission order
    matches the reference exactly: ascending code, then a-entries in (read,
    rpos) order, then b-entries in (read, rpos) order.
    """
    empty = SeedHits(*(np.zeros(0, np.int32),) * 4)
    if len(aidx) == 0 or len(bidx) == 0:
        return empty

    a_starts, a_ends = _group_ranges(aidx.code)
    a_codes = aidx.code[a_starts]
    b_lo, b_hi = _locate_ranges(bidx.code, a_codes)
    ca = (a_ends - a_starts)
    cb = (b_hi - b_lo)
    hit = cb > 0
    ct = ca * cb

    if mem_limit > 0:
        hitgram = np.zeros(MAXGRAM, np.int64)
        small = hit & (ct < MAXGRAM)
        np.add.at(hitgram, ct[small], 1)
        limit = match_limit(hitgram, mem_limit, db_bytes, len(aidx), len(bidx))
    else:
        limit = np.iinfo(np.int64).max

    sel = hit & (ct < limit)
    if not sel.any():
        return empty
    raw = _expand_groups(aidx, bidx, a_starts[sel], a_ends[sel],
                         b_lo[sel], cb[sel])
    return _sort_hits(*raw)


def _expand_groups(aidx, bidx, gs_a, ge_a, gs_b, ncb):
    """Expand selected code groups into raw (aread, bread, apos, diag)
    rows in the reference's emission order (a entries × b entries)."""
    na_per_group = (ge_a - gs_a)
    a_rows = _grouped_arange(gs_a, na_per_group)            # indices into aidx
    cb_per_arow = np.repeat(ncb, na_per_group)
    bstart_per_arow = np.repeat(gs_b, na_per_group)
    # expand b per a-row
    b_rows = _grouped_arange(bstart_per_arow, cb_per_arow)  # indices into bidx
    a_all = np.repeat(a_rows, cb_per_arow)

    aread = aidx.read[a_all]
    apos = aidx.rpos[a_all]
    bread = bidx.read[b_rows]
    diag = apos - bidx.rpos[b_rows]
    return aread, bread, apos, diag


def _sort_hits(aread, bread, apos, diag) -> SeedHits:
    # single-key stable sort instead of a 3-key np.lexsort: pack
    # (aread, bread, apos) into one uint64 (21+11+32 bits); a stable
    # argsort preserves the emission order of exact ties like the
    # reference's stable radix passes
    if (aread.max(initial=0) < (1 << 21)
            and bread.max(initial=0) < (1 << 11)):
        key = ((aread.astype(np.uint64) << 43)
               | (bread.astype(np.uint64) << 32)
               | apos.astype(np.uint64))
        order = np.argsort(key, kind="stable")
    else:
        order = np.lexsort((apos, bread, aread))
    return SeedHits(aread[order].astype(np.int32),
                    bread[order].astype(np.int32),
                    apos[order].astype(np.int32),
                    diag[order].astype(np.int32))


def match_seeds_multi(aidx: KmerIndex, subs, mem_limit: int = 0,
                      db_bytes: int = 0) -> SeedHits:
    """match_seeds against a read-range-partitioned reference index
    (kmers.sort_kmers_partitioned): per-code counts are merged across
    partitions so the -M governor and the MAXGRAM cap apply at BLOCK
    level, making the hit set identical to the unpartitioned match.
    subs: [(KmerIndex, first_read), ...]; emitted bread is block-local.

    Ties in the final (aread, bread, apos) sort share a bread, and a
    bread lives in exactly one partition, so per-partition emission
    preserves the reference's stable order.
    """
    empty = SeedHits(*(np.zeros(0, np.int32),) * 4)
    if len(aidx) == 0 or not subs:
        return empty
    a_starts, a_ends = _group_ranges(aidx.code)
    a_codes = aidx.code[a_starts]
    ca = (a_ends - a_starts)

    ranges = []
    cbt = np.zeros(len(a_codes), np.int64)
    blen = 0
    for idx, i0 in subs:
        lo, hi = _locate_ranges(idx.code, a_codes)
        ranges.append((lo, hi))
        cbt += hi - lo
        blen += len(idx)
    hit = cbt > 0
    ct = ca * cbt

    if mem_limit > 0:
        hitgram = np.zeros(MAXGRAM, np.int64)
        small = hit & (ct < MAXGRAM)
        np.add.at(hitgram, ct[small], 1)
        limit = match_limit(hitgram, mem_limit, db_bytes, len(aidx), blen)
    else:
        limit = np.iinfo(np.int64).max

    sel = hit & (ct < limit)
    if not sel.any():
        return empty

    parts = []
    for (idx, i0), (lo, hi) in zip(subs, ranges):
        s = sel & (hi > lo)
        if not s.any():
            continue
        aread, bread, apos, diag = _expand_groups(
            aidx, idx, a_starts[s], a_ends[s], lo[s], (hi - lo)[s])
        parts.append((aread, bread + i0, apos, diag))
    if not parts:
        return empty
    cat = [np.concatenate([p[i] for p in parts]) for i in range(4)]
    return _sort_hits(*cat)


def _grouped_arange(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """concat([arange(s, s+c) for s, c in zip(starts, counts)]) vectorized."""
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    ends = np.cumsum(counts)
    offs = np.arange(total, dtype=np.int64)
    block = np.repeat(np.arange(len(counts)), counts)
    block_start = ends - counts
    return starts.astype(np.int64)[block] + (offs - block_start[block])

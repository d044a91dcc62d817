"""The seed hits of a sample of reads, worked out again in plain PyTorch.

Semantics of the reference's Sort_Kmers and Match_Filter (map.c:447-1002,
2889-3135), with no culling (-t absent): every k-mer of every read of the
block and of every contig of the reference block, in each orientation of
the reference block (the complement pass matches the reads against the
block's reverse complemented contigs); a code's group is dropped when its
count in the reads block times its count in the reference block reaches the
limit that the -M governor derives from the histogram of those products
(MAXGRAM when memory is ample); the hits of the surviving groups, sorted by
(aread, bread, apos) with ties in emission order (the reference block's
entries in (contig, position) order).

Only the sampled reads' hits are emitted, but the counts and the histogram
take in the whole read block and the whole reference block, as the program's
do.  The counting runs on the tensors' device; what it emits goes to the
host.
"""

from __future__ import annotations

import numpy as np
import torch

MAXGRAM = 10000   # map.c:32


def kmer_codes(seq: torch.Tensor, lens: torch.Tensor, k: int):
    """(code, valid) at every position of ``seq``, the sequences of lengths
    ``lens`` back to back: code[p] is the 2-bit big-endian code of the
    k-mer whose LAST base is p, valid where that k-mer lies in one
    sequence."""
    n = seq.numel()
    code = torch.zeros(n, dtype=torch.int64, device=seq.device)
    if n >= k:
        body = torch.zeros(n - k + 1, dtype=torch.int64, device=seq.device)
        for x in range(k):
            body.mul_(4).add_(seq[x:n - k + 1 + x].to(torch.int64))
        code[k - 1:] = body
    starts = torch.cumsum(lens, 0) - lens
    local = (torch.arange(n, device=seq.device)
             - torch.repeat_interleave(starts, lens))
    return code, local >= k - 1


def match_limit(hitgram: np.ndarray, mem_limit: int, db_bytes: int,
                alen: int, blen: int) -> int:
    """The group-size cap of the -M governor (map.c:2992-3052)."""
    avail = (mem_limit - db_bytes) // 16
    if avail > alen + 2 * blen:
        avail = (avail - alen) // 2
    else:
        avail = avail - (alen + blen)
    avail = int(avail * .98)
    tom = 0
    for j in range(MAXGRAM):
        tom += j * int(hitgram[j])
        if tom > avail:
            if j <= 1:
                raise MemoryError("-M leaves no room for seed hits")
            return j
    return MAXGRAM


class ReadIndex:
    """The read block's k-mers: sorted distinct codes with their counts, and
    each sampled read's k-mers (sample position, last-base position, code)
    on the host."""

    def __init__(self, block, sample, k: int, device):
        self.k = k
        seq = torch.from_numpy(block.seq).to(device)
        lens = torch.from_numpy(block.lens).to(device)
        code, valid = kmer_codes(seq, lens, k)
        self.n = int(valid.sum())
        self.codes, self.counts = torch.unique(code[valid],
                                               return_counts=True)
        del code, valid, seq
        rows = []
        for si, r in enumerate(sample):
            rs = block.read(int(r))
            c, v = kmer_codes(torch.from_numpy(rs), torch.tensor([len(rs)]),
                              k)
            p = np.flatnonzero(v.numpy())
            rows.append((np.full(len(p), si), p, c.numpy()[p]))
        self.s_read, self.s_pos, self.s_code = (np.concatenate(x) for x in
                                                zip(*rows))
        # (largest count product, the governor's limit) of each reference
        # block and orientation, for the run's log
        self.governor = []
        self.sampled = torch.zeros(len(self.codes), dtype=torch.bool,
                                   device=device)
        self.sampled[torch.searchsorted(
            self.codes, torch.from_numpy(np.unique(self.s_code)).to(
                device))] = True


def ref_codes(seq: torch.Tensor, lens: np.ndarray, comp: bool, k: int):
    """(code, valid, count of valid k-mers, where) of the reference block
    whose contigs of lengths ``lens`` lie back to back in ``seq``, its
    contigs reverse complemented in the complement pass; ``where`` maps a
    position of ``code`` to (block-local contig, position in that contig's
    strand)."""
    lens = np.asarray(lens, np.int64)
    if comp:
        # the whole block reversed: its contigs in reverse order, each
        # reverse complemented
        seq, lens = 3 - seq.flip(0), lens[::-1].copy()
    code, valid = kmer_codes(seq, torch.from_numpy(lens).to(seq.device), k)
    starts = np.cumsum(lens) - lens
    n = len(lens)

    def where(pos: np.ndarray):
        j = np.searchsorted(starts, pos, "right") - 1
        return (n - 1 - j if comp else j), pos - starts[j]
    return code, valid, int(valid.sum()), where


def block_hits(rix: ReadIndex, ref: tuple, c0: int, mem_limit: int,
               db_bytes: int):
    """The sampled reads' hits against one reference block in one
    orientation, ``ref`` its ref_codes and c0 its first global contig.
    Returns (aread, bread, apos, diag) int64 arrays, aread the read's place
    in the sample and bread the global contig."""
    code, valid, blen, where = ref
    idx = torch.searchsorted(rix.codes, code).clamp_(max=len(rix.codes) - 1)
    found = valid & (rix.codes[idx] == code)
    cb = torch.bincount(idx[found], minlength=len(rix.codes))
    ct = rix.counts * cb
    small = (cb > 0) & (ct < MAXGRAM)
    hitgram = torch.bincount(ct[small], minlength=MAXGRAM).cpu().numpy()
    limit = match_limit(hitgram, mem_limit, db_bytes, rix.n, blen)
    rix.governor.append((int(ct.max()) if len(ct) else 0, limit))
    pos = torch.nonzero(found & rix.sampled[idx]).flatten()
    keep = ct[idx[pos]] < limit
    pos = pos[keep]
    g_code = rix.codes[idx[pos]].cpu().numpy()
    g_ctg, g_pos = where(pos.cpu().numpy())
    g_ctg = g_ctg + c0
    # join the sampled reads' k-mers with the block's, code by code: a
    # (code, contig, position) sort of the block's side, then each read
    # k-mer takes its code's run
    order = np.lexsort((g_pos, g_ctg, g_code))
    g_code, g_ctg, g_pos = g_code[order], g_ctg[order], g_pos[order]
    lo = np.searchsorted(g_code, rix.s_code, "left")
    hi = np.searchsorted(g_code, rix.s_code, "right")
    cnt = hi - lo
    a_row = np.repeat(np.arange(len(cnt)), cnt)
    b_row = np.repeat(lo - np.cumsum(cnt) + cnt, cnt) + np.arange(cnt.sum())
    aread = rix.s_read[a_row]
    apos = rix.s_pos[a_row]
    bread = g_ctg[b_row]
    bpos = g_pos[b_row]
    order = np.lexsort((bpos, apos, bread, aread))
    return (aread[order], bread[order], apos[order],
            (apos - bpos)[order])

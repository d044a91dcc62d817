"""Alignment, fusion and selection of one read's candidates.

The benchmark's frozen copy of the sequential path of the port's
``pipeline/reporter.py`` (the reference's report_thread, map.c:1925-2871),
A side only (no -C, which no configuration asks for):
Local_Alignment at the chain seed points not yet covered, fusion of entwined
LAs and removal of contained ones per (bread, comp) run, the LA chain graph
and the zone selection with its START/NEXT/BEST flags, and the -p track's
log coverage values; plus the chain-preserving map-order sort of the port's
``io/las.py`` (LAsort -a).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .chain import HITMIN
from .wave import ACOMP_FLAG, PathRec, local_alignment

COMP_FLAG, START_FLAG, NEXT_FLAG, BEST_FLAG = 0x1, 0x4, 0x8, 0x10
TRACE_XOVR = 125

CHAIN_OFF = 500.   # map.c:42
CHAIN_OVL = 400.   # map.c:43
CHAIN_PLAY = 1.4   # map.c:44
DIFF_SCORE = 2.3   # map.c:47
TIE_SCORE = 50     # map.c:48
TIE_GAP = 500      # map.c:49


@dataclass
class _Match:
    aread: int
    bread: int
    flags: int
    path: PathRec


def entwine(jpath: PathRec, kpath: PathRec, spacing: int):
    """Minimum b-distance between two a-overlapping paths at shared trace
    ticks; returns (min_dist, where) with where = a-coordinate of a shared
    trace point if min_dist==0 (Entwine map.c:1953-2058)."""
    where = None
    minv = 10000
    y2 = jpath.bbpos
    j = jpath.abpos // spacing
    b2 = kpath.bbpos
    k = kpath.abpos // spacing

    if jpath.abpos == kpath.abpos:
        minv = abs(y2 - b2)
        if minv == 0:
            where = kpath.abpos

    jt, kt = jpath.trace, kpath.trace
    if j < k:
        ac = k * spacing
        j = 1 + 2 * (k - j)
        k = 1
        for i in range(1, j, 2):
            y2 += jt[i]
    else:
        ac = j * spacing
        k = 1 + 2 * (j - k)
        j = 1
        for i in range(1, k, 2):
            b2 += kt[i]

    ae = min(jpath.aepos, kpath.aepos)
    den = 0
    while True:
        ac += spacing
        if ac >= ae:
            break
        y2 += jt[j]
        b2 += kt[k]
        j += 2
        k += 2
        i = abs(y2 - b2)
        if i <= minv:
            minv = i
            if i == 0:
                where = ac
        den += 1

    if jpath.aepos == kpath.aepos:
        i = abs(jpath.bepos - kpath.bepos)
        if i <= minv:
            minv = i
            if i == 0:
                where = kpath.aepos

    if den == 0:
        return -1, where
    return minv, where


def fusion(path1: PathRec, ap: int, path2: PathRec, spacing: int) -> None:
    """Concatenate path1[..ap] with path2[ap..] into path1 (Fusion
    map.c:2065-2109)."""
    k1 = 2 * ((ap // spacing) - (path1.abpos // spacing))
    k2 = 2 * ((ap // spacing) - (path2.abpos // spacing))
    trace = []
    diff = 0
    if k1 > 0:
        t = path1.trace
        for k in range(0, k1, 2):
            trace.append(t[k])
            trace.append(t[k + 1])
            diff += t[k]
    if k2 < path2.tlen:
        t = path2.trace
        for k in range(k2, path2.tlen, 2):
            trace.append(t[k])
            trace.append(t[k + 1])
            diff += t[k]
    path1.aepos = path2.aepos
    path1.bepos = path2.bepos
    path1.diffs = diff
    path1.trace = trace


def handle_redundancies(amatch: list[_Match], spacing: int) -> list:
    """Fuse entwined LAs / drop contained ones (map.c:2116-2268), A side
    only (no -C)."""
    novls = len(amatch)
    for j in range(1, novls):
        jpath = amatch[j].path
        for k in range(j - 1, -1, -1):
            kpath = amatch[k].path
            if kpath.abpos < 0:
                continue
            if jpath.abpos < kpath.abpos:
                if kpath.abpos <= jpath.aepos and kpath.bbpos <= jpath.bepos:
                    dist, awhen = entwine(jpath, kpath, spacing)
                    if dist == 0:
                        if kpath.aepos > jpath.aepos:
                            fusion(jpath, awhen, kpath, spacing)
                        kpath.abpos = -1
                        break
            else:
                if jpath.abpos <= kpath.aepos and jpath.bbpos <= kpath.bepos:
                    dist, awhen = entwine(kpath, jpath, spacing)
                    if dist == 0:
                        if kpath.abpos == jpath.abpos:
                            if kpath.aepos > jpath.aepos:
                                amatch[j] = _copy_match_path(amatch[j], kpath)
                                jpath = amatch[j].path
                        elif jpath.aepos > kpath.aepos:
                            fusion(kpath, awhen, jpath, spacing)
                            amatch[j] = _copy_match_path(amatch[j], kpath)
                            jpath = amatch[j].path
                        else:
                            amatch[j] = _copy_match_path(amatch[j], kpath)
                            jpath = amatch[j].path
                        kpath.abpos = -1
                        break
    return [m for m in amatch if m.path.abpos >= 0]


def _copy_path(p: PathRec) -> PathRec:
    return PathRec(p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs, list(p.trace))


def _copy_match_path(m: _Match, p: PathRec) -> _Match:
    """*jpath = *kpath (struct copy of the path only; flags/ids keep j's)."""
    return _Match(m.aread, m.bread, m.flags, _copy_path(p))


class Reporter:
    """Drives alignment + selection for each read (report_thread
    map.c:2362-2871)."""

    def __init__(self, spec, kmer: int, spacing: int, best_tie: float):
        self.spec = spec
        self.kmer = kmer
        self.spacing = spacing
        self.best_tie = best_tie
        self.small = spacing <= TRACE_XOVR
        self.hithr = HITMIN * kmer

    def align_read(self, ar: int, aseq, contig, state):
        """Every candidate of read ``ar`` (bases ``aseq``) aligned against
        ``contig(i)``, the bases of global contig i; returns the LAs as
        the zone selection takes them."""
        alen = len(aseq)
        acomp = None

        amatch: list[_Match] = []
        lovl = 0

        cands = state.cands[ar]
        for ci, cand in enumerate(cands):
            br = cand.bread
            cm = cand.comp
            bseq = contig(br)
            blen = len(bseq)
            if cm:
                if acomp is None:
                    acomp = (3 - aseq)[::-1].copy()
                a_use = acomp
                flags = ACOMP_FLAG
            else:
                a_use = aseq
                flags = 0

            apos, bpos = cand.alast, cand.blast
            alast = alen + 1
            for (adisp, bdisp) in cand.jumps:
                apos -= adisp
                bpos -= bdisp
                if apos < alast:
                    if cm:
                        ac = alen - apos
                        bc = blen - bpos
                        dg, ad = ac - bc, ac + bc
                    else:
                        dg, ad = apos - bpos, apos + bpos
                    apath, _ = local_alignment(a_use, bseq, self.spec,
                                               dg, dg, ad, -1, -1, flags)
                    if apath.aepos - apath.abpos >= self.hithr:
                        alast = apath.abpos
                        amatch.append(_Match(ar, br, COMP_FLAG if cm else 0,
                                             apath))

            nxt = cands[ci + 1] if ci + 1 < len(cands) else None
            if nxt is None or nxt.bread != br or nxt.comp != cm:
                amatch = self._flush_group(amatch, lovl)
                lovl = len(amatch)

        return amatch

    def _flush_group(self, amatch, lovl):
        """Dedup + order one finished (bread, comp) run (map.c:2589-2606)."""
        seg_a = amatch[lovl:]
        if len(seg_a) > 1:
            seg_a = handle_redundancies(seg_a, self.spacing)
        if len(seg_a) > 1:
            order = sorted(range(len(seg_a)),
                           key=lambda i: (-seg_a[i].path.abpos, -i))
            seg_a = [seg_a[i] for i in order]
        return amatch[:lovl] + seg_a

    # -- chain graph + zone selection (map.c:2630-2816) ----------------------

    def select(self, aread_global: int, amatch, a_out):
        """The chains of a read's LAs that survive the zone selection,
        appended to ``a_out`` as records."""
        novl = len(amatch)
        if novl == 0:
            return
        score = [0] * novl
        link = [-1] * novl
        mark = [1] * novl

        score[0] = int((amatch[0].path.aepos - amatch[0].path.abpos)
                       - DIFF_SCORE * amatch[0].path.diffs)
        br = amatch[0].bread
        lovl = 0
        for c in range(1, novl):
            cpath = amatch[c].path
            score[c] = int((cpath.aepos - cpath.abpos)
                           - DIFF_SCORE * cpath.diffs)
            if amatch[c].bread != br:
                br = amatch[c].bread
                lovl = c
                continue
            cor = amatch[c].flags & COMP_FLAG
            for d in range(c - 1, lovl - 1, -1):
                dor = amatch[d].flags & COMP_FLAG
                if dor != cor:
                    continue
                dpath = amatch[d].path
                if dor:
                    if dpath.bepos < cpath.bepos:
                        continue
                else:
                    if dpath.bbpos < cpath.bbpos:
                        continue
                if dpath.abpos <= cpath.aepos - CHAIN_OVL or \
                   dpath.bbpos <= cpath.bepos - CHAIN_OVL:
                    continue
                rat = ((dpath.abpos - cpath.aepos + CHAIN_OFF)
                       / (dpath.bbpos - cpath.bepos + CHAIN_OFF))
                if 1. > rat * CHAIN_PLAY or rat > CHAIN_PLAY:
                    continue
                scr = int(score[d] + (cpath.aepos - cpath.abpos)
                          - DIFF_SCORE * cpath.diffs)
                scr2 = score[c]
                if scr < scr2 - TIE_SCORE:
                    continue
                if scr <= scr2 + TIE_SCORE:
                    gap = dpath.abpos - cpath.aepos
                    if link[c] >= 0:
                        gap2 = amatch[link[c]].path.aepos - dpath.abpos
                    else:
                        gap2 = 0
                    if gap > gap2 + TIE_GAP:
                        continue
                    if gap >= gap2 - TIE_GAP:
                        if scr < scr2:
                            continue
                        if scr == scr2 and gap >= gap2:
                            continue
                link[c] = d
                score[c] = scr
                mark[d] = 0

        perm = sorted(range(novl), key=lambda c: -score[c])   # stable

        parts: list[list] = []   # [beg, end, top]
        for c in perm:
            if score[c] < 0:
                break
            if mark[c] != 1:
                continue
            b = e = c
            p = link[b]
            while p >= 0 and mark[p] >= 0:
                e = p
                p = link[p]

            for pi, part in enumerate(parts):
                if amatch[b].path.abpos < part[1] - 100 and \
                   amatch[e].path.aepos > part[0] + 100:
                    break
            else:
                pi = len(parts)
            if pi >= len(parts):
                parts.append([amatch[b].path.abpos, amatch[e].path.aepos,
                              score[b]])
                best = True
            else:
                if score[b] < self.best_tie * parts[pi][2]:
                    continue
                best = (score[b] == parts[pi][2])

            # emit the chain
            p = b
            while True:
                mark[p] = -1
                a_out.append(self._to_la(amatch[p], aread_global,
                                         start=(p == b), best=best))
                n = link[p]
                if p == e:
                    break
                p = n

    def _to_la(self, m: _Match, aread_global: int, start: bool,
               best: bool) -> tuple:
        """The record as a .las file holds it: (tlen, diffs, abpos, bbpos,
        aepos, bepos, flags, aread, bread, *trace)."""
        p = m.path
        flags = m.flags
        if start:
            flags |= START_FLAG
            if best:
                flags |= BEST_FLAG
        else:
            flags |= NEXT_FLAG
        trace = np.array(p.trace, np.int32)
        if self.small and trace.size and trace.max() > 255:
            raise ValueError("Compression of trace to bytes fails, value too "
                             "big")
        return (len(trace), p.diffs, p.abpos, p.bbpos, p.aepos, p.bepos,
                flags, aread_global, m.bread) + tuple(int(x) for x in trace)


_SPOW = [10.0 ** (m / 10.0) for m in range(41)]


def special_log(cover: int) -> int:
    """Log-bucketed coverage value, cap 40 (special_log map.c:2270-2302)."""
    if cover <= 1:
        return cover
    if cover >= 10000:
        return 40
    lo, hi = 0, 41
    while lo < hi:
        m = (lo + hi) >> 1
        if _SPOW[m] <= cover:
            lo = m + 1
        else:
            hi = m
    return lo - 1


def sort_map_order(recs: list[tuple]) -> list[tuple]:
    """LAsort -a: chains (a START record and the NEXT records after it)
    ordered by (aread, abpos, bread, comp, bbpos) of their first record,
    stably."""
    chains: list[list[tuple]] = []
    for r in recs:
        if r[6] & NEXT_FLAG and chains:
            chains[-1].append(r)
        else:
            chains.append([r])
    chains.sort(key=lambda ch: (ch[0][7], ch[0][2], ch[0][8],
                                ch[0][6] & COMP_FLAG, ch[0][3]))
    return [r for ch in chains for r in ch]

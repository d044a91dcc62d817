"""Exact O(nd) trace-point wave aligner, one seed at a time, in Python.

The benchmark's frozen copy of the port's host oracle (the reference's
forward_wave align.c:353-1011, reverse_wave align.c:1015-1720 and
Local_Alignment align.c:1727-1946), without its debug prints and the
engine-only ``find_extension``.  The harness's reference aligns every seed of
its sample with it; it imports nothing of the program.

Algorithm recap: from a seed point (anti, diag in [low,hgh]) extend a banded
wave of furthest-reaching points forward and backward.  Per diagonal keep the
furthest antidiagonal V, a PATH_LEN(=60)-column bitvector T of match/mismatch
history, the match count M, and "pebble" cells recording trace-point crossings
every `trace_space` columns of A and of B.  The wave stops when no point within
TRIM_MLAG of the best survives; the reported tip is the last point whose
trailing 2*TRIM_LEN columns are suffix-positive under the spec's tables, or the
boundary-reach point when `reach` is set and a sentinel was hit.

Sequences are numeric uint8 over {0..3} with 4 as the out-of-bounds sentinel;
the implementation pads internally so reads may be walked off either end, like
the reference's `4`-terminated read buffers (DB.c:1232-1297).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .spec import (AlignSpec, DUB_TRIM, PATH_INT, PATH_LEN, PATH_TOP,
                   TRIM_LEN, TRIM_MASK, TRIM_MLAG, WAVE_LAG)

INT32_MAX = 0x7FFFFFFF

COMP_FLAG = 0x1
ACOMP_FLAG = 0x2


@dataclass
class PathRec:
    abpos: int = 0
    bbpos: int = 0
    aepos: int = 0
    bepos: int = 0
    diffs: int = 0
    trace: list = field(default_factory=list)   # interleaved (d_i, b_i) pairs

    @property
    def tlen(self):
        return len(self.trace)


def _u16(x: int) -> int:
    return x & 0xFFFF


class _Wave:
    """Shared band state for one forward or reverse pass."""

    def __init__(self):
        self.V = {}
        self.M = {}
        self.T = {}
        self.HA = {}
        self.HB = {}
        self.NA = {}
        self.NB = {}
        self.cells = []       # each: [ptr, diag, diff, mark]

    def pebble(self, ptr, diag, diff, mark) -> int:
        self.cells.append((ptr, diag, diff, mark))
        return len(self.cells) - 1

    def chain(self, h) -> list:
        """Pebble indices from root (first dropped) to h."""
        out = []
        while h >= 0:
            out.append(h)
            h = self.cells[h][0]
        out.reverse()
        return out


def forward_wave(A, B, spec: AlignSpec, mind, maxd, mida, minp, maxp,
                 aoff, boff):
    """Forward pass.  A/B are numeric arrays padded so index -1 and len are 4
    (callers pass np arrays via _pad).  Returns (low, fwd) where fwd carries
    aepos/bepos/diffs and the A/B trace pair lists."""
    TS = spec.trace_space
    PATH_AVE = spec.ave_path
    REACH = spec.reach
    SCORE = spec.score
    TABLE = spec.table

    w = _Wave()
    V, M, T, HA, HB, NA, NB = w.V, w.M, w.T, w.HA, w.HB, w.NA, w.NB

    hgh, low, dif = maxd, mind, 0
    more = True
    aclip, bclip = INT32_MAX, -INT32_MAX

    besta = trima = morea = lasta = mida
    besty = trimy = morey = (mida - hgh) >> 1
    trimd = mored = 0
    trimha = moreha = 0
    trimhb = morehb = 1
    morem = -1

    # 0-wave from the midline (align.c:420-556)
    for k in range(hgh, low - 1, -1):
        y = (mida - k) >> 1

        na = (((y + k) + (TS - aoff)) // TS - 1) * TS + aoff
        ha = w.pebble(-1, k, 0, na)
        na += TS
        nb = ((y + (TS - boff)) // TS - 1) * TS + boff
        hb = w.pebble(-1, k, 0, nb)
        nb += TS

        while True:
            c = B[y]
            if c == 4:
                more = False
                if bclip < k:
                    bclip = k
                break
            d = A[y + k]
            if c != d:
                if d == 4:
                    more = False
                    aclip = k
                break
            y += 1
        c = (y << 1) + k

        while y + k >= na:
            ha = w.pebble(ha, k, 0, na)
            na += TS
        while y >= nb:
            hb = w.pebble(hb, k, 0, nb)
            nb += TS

        if c > besta:
            besta = trima = lasta = c
            besty = trimy = y
            trimha, trimhb = ha, hb

        V[k] = c
        T[k] = PATH_INT
        M[k] = PATH_LEN
        HA[k], HB[k] = ha, hb
        NA[k], NB[k] = na, nb

    if not more:
        if B[besty] != 4 and A[besta - besty] != 4:
            more = True
        if hgh >= aclip:
            hgh = aclip - 1
            if morem <= M[aclip]:
                morem = M[aclip]
                morea = V[aclip]
                morey = (morea - aclip) // 2
                moreha, morehb = HA[aclip], HB[aclip]
        if low <= bclip:
            low = bclip + 1
            if morem <= M[bclip]:
                morem = M[bclip]
                morea = V[bclip]
                morey = (morea - bclip) // 2
                moreha, morehb = HA[bclip], HB[bclip]
        aclip, bclip = INT32_MAX, -INT32_MAX

    # successive waves (align.c:592-898)
    while more and lasta >= besta - TRIM_MLAG:
        low -= 1
        hgh += 1

        if low >= minp:
            NA[low] = NA[low + 1]
            NB[low] = NB[low + 1]
            V[low] = -1
        else:
            low += 1

        if hgh <= maxp:
            NA[hgh] = NA[hgh - 1]
            NB[hgh] = NB[hgh - 1]
            V[hgh] = am = -1
        else:
            hgh -= 1
            am = V[hgh]

        dif += 1

        ac = V[hgh + 1] = V[low - 1] = -1
        t, n = PATH_INT, PATH_LEN
        ua = ub = -1
        for k in range(hgh, low - 1, -1):
            ap = ac
            ac = am
            d = k - 1
            am = V[d]

            if ac < am:
                if am < ap:
                    c, m, b, ha, hb = ap + 1, n, t, ua, ub
                else:
                    c, m, b, ha, hb = am + 1, M[d], T[d], HA[d], HB[d]
            else:
                if ac < ap:
                    c, m, b, ha, hb = ap + 1, n, t, ua, ub
                else:
                    c, m, b, ha, hb = ac + 2, M[k], T[k], HA[k], HB[k]

            if b & PATH_TOP:
                m -= 1
            b = (b << 1) & ((PATH_TOP << 1) - 1)

            y = (c - k) >> 1
            while True:
                cb = B[y]
                if cb == 4:
                    more = False
                    if bclip < k:
                        bclip = k
                    break
                da = A[y + k]
                if cb != da:
                    if da == 4:
                        more = False
                        aclip = k
                    break
                y += 1
                if (b & PATH_TOP) == 0:
                    m += 1
                b = ((b << 1) | 1) & ((PATH_TOP << 1) - 1)
            c = (y << 1) + k

            while y + k >= NA[k]:
                if w.cells[ha][3] < NA[k]:
                    ha = w.pebble(ha, k, dif, NA[k])
                NA[k] += TS
            while y >= NB[k]:
                if w.cells[hb][3] < NB[k]:
                    hb = w.pebble(hb, k, dif, NB[k])
                NB[k] += TS

            if c > besta:
                besta, besty = c, y
                if m >= PATH_AVE:
                    lasta = c
                    if TABLE[b & TRIM_MASK] >= 0 and \
                       TABLE[(b >> TRIM_LEN) & TRIM_MASK] + SCORE[b & TRIM_MASK] >= 0:
                        trima, trimy, trimd = c, y, dif
                        trimha, trimhb = ha, hb

            # C reads stale band-edge slots here; they are never consumed
            # (the ap-branch can't be selected past a -1 sentinel), so any
            # default preserves semantics.
            t, n = T.get(k, PATH_INT), M.get(k, PATH_LEN)
            ua, ub = HA.get(k, -1), HB.get(k, -1)
            V[k], T[k], M[k], HA[k], HB[k] = c, b, m, ha, hb

        if not more:
            if B[besty] != 4 and A[besta - besty] != 4:
                more = True
            if hgh >= aclip:
                hgh = aclip - 1
                if morem <= M[aclip]:
                    morem = M[aclip]
                    morea = V[aclip]
                    morey = (morea - aclip) // 2
                    mored = dif
                    moreha, morehb = HA[aclip], HB[aclip]
            if low <= bclip:
                low = bclip + 1
                if morem <= M[bclip]:
                    morem = M[bclip]
                    morea = V[bclip]
                    morey = (morea - bclip) // 2
                    mored = dif
                    moreha, morehb = HA[bclip], HB[bclip]
            aclip, bclip = INT32_MAX, -INT32_MAX

        nthr = besta - WAVE_LAG
        while hgh >= low:
            if V[hgh] < nthr:
                hgh -= 1
            else:
                while V[low] < nthr:
                    low += 1
                break

    # trace extraction (align.c:900-1007)
    if morem >= 0 and REACH:
        trimx = morea - morey
        trimy = morey
        trimd = mored
        trimha, trimhb = moreha, morehb
    else:
        trimx = trima - trimy

    return extract_forward_traces(w.cells, trimha, trimhb, trimx, trimy,
                                  trimd, mida)


def reverse_wave(A, B, spec: AlignSpec, mind, maxd, mida, minp, maxp,
                 aoff, boff, apath: PathRec, atrace_f: list, btrace_f: list):
    """Reverse pass; A/B indexed with the same convention but the reference
    decrements its pointers by one (align.c:1017-1018), so all sequence
    accesses here are at index-1.  Prepends to atrace_f/btrace_f and fills
    apath.abpos/bbpos, accumulating diffs.  Returns (a_pre, b_pre) prepend
    lists (junction merges may mutate atrace_f[0:2]/btrace_f[0:2])."""
    TS = spec.trace_space
    PATH_AVE = spec.ave_path
    REACH = spec.reach
    SCORE = spec.score
    TABLE = spec.table

    w = _Wave()
    V, M, T, HA, HB, NA, NB = w.V, w.M, w.T, w.HA, w.HB, w.NA, w.NB

    hgh, low, dif = maxd, mind, 0
    more = True
    aclip, bclip = -INT32_MAX, INT32_MAX

    besta = trima = morea = lasta = mida
    besty = trimy = morey = (mida - hgh) >> 1
    trimd = mored = 0
    trimha = moreha = 0
    trimhb = morehb = 1
    morem = -1

    # sequence access with the decremented-pointer convention
    def Bc(y):
        return B[y - 1]

    def Ac(x):
        return A[x - 1]

    for k in range(low, hgh + 1):
        y = (mida - k) >> 1

        na = (((y + k) + (TS - aoff) - 1) // TS - 1) * TS + aoff
        ha = w.pebble(-1, k, 0, y + k)
        nb = ((y + (TS - boff) - 1) // TS - 1) * TS + boff
        hb = w.pebble(-1, k, 0, y)

        while True:
            c = Bc(y)
            if c == 4:
                more = False
                if bclip > k:
                    bclip = k
                break
            d = Ac(y + k)
            if c != d:
                if d == 4:
                    more = False
                    aclip = k
                break
            y -= 1
        c = (y << 1) + k

        while y + k <= na:
            ha = w.pebble(ha, k, 0, na)
            na -= TS
        while y <= nb:
            hb = w.pebble(hb, k, 0, nb)
            nb -= TS

        if c < besta:
            besta = trima = lasta = c
            besty = trimy = y
            trimha, trimhb = ha, hb

        V[k] = c
        T[k] = PATH_INT
        M[k] = PATH_LEN
        HA[k], HB[k] = ha, hb
        NA[k], NB[k] = na, nb

    if not more:
        if Bc(besty) != 4 and Ac(besta - besty) != 4:
            more = True
        if low <= aclip:
            low = aclip + 1
            if morem <= M[aclip]:
                morem = M[aclip]
                morea = V[aclip]
                morey = (morea - aclip) // 2
                moreha, morehb = HA[aclip], HB[aclip]
        if hgh >= bclip:
            hgh = bclip - 1
            if morem <= M[bclip]:
                morem = M[bclip]
                morea = V[bclip]
                morey = (morea - bclip) // 2
                moreha, morehb = HA[bclip], HB[bclip]
        aclip, bclip = -INT32_MAX, INT32_MAX

    while more and lasta <= besta + TRIM_MLAG:
        low -= 1
        hgh += 1

        if low >= minp:
            NA[low] = NA[low + 1]
            NB[low] = NB[low + 1]
            V[low] = ap = INT32_MAX
        else:
            low += 1
            ap = V[low]

        if hgh <= maxp:
            NA[hgh] = NA[hgh - 1]
            NB[hgh] = NB[hgh - 1]
            V[hgh] = INT32_MAX
        else:
            hgh -= 1

        dif += 1

        ac = V[hgh + 1] = V[low - 1] = INT32_MAX
        t, n = PATH_INT, PATH_LEN
        ua = ub = -1
        for k in range(low, hgh + 1):
            am = ac
            ac = ap
            d = k + 1
            ap = V[d]

            if ac > ap:
                if ap > am:
                    c, m, b, ha, hb = am - 1, n, t, ua, ub
                else:
                    c, m, b, ha, hb = ap - 1, M[d], T[d], HA[d], HB[d]
            else:
                if ac > am:
                    c, m, b, ha, hb = am - 1, n, t, ua, ub
                else:
                    c, m, b, ha, hb = ac - 2, M[k], T[k], HA[k], HB[k]

            if b & PATH_TOP:
                m -= 1
            b = (b << 1) & ((PATH_TOP << 1) - 1)

            y = (c - k) >> 1
            while True:
                cb = Bc(y)
                if cb == 4:
                    more = False
                    if bclip > k:
                        bclip = k
                    break
                da = Ac(y + k)
                if cb != da:
                    if da == 4:
                        more = False
                        aclip = k
                    break
                y -= 1
                if (b & PATH_TOP) == 0:
                    m += 1
                b = ((b << 1) | 1) & ((PATH_TOP << 1) - 1)
            c = (y << 1) + k

            while y + k <= NA[k]:
                if w.cells[ha][3] > NA[k]:
                    ha = w.pebble(ha, k, dif, NA[k])
                NA[k] -= TS
            while y <= NB[k]:
                if w.cells[hb][3] > NB[k]:
                    hb = w.pebble(hb, k, dif, NB[k])
                NB[k] -= TS

            if c < besta:
                besta, besty = c, y
                if m >= PATH_AVE:
                    lasta = c
                    if TABLE[b & TRIM_MASK] >= 0 and \
                       TABLE[(b >> TRIM_LEN) & TRIM_MASK] + SCORE[b & TRIM_MASK] >= 0:
                        trima, trimy, trimd = c, y, dif
                        trimha, trimhb = ha, hb

            # C reads stale band-edge slots here; they are never consumed
            # (the ap-branch can't be selected past a -1 sentinel), so any
            # default preserves semantics.
            t, n = T.get(k, PATH_INT), M.get(k, PATH_LEN)
            ua, ub = HA.get(k, -1), HB.get(k, -1)
            V[k], T[k], M[k], HA[k], HB[k] = c, b, m, ha, hb

        if not more:
            if Bc(besty) != 4 and Ac(besta - besty) != 4:
                more = True
            if low <= aclip:
                low = aclip + 1
                if morem <= M[aclip]:
                    morem = M[aclip]
                    morea = V[aclip]
                    morey = (morea - aclip) // 2
                    mored = dif
                    moreha, morehb = HA[aclip], HB[aclip]
            if hgh >= bclip:
                hgh = bclip - 1
                if morem <= M[bclip]:
                    morem = M[bclip]
                    morea = V[bclip]
                    morey = (morea - bclip) // 2
                    mored = dif
                    moreha, morehb = HA[bclip], HB[bclip]
            aclip, bclip = -INT32_MAX, INT32_MAX

        nthr = besta + WAVE_LAG
        while hgh >= low:
            if V[hgh] > nthr:
                hgh -= 1
            else:
                while V[low] > nthr:
                    low += 1
                break

    # trace extraction (align.c:1554-1717)
    if morem >= 0 and REACH:
        trimx = morea - morey
        trimy = morey
        trimd = mored
        trimha, trimhb = moreha, morehb
    else:
        trimx = trima - trimy

    a_pre, b_pre = extract_reverse_traces(w.cells, trimha, trimhb, trimx,
                                          trimy, trimd, TS, aoff, boff,
                                          atrace_f, btrace_f)
    apath.abpos = trimx
    apath.bbpos = trimy
    apath.diffs = apath.diffs + trimd
    return a_pre, b_pre


def _pad(seq: np.ndarray):
    """Return an accessor giving sentinel 4 at any index outside [0,len)."""
    n = len(seq)
    # generous sentinel pads: the wave can run past the end by up to a snake
    arr = np.full(n + 2, 4, np.uint8)
    arr[1:n + 1] = seq

    class Acc:
        __slots__ = ("a", "n")

        def __init__(self, a, n):
            self.a = a
            self.n = n

        def __getitem__(self, i):
            if -1 <= i <= self.n:
                return self.a[i + 1]
            return 4

    return Acc(arr, n)


def local_alignment(aseq: np.ndarray, bseq: np.ndarray, spec: AlignSpec,
                    low: int, hgh: int, anti: int,
                    lbord: int = -1, hbord: int = -1, flags: int = 0,
                    selfie: bool = False):
    """Local_Alignment (align.c:1727-1946).  aseq/bseq numeric (0..3), no
    sentinels.  Returns (apath, bpath) PathRecs with uint16 trace pairs."""
    alen, blen = len(aseq), len(bseq)
    A, B = _pad(aseq), _pad(bseq)

    apath = PathRec()
    bpath = PathRec()

    while ((anti - hgh) >> 1) < 0:
        hgh -= 1

    if lbord < 0:
        minp = 1 if (selfie and low >= 0) else -INT32_MAX
    else:
        minp = low - lbord
    if hbord < 0:
        maxp = -1 if (selfie and hgh <= 0) else INT32_MAX
    else:
        maxp = hgh + hbord

    if flags & ACOMP_FLAG:
        aoff = alen % spec.trace_space
        boff = 0
    elif flags & COMP_FLAG:
        aoff = 0
        boff = blen % spec.trace_space
    else:
        aoff = boff = 0

    low2, fwd, btrace_f = forward_wave(A, B, spec, low, hgh, anti,
                                       minp, maxp, aoff, boff)
    apath.aepos, apath.bepos, apath.diffs = fwd.aepos, fwd.bepos, fwd.diffs
    atrace_f = fwd.trace

    fshort = (apath.aepos + apath.bepos) - anti < DUB_TRIM

    a_pre, b_pre = reverse_wave(A, B, spec, low2, low2, anti, minp, maxp,
                                aoff, boff, apath, atrace_f, btrace_f)

    rshort = anti - (apath.abpos + apath.bbpos) < DUB_TRIM

    if fshort:
        if rshort:
            apath.aepos = apath.abpos = (apath.abpos + apath.aepos) // 2
            apath.bepos = apath.bbpos = (apath.bbpos + apath.bepos) // 2
            atrace_f, a_pre = [], []
            btrace_f, b_pre = [], []
        else:
            low = apath.abpos - apath.bbpos
            anti = apath.abpos + apath.bbpos
            atrace_f, a_pre = [], []
            btrace_f, b_pre = [], []
            low2, fwd, btrace_f = forward_wave(A, B, spec, low, low, anti,
                                               minp, maxp, aoff, boff)
            apath.aepos, apath.bepos = fwd.aepos, fwd.bepos
            apath.diffs = fwd.diffs   # forward overwrites diffs (align.c:1004)
            atrace_f = fwd.trace
    else:
        if rshort:
            low = apath.aepos - apath.bepos
            anti = apath.aepos + apath.bepos
            atrace_f, a_pre = [], []
            btrace_f, b_pre = [], []
            apath.diffs = 0
            a_pre, b_pre = reverse_wave(A, B, spec, low, low, anti,
                                        minp, maxp, aoff, boff,
                                        apath, atrace_f, btrace_f)

    apath.trace = a_pre + atrace_f
    bpath.trace = b_pre + btrace_f
    finalize_paths(apath, bpath, flags, alen, blen)

    return apath, bpath


def finalize_paths(apath: PathRec, bpath: PathRec, flags: int,
                   alen: int, blen: int) -> None:
    """Fill bpath coordinates and apply COMP/ACOMP coordinate flips and
    trace-pair reversal (align.c:1857-1912)."""
    bpath.diffs = apath.diffs

    if flags & ACOMP_FLAG:
        bpath.aepos = apath.bepos
        bpath.bepos = apath.aepos
        bpath.abpos = apath.bbpos
        bpath.bbpos = apath.abpos

        apath.abpos = alen - bpath.bepos
        apath.bbpos = blen - bpath.aepos
        apath.aepos = alen - bpath.bbpos
        apath.bepos = blen - bpath.abpos
        _reverse_pairs(apath.trace)
    elif flags & COMP_FLAG:
        bpath.abpos = blen - apath.bepos
        bpath.bbpos = alen - apath.aepos
        bpath.aepos = blen - apath.bbpos
        bpath.bepos = alen - apath.abpos
        _reverse_pairs(bpath.trace)
    else:
        bpath.aepos = apath.bepos
        bpath.bepos = apath.aepos
        bpath.abpos = apath.bbpos
        bpath.bbpos = apath.abpos


def _reverse_pairs(tr: list) -> None:
    """Reverse a flat (d,b)-pair list pairwise in place (align.c:1872-1883)."""
    i = len(tr) - 2
    j = 0
    while j < i:
        tr[i], tr[j] = tr[j], tr[i]
        tr[i + 1], tr[j + 1] = tr[j + 1], tr[i + 1]
        i -= 2
        j += 2


def _chain_of(cells, h) -> list:
    out = []
    while h >= 0:
        out.append(h)
        h = cells[h][0]
    out.reverse()
    return out


def extract_forward_traces(cells, trimha, trimhb, trimx, trimy, trimd, mida):
    """Walk the pebble chains of a finished forward pass into (d,b) trace
    pair lists (align.c:900-1007).  cells[h] -> (ptr, diag, diff, mark).
    Returns (low, fwd PathRec, btrace)."""
    atrace: list[int] = []
    btrace: list[int] = []

    chain = _chain_of(cells, trimha)
    h0 = chain[0]
    k = cells[h0][1]
    b = (mida - k) // 2
    e = 0
    for h in chain[1:]:
        _, k, d, mark = cells[h]
        a = mark - k
        atrace.append(_u16(d - e))
        atrace.append(_u16(a - b))
        b, e = a, d
    if b + k != trimx:
        atrace.append(_u16(trimd - e))
        atrace.append(_u16(trimy - b))
    elif b != trimy:
        atrace[-1] = _u16(atrace[-1] + (trimy - b))
        atrace[-2] = _u16(atrace[-2] + (trimd - e))

    chain = _chain_of(cells, trimhb)
    h0 = chain[0]
    k = cells[h0][1]
    b = (mida + k) // 2
    e = 0
    low = k
    for h in chain[1:]:
        _, k, d, mark = cells[h]
        a = mark + k
        btrace.append(_u16(d - e))
        btrace.append(_u16(a - b))
        b, e = a, d
    if b - k != trimy:
        btrace.append(_u16(trimd - e))
        btrace.append(_u16(trimx - b))
    elif b != trimx:
        btrace[-1] = _u16(btrace[-1] + (trimx - b))
        btrace[-2] = _u16(btrace[-2] + (trimd - e))

    fwd = PathRec(aepos=trimx, bepos=trimy, diffs=trimd)
    fwd.trace = atrace
    return low, fwd, btrace


def extract_reverse_traces(cells, trimha, trimhb, trimx, trimy, trimd,
                           TS, aoff, boff, atrace_f, btrace_f):
    """Walk the pebble chains of a finished reverse pass (align.c:1554-1708).
    Prepends before the forward lists; may mutate atrace_f[0:2]/btrace_f[0:2]
    at the junction.  Returns (a_pre, b_pre)."""
    a_pre: list[int] = []
    b_pre: list[int] = []

    chain = _chain_of(cells, trimha)
    h0 = chain[0]
    k = cells[h0][1]
    b = cells[h0][3] - k
    e = 0
    hrest = chain[1:]
    if (b + k) % TS != aoff:
        if not hrest:
            a, d = trimy, trimd
        else:
            _, k, d, mark = cells[hrest[0]]
            a = mark - k
        if len(atrace_f) == 0:
            a_pre[:0] = [_u16(d - e), _u16(b - a)]
        else:
            atrace_f[1] = _u16(atrace_f[1] + (b - a))
            atrace_f[0] = _u16(atrace_f[0] + (d - e))
        b, e = a, d
        hrest = hrest[1:] if hrest else hrest
        h_valid = bool(chain[1:])  # h >= 0 in C after the advance
    else:
        h_valid = True
    if h_valid:
        for h in hrest:
            _, k, d, mark = cells[h]
            a = mark - k
            a_pre[:0] = [_u16(d - e), _u16(b - a)]
            b, e = a, d
        if b + k != trimx:
            a_pre[:0] = [_u16(trimd - e), _u16(b - trimy)]
        elif b != trimy:
            a_pre[1] = _u16(a_pre[1] + (b - trimy))
            a_pre[0] = _u16(a_pre[0] + (trimd - e))

    chain = _chain_of(cells, trimhb)
    h0 = chain[0]
    k = cells[h0][1]
    b = cells[h0][3] + k
    e = 0
    hrest = chain[1:]
    if (b - k) % TS != boff:
        if not hrest:
            a, d = trimx, trimd
        else:
            _, k, d, mark = cells[hrest[0]]
            a = mark + k
        if len(btrace_f) == 0:
            # NB: the reference writes (b-a) into both slots here
            # (align.c:1669-1672); parity preserved.
            b_pre[:0] = [_u16(b - a), _u16(b - a)]
        else:
            btrace_f[1] = _u16(btrace_f[1] + (b - a))
            btrace_f[0] = _u16(btrace_f[0] + (d - e))
        b, e = a, d
        h_valid = bool(chain[1:])
        hrest = hrest[1:] if hrest else hrest
    else:
        h_valid = True
    if h_valid:
        for h in hrest:
            _, k, d, mark = cells[h]
            a = mark + k
            b_pre[:0] = [_u16(d - e), _u16(b - a)]
            b, e = a, d
        if b - k != trimy:
            b_pre[:0] = [_u16(trimd - e), _u16(b - trimx)]
        elif b != trimx:
            b_pre[1] = _u16(b_pre[1] + (b - trimx))
            b_pre[0] = _u16(b_pre[0] + (trimd - e))

    return a_pre, b_pre

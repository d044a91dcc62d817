"""Gap consolidation of exact traces (Gap_Improver, align.c:5497-5892).

Scans an exact indel script for "boxes": clusters of nearby gap groups
separated by short (< LONG_SNAKE) imperfect snakes.  For each box a greedy
unit-cost DP over the box's diagonals (furthest-reaching with snake
extension) finds the cheapest path between the box's endpoints; when it
beats the current cost (gap groups + hamming mismatches) the box's section
of the trace is rewritten from the DP back-walk.

The result is an equivalent alignment with the same endpoints whose gaps
are consolidated (affine-gap-like cleanup).  Unlike the reference, which
rewrites trace entries in place and never shrinks ``tlen``, this
implementation splices the improved (possibly shorter) entry list into the
Python trace and recounts ``path.diffs``, so the output is always a valid
script under the align.h:79-87 encoding.
"""

from __future__ import annotations

import numpy as np

from .wave import PathRec

LONG_SNAKE = 50     # align.c:5505


def _snake(a, b, i, j):
    """Match run comparing a[i+n] vs b[j+n]; breaks on a-sentinel or
    mismatch (snake align.c:5539; arrays here are 1-based sentinel-padded)."""
    n = 0
    while a[i + n] != 4 and a[i + n] == b[j + n]:
        n += 1
    return n


def _rsnake(a, b, i, j):
    """Backward match run comparing a[i-1-n] vs b[j-1-n] (align.c:5552)."""
    n = 0
    while a[i - n - 1] != 4 and a[i - n - 1] == b[j - n - 1]:
        n += 1
    return n


def _hamming(a, b, i, j, n):
    h = 0
    for t in range(n):
        x = a[i + t]
        if x == 4:
            break
        y = b[j + t]
        if x != y:
            if y == 4:
                break
            h += 1
    return h


def _recount_diffs(A, B, path) -> int:
    """#gap columns + #substitutions of the script (1-based padded seqs)."""
    i = path.abpos + 1
    j = path.bbpos + 1
    diffs = 0
    for c in path.trace:
        if c < 0:
            k = -c
            while i < k:
                diffs += int(A[i] != B[j])
                i += 1
                j += 1
            j += 1
            diffs += 1
        else:
            while j < c:
                diffs += int(A[i] != B[j])
                i += 1
                j += 1
            i += 1
            diffs += 1
    while i <= path.aepos:
        diffs += int(A[i] != B[j])
        i += 1
        j += 1
    return diffs


def gap_improver(aln_aseq: np.ndarray, aln_bseq: np.ndarray,
                 path: PathRec) -> PathRec:
    """Consolidate the gaps of path.trace (an exact indel script) in place.
    aln_aseq/aln_bseq are the full numeric sequences (no sentinels)."""
    A = np.full(len(aln_aseq) + 2, 4, np.int16)
    A[1:len(aln_aseq) + 1] = aln_aseq
    B = np.full(len(aln_bseq) + 2, 4, np.int16)
    B[1:len(aln_bseq) + 1] = aln_bseq

    t = path.trace
    d = path.abpos - path.bbpos
    x = 0
    improved = False
    while x < len(t):
        q = t[x]
        p = q
        mstart = x
        box_start = x
        Fdag = d
        Fpos = p
        Hamm = 0
        Gaps = 1
        # box extent scan (align.c:5629-5660)
        while True:
            x += 1
            q = t[x] if x < len(t) else 0
            if x >= len(t) or q != p:
                m = x - mstart
                if p < 0:
                    d -= m
                    if q >= 0 or p - q >= LONG_SNAKE:
                        break
                    Hamm += _hamming(A, B, -p, -(d + p), p - q)
                else:
                    d += m
                    if q <= 0 or q - p >= LONG_SNAKE:
                        break
                    Hamm += _hamming(A, B, p + d, p, q - p)
                Gaps += 1
                p = q
                mstart = x
        if Gaps == 1:
            continue
        Lpos = p
        Diag = abs(Fdag - d) + 1

        new = _box_dp(A, B, Fpos, Lpos, Fdag, d, Diag, Gaps + Hamm)
        if new is not None:
            old_n = x - box_start
            t[box_start:x] = new
            x -= old_n - len(new)
            improved = True
    if improved:
        path.diffs = _recount_diffs(A, B, path)
    return path


def _box_dp(A, B, Fpos, Lpos, Fdag, d, Diag, budget):
    """Greedy furthest-reaching DP over one box; returns the new gap-entry
    list for the box, or None when no improvement (align.c:5700-5890)."""
    neg = Fpos < 0
    if neg:
        Fpos, Lpos = -Fpos, -Lpos
        # extend the box to clean snake ends (align.c:5702-5712)
        while (A[Fpos - 1] != B[(Fpos - Fdag) - 1] and A[Fpos - 1] != 4
               and B[(Fpos - Fdag) - 1] != 4):
            Fpos -= 1
        while A[Lpos] != B[Lpos - d] and A[Lpos] != 4 and B[Lpos - d] != 4:
            Lpos += 1
        diags = list(range(Fdag, d - 1, -1))

        def sn(p, m):
            return _snake(A, B, p, p - m)

        def rsn(p, m):
            return _rsnake(A, B, p, p - m)
    else:
        while (B[Fpos - 1] != A[(Fpos + Fdag) - 1] and B[Fpos - 1] != 4
               and A[(Fpos + Fdag) - 1] != 4):
            Fpos -= 1
        while B[Lpos] != A[Lpos + d] and B[Lpos] != 4 and A[Lpos + d] != 4:
            Lpos += 1
        diags = list(range(Fdag, d + 1))

        def sn(p, m):
            return _snake(A, B, p + m, p)

        def rsn(p, m):
            return _rsnake(A, B, p + m, p)

    F = [Fpos - 1] * Diag
    F[0] = Fpos + sn(Fpos, diags[0])
    Hrows = []
    passes = 0
    while F[-1] < Lpos and passes <= budget:
        brow = Fpos
        c = 0
        hrow = []
        for i, m in enumerate(diags):
            p = brow
            if F[i] >= brow:
                brow = F[i]
                c = 0
                p = brow + 1
            else:
                c += 1
            hrow.append(c)
            F[i] = p + sn(p, m)
        Hrows.append(hrow)
        passes += 1

    if passes >= budget:
        return None

    # back-walk emitting gap entries end-first (align.c:5765-5790)
    out = []
    p = Lpos
    m = d
    for hrow in reversed(Hrows):
        p -= rsn(p, m)
        if p < Fpos:
            p = Fpos
        k = hrow[diags.index(m)]
        if k == 0:
            p -= 1
        else:
            if neg:
                m += k
                for _ in range(k):
                    out.append(-p)
            else:
                m -= k
                for _ in range(k):
                    out.append(p)
    out.reverse()
    return out

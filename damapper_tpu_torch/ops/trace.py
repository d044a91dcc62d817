"""Exact trace computation between/through trace points (consumer side).

Semantics-parity reimplementation of the reference's O(np) and O(nd) tracing
algorithms (align.c:3955-5574), operating on numeric uint8 sequences and this
framework's PathRec records (ops.wave.PathRec).

 * ``iter_np``        — leftmost-optimal O(np) alignment of one trace-point
                        segment, emitting the indel script (iter_np
                        align.c:4531-4866).
 * ``middle_np``      — same forward pass, but walks back only half the edits
                        to report the alignment midpoint (align.c:4869-5148).
 * ``compute_trace_pts/mid/irr`` — the three Compute_Trace flavors
                        (align.c:5152-5497): replace a Path's trace-point list
                        with an exact integer trace.
 * ``split_nd``       — bidirectional O(nd) wave meeting in the middle
                        (align.c:3993-4153).
 * ``compute_alignment`` — from-scratch optimal alignment of the Path's
                        substrings via divide & conquer over ``split_nd``
                        (dandc_nd align.c:4300, trace_nd align.c:4155,
                        Compute_Alignment align.c:4373).

Exact trace encoding (align.h:79-87): a list of ints where a negative value
-j means "a dash before A[j]" and a positive value k means "a dash before
B[k]" (1-based), in alignment order.

These run on host: the reference's consumers (LAshow/DaViewer) are CPU tools,
and segments are <= trace_spacing bp.
"""

from __future__ import annotations

import numpy as np

from .wave import PathRec

# trace-back modes (align.h:253-255)
LOWERMOST = -1
GREEDIEST = 0
UPPERMOST = 1

# Compute_Alignment tasks (align.h:279-283)
PLUS_ALIGN = 0
PLUS_TRACE = 1
DIFF_ONLY = 2
DIFF_ALIGN = 3
DIFF_TRACE = 4


class TraceError(Exception):
    """Trace-point data inconsistent with the sequences (align.c:4528)."""


TP_ALIGN = ("Bad alignment between trace points (Compute_Trace), "
            "source DB likely incorrect")
TP_ERROR = ("Trace point out of bounds (Compute_Trace), "
            "source DB likely incorrect")


class _NPWaves:
    """The PVF/PHF wave stacks of one O(np) pass (Trace_Waves align.c:3982).

    Rows are D = -2..dmax; columns are diagonals posl-1..posh+1.  Storage is a
    dense int32 matrix; ``V``/``H`` accessors take (D, k) in those logical
    coordinates.
    """

    def __init__(self, dmax: int, delta: int = 0):
        # diagonals span [min(delta,0)-1, max(delta,0)+1] initially and can
        # widen to +-dmax; the reference sizes its rows trace_spacing+nmax+3
        # wide which covers both (align.c:5210)
        self.dmax = dmax
        reach = max(dmax, abs(delta)) + 1
        span = 2 * reach + 1
        self.koff = reach             # k = -reach .. reach
        self.V = np.zeros((dmax + 3, span), np.int32)
        self.H = np.zeros((dmax + 3, span), np.int32)

    def _ix(self, D, k):
        kx = k + self.koff
        if not (0 <= D + 2 < self.V.shape[0] and 0 <= kx < self.V.shape[1]):
            # walked outside the wave stacks: the stored trace points do not
            # describe a real alignment of these sequences
            raise TraceError(TP_ALIGN)
        return D + 2, kx

    def v(self, D, k):
        return int(self.V[self._ix(D, k)])

    def setv(self, D, k, x):
        self.V[self._ix(D, k)] = x

    def h(self, D, k):
        return int(self.H[self._ix(D, k)])

    def seth(self, D, k, x):
        self.H[self._ix(D, k)] = x


def _np_forward(A, M, B, N, w: _NPWaves, dmax, posl, posh):
    """The shared furthest-reaching forward pass of iter_np/middle_np
    (align.c:4536-4674).  Returns the terminal wave index D."""
    delta = M - N
    low, hgh = (0, delta) if delta >= 0 else (delta, 0)

    V, H, koff = w.V, w.H, w.koff
    V[0, low - 1 + koff:hgh + 2 + koff] = -2     # PVF[-2]
    V[1, low - 1 + koff:hgh + 2 + koff] = -2     # PVF[-1]
    V[1, koff] = -1
    low += 1
    hgh -= 1

    Ai = A  # numpy uint8
    Bi = B

    D = 0
    while True:
        if D > dmax:
            raise TraceError(TP_ALIGN)
        F2 = V[D]           # PVF[D-2]
        F1 = V[D + 1]       # PVF[D-1]
        F0 = V[D + 2]       # PVF[D]
        HF = H[D + 2]
        if (D & 1) == 0:
            if low > posl:
                low -= 1
            if hgh < posh:
                hgh += 1
        F0[hgh + 1 + koff] = F0[low - 1 + koff] = -2

        def fs_move(k, am, ap, mdir, pdir):
            ac = F1[k + koff] + 1
            if ac < am:
                if ap < am:
                    HF[k + koff] = mdir
                    j = am
                else:
                    HF[k + koff] = pdir
                    j = ap
            else:
                if ap < ac:
                    HF[k + koff] = 0
                    j = ac
                else:
                    HF[k + koff] = pdir
                    j = ap
            lim = min(N, M - k)
            # vectorized snake: first mismatch of B[j:lim] vs A[k+j:k+lim]
            if j < lim:
                seg = Bi[j:lim] != Ai[k + j:k + lim]
                nz = np.argmax(seg)
                if seg[nz]:
                    j += int(nz)
                else:
                    j = lim
            F0[k + koff] = j
            return j

        j = -2
        for k in range(hgh, delta, -1):
            j = fs_move(k, int(F2[k - 1 + koff]), j + 1, -1, 4)
        j = -2
        for k in range(low, delta):
            j = fs_move(k, j, int(F2[k + 1 + koff]) + 1, 2, 1)
        fs_move(delta, j, int(F0[delta + 1 + koff]) + 1, 2, 4)

        if F0[delta + koff] >= N:
            return D
        D += 1


def _walk_back(A, B, w: _NPWaves, D, delta, N, mode, half=None):
    """Back-walk the H pointers from (D, delta), optionally re-canonicalizing
    snakes for UPPERMOST/LOWERMOST (align.c:4676-4822 / 4986-5137).

    With ``half`` None this walks to the origin, reversing the H pointers in
    place for the forward emission pass, and returns None.  With ``half`` an
    int it stops after ``half`` edges and returns the (D, k) reached.
    """
    c = N
    k = delta
    if half is None:
        w.seth(0, 0, 3)
        e = w.h(D, k)
        w.seth(D, k, 3)
        steps = None
    else:
        e = None
        steps = half

    while True:
        if half is None:
            if e == 3:
                return None
        else:
            if steps <= 0:
                return D, k
            e = w.h(D, k)
            steps -= 1

        h = k + e
        if e > 1:
            h -= 3
        elif e == 0:
            D -= 1
        else:
            D -= 2

        if mode == UPPERMOST and h < k:
            # e is -1 or 2: renormalize the snake upward (align.c:4700-4746)
            m = -k if k < 0 else 0
            if w.v(D, h) <= c:
                c = w.v(D, h) - 1
            while c >= m and A[k + c] == B[c]:
                c -= 1
            if e == -1:
                if c <= w.v(D + 2, k + 1):
                    e, h, D = 4, k + 1, D + 2
                elif c == w.v(D + 1, k):
                    e, h, D = 0, k, D + 1
                else:
                    w.setv(D, h, c + 1)
            else:
                mrow = D if k == delta else D - 2
                if c <= w.v(mrow, k + 1):
                    e = 4 if k == delta else 1
                    h, D = k + 1, mrow
                elif c == w.v(D - 1, k):
                    e, h, D = 0, k, D - 1
                else:
                    w.setv(D, h, c + 1)
        elif mode == LOWERMOST and h > k:
            # e is 1 or 4: renormalize the snake downward (align.c:4757-4817)
            m = -k if k < 0 else 0
            if w.v(D, h) < c:
                c = w.v(D, h)
            while c >= m and A[k + c] == B[c]:
                c -= 1
            if e == 1:
                if c < w.v(D + 2, k - 1):
                    e, h, D = 2, k - 1, D + 2
                elif c == w.v(D + 1, k):
                    e, h, D = 0, k, D + 1
                else:
                    w.setv(D, h, c)
                    c -= 1
            else:
                mrow = D if k == delta else D - 2
                if c < w.v(mrow, k - 1):
                    e = 2 if k == delta else -1
                    h, D = k - 1, mrow
                elif c == w.v(D - 1, k):
                    e, h, D = 0, k, D - 1
                else:
                    w.setv(D, h, c)
                    c -= 1

        if half is None:
            m = w.h(D, h)
            w.seth(D, h, e)
            e = m
        k = h


def iter_np(A, B, aoff: int, boff: int, mode: int, dmax: int, out: list,
            posl=None, posh=None) -> int:
    """Leftmost-optimal O(np) alignment of A vs B (numpy uint8 segments at
    absolute offsets aoff/boff), appending indel codes to ``out``.  Returns
    the number of differences (iter_np align.c:4531)."""
    M, N = len(A), len(B)
    delta = M - N
    if posl is None:
        posl = -dmax
    if posh is None:
        posh = dmax
    w = _NPWaves(dmax, delta)
    D = _np_forward(A, M, B, N, w, dmax, posl, posh)
    Dtotal = D + abs(delta)

    _walk_back(A, B, w, D, delta, N, mode)

    # forward emission (align.c:4825-4860)
    ap = -aoff - 1
    bp = boff + 1
    k = D = 0
    e = w.h(D, k)
    while e != 3:
        h = k - e
        c = w.v(D, k)
        if e > 1:
            h += 3
        elif e == 0:
            D += 1
        else:
            D += 2
        if h > k:
            out.append(bp + c)
        elif h < k:
            out.append(ap - (c + k))
        k = h
        e = w.h(D, h)
    return Dtotal


def middle_np(A, B, aoff: int, boff: int, mode: int, dmax: int,
              posl=None, posh=None):
    """Forward pass + half back-walk; returns the absolute alignment midpoint
    (mida, midb) (middle_np align.c:4869)."""
    M, N = len(A), len(B)
    delta = M - N
    if posl is None:
        posl = -dmax
    if posh is None:
        posh = dmax
    w = _NPWaves(dmax, delta)
    D = _np_forward(A, M, B, N, w, dmax, posl, posh)
    d = D + abs(delta)
    D, k = _walk_back(A, B, w, D, delta, N, mode, half=d - d // 2)
    midb = boff + w.v(D, k)
    mida = aoff + k + w.v(D, k)
    return mida, midb


def _trace_dmax(points, tlen, N):
    """Shared dmax/nmax scan over the stored (diff, b) pairs
    (align.c:5189-5200)."""
    nmax = dmax = 0
    for d in range(1, tlen, 2):
        if points[d - 1] > dmax:
            dmax = int(points[d - 1])
        if points[d] > nmax:
            nmax = int(points[d])
    if tlen <= 1:
        nmax = N
    if dmax & 1:
        dmax += 1
    return dmax, nmax


def compute_trace_pts(path: PathRec, aseq, bseq, trace_spacing: int,
                      mode: int = GREEDIEST) -> PathRec:
    """Replace path.trace (trace points) with an exact trace by aligning each
    consecutive trace-point segment (Compute_Trace_PTS align.c:5152).
    aseq/bseq are the FULL numeric sequences; coordinates in path are
    absolute."""
    alen, blen = len(aseq), len(bseq)
    points = path.trace
    tlen = len(points)
    dmax, _ = _trace_dmax(points, tlen, path.bepos - path.bbpos)

    out: list[int] = []
    diffs = 0
    ab = path.abpos
    ae = (ab // trace_spacing) * trace_spacing
    bb = path.bbpos
    for i in range(1, tlen - 2, 2):
        ae = ae + trace_spacing
        be = bb + int(points[i])
        if ae > alen or be > blen:
            raise TraceError(TP_ERROR)
        diffs += iter_np(aseq[ab:ae], bseq[bb:be], ab, bb, mode, dmax, out)
        ab, bb = ae, be
    ae, be = path.aepos, path.bepos
    if ae > alen or be > blen:
        raise TraceError(TP_ERROR)
    diffs += iter_np(aseq[ab:ae], bseq[bb:be], ab, bb, mode, dmax, out)

    path.trace = out
    path.diffs = diffs
    return path


def compute_trace_mid(path: PathRec, aseq, bseq, trace_spacing: int,
                      mode: int = GREEDIEST) -> PathRec:
    """Like compute_trace_pts but aligns between segment midpoints for nearer
    optimal traces (Compute_Trace_MID align.c:5264)."""
    alen, blen = len(aseq), len(bseq)
    points = path.trace
    tlen = len(points)
    dmax, _ = _trace_dmax(points, tlen, path.bepos - path.bbpos)

    out: list[int] = []
    diffs = 0
    ab = as_ = path.abpos
    ae = (ab // trace_spacing) * trace_spacing
    bb = bs = path.bbpos
    for i in range(1, tlen - 2, 2):
        ae = ae + trace_spacing
        be = bb + int(points[i])
        if ae > alen or be > blen:
            raise TraceError(TP_ERROR)
        af, bf = middle_np(aseq[ab:ae], bseq[bb:be], ab, bb, mode, dmax)
        diffs += iter_np(aseq[as_:af], bseq[bs:bf], as_, bs, mode, dmax, out)
        ab, bb = ae, be
        as_, bs = af, bf

    ae, be = path.aepos, path.bepos
    if ae > alen or be > blen:
        raise TraceError(TP_ERROR)
    af, bf = middle_np(aseq[ab:ae], bseq[bb:be], ab, bb, mode, dmax)
    diffs += iter_np(aseq[as_:af], bseq[bs:bf], as_, bs, mode, dmax, out)
    diffs += iter_np(aseq[af:ae], bseq[bf:be], af, bf, mode, dmax, out)

    path.trace = out
    path.diffs = diffs
    return path


def compute_trace_irr(path: PathRec, aseq, bseq, mode: int = GREEDIEST
                      ) -> PathRec:
    """Trace with irregular spacing: the stored pairs are (a-advance,
    b-advance) per segment (Compute_Trace_IRR align.c:5397)."""
    alen, blen = len(aseq), len(bseq)
    points = path.trace
    tlen = len(points)
    mmax = nmax = 0
    for d in range(0, tlen, 2):
        mmax = max(mmax, int(points[d]))
        nmax = max(nmax, int(points[d + 1]))
    if tlen <= 1:
        mmax = path.aepos - path.abpos
        nmax = path.bepos - path.bbpos
    dmax = min(mmax, nmax)

    out: list[int] = []
    diffs = 0
    ab, bb = path.abpos, path.bbpos
    for i in range(0, tlen, 2):
        ae = ab + int(points[i])
        be = bb + int(points[i + 1])
        if ae > alen or be > blen:
            raise TraceError(TP_ERROR)
        diffs += iter_np(aseq[ab:ae], bseq[bb:be], ab, bb, mode, dmax, out)
        ab, bb = ae, be

    path.trace = out
    path.diffs = diffs
    return path


# ---------------------------------------------------------------------------
# O(nd) exact alignment (from scratch): split_nd / dandc / trace accumulation
# ---------------------------------------------------------------------------


def split_nd(A, B):
    """Bidirectional O(nd) wave; returns (D, x, y) where (x, y) is the point
    where the optimal alignment crosses the middle wave (split_nd
    align.c:3993)."""
    M, N = len(A), len(B)
    cap = max(M, N)
    VF = np.zeros(2 * cap + 3, np.int32)
    VB = np.zeros(2 * cap + 3, np.int32)
    off = cap + 1

    def snake_f(y, k):
        lim = min(N, M + 0 if False else (k + N if False else 0))
        return y

    # forward seed (diagonal 0)
    y = 0
    lim = min(M, N)
    while y < lim and B[y] == A[y]:
        y += 1
    if y >= M and N == M:
        return 0, M, M
    flow = 0
    VF[0 + off] = y
    VF[-1 + off] = -2

    # reverse seed (diagonal N-M in B coords, stored at index -x)
    x = N - M
    y = N - 1
    ylo = max(x, 0)
    while y >= ylo and B[y] == A[y - x]:
        y -= 1
    blow = bhgh = -x
    boff = off + x       # VB logical index k maps to VB[k + boff]
    VB[blow + boff] = y
    VB[blow - 1 + boff] = N + 1

    D = 1
    while True:
        # forward wave D
        flow -= 1
        am = ac = -2
        VF[flow - 1 + off] = -2
        for k in range(D, flow - 1, -1):
            ap = ac
            ac = am + 1
            am = int(VF[k - 1 + off])
            if ac < am:
                yv = am if ap < am else ap
            else:
                yv = ac if ap < ac else ap
            if blow <= k <= bhgh:
                r = int(VB[k + boff])
                if yv > r:
                    D = (D << 1) - 1
                    if ap > r:
                        yv = ap
                    elif ac > r:
                        yv = ac
                    else:
                        yv = r + 1
                    return D, k + yv, yv
            lim = min(N, M - k)
            while yv < lim and B[yv] == A[k + yv]:
                yv += 1
            VF[k + off] = yv

        # reverse wave D
        bhgh += 1
        blow -= 1
        am = ac = N + 1
        VB[blow - 1 + boff] = N + 1
        for k in range(bhgh, blow - 1, -1):
            ap = ac + 1
            ac = am
            am = int(VB[k - 1 + boff])
            if ac > am:
                yv = am if ap > am else ap
            else:
                yv = ac if ap > ac else ap
            if flow <= k <= D:
                r = int(VF[k + off])
                if yv <= r:
                    D = D << 1
                    if ap <= r:
                        yv = ap
                    elif ac <= r:
                        yv = ac
                    else:
                        yv = r
                    return D, k + yv, yv
            yv -= 1
            ylo = max(-k, 0)
            while yv >= ylo and B[yv] == A[k + yv]:
                yv -= 1
            VB[k + boff] = yv
        D += 1


def _dandc_nd(A, B, aoff, boff, out: list) -> int:
    """Divide & conquer exact-trace emission (dandc_nd align.c:4300)."""
    M, N = len(A), len(B)
    if M <= 0:
        x = -aoff - 1
        out.extend([x] * N)
        return N
    if N <= 0:
        y = boff + 1
        out.extend([y] * M)
        return M
    D, x, y = split_nd(A, B)
    if D > 1:
        _dandc_nd(A[:x], B[:y], aoff, boff, out)
        _dandc_nd(A[x:], B[y:], aoff + x, boff + y, out)
    elif D == 1:
        if M > N:
            out.append(boff + y + 1)
        elif M < N:
            out.append(-aoff - x - 1)
    return D


def _add_tp(trace, tp, dd, db):
    trace[2 * tp] += dd
    trace[2 * tp + 1] += db


def _trace_nd(A, B, aoff, boff, trace, tspace) -> int:
    """Divide & conquer trace-POINT emission (trace_nd align.c:4155).
    ``trace`` is indexed by global trace-point number (aoff absolute)."""
    M, N = len(A), len(B)
    if M <= 0:
        _add_tp(trace, aoff // tspace, N, N)
        return N
    if N <= 0:
        x = aoff
        v = x // tspace
        x = (v + 1) * tspace - x
        s = M
        while s > 0:
            if x > s:
                x = s
            trace[2 * v] += x
            v += 1
            s -= x
            x = tspace
        return M
    D, x, y = split_nd(A, B)
    if D > 1:
        s = aoff
        if (s // tspace + 1) * tspace - s >= x:
            _add_tp(trace, s // tspace, (D + 1) // 2, y)
        else:
            _trace_nd(A[:x], B[:y], aoff, boff, trace, tspace)
        s = aoff + x
        if (s // tspace + 1) * tspace - s >= M - x:
            _add_tp(trace, s // tspace, D // 2, N - y)
        else:
            _trace_nd(A[x:], B[y:], aoff + x, boff + y, trace, tspace)
    else:
        s = x if (D == 0 or M < N) else x - 1
        if s > 0:
            u = aoff
            v = u // tspace
            u = (v + 1) * tspace - u
            while s > 0:
                if u > s:
                    u = s
                trace[2 * v + 1] += u
                v += 1
                s -= u
                u = tspace
        if D == 0:
            return D
        if M < N:
            yv = (aoff + x) // tspace
        else:
            yv = (aoff + x - 1) // tspace
        trace[2 * yv] += 1
        if M <= N:
            trace[2 * yv + 1] += 1
        s = M - x
        if s > 0:
            u = aoff + x
            v = u // tspace
            u = (v + 1) * tspace - u
            while s > 0:
                if u > s:
                    u = s
                trace[2 * v + 1] += u
                v += 1
                s -= u
                u = tspace
    return D


class AlignWork:
    """Carries the DIFF_ONLY midpoint between calls (Compute_Alignment's
    PLUS_* fast path, align.c:4373-4431)."""

    def __init__(self):
        self.mida = -1
        self.midb = -1


def compute_alignment(path: PathRec, aseq, bseq, task: int, tspace: int,
                      work: AlignWork | None = None) -> PathRec:
    """Optimal alignment of the substrings denoted by path
    (Compute_Alignment align.c:4373).  DIFF_ONLY sets only path.diffs;
    *_TRACE sets path.trace to (diff, b) trace-point pairs; *_ALIGN sets
    path.trace to an exact indel script."""
    if work is None:
        work = AlignWork()
    asub = path.aepos - path.abpos
    bsub = path.bepos - path.bbpos
    A = aseq[path.abpos:path.aepos]
    B = bseq[path.bbpos:path.bepos]

    if task == DIFF_ONLY:
        if asub <= 0:
            path.diffs = bsub
            work.mida = -1
        elif bsub <= 0:
            path.diffs = asub
            work.mida = -1
        else:
            D, x, y = split_nd(A, B)
            path.diffs = D
            work.mida, work.midb = x, y
        path.trace = []
        return path

    ntp = ((path.aepos + tspace - 1) // tspace - path.abpos // tspace) + 1

    if task < DIFF_ONLY and work.mida >= 0:
        x, y = work.mida, work.midb
        if task == PLUS_ALIGN:
            out: list[int] = []
            _dandc_nd(A[:x], B[:y], path.abpos, path.bbpos, out)
            _dandc_nd(A[x:], B[y:], path.abpos + x, path.bbpos + y, out)
            path.trace = out
        else:
            tr = np.zeros(2 * ntp, np.int64)
            base = path.abpos // tspace
            shifted = _ShiftedTrace(tr, base)
            _trace_nd(A[:x], B[:y], path.abpos, path.bbpos, shifted, tspace)
            _trace_nd(A[x:], B[y:], path.abpos + x, path.bbpos + y,
                      shifted, tspace)
            _fold_last(tr)
            path.trace = [int(v) for v in tr[:2 * ntp - 2]]
    else:
        if task == DIFF_ALIGN:
            out = []
            path.diffs = _dandc_nd(A, B, path.abpos, path.bbpos, out)
            path.trace = out
        else:
            tr = np.zeros(2 * ntp, np.int64)
            base = path.abpos // tspace
            shifted = _ShiftedTrace(tr, base)
            path.diffs = _trace_nd(A, B, path.abpos, path.bbpos, shifted,
                                   tspace)
            _fold_last(tr)
            path.trace = [int(v) for v in tr[:2 * ntp - 2]]
    return path


class _ShiftedTrace:
    """Index adapter: global trace-point slot -> local array slot
    (wave.Trace = strace - 2*(abpos/tspace), align.c:4438)."""

    def __init__(self, arr, base_tp):
        self.arr = arr
        self.base = 2 * base_tp

    def __getitem__(self, i):
        return self.arr[i - self.base]

    def __setitem__(self, i, v):
        self.arr[i - self.base] = v


def _fold_last(tr):
    """Fold boundary inserts of the sentinel last element into the final
    segment (align.c:4447-4450)."""
    n = len(tr)
    if tr[n - 1] != 0:
        tr[n - 3] += tr[n - 1]
        tr[n - 4] += tr[n - 2]

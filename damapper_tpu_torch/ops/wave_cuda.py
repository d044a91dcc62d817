"""Batched wave lanes: the O(nd) trace-point wave for many seeds at once.

``wave_lanes`` runs one direction (forward or reverse) of Local_Alignment's
adaptive wave (reference align.c:353-1946) for N independent lanes, from the
wave-0 prologue (seed snake, first pebbles, first boundary clip) to the end
of the lane, and returns the per-lane trim/REACH points and pebble pool that
the host trace extraction (ops.wave) consumes.

Two implementations with one contract:

  * ``csrc/wave.cu`` — the hand-written CUDA kernels for sm_90a, for three
    layouts of the lane state (see the note at the top of that file), built
    with nvcc at first use into ``build/torch_kernels/`` and bound through
    ctypes:
      layout "plain"    — one thread block per lane, one int32 array per
                          field (TPU kernel: wave_pallas.py:1524);
      layout "packed"   — the same, with one (N, 8) int32 input record and
                          one (N, 16) output record per lane
                          (wave_pallas.py:1457);
      layout "lanepack" — the plain kernel at W=64, one 64-thread block
                          per lane (wave_pallas.py:1413, where two W=64
                          lanes share a 128-row tile);
  * ``wave_lanes_ref`` — the plain PyTorch version of all three: a Python
    loop over waves over a (N, W) lane batch with masks for finished lanes,
    a snake step that gathers SS columns per slot, and floor division/modulo
    throughout.  It repeats the kernel's arithmetic and is no yardstick of
    speed.

``wave_lanes`` takes the plain version only for tensors on the CPU; for CUDA
tensors it launches the layout's kernel or raises.

The result equals the JAX package's classic segment driver field for field,
pool cells included, on every lane that neither flags as overflowed.  A lane
overflows when its band outgrows W (hgh - low + 4 >= W at a wave start),
when its pool gets within W rows of P, or when it runs past ``max_waves``
waves; its results are then undefined and the engine re-aligns it on the
host oracle.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

import torch

from .spec import PATH_LEN, TRIM_LEN, TRIM_MLAG, WAVE_LAG

INT32_MAX = 0x7FFFFFFF
NEG_BIG = -(1 << 30)
MASK61 = (1 << 61) - 1
TRIM_RB = 10        # rel bits in the lazy-trim ordering key (W <= 512)
DRANK = 2           # pebble drops ranked per trip (pool order contract)
SS = 16             # snake columns gathered per step (plain version)
MAX_WAVES = 1 << 20  # a lane still live after this many waves overflows

OUT_FIELDS = ("trima", "trimy", "trimd", "trimha", "trimhb",
              "morem", "morea", "morey", "mored", "moreha", "morehb",
              "avail", "overflow", "waves")
IN_FIELDS = ("abase", "bbase", "mida", "k0", "aoffp", "boffp")
LAYOUTS = ("plain", "packed", "lanepack")
KERNEL_NAMES = {"plain": "wave_lanes", "packed": "wave_lanes_packed",
                "lanepack": "wave_lanes_lanepack"}
NREC_IN = 8             # the packed input record: IN_FIELDS, awst, bwst
NREC_OUT = 16           # the packed output record: OUT_FIELDS, 2 pad words

CSRC_DIR = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_CSRC = CSRC_DIR / "wave.cu"
BUILD_DIR = (pathlib.Path(__file__).resolve().parent.parent.parent
             / "build" / "torch_kernels")


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------


def _fdiv(a, b):
    return torch.div(a, b, rounding_mode="floor")


def _wrap32(x):
    """int64 -> the int32 two's-complement value (the kernel's int)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _popcount16(x):
    """Population count of values < 2**16 (int64 tensor)."""
    x = x - ((x >> 1) & 0x5555)
    x = (x & 0x3333) + ((x >> 2) & 0x3333)
    x = (x + (x >> 4)) & 0x0F0F
    return (x + (x >> 8)) & 0x1F


def _shift_in_matches(T, n):
    """Shift n (<= SS) match bits into the 61-bit history T; returns
    (T', number of match bits shifted out at the top)."""
    ext = T >> (61 - n)
    pops = _popcount16(ext)
    keep = (torch.ones_like(T) << (61 - n)) - 1
    Tn = ((T & keep) << n) | ((torch.ones_like(T) << n) - 1)
    return Tn, pops


def _trim_tables(x, msc, dsc):
    """Suffix-positivity of a TRIM_LEN-column window (bit TRIM_LEN-1 oldest):
    returns (total - max prefix, total), as align.c's score tables."""
    cum = torch.zeros_like(x)
    maxp = torch.zeros_like(x)
    for ii in range(TRIM_LEN - 1, -1, -1):
        bit = (x >> ii) & 1
        cum = cum + torch.where(bit == 1, msc, -dsc)
        maxp = torch.maximum(maxp, cum)
    return cum - maxp, cum


def memory_reader(mem):
    """The classic sequence access: ``read(idx) -> (bytes, None)``, the
    sentinel 4 outside the memory.  Reads outside the sequence memory see
    the sentinel: the same bytes as the JAX driver's clamped gathers, since
    the memory starts and ends with a sentinel."""
    LM = int(mem.shape[0])

    def read(idx):
        return torch.where((idx >= 0) & (idx < LM),
                           mem[idx.clamp(0, LM - 1)], 4), None

    return read


def wave_lanes_ref(abase, bbase, mida, k0, aoffp, boffp, A, B, ts, pave,
                   msc, dsc, *, W, P, reverse, max_waves=MAX_WAVES,
                   seq=None):
    """Plain PyTorch version of ``wave_lanes`` (same signature and
    result).

    seq: the sequence access, a pair of readers (A side, B side); each maps
    an int64 index tensor whose first dimension is the lane to (bytes,
    miss), where miss is None or a bool tensor that marks indices outside
    the lane's window (read as 4).  None: ``memory_reader`` of A and B.  A
    lane that needs a missed byte (the snake stops on it, or the REACH rest
    test reads it) is flagged as overflowed and stops at the end of that
    wave, as the window kernels do (csrc/wave_body.cuh)."""
    dev = A.device
    i64 = torch.int64
    N = int(abase.shape[0])
    TS, pave, msc, dsc = int(ts), int(pave), int(msc), int(dsc)
    Wm = W - 1
    sgn = -1 if reverse else 1
    soff = -1 if reverse else 0
    fill = INT32_MAX if reverse else NEG_BIG
    ab, bb, mida, k0, aoffp, boffp = (
        t.to(dev, i64) for t in (abase, bbase, mida, k0, aoffp, boffp))
    ar = torch.arange(N, device=dev)
    slots = torch.arange(W, device=dev, dtype=i64)[None, :]

    windowed = seq is not None
    achar, bchar = seq if windowed else (memory_reader(A), memory_reader(B))

    def needed(bv, bm, am):
        # a missed byte is needed where the read stops on it: the B byte,
        # and the A byte when the B byte is a base
        return bm | ((bv != 4) & am)

    # ---------------- wave 0: prologue ----------------
    y0 = (mida - k0) >> 1
    if not reverse:
        na0 = (_fdiv(y0 + k0 + (TS - aoffp), TS) - 1) * TS + aoffp
        nb0 = (_fdiv(y0 + (TS - boffp), TS) - 1) * TS + boffp
        amark0, bmark0 = na0, nb0
        na0, nb0 = na0 + TS, nb0 + TS
    else:
        na0 = (_fdiv(y0 + k0 + (TS - aoffp) - 1, TS) - 1) * TS + aoffp
        nb0 = (_fdiv(y0 + (TS - boffp) - 1, TS) - 1) * TS + boffp
        amark0, bmark0 = y0 + k0, y0

    pool = torch.zeros((N, P, 4), dtype=torch.int32, device=dev)
    zero = torch.zeros_like(k0)
    pool[:, 0] = torch.stack([zero - 1, k0, zero, amark0], 1).to(torch.int32)
    pool[:, 1] = torch.stack([zero - 1, k0, zero, bmark0], 1).to(torch.int32)

    stepv = torch.arange(SS, device=dev, dtype=i64)[None, :] * sgn
    y = y0.clone()
    stop = torch.zeros(N, dtype=torch.bool, device=dev)
    ca = torch.zeros_like(stop)
    cb = torch.zeros_like(stop)
    pmiss = torch.zeros_like(stop)
    while not bool(stop.all()):
        run = ~stop
        bw, bm = bchar((bb + y + soff)[:, None] + stepv)
        aw, am = achar((ab + y + k0 + soff)[:, None] + stepv)
        sbv = bw == 4
        misv = bw != aw
        advv = ~sbv & ~misv
        pref = torch.cumprod(advv.to(i64), dim=1)
        nst = pref.sum(1)
        prefx = torch.cat([torch.ones_like(pref[:, :1]), pref[:, :-1]], 1)
        fs = (prefx == 1) & ~advv
        if windowed:
            pmiss |= run & (fs & needed(bw, bm, am)).any(1)
        sb = (fs & sbv).any(1)
        sa = (fs & ~sbv & misv & (aw == 4)).any(1)
        y = torch.where(run, y + sgn * nst, y)
        ca |= run & sa
        cb |= run & sb
        stop |= run & (nst < SS)
    y0f = y
    c0 = (y0f << 1) + k0
    more = ~(ca | cb)
    aclip = torch.where(ca, k0, torch.full_like(k0, -INT32_MAX if reverse
                                               else INT32_MAX))
    bclip = torch.where(cb, k0, torch.full_like(k0, INT32_MAX if reverse
                                               else -INT32_MAX))

    def drops0(x, n, h, av, mk):
        while True:
            act = (x <= n) if reverse else (x >= n)
            if not bool(act.any()):
                return n, h, av, mk
            w = act & (av < P)
            rows = torch.stack([h, k0, zero, n], 1).to(torch.int32)
            pool[ar[w], av[w]] = rows[w]
            mk = torch.where(act, n, mk)
            h = torch.where(w, av, h)
            n = torch.where(act, n - TS if reverse else n + TS, n)
            av = torch.where(act, av + 1, av)

    na0, ha0, avail, amk0 = drops0(y0f + k0, na0, zero.clone(), zero + 2,
                                   amark0)
    nb0, hb0, avail, bmk0 = drops0(y0f, nb0, zero + 1, avail, bmark0)

    better0 = (c0 < mida) if reverse else (c0 > mida)
    besta = torch.where(better0, c0, mida)
    besty = torch.where(better0, y0f, y0)
    lasta = besta.clone()
    trima, trimy = besta.clone(), besty.clone()
    trimd = zero.clone()
    trimha = torch.where(better0, ha0, zero)
    trimhb = torch.where(better0, hb0, zero + 1)

    s0 = (k0 & Wm)[:, None]
    at0 = slots == s0

    def band0(v, other):
        return torch.where(at0, v[:, None], torch.full((N, W), other,
                                                       dtype=i64, device=dev))

    V = band0(c0, fill)
    T = torch.full((N, W), (1 << 60) - 1, dtype=i64, device=dev)
    M = torch.full((N, W), PATH_LEN, dtype=i64, device=dev)
    NA, NB = band0(na0, 0), band0(nb0, 0)
    HA, HB = band0(ha0, 0), band0(hb0, 0)
    MA, MB = band0(amk0, 0), band0(bmk0, 0)
    ltk = torch.zeros((N, W), dtype=i64, device=dev)
    ltc, lty, ltha, lthb = (torch.zeros_like(ltk) for _ in range(4))

    low, hgh = k0.clone(), k0.clone()
    morem = zero - 1
    morea, morey, mored, moreha, morehb = (zero.clone() for _ in range(5))

    def band_at(arr, kc):
        return arr.gather(1, (kc & Wm)[:, None])[:, 0]

    clipped = ~more
    rb, rbm = bchar(bb + besty + soff)
    ra, ram = achar(ab + besta - besty + soff)
    rest = (rb != 4) & (ra != 4)
    if windowed:
        pmiss |= clipped & needed(rb, rbm, ram)
    if not reverse:
        hit_a = clipped & (hgh >= aclip)
        hit_b = clipped & (low <= bclip)
    else:
        hit_a = clipped & (low <= aclip)
        hit_b = clipped & (hgh >= bclip)
    for kc, hit in ((aclip, hit_a), (bclip, hit_b)):
        Mv, Vv = band_at(M, kc), band_at(V, kc)
        upd = hit & (morem <= Mv)
        morem = torch.where(upd, Mv, morem)
        morea = torch.where(upd, Vv, morea)
        morey = torch.where(upd, _fdiv(Vv - kc, 2), morey)
        moreha = torch.where(upd, band_at(HA, kc), moreha)
        morehb = torch.where(upd, band_at(HB, kc), morehb)
    if not reverse:
        hgh = torch.where(hit_a, aclip - 1, hgh)
        low = torch.where(hit_b, bclip + 1, low)
    else:
        low = torch.where(hit_a, aclip + 1, low)
        hgh = torch.where(hit_b, bclip - 1, hgh)
    more = torch.where(clipped, rest, more)
    overflow = pmiss
    live = more & ~overflow
    dif = zero.clone()

    # ---------------- waves 1, 2, ... ----------------
    while bool(live.any()):
        L = live
        Lb = L[:, None]
        low = torch.where(L, low - 1, low)
        hgh = torch.where(L, hgh + 1, hgh)
        dif = torch.where(L, dif + 1, dif)
        overflow |= L & ((hgh - low + 4 >= W) | (avail + W >= P))
        lo_, hi_ = low[:, None], hgh[:, None]
        k = lo_ + torch.remainder(slots - lo_, W)
        in_band = k <= hi_

        # wave start: border init + pick3 inheritance from ring neighbours
        is_sl = slots == (lo_ & Wm)
        is_sh = slots == (hi_ & Wm)
        V = torch.where(Lb & (is_sl | is_sh), fill, V)
        NA = torch.where(Lb & is_sl, NA.roll(-1, 1),
                         torch.where(Lb & is_sh, NA.roll(1, 1), NA))
        NB = torch.where(Lb & is_sl, NB.roll(-1, 1),
                         torch.where(Lb & is_sh, NB.roll(1, 1), NB))
        Vm = torch.where(in_band, V, fill)
        ap, am, ac = Vm.roll(-1, 1), Vm.roll(1, 1), Vm
        if not reverse:
            lt = ac < am
            pickP = (lt & (am < ap)) | (~lt & (ac < ap))
            pickM = lt & ~pickP
            c0w = torch.where(pickP, ap + 1, torch.where(pickM, am + 1,
                                                         ac + 2))
        else:
            gt = ac > ap
            pickM = (gt & (ap > am)) | (~gt & (ac > am))
            pickP = gt & ~pickM
            c0w = torch.where(pickM, am - 1, torch.where(pickP, ap - 1,
                                                         ac - 2))

        def pick3(arr):
            return torch.where(pickP, arr.roll(-1, 1),
                               torch.where(pickM, arr.roll(1, 1), arr))

        sm = pick3(M)
        sT = pick3(T)
        wha, whb, wma, wmb = pick3(HA), pick3(HB), pick3(MA), pick3(MB)
        sm = sm - ((sT >> 60) & 1)
        sT = (sT << 1) & MASK61
        sy = _wrap32(c0w - k) >> 1
        sact = in_band & Lb
        sca = torch.zeros_like(sact)
        scb = torch.zeros_like(sact)
        smiss = torch.zeros_like(sact)

        # snake: every active slot walks its diagonal to the first mismatch
        # or sentinel, SS columns per step
        stepw = stepv[:, :, None].transpose(1, 2)     # (1, 1, SS)
        while bool(sact.any()):
            bw, bm = bchar((bb[:, None] + sy + soff)[:, :, None] + stepw)
            aw, am = achar((ab[:, None] + sy + k + soff)[:, :, None] + stepw)
            sbv = bw == 4
            stopv = sbv | (bw != aw)
            found = stopv.any(2)
            jstar = torch.where(found, stopv.to(torch.int8).argmax(2),
                                torch.full_like(sy, SS))
            nst = torch.where(sact, jstar, torch.zeros_like(jstar))
            done = sact & found
            jc = jstar.clamp(max=SS - 1)[:, :, None]
            sb = done & sbv.gather(2, jc)[:, :, 0]
            sa = done & ~sb & (aw.gather(2, jc)[:, :, 0] == 4)
            if windowed:
                smiss |= done & needed(bw, bm, am).gather(2, jc)[:, :, 0]
            nT, pops = _shift_in_matches(sT, nst)
            sm = torch.where(sact, sm + nst - pops, sm)
            sT = torch.where(sact, nT, sT)
            sy = torch.where(sact, sy + sgn * nst, sy)
            sca |= sa
            scb |= sb
            sact &= ~done

        # wave end: pebble drops in trips of DRANK ranks, [A | B] slot order
        c = _wrap32((sy << 1) + k)
        clipA = sca & in_band
        clipB = scb & in_band
        clip_any = (clipA | clipB).any(1)
        more_new = torch.where(L & clip_any, False, more)
        if windowed:
            overflow |= L & smiss.any(1)
        X2 = torch.cat([sy + k, sy], 1)
        N2 = torch.cat([NA, NB], 1)
        H2 = torch.cat([wha, whb], 1)
        MK2 = torch.cat([wma, wmb], 1)
        k2w = torch.cat([k, k], 1)
        inb2w = torch.cat([in_band, in_band], 1) & Lb
        while True:
            dact = inb2w & ((X2 <= N2) if reverse else (X2 >= N2))
            if not bool(dact.any()):
                break
            need = dact & ((MK2 > N2) if reverse else (MK2 < N2))
            cs = torch.cumsum(need.to(i64), 1)
            ridx = cs - 1
            cnt = cs[:, -1]
            processed = need & (ridx < DRANK)
            pidx = avail[:, None] + ridx
            wr = processed & (pidx < P)
            li, si = wr.nonzero(as_tuple=True)
            rows = torch.stack([H2, k2w, dif[:, None].expand_as(H2), N2],
                               2).to(torch.int32)
            pool[li, pidx[li, si]] = rows[li, si]
            H2 = torch.where(processed, pidx, H2)
            MK2 = torch.where(processed, N2, MK2)
            adv = dact & (~need | processed)
            N2 = torch.where(adv, N2 - TS if reverse else N2 + TS, N2)
            avail = avail + cnt.clamp(max=DRANK)
            overflow |= L & (avail + W >= P)
        NA, NB = N2[:, :W], N2[:, W:]
        wha, whb = H2[:, :W], H2[:, W:]
        wma, wmb = MK2[:, :W], MK2[:, W:]

        # best / trim triggers: the reference updates from the high diagonal
        # down (reverse: low up); in rel order that is an exclusive suffix
        # max (reverse: prefix min)
        rel = torch.remainder(slots - lo_, W)
        ring = (lo_ + slots) & Wm                      # slot of rel r
        if not reverse:
            cm = torch.where(in_band, c, NEG_BIG)
            crel = cm.gather(1, ring)
            sufr = crel.flip(1).cummax(1).values.flip(1)
            excl = torch.cat([sufr[:, 1:], torch.full_like(sufr[:, :1],
                                                          NEG_BIG)], 1)
            runbase = torch.maximum(besta[:, None], excl.gather(1, rel))
            trigger = in_band & (c > runbase)
        else:
            cm = torch.where(in_band, c, INT32_MAX)
            crel = cm.gather(1, ring)
            prer = crel.cummin(1).values
            excl = torch.cat([torch.full_like(prer[:, :1], INT32_MAX),
                              prer[:, :-1]], 1)
            runbase = torch.minimum(besta[:, None], excl.gather(1, rel))
            trigger = in_band & (c < runbase)
        t1, s1 = _trim_tables(sT & 0x7FFF, msc, dsc)
        t2, _ = _trim_tables((sT >> 15) & 0x7FFF, msc, dsc)
        tbl_ok = (t1 >= 0) & (t2 + s1 >= 0)
        m_ok = sm >= pave
        if not reverse:
            bandc = cm.max(1).values
            any0 = bandc > besta
            new_besta = torch.maximum(besta, bandc)
            lastc = torch.where(trigger & m_ok, c, NEG_BIG).max(1).values
            any1 = lastc != NEG_BIG
        else:
            bandc = cm.min(1).values
            any0 = bandc < besta
            new_besta = torch.minimum(besta, bandc)
            lastc = torch.where(trigger & m_ok, c, INT32_MAX).min(1).values
            any1 = lastc != INT32_MAX
        selb = trigger & (c == bandc[:, None])
        kstar = torch.where(selb, k, 0).sum(1)
        besty = torch.where(L & any0, (bandc - kstar) >> 1, besty)
        besta = torch.where(L, new_besta, besta)
        lasta = torch.where(L & any1, lastc, lasta)
        upd_s = trigger & m_ok & tbl_ok & Lb
        relenc = rel if reverse else Wm - rel
        ltk = torch.where(upd_s, (dif[:, None] << TRIM_RB) | relenc, ltk)
        ltc = torch.where(upd_s, c, ltc)
        lty = torch.where(upd_s, sy, lty)
        ltha = torch.where(upd_s, wha, ltha)
        lthb = torch.where(upd_s, whb, lthb)

        # store the band
        st = in_band & Lb
        V = torch.where(st, c, V)
        T = torch.where(st, sT, T)
        M = torch.where(st, sm, M)
        HA, HB = torch.where(st, wha, HA), torch.where(st, whb, HB)
        MA, MB = torch.where(st, wma, MA), torch.where(st, wmb, MB)

        # boundary clip + REACH grab
        clipped = L & clip_any & more
        if not reverse:
            aclip = torch.where(clipA, k, INT32_MAX).min(1).values
            bclip = torch.where(clipB, k, -INT32_MAX).max(1).values
            hit_a = clipped & (hgh >= aclip)
            hit_b = clipped & (low <= bclip)
        else:
            aclip = torch.where(clipA, k, -INT32_MAX).max(1).values
            bclip = torch.where(clipB, k, INT32_MAX).min(1).values
            hit_a = clipped & (low <= aclip)
            hit_b = clipped & (hgh >= bclip)
        for kc, hit in ((aclip, hit_a), (bclip, hit_b)):
            sel = k == kc[:, None]
            Mv = torch.where(sel, M, 0).sum(1)
            Vv = torch.where(sel, V, 0).sum(1)
            upd = hit & (morem <= Mv)
            morem = torch.where(upd, Mv, morem)
            morea = torch.where(upd, Vv, morea)
            morey = torch.where(upd, _fdiv(Vv - kc, 2), morey)
            mored = torch.where(upd, dif, mored)
            moreha = torch.where(upd, torch.where(sel, HA, 0).sum(1), moreha)
            morehb = torch.where(upd, torch.where(sel, HB, 0).sum(1), morehb)
        if not reverse:
            hgh = torch.where(hit_a, aclip - 1, hgh)
            low = torch.where(hit_b, bclip + 1, low)
        else:
            low = torch.where(hit_a, aclip + 1, low)
            hgh = torch.where(hit_b, bclip - 1, hgh)

        # band prune on the post-clip band
        lo_, hi_ = low[:, None], hgh[:, None]
        rel2 = torch.remainder(slots - lo_, W)
        inb2 = lo_ + rel2 <= hi_
        if not reverse:
            ok = inb2 & (V >= besta[:, None] - WAVE_LAG)
        else:
            ok = inb2 & (V <= besta[:, None] + WAVE_LAG)
        okpos = torch.where(ok, rel2, -1)
        hi_rel = okpos.max(1).values
        lo_rel = torch.where(okpos >= 0, okpos, W).min(1).values
        have = L & (hi_rel >= 0)
        hgh2 = torch.where(have, low + hi_rel, hgh)
        low = torch.where(have, low + torch.minimum(lo_rel, hi_rel), low)
        hgh = hgh2

        # next wave?  A clipped lane first resolves its REACH rest test
        if reverse:
            go = lasta <= besta + TRIM_MLAG
        else:
            go = lasta >= besta - TRIM_MLAG
        more = more_new
        live = L & more & go & ~overflow
        rb, rbm = bchar(bb + besty + soff)
        ra, ram = achar(ab + besta - besty + soff)
        rest = (rb != 4) & (ra != 4)
        if windowed:
            overflow |= clipped & needed(rb, rbm, ram)
        more = torch.where(clipped, rest, more)
        live = torch.where(clipped, rest & go & ~overflow, live)
        capped = live & (dif >= max_waves)
        overflow |= capped
        live &= ~capped

    kmax, sl = ltk.max(1)
    have = kmax > 0

    def pick(arr, dflt):
        return torch.where(have, arr.gather(1, sl[:, None])[:, 0], dflt)

    out = dict(trima=pick(ltc, trima), trimy=pick(lty, trimy),
               trimd=torch.where(have, kmax >> TRIM_RB, trimd),
               trimha=pick(ltha, trimha), trimhb=pick(lthb, trimhb),
               morem=morem, morea=morea, morey=morey, mored=mored,
               moreha=moreha, morehb=morehb, avail=avail,
               overflow=overflow, waves=dif)
    out = {nm: v.to(torch.int32) for nm, v in out.items()}
    out["overflow"] = overflow
    out["pool"] = pool
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel: build, bind, launch
# ---------------------------------------------------------------------------

_lib = None
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]


def nvcc_build(src: pathlib.Path, name: str, verbose: bool = False,
               flags=()) -> pathlib.Path:
    """Compile one csrc/ source with nvcc (and the extra ``flags``) into
    build/torch_kernels/<name>, skipped when the library is newer than src
    and the wave body it includes.  verbose=True adds ``-Xptxas -v`` and
    prints its report."""
    so = BUILD_DIR / name
    if verbose:
        so, report = ptxas_build(src, name, flags)
        print(report.strip())
        return so
    if so.exists() and so.stat().st_mtime > max(
            f.stat().st_mtime for f in (src, CSRC_DIR / "wave_body.cuh")):
        return so
    return _nvcc(src, so, flags)[0]


def ptxas_build(src: pathlib.Path, name: str, flags=()):
    """nvcc_build under ``-Xptxas -v``, always compiling; returns (the
    library's path, ptxas's report)."""
    return _nvcc(src, BUILD_DIR / name, [*flags, "-Xptxas", "-v"])


def _nvcc(src, so, flags):
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = os.environ.get("NVCC") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc")
    tmp = so.with_suffix(".so.tmp%d" % os.getpid())
    cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed ({r.returncode}):\n{r.stderr}")
    os.replace(tmp, so)
    return so, r.stderr


def build(verbose: bool = False) -> pathlib.Path:
    """Build csrc/wave.cu into build/torch_kernels/libwave.so."""
    return nvcc_build(_CSRC, "libwave.so", verbose)


def bind(lib):
    """Sets the C signatures of a build of csrc/wave.cu; returns lib."""
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    seqargs = [P, LL, P, LL]
    tail = [P, P, P]                  # out, pool, stream
    lib.wave_lanes_launch.argtypes = [P] * 6 + seqargs + [I] * 9 + tail
    lib.wave_lanes_packed_launch.argtypes = [P] + seqargs + [I] * 9 + tail
    for fn in (lib.wave_lanes_launch, lib.wave_lanes_packed_launch):
        fn.restype = ctypes.c_int
    lib.wave_error_string.restype = ctypes.c_char_p
    lib.wave_error_string.argtypes = [I]
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def check_seq(fn, A, B):
    """A and B: contiguous 1-D uint8 tensors on one device; returns it."""
    dev = A.device
    for nm, t in (("A", A), ("B", B)):
        if t.dtype != torch.uint8 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{fn}: {nm} must be a contiguous 1-D uint8 "
                             f"tensor")
        if t.device != dev:
            raise ValueError(f"{fn}: {nm} is on {t.device}, not {dev}")
    return dev


def check_lanes(fn, names, ins, record, dev):
    """The lane inputs: contiguous int32 [n] tensors on dev, or (packed
    layout) one contiguous int32 [n, NREC_IN] record.  Returns n."""
    if record is not None:
        n = int(record.shape[0])
        if record.dtype != torch.int32 or tuple(record.shape) != \
                (n, NREC_IN) or not record.is_contiguous() \
                or record.device != dev:
            raise ValueError(f"{fn}: record must be a contiguous int32 "
                             f"[n, {NREC_IN}] tensor on {dev}")
        return n
    n = int(ins[0].shape[0])
    for nm, t in zip(names, ins):
        if t.dtype != torch.int32 or t.shape != (n,) \
                or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"{fn}: {nm} must be a contiguous int32 [{n}] "
                             f"tensor on {dev}")
    return n


def pack_record(ins):
    """The packed layout's (n, NREC_IN) input record from the lane inputs
    (six fields, or eight with the window starts; the rest is 0)."""
    rec = torch.zeros((int(ins[0].shape[0]), NREC_IN), dtype=torch.int32,
                      device=ins[0].device)
    for i, t in enumerate(ins):
        rec[:, i] = t
    return rec


def out_buffers(n, layout, dev):
    """The output buffer of one launch and the result fields as its views:
    (n, NREC_OUT) records for the packed layout (also returned whole as
    ``record``), else (len(OUT_FIELDS), n) rows."""
    if layout == "packed":
        out = torch.empty((n, NREC_OUT), dtype=torch.int32, device=dev)
        res = {nm: out[:, i] for i, nm in enumerate(OUT_FIELDS)}
        res["record"] = out
    else:
        out = torch.empty((len(OUT_FIELDS), n), dtype=torch.int32,
                          device=dev)
        res = {nm: out[i] for i, nm in enumerate(OUT_FIELDS)}
    return out, res


def count_launch(fn, layout):
    attr = "launches_" + layout
    setattr(fn, attr, getattr(fn, attr) + 1)


def _launch(ins, A, B, ts, pave, msc, dsc, W, P, reverse, max_waves, layout,
            record):
    fn = "wave_lanes"
    if not torch.cuda.is_available():
        raise RuntimeError("wave_lanes: CUDA tensors given but no CUDA "
                           "device is available")
    if W not in (64, 128) or (layout == "lanepack" and W != 64):
        raise ValueError(f"wave_lanes: W={W} is not served by layout "
                         f"{layout!r} (64 or 128; lanepack 64)")
    if P < W + 2:
        raise ValueError(f"wave_lanes: P={P} must exceed W+2")
    dev = check_seq(fn, A, B)
    n = check_lanes(fn, IN_FIELDS, ins, record, dev)
    if layout == "packed" and record is None:
        record = pack_record(ins)
    out, res = out_buffers(n, layout, dev)
    pool = torch.zeros((n, P, 4), dtype=torch.int32, device=dev)
    if n:
        lib = _load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        seqargs = (A.data_ptr(), A.shape[0], B.data_ptr(), B.shape[0])
        scal = (int(reverse), int(ts), int(pave), int(msc), int(dsc),
                int(max_waves))
        tail = (out.data_ptr(), pool.data_ptr(), stream)
        if layout == "packed":
            rc = lib.wave_lanes_packed_launch(record.data_ptr(), *seqargs, n,
                                              W, P, *scal, *tail)
        else:   # plain, and lanepack: the plain kernel at W=64
            rc = lib.wave_lanes_launch(*[t.data_ptr() for t in ins],
                                       *seqargs, n, W, P, *scal, *tail)
        if rc != 0:
            raise RuntimeError(f"wave_lanes: {layout} kernel launch failed: "
                               + lib.wave_error_string(rc).decode())
        count_launch(wave_lanes, layout)
    res["overflow"] = res["overflow"] != 0
    res["pool"] = pool
    return res


def lane_device_kinds(fn, tensors):
    """'cpu' or 'cuda': the one device type of all the tensors given."""
    kinds = {t.device.type for t in tensors}
    if kinds in ({"cpu"}, {"cuda"}):
        return kinds.pop()
    raise ValueError(f"{fn}: tensors on {sorted(kinds)}; they must all lie "
                     f"on the CPU or all on one CUDA device")


def wave_lanes(abase, bbase, mida, k0, aoffp, boffp, A, B, ts, pave, msc,
               dsc, *, W, P, reverse, layout="plain", record=None,
               max_waves=MAX_WAVES):
    """Run one wave direction for N lanes.

    abase, bbase, mida (seed antidiagonal), k0 (seed diagonal), aoffp,
    boffp: int32 [N].  A, B: uint8 sequence memory, sentinel 4 around every
    read.  ts, pave, msc, dsc: the AlignSpec's trace spacing, ave_path,
    mscore and dscore.  layout: one of LAYOUTS (the kernel; all compute the
    same result).  record: for the packed layout, the lanes' ready-made
    (N, NREC_IN) int32 input record on the card (``pack_record``), which the
    kernel then reads in place of the six lane tensors.  Returns a dict of
    int32 [N] tensors (OUT_FIELDS; ``overflow`` is bool) plus ``pool``,
    int32 [N, P, 4] pebble cells (ptr, diag, diff, mark), valid below
    ``avail``; the packed layout also returns its raw (N, NREC_OUT)
    output ``record``.

    CPU tensors run the plain PyTorch version; CUDA tensors launch the
    layout's kernel and count the launch in
    ``wave_lanes.launches_<layout>``."""
    if layout not in LAYOUTS:
        raise ValueError(f"wave_lanes: layout must be one of {LAYOUTS}, got "
                         f"{layout!r}")
    if record is not None and layout != "packed":
        raise ValueError("wave_lanes: a record is the packed layout's input")
    ins = (abase, bbase, mida, k0, aoffp, boffp)
    extra = () if record is None else (record,)
    if lane_device_kinds("wave_lanes", ins + extra + (A, B)) == "cpu":
        return wave_lanes_ref(*ins, A, B, ts, pave, msc, dsc, W=W, P=P,
                              reverse=reverse, max_waves=max_waves)
    return _launch(ins, A, B, ts, pave, msc, dsc, W, P, reverse, max_waves,
                   layout, record)


wave_lanes.launches_plain = 0
wave_lanes.launches_packed = 0
wave_lanes.launches_lanepack = 0

"""Device chain sweep: the batched equivalent of the splay-tree seed
chaining sweep (reference chain_thread map.c:1020-1922), as PyTorch ops.

The counterpart of damapper_tpu/ops/chain_jax.py.  The host sweeps
(ops.chain._sweep_group, native/chain_sweep.cpp) run one (aread, bread)
group's hits in order with an ordered active set.  The queries per hit are
order statistics over the LIVE nodes (within MAX_GAP of the sweep
position, not absorbed):

  pred  = smallest (diag, apos) key > new with bpos >= bpos - MAX_GAP,
  left  = largest-apos live node on pred's diagonal,
  succ  = largest key < new with bpos <= bpos.

Hits arrive sorted by apos, so "within MAX_GAP" is a sliding window over
the hit array: the step for hit i is a handful of masked reductions over
the group's arrays.  Groups are padded to a common capacity C (bucketed by
size) and stacked as the rows of [lanes, C] tensors; the JAX package's
lax.scan of C steps vmapped over groups is here a loop of C steps, each a
few whole-tensor ops over all lanes.  Results equal the host sweep's (the
absorb rule 5*|ddiag| <= dapos is exact for the reference's
``|ddiag| <= .2*dapos``).

The candidate dominance stack (map.c:1668-1766) stays on the host
(ops.chain.ChainState): it depends on order across reference blocks and
costs O(candidates), not O(hits).
"""

from __future__ import annotations

import numpy as np
import torch

from .chain import MAX_GAP
from .wave_engine import resolve_device

_I32MAX = 0x7FFFFFFF
_I32MIN = -0x80000000
_I32 = torch.int32
_I64 = torch.int64


def _sweep_bucket(apos, bpos, nvalid, kmer: int):
    """Chain sweep over one bucket of padded groups.

    apos/bpos: int32[L, C] 1-based hit coordinates, ascending apos per lane
               (padding after nvalid entries).
    nvalid:    int32[L] live hits per lane.
    Returns per-hit int32[L, C] tensors: cost, frm (-1 = origin), orig,
    best (per-ORIGIN best node index), absorbed, expired (flagged at expiry
    with the best check), estep (the step at which the node expires; >= C
    means never)."""
    Ln, C = apos.shape
    dev = apos.device
    idx = torch.arange(C, dtype=_I32, device=dev)[None, :]
    valid = idx < nvalid[:, None]
    big = torch.where(valid, apos, _I32MAX).contiguous()
    dg_v = apos - bpos
    # first step whose apos exceeds apos[j] + MAX_GAP (strict >, matching
    # `queue[head].apos < apos - MAX_GAP`)
    estep = torch.searchsorted(
        big, torch.where(valid, apos + MAX_GAP, _I32MAX).contiguous(),
        right=True, out_int32=True)
    estep = torch.where(valid, estep, C + 1)

    cost = torch.zeros((Ln, C), dtype=_I32, device=dev)
    frm = torch.full((Ln, C), -1, dtype=_I32, device=dev)
    orig = idx.expand(Ln, C).clone()
    best = orig.clone()
    absorbed = torch.zeros((Ln, C), dtype=torch.bool, device=dev)
    expired = torch.zeros((Ln, C), dtype=torch.bool, device=dev)

    def at(x, i):
        """x[lane, i[lane]] as an [L, 1] column."""
        return x.gather(1, i)

    def first_true(m):
        """Index of the first True per lane (0 if none), as JAX's argmax."""
        return torch.argmax(m.to(torch.uint8), 1, keepdim=True).to(_I64)

    for i in range(C):
        ap = apos[:, i:i + 1]
        bp = bpos[:, i:i + 1]
        dg = dg_v[:, i:i + 1]
        vi = valid[:, i:i + 1]

        # flag nodes expiring at this step whose chain-best they are (pad
        # steps expire nobody: the host sweep stops at the last live hit)
        expiring = (estep == i) & (idx < i) & ~absorbed & valid & vi
        isbest = best.gather(1, orig.to(_I64)) == idx
        expired |= expiring & isbest

        live = (idx < i) & (estep > i) & ~absorbed & valid
        keygt = (dg_v > dg) | ((dg_v == dg) & (apos > ap))
        keylt = (dg_v < dg) | ((dg_v == dg) & (apos < ap))

        # pred: min key among live, key > new, bpos >= bp - MAX_GAP
        cl = live & keygt & (bpos >= bp - MAX_GAP)
        dmin = torch.where(cl, dg_v, _I32MAX).amin(1, keepdim=True)
        cld = cl & (dg_v == dmin)
        amin = torch.where(cld, apos, _I32MAX).amin(1, keepdim=True)
        l = first_true(cld & (apos == amin))
        has_l = cl.any(1, keepdim=True)
        # leftmost: largest-apos live node on l's diagonal
        cll = live & (dg_v == dmin)
        amax = torch.where(cll, apos, _I32MIN).amax(1, keepdim=True)
        l = torch.where(has_l, first_true(cll & (apos == amax)), l)

        # succ: max key among live, key < new, bpos <= bp
        cr = live & keylt & (bpos <= bp)
        dmax = torch.where(cr, dg_v, _I32MIN).amax(1, keepdim=True)
        crd = cr & (dg_v == dmax)
        armax = torch.where(crd, apos, _I32MIN).amax(1, keepdim=True)
        r = first_true(crd & (apos == armax))
        has_r = cr.any(1, keepdim=True)

        adv_l = torch.clamp_max(ap - at(apos, l), kmer)
        adv_r = torch.clamp_max(bp - at(bpos, r), kmer)
        lcost = torch.where(has_l, at(cost, l) + adv_l, 0)
        rcost = torch.where(has_r, at(cost, r) + adv_r, 0)
        use_l = (lcost > rcost) & (lcost > 0)
        use_r = ~use_l & (rcost > 0)

        p = torch.where(use_l, l, r)
        ext = use_l | use_r
        ncost = torch.where(use_l, lcost, rcost)

        porig = torch.where(at(frm, p) < 0, p, at(orig, p).to(_I64))
        col = torch.full_like(p, i)
        cost.scatter_(1, col, torch.where(
            vi, torch.where(ext, ncost, kmer), 0).to(_I32))
        frm.scatter_(1, col, torch.where(
            vi, torch.where(ext, p, -1), -1).to(_I32))
        orig.scatter_(1, col, torch.where(
            vi, torch.where(ext, porig, i), i).to(_I32))

        bpo = at(best, porig)
        improved = ext & (ncost >= at(cost, bpo.to(_I64))) & vi
        best.scatter_(1, porig, torch.where(improved, i, bpo).to(_I32))
        dd = (at(dg_v, p) - dg).abs()
        da = ap - at(apos, p)
        absorb = improved & (5 * dd <= da)
        absorbed.scatter_(1, p, absorb | at(absorbed, p))
    return (cost, frm, orig, best, absorbed.to(_I32), expired.to(_I32),
            estep)


_MAXC = 2048      # groups above this route to the host sweep


def sweep_hits_device(apos1: np.ndarray, bpos1: np.ndarray,
                      starts: np.ndarray, ends: np.ndarray, kmer: int,
                      device=None):
    """The chain sweep on ``device`` (None: the card) for every group of
    size <= _MAXC.

    apos1/bpos1: 1-based hit coordinates (global arrays over all groups).
    Returns {group index: (cost, frm, orig, best, absorbed, expired,
    estep)}, each np.int32[G], for the groups swept here; larger groups are
    absent (the caller sweeps them on the host)."""
    dev = resolve_device(device)
    sizes = ends - starts
    out: dict[int, tuple] = {}
    buckets: dict[int, list[int]] = {}
    for gi, sz in enumerate(sizes):
        if sz > _MAXC:
            continue
        cap = max(8, 1 << int(sz - 1).bit_length())
        buckets.setdefault(cap, []).append(gi)

    for cap, gis in buckets.items():
        # lanes padded to a power of two (padded lanes are empty groups)
        L = max(8, 1 << int(len(gis) - 1).bit_length())
        ap = np.zeros((L, cap), np.int32)
        bp = np.zeros((L, cap), np.int32)
        nv = np.zeros(L, np.int32)
        for li, gi in enumerate(gis):
            s, e = starts[gi], ends[gi]
            g = e - s
            ap[li, :g] = apos1[s:e]
            bp[li, :g] = bpos1[s:e]
            # padding apos sorts after every live entry (searchsorted)
            ap[li, g:] = _I32MAX
            nv[li] = g
        res = _sweep_bucket(torch.from_numpy(ap).to(dev),
                            torch.from_numpy(bp).to(dev),
                            torch.from_numpy(nv).to(dev), kmer)
        cost, frm, orig, best, absorbed, expired, estep = (
            torch.stack(res).cpu().numpy())
        for li, gi in enumerate(gis):
            g = int(nv[li])
            out[gi] = (cost[li, :g], frm[li, :g], orig[li, :g],
                       best[li, :g], absorbed[li, :g], expired[li, :g],
                       estep[li, :g])
    return out


def emit_group(state, apos1, bpos1, gsize: int, kmer: int, hithr: int):
    """The end-of-group scan and candidate emission from the sweep's
    state: (cost, ab, ae, bb, be, length, jumps) in the host sweep's order
    (active set by decreasing key, then expiries in REVERSE queue order —
    the reference prepends each expiring node, map.c:1790-1794; chain_length
    same-diagonal compression applied)."""
    cost, frm, orig, best, absorbed, expired, estep = state
    diag = apos1 - bpos1
    active = (~absorbed.astype(bool)) & (estep >= gsize)
    act_idx = np.flatnonzero(active)
    order = np.lexsort((-apos1[act_idx], -diag[act_idx]))
    scan = list(act_idx[order]) + list(np.flatnonzero(expired)[::-1])

    res = []
    frm_l = frm.copy()      # chain_length mutates links
    for h in scan:
        if cost[h] < hithr or best[orig[h]] != h:
            continue
        # chain_length compression (map.c:1243-1260)
        n = 0
        x = h
        y = frm_l[x]
        while y >= 0:
            da = apos1[x] - apos1[y]
            if da == bpos1[x] - bpos1[y] and da < 100:
                y = frm_l[x] = frm_l[y]
            else:
                n += 1
                x = y
                y = frm_l[x]
        jumps = []
        g = h
        f = frm_l[g]
        while f >= 0:
            jumps.append((int(apos1[g] - apos1[f]),
                          int(bpos1[g] - bpos1[f])))
            g = f
            f = frm_l[g]
        o = orig[h]
        res.append((int(cost[h]), int(apos1[o]) - kmer, int(apos1[h]),
                    int(bpos1[o]) - kmer, int(bpos1[h]), n, jumps))
    return res

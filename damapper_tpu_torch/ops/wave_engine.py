"""Batched Local_Alignment over many seeds: the host shell around the wave
kernel (ops.wave_cuda.wave_lanes).

Per round of seeds (one pending seed per live candidate, pipeline.reporter):
forward wave of every lane -> host trace extraction -> reverse wave from
each lane's forward low point -> the fshort/rshort redo rounds of the
double-pass refinement (align.c:1810-1854) -> lanes the kernel flags as
overflowed (band, pool or wave cap) re-aligned by the host oracle
(ops.wave.local_alignment, bit-identical), as are whole rounds smaller than
``host_min`` lanes.  Each wave direction of a round is ONE kernel launch
over all its lanes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch

from . import wave as _host
from .spec import AlignSpec
from .wave_cuda import OUT_FIELDS, wave_lanes


@dataclass
class WaveResult:
    """Raw per-lane kernel outputs (host numpy)."""
    trima: np.ndarray
    trimy: np.ndarray
    trimd: np.ndarray
    trimha: np.ndarray
    trimhb: np.ndarray
    morem: np.ndarray
    morea: np.ndarray
    morey: np.ndarray
    mored: np.ndarray
    moreha: np.ndarray
    morehb: np.ndarray
    pool: np.ndarray        # (N, <=P, 4) int32: ptr, diag, diff, mark
    avail: np.ndarray
    overflow: np.ndarray
    waves: np.ndarray       # per-lane wave count (telemetry)


def resolve_device(device) -> torch.device:
    """None means the CUDA card; no card and no explicit CPU request is an
    error, never a silent fall back."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    return dev


class WaveEngine:
    """Batched device Local_Alignment with host oracle fallback.

    band_cap (W): ring band capacity, 128 on the card and 64 on the CPU
    by default.  pool_cap: the most pebble rows a lane may use; each round
    sizes its pool from its longest a-read.  host_min: rounds with fewer
    lanes run on the host oracle."""

    def __init__(self, spec: AlignSpec, band_cap: int | None = None,
                 pool_cap: int = 2048, device=None, host_min: int = 16):
        self.spec = spec
        self.device = resolve_device(device)
        if band_cap is None:
            band_cap = 128 if self.device.type == "cuda" else 64
        self.W = band_cap
        self.P = pool_cap
        self.host_min = host_min
        self._consts = (spec.trace_space, spec.ave_path, spec.mscore,
                        spec.dscore)
        self._activeP = pool_cap
        self.n_fallback = 0
        self.n_total = 0
        self.n_hostmin = 0      # lanes routed to the host oracle (tiny rounds)
        self.total_waves = 0    # summed per-lane wave counts (telemetry)
        self.t_run = 0.0        # seconds inside _run (device + pull wait)
        self.t_batch = 0.0      # seconds inside local_alignment_batch
        self.kernel_ms = 0.0    # summed kernel time from CUDA events

    def upload(self, flat) -> torch.Tensor:
        """Sequence memory (uint8 numpy, sentinel layout) on the device."""
        return torch.from_numpy(np.ascontiguousarray(flat, np.uint8)).to(
            self.device)

    def _run(self, which, abase, bbase, mida, k0, aoffp, boffp,
             Adev, Bdev, sortkey=None) -> WaveResult:
        _t0 = time.perf_counter()
        try:
            return self._launch_and_pull(which, abase, bbase, mida, k0,
                                         aoffp, boffp, Adev, Bdev, sortkey)
        finally:
            self.t_run += time.perf_counter() - _t0

    def _launch_and_pull(self, which, abase, bbase, mida, k0, aoffp, boffp,
                         Adev, Bdev, sortkey=None) -> WaveResult:
        P = self._activeP
        n = len(abase)
        if n == 0:
            z = np.zeros(0, np.int32)
            return WaveResult(*([z] * 11), np.zeros((0, P, 4), np.int32),
                              z, np.zeros(0, bool), z)
        # longest lanes first: blocks are scheduled in launch order, so the
        # long lanes start early and the short ones fill in behind them
        # (the permutation is undone on output; results are unchanged)
        order = None
        if sortkey is not None and n > 1:
            order = np.argsort(-np.asarray(sortkey, np.int64), kind="stable")
            inv = np.empty(n, np.int64)
            inv[order] = np.arange(n)
        args = [np.asarray(x, np.int32) for x in
                (abase, bbase, mida, k0, aoffp, boffp)]
        if order is not None:
            args = [x[order] for x in args]
        ins = [torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
               for x in args]
        timed = self.device.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        out = wave_lanes(*ins, Adev, Bdev, *self._consts, W=self.W, P=P,
                         reverse=(which == "rev"))
        if timed:
            ev1.record()
        # one pull per field group; the pool only up to the longest chain
        scal = torch.stack([out[f].to(torch.int32) for f in OUT_FIELDS]
                           ).cpu().numpy()
        top = int(min(P, max(2, int(scal[OUT_FIELDS.index("avail")].max()))))
        pool = out["pool"][:, :top].cpu().numpy()
        if timed:
            self.kernel_ms += ev0.elapsed_time(ev1)
        merged = {f: scal[i] for i, f in enumerate(OUT_FIELDS)}
        merged["overflow"] = merged["overflow"] != 0
        merged["pool"] = pool
        if order is not None:
            merged = {f: v[inv] for f, v in merged.items()}
        self.total_waves += int(merged["waves"].sum())
        return WaveResult(**merged)

    # ---- full Local_Alignment over a batch of seeds ----

    def local_alignment_batch(self, Adev, Bdev, Anp, Bnp, seeds):
        """seeds: list of dicts with abase, alen, bbase, blen, diag, anti,
        flags.  Adev/Bdev are the uint8 sequence memories (with `4`
        sentinels) on the engine's device; Anp/Bnp the same as host numpy
        (for fallback + trace walking).  Returns list of (apath, bpath)."""
        _t0 = time.perf_counter()
        try:
            return self._batch_inner(Adev, Bdev, Anp, Bnp, seeds)
        finally:
            self.t_batch += time.perf_counter() - _t0

    def _oracle(self, Anp, Bnp, s):
        a_np = Anp[s["abase"]:s["abase"] + s["alen"]]
        b_np = Bnp[s["bbase"]:s["bbase"] + s["blen"]]
        return _host.local_alignment(
            a_np, b_np, self.spec, int(s["diag"]), int(s["diag"]),
            int(s["anti"]), -1, -1, int(s["flags"]))

    def _batch_inner(self, Adev, Bdev, Anp, Bnp, seeds):
        n = len(seeds)
        self.n_total += n
        TS = self.spec.trace_space
        out = [None] * n

        if n < self.host_min:
            self.n_hostmin += n
            return [self._oracle(Anp, Bnp, s) for s in seeds]

        # pool bucket: pebbles per lane are bounded by the aligned span
        # (two trace lines per TS columns on each side of a < 2*alen-wide
        # extension) + wave-0 drops + slack
        need = 4 * int(max(s["alen"] for s in seeds)) // TS + 128
        self._activeP = int(min(self.P,
                                max(256, 1 << (need - 1).bit_length())))

        def col(nm):
            return np.array([s[nm] for s in seeds], np.int32)

        abase, bbase, alen, blen = (col(nm) for nm in
                                    ("abase", "bbase", "alen", "blen"))
        diag, anti, flags = col("diag"), col("anti"), col("flags")
        aoffp, boffp = trace_offsets(flags, alen, blen, TS)

        x0 = (anti + diag) // 2
        y0 = (anti - diag) // 2
        f = self._run("fwd", abase, bbase, anti, diag, aoffp, boffp,
                      Adev, Bdev, sortkey=np.minimum(alen - x0, blen - y0))

        apaths = [None] * n
        fwd_a = [None] * n
        fwd_b = [None] * n
        low2 = np.zeros(n, np.int32)
        fallback = set(np.flatnonzero(f.overflow).tolist())
        for i in range(n):
            if i in fallback:
                continue
            trimx, trimy, trimd, trimha, trimhb = _reach_select(
                f, i, self.spec.reach)
            lowi, fwd, btr = _host.extract_forward_traces(
                f.pool[i], trimha, trimhb, trimx, trimy, trimd, int(anti[i]))
            apaths[i] = _host.PathRec(aepos=fwd.aepos, bepos=fwd.bepos,
                                      diffs=fwd.diffs)
            fwd_a[i] = fwd.trace
            fwd_b[i] = btr
            low2[i] = lowi

        r = self._run("rev", abase, bbase, anti, low2, aoffp, boffp,
                      Adev, Bdev,
                      sortkey=np.minimum((anti + low2) // 2,
                                         (anti - low2) // 2))
        for i in range(n):
            if i in fallback:
                continue
            if r.overflow[i]:
                fallback.add(i)
                continue
            trimx, trimy, trimd, trimha, trimhb = _reach_select(
                r, i, self.spec.reach)
            ap = apaths[i]
            a_pre, b_pre = _host.extract_reverse_traces(
                r.pool[i], trimha, trimhb, trimx, trimy, trimd, TS,
                int(aoffp[i]), int(boffp[i]), fwd_a[i], fwd_b[i])
            ap.abpos, ap.bbpos = trimx, trimy
            ap.diffs = ap.diffs + trimd
            fwd_a[i] = a_pre + fwd_a[i]
            fwd_b[i] = b_pre + fwd_b[i]

        # fshort/rshort double-pass refinement (align.c:1810-1854)
        redo_f, redo_r = [], []
        for i in range(n):
            if i in fallback:
                continue
            ap = apaths[i]
            fshort = (ap.aepos + ap.bepos) - int(anti[i]) < _host.DUB_TRIM
            rshort = int(anti[i]) - (ap.abpos + ap.bbpos) < _host.DUB_TRIM
            if fshort and rshort:
                ap.aepos = ap.abpos = (ap.abpos + ap.aepos) // 2
                ap.bepos = ap.bbpos = (ap.bbpos + ap.bepos) // 2
                fwd_a[i] = []
                fwd_b[i] = []
            elif fshort:
                redo_f.append(i)
            elif rshort:
                redo_r.append(i)

        if redo_f:
            idx = np.array(redo_f, np.int32)
            d2 = np.array([apaths[i].abpos - apaths[i].bbpos
                           for i in redo_f], np.int32)
            a2 = np.array([apaths[i].abpos + apaths[i].bbpos
                           for i in redo_f], np.int32)
            f2 = self._run("fwd", abase[idx], bbase[idx], a2, d2,
                           aoffp[idx], boffp[idx], Adev, Bdev,
                           sortkey=np.minimum(alen[idx] - (a2 + d2) // 2,
                                              blen[idx] - (a2 - d2) // 2))
            for j, i in enumerate(redo_f):
                if f2.overflow[j]:
                    fallback.add(i)
                    continue
                trimx, trimy, trimd, trimha, trimhb = _reach_select(
                    f2, j, self.spec.reach)
                _, fwd, btr = _host.extract_forward_traces(
                    f2.pool[j], trimha, trimhb, trimx, trimy, trimd,
                    int(a2[j]))
                ap = apaths[i]
                ap.aepos, ap.bepos, ap.diffs = fwd.aepos, fwd.bepos, fwd.diffs
                fwd_a[i] = fwd.trace
                fwd_b[i] = btr

        if redo_r:
            idx = np.array(redo_r, np.int32)
            d2 = np.array([apaths[i].aepos - apaths[i].bepos
                           for i in redo_r], np.int32)
            a2 = np.array([apaths[i].aepos + apaths[i].bepos
                           for i in redo_r], np.int32)
            r2 = self._run("rev", abase[idx], bbase[idx], a2, d2,
                           aoffp[idx], boffp[idx], Adev, Bdev,
                           sortkey=np.minimum((a2 + d2) // 2,
                                              (a2 - d2) // 2))
            for j, i in enumerate(redo_r):
                if r2.overflow[j]:
                    fallback.add(i)
                    continue
                trimx, trimy, trimd, trimha, trimhb = _reach_select(
                    r2, j, self.spec.reach)
                ap = apaths[i]
                fa, fb = [], []
                a_pre, b_pre = _host.extract_reverse_traces(
                    r2.pool[j], trimha, trimhb, trimx, trimy, trimd, TS,
                    int(aoffp[i]), int(boffp[i]), fa, fb)
                ap.abpos, ap.bbpos = trimx, trimy
                ap.diffs = trimd
                fwd_a[i] = a_pre + fa
                fwd_b[i] = b_pre + fb

        for i in range(n):
            if i in fallback:
                self.n_fallback += 1
                out[i] = self._oracle(Anp, Bnp, seeds[i])
                continue
            ap = apaths[i]
            bp = _host.PathRec()
            ap.trace = fwd_a[i]
            bp.trace = fwd_b[i]
            _host.finalize_paths(ap, bp, int(flags[i]), int(alen[i]),
                                 int(blen[i]))
            out[i] = (ap, bp)
        return out


def trace_offsets(flags, alen, blen, trace_space):
    """Trace-line phase of the complemented sides (aoffp, boffp): int32
    arrays."""
    flags = np.asarray(flags)
    aoffp = np.where(flags & _host.ACOMP_FLAG,
                     np.asarray(alen) % trace_space, 0)
    boffp = np.where(flags & _host.COMP_FLAG,
                     np.asarray(blen) % trace_space, 0)
    return aoffp.astype(np.int32), boffp.astype(np.int32)


def _reach_select(res: WaveResult, i: int, reach: bool):
    """REACH boundary selection (align.c:907-915 / 1561-1569)."""
    if res.morem[i] >= 0 and reach:
        trimy = int(res.morey[i])
        trimx = int(res.morea[i]) - trimy
        trimd = int(res.mored[i])
        trimha = int(res.moreha[i])
        trimhb = int(res.morehb[i])
    else:
        trimy = int(res.trimy[i])
        trimx = int(res.trima[i]) - trimy
        trimd = int(res.trimd[i])
        trimha = int(res.trimha[i])
        trimhb = int(res.trimhb[i])
    return trimx, trimy, trimd, trimha, trimhb


def local_alignment_batch(spec: AlignSpec, Anp, Bnp, seeds, device=None,
                          host_min: int = 16, band_cap=None,
                          pool_cap: int = 2048):
    """One-shot batched Local_Alignment: uploads the sequence memories to
    ``device`` (None: the CUDA card) and aligns every seed.  Returns
    (list of (apath, bpath), engine)."""
    eng = WaveEngine(spec, band_cap=band_cap, pool_cap=pool_cap,
                     device=device, host_min=host_min)
    Adev = eng.upload(Anp)
    Bdev = Adev if Bnp is Anp else eng.upload(Bnp)
    return eng.local_alignment_batch(Adev, Bdev, Anp, Bnp, seeds), eng

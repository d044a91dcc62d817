"""Batched Local_Alignment over many seeds: the host shell around the wave
kernels (ops.wave_cuda.wave_lanes, ops.wave_persistent.wave_lanes_persistent).

Per round of seeds (one pending seed per live candidate, pipeline.reporter):
forward wave of every lane -> host trace extraction -> reverse wave from
each lane's forward low point -> the fshort/rshort redo rounds of the
double-pass refinement (align.c:1810-1854) -> lanes the kernel flags as
overflowed (band, pool or wave cap) re-aligned by the host oracle
(ops.wave.local_alignment, bit-identical), as are whole rounds smaller than
``host_min`` lanes.  Each wave direction of a round is ONE kernel launch
over all its lanes, and each pass's trace walk ONE call over all its lanes
(ops.trace_walk: native/trace_walk.cpp, or ops.wave's plain walk where the
native library cannot be loaded); the traces stay flat until the round's
paths are built.  The walked lanes are counted ("engine.walk_lanes", and
"engine.walk_native_lanes" for the native walk's).

The mode is chosen as the JAX package chooses it (resolve_wave_mode: the
explicit argument, then the environment, then the measured mode file
damapper_tpu_torch/wave_mode.json, then the built-in default): classic
(wave_lanes, the default) or persistent (DAMAPPER_WAVE_PERSISTENT=1:
wave_lanes_persistent, each lane against its sequence windows), each in one
of three layouts of the lane state, which pick the kernel: plain, packed
(DAMAPPER_WAVE_PACKOPS=1) or lane-packed (DAMAPPER_WAVE_LANEPACK=1, which
wins over packed).  The band (DAMAPPER_WAVE_BANDCAP) and the smallest round
that reaches the card (DAMAPPER_WAVE_HOSTMIN) resolve the same way.  The
mode file applies only to an engine on the card it was measured on
(tools/pick_wave_mode.py writes it); the CPU ignores it.  In persistent
mode the lanes a persistent kernel flags as overflowed (most often a window
miss) are re-run on the classic kernel of the same layout at the same band
before any of them reaches the oracle (the JAX engine's retry tier and its
classic twin, wave_pallas.py:2369-2416).

DAMAPPER_WAVE_DUMP=<file> appends every round's seed list to <file>, one
pickle a round, as the JAX engine does; damapper_tpu_torch.tools.wave_replay
replays such a dump, this engine against the host oracle.

The engine's host seconds are split by step (``host_s``: upload, pull,
trace, refine, oracle; see HOST_STEPS); each batch is the span
"engine.batch" and each step's interval the span "engine.<step>" inside it
(utils.spans), and the lanes launched are counted there
("engine.launch_lanes").  DAMAPPER_WAVE_KIT=1 also keeps a
log of every launch (``kit_log``, the newest DAMAPPER_WAVE_KIT_CAP entries):
its direction, lanes, each lane's waves, its kernel ms and the host seconds
by step that followed it in its round (tools/wave_kit.py reads it).  Neither
changes a record.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import pathlib
import pickle
import time
from dataclasses import dataclass

import numpy as np
import torch

from . import trace_walk as _tw
from . import wave as _host
from . import wave_cuda as _wc
from . import wave_persistent as _wp
from .. import native
from ..utils import spans
from .spec import AlignSpec
from .wave_cuda import NREC_IN, OUT_FIELDS, wave_lanes
from .wave_persistent import (persistent_windows, wave_lanes_persistent,
                              window_length)


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


#: the measured default mode (tools/pick_wave_mode.py writes it)
MODE_FILE = pathlib.Path(__file__).resolve().parent.parent / "wave_mode.json"
#: the engine's knobs, resolved by resolve_wave_mode, and their variables
MODE_ENV = {"persistent": "DAMAPPER_WAVE_PERSISTENT",
            "packops": "DAMAPPER_WAVE_PACKOPS",
            "lanepack": "DAMAPPER_WAVE_LANEPACK",
            "band_cap": "DAMAPPER_WAVE_BANDCAP",
            "host_min": "DAMAPPER_WAVE_HOSTMIN"}
SWITCHES = ("persistent", "packops", "lanepack")
#: the steps of the engine's host seconds (``WaveEngine.host_s``): upload
#: (seed columns, each launch's lane inputs and their copies to the card),
#: pull (the launch, the wait for the kernel and the copy back; on the CPU
#: the plain version's run), trace (the forward and reverse trace
#: extraction and the paths' finish), refine (the fshort/rshort double
#: pass: its classification, its redo rounds' inputs and traces), oracle
#: (lanes re-aligned on the host: overflows and tiny rounds)
HOST_STEPS = ("upload", "pull", "trace", "refine", "oracle")
#: kit log entries kept by default (the JAX engine's KIT_LOG_CAP)
KIT_CAP = 4096


def default_band(device_type: str, persistent: bool, lanepack: bool) -> int:
    """The built-in band: 128 for the classic plain and packed kernels on
    the card, else 64 (the JAX engine's defaults)."""
    return 128 if (device_type == "cuda" and not persistent
                   and not lanepack) else 64


def resolve_wave_mode(device_type: str, args: dict, env, mode_file: dict):
    """The engine's knobs (SWITCHES, band_cap, host_min), each from the
    first of: its argument (not None), its MODE_ENV variable (a switch is on
    when it is "1"), the mode file's entry, the built-in default (classic;
    default_band; 16).  mode_file applies only on the card: pass {} where
    it does not (mode_file_for).  Pure; returns (values, sources), sources
    naming "arg", "env", "file" or "default" for each knob, plus "mode":
    the lowest-precedence source that set one of the three switches."""
    vals, srcs = {}, {}
    order = (*SWITCHES, "band_cap", "host_min")
    for k in order:
        conv = bool if k in SWITCHES else int
        if args.get(k) is not None:
            vals[k], srcs[k] = conv(args[k]), "arg"
        elif MODE_ENV[k] in env:
            v = env[MODE_ENV[k]]
            vals[k], srcs[k] = (v == "1" if k in SWITCHES else int(v)), "env"
        elif device_type == "cuda" and mode_file.get(k) is not None:
            vals[k], srcs[k] = conv(mode_file[k]), "file"
        else:
            vals[k] = (False if k in SWITCHES else 16 if k == "host_min"
                       else default_band(device_type, vals["persistent"],
                                         vals["lanepack"]))
            srcs[k] = "default"
    srcs["mode"] = next((s for s in ("file", "env", "arg")
                         if s in {srcs[k] for k in SWITCHES}), "default")
    return vals, srcs


def mode_file_for(device) -> dict:
    """The mode file's entries where they apply to an engine on
    ``device``: on a CUDA device, when the file's platform is "cuda" and
    its card is that device's name; else {} (a measurement steers only the
    card it was taken on, never the CPU)."""
    if device.type != "cuda":
        return {}
    try:
        f = json.loads(MODE_FILE.read_text())
    except (OSError, ValueError):
        return {}
    if (not isinstance(f, dict) or f.get("platform") != "cuda"
            or f.get("card") != torch.cuda.get_device_name(device)):
        return {}
    return f


class WaveEngine:
    """Batched device Local_Alignment with host oracle fallback.

    band_cap (W): ring band capacity; by default 128 for the classic plain
    and packed kernels on the card, else 64 (the JAX engine's defaults).
    pool_cap: the most pebble rows a lane may use; each round sizes its pool
    from its longest a-read.
    host_min: rounds with fewer lanes run on the host oracle (default 16).
    persistent, packops, lanepack: the wave mode.  None leaves a knob to
    resolve_wave_mode (the environment, the mode file on its card, the
    default); ``mode_source`` says where the mode came from.  mesh: a
    parallel.mesh.Mesh of one process whose "dp" axis shards every
    launch's lanes (padded with filler lanes to a multiple of the dp size):
    each shard's kernel runs on its dp row's device, every shard is
    launched before any pull, the results come back in lane order, and a
    launch counts once per shard."""

    def __init__(self, spec: AlignSpec, band_cap: int | None = None,
                 pool_cap: int = 2048, device=None, host_min=None,
                 persistent=None, packops=None, lanepack=None, mesh=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.mesh = mesh
        if mesh is None:
            self._dp = [self.device]
        else:
            if mesh.is_multiprocess():
                raise ValueError("the wave engine shards lanes within one "
                                 "process; a mesh across ranks runs the "
                                 "wave unsharded on every rank")
            self._dp = mesh.dp_devices()
            if any(d.type != self.device.type for d in self._dp):
                raise ValueError(f"the mesh's dp devices {self._dp} are not "
                                 f"all of the engine's device type "
                                 f"{self.device.type}")
        self._mirrors = {}      # dp device -> sequence memories there
        knobs, sources = resolve_wave_mode(
            self.device.type, dict(persistent=persistent, packops=packops,
                                   lanepack=lanepack, band_cap=band_cap,
                                   host_min=host_min),
            os.environ, mode_file_for(self.device))
        self.mode_source = sources["mode"]
        self.persistent = knobs["persistent"]
        self.layout = ("lanepack" if knobs["lanepack"] else
                       "packed" if knobs["packops"] else "plain")
        self.mode = (("persistent" if self.persistent else "classic")
                     + {"plain": "", "packed": "+packops",
                        "lanepack": "+lanepack"}[self.layout])
        self.W = knobs["band_cap"]
        self.P = pool_cap
        self.host_min = knobs["host_min"]
        self._consts = (spec.trace_space, spec.ave_path, spec.mscore,
                        spec.dscore)
        self._activeP = pool_cap
        self.n_fallback = 0
        self.n_total = 0
        self.n_hostmin = 0      # lanes routed to the host oracle (tiny rounds)
        self.n_winmiss = 0      # persistent-mode lanes retried on classic
        self._L = 0             # persistent window length of the round
        # kernel launches made by this engine, by kernel
        self.launches = dict.fromkeys((*_wc.KERNEL_NAMES.values(),
                                       *_wp.KERNEL_NAMES.values()), 0)
        self.total_waves = 0    # summed per-lane wave counts (telemetry)
        self.t_run = 0.0        # seconds inside _run (device + pull wait)
        self.t_batch = 0.0      # seconds inside local_alignment_batch
        self.kernel_ms = 0.0    # summed kernel time from CUDA events
        self.host_s = dict.fromkeys(HOST_STEPS, 0.0)
        # DAMAPPER_WAVE_KIT=1: one entry a launch (and a tiny host round),
        # the newest DAMAPPER_WAVE_KIT_CAP kept, so a long run with the
        # variable left on holds a bounded log
        self.kit_log = None
        if os.environ.get("DAMAPPER_WAVE_KIT") == "1":
            self.kit_log = collections.deque(maxlen=int(os.environ.get(
                "DAMAPPER_WAVE_KIT_CAP", KIT_CAP)))
        self._entry = None      # the kit entry host steps are charged to
        self._clk = 0           # the end of the round's last host step (ns)
        self._tlib = None       # the native trace walk (False: none)

    def _step(self, step: str):
        """Charge the host seconds since the round's last step to ``step``
        (and to the kit entry of the round's latest launch), and make the
        interval the span "engine.<step>"."""
        t = spans.now()
        dt = (t - self._clk) / 1e9
        self.host_s[step] += dt
        if self._entry is not None:
            self._entry["host_s"][step] += dt
        spans.interval("engine." + step, self._clk, t)
        self._clk = t

    def _kit_entry(self, which, n, persistent):
        """A new kit entry (the one later host steps are charged to), or
        None with the kit off."""
        self._entry = None
        if self.kit_log is not None:
            self._entry = dict(dir=which, lanes=n, persistent=persistent,
                               waves=np.zeros(0, np.int32), kernel_ms=0.0,
                               host_s=dict.fromkeys(HOST_STEPS, 0.0))
            self.kit_log.append(self._entry)
        return self._entry

    def upload(self, flat) -> torch.Tensor:
        """Sequence memory (uint8 numpy, sentinel layout) on the device."""
        return torch.from_numpy(np.ascontiguousarray(flat, np.uint8)).to(
            self.device)

    def _run(self, which, abase, bbase, mida, k0, aoffp, boffp,
             Adev, Bdev, sortkey=None) -> WaveResult:
        _t0 = time.perf_counter()
        try:
            res = self._launch_and_pull(which, abase, bbase, mida, k0,
                                        aoffp, boffp, Adev, Bdev, sortkey,
                                        persistent=self.persistent)
            if self.persistent:
                res = self._retry_classic(
                    res, which, (abase, bbase, mida, k0, aoffp, boffp),
                    Adev, Bdev, sortkey)
            return res
        finally:
            self.t_run += time.perf_counter() - _t0

    def _retry_classic(self, res, which, lanes, Adev, Bdev, sortkey):
        """Re-run the lanes a persistent kernel flagged on the classic
        kernel of the same layout at the same band: the classic kernel
        reads the whole sequence memory, so only its own overflows reach
        the oracle."""
        bad = np.flatnonzero(res.overflow)
        if len(bad) == 0:
            return res
        if self._entry is not None:
            # as total_waves: a retried lane counts its classic waves only
            self._entry["waves"][bad] = 0
        sub = self._launch_and_pull(
            which, *(np.asarray(x)[bad] for x in lanes), Adev, Bdev,
            None if sortkey is None else np.asarray(sortkey)[bad],
            persistent=False)
        self.n_winmiss += len(bad)
        # telemetry: the retried lanes count the classic run's waves only
        self.total_waves -= int(res.waves[bad].sum())
        width = max(res.pool.shape[1], sub.pool.shape[1])
        for fld in res.__dataclass_fields__:
            arr, new = getattr(res, fld), getattr(sub, fld)
            if fld == "pool":
                arr, new = (np.pad(a, ((0, 0), (0, width - a.shape[1]),
                                       (0, 0))) for a in (arr, new))
                res.pool = arr
            arr[bad] = new
        return res

    def _launch_and_pull(self, which, abase, bbase, mida, k0, aoffp, boffp,
                         Adev, Bdev, sortkey=None,
                         persistent=False) -> WaveResult:
        P = self._activeP
        n = len(abase)
        if n == 0:
            z = np.zeros(0, np.int32)
            return WaveResult(*([z] * 11), np.zeros((0, P, 4), np.int32),
                              z, np.zeros(0, bool), z)
        spans.count("engine.launch_lanes", n)
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
        ndp = len(self._dp)
        npad = -(-n // ndp) * ndp
        if npad > n:
            # a dp-sharded launch takes a multiple of the dp size: filler
            # lanes anchored on the memory's leading sentinel stop after one
            # wave and are dropped (wave_jax.py's degenerate filler seed)
            args = [np.concatenate([x, np.zeros(npad - n, np.int32)])
                    for x in args]
        reverse = which == "rev"
        if persistent:
            args += [w.numpy() for w in persistent_windows(
                *(torch.from_numpy(x) for x in args[:4]), Adev.shape[0],
                Bdev.shape[0], self._L, reverse)]
        entry = self._kit_entry(which, n, persistent)
        # kernel time on the current device's stream (with shards on other
        # cards, theirs is not in it)
        timed = self.device.type == "cuda"
        if timed:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        # every shard's kernel is launched before any result is pulled
        per = npad // ndp
        outs = [self._launch_shard([x[s * per:(s + 1) * per] for x in args],
                                   dev, Adev, Bdev, P, reverse, persistent)
                for s, dev in enumerate(self._dp)]
        if timed:
            ev1.record()
        # one pull per field group and shard (the packed layout's whole
        # output record in one copy); the pool only up to the longest chain
        scal = np.concatenate([
            out["record"].cpu().numpy().T[:len(OUT_FIELDS)]
            if "record" in out else
            torch.stack([out[f].to(torch.int32) for f in OUT_FIELDS]
                        ).cpu().numpy() for out in outs], 1)[:, :n]
        top = int(min(P, max(2, int(scal[OUT_FIELDS.index("avail")].max()))))
        pool = np.concatenate([out["pool"][:, :top].cpu().numpy()
                               for out in outs])[:n]
        ms = ev0.elapsed_time(ev1) if timed else 0.0
        self.kernel_ms += ms
        merged = {f: scal[i] for i, f in enumerate(OUT_FIELDS)}
        merged["overflow"] = merged["overflow"] != 0
        merged["pool"] = pool
        if order is not None:
            merged = {f: v[inv] for f, v in merged.items()}
        self.total_waves += int(merged["waves"].sum())
        if entry is not None:
            entry["waves"] = merged["waves"].astype(np.int32)
            entry["kernel_ms"] = ms
        self._step("pull")
        return WaveResult(**merged)

    def _seq_on(self, dev, Adev, Bdev):
        """The sequence memories on a dp shard's device: copied once per
        distinct device (and upload), not once per shard or launch."""
        if self.mesh is None or dev == Adev.device:
            return Adev, Bdev
        ent = self._mirrors.get(dev)
        if ent is None or ent[0] is not Adev or ent[1] is not Bdev:
            A = Adev.to(dev)
            ent = (Adev, Bdev, A, A if Bdev is Adev else Bdev.to(dev))
            self._mirrors[dev] = ent
        return ent[2], ent[3]

    def _launch_shard(self, args, dev, Adev, Bdev, P, reverse, persistent):
        """Upload one shard's lane inputs to ``dev`` and launch its kernel
        there (asynchronous on the card); returns the wrapper's output."""
        A, B = self._seq_on(dev, Adev, Bdev)
        n = len(args[0])
        # the lane inputs go up in one copy: the packed layout's (n, 8)
        # records, else the rows of one array
        kw = {}
        if self.layout == "packed":
            rec = np.zeros((n, NREC_IN), np.int32)
            rec[:, :len(args)] = np.stack(args, 1)
            kw["record"] = torch.from_numpy(rec).to(dev)
            ins = list(kw["record"].unbind(1))
        else:
            ins = list(torch.from_numpy(np.stack(args)).to(dev))
        # launches are counted on the wrappers themselves (_wc, _wp), which
        # a test may stand in for with its own function
        consts = dict(zip(("ts", "pave", "msc", "dsc"), self._consts))
        cnt = "launches_" + self.layout
        ctx = (torch.cuda.device(dev) if self.mesh is not None
               and dev.type == "cuda" else contextlib.nullcontext())
        # the launch itself counts as the wait for its results (on the CPU
        # it is the plain version's whole run)
        self._step("upload")
        with ctx:
            if persistent:
                real, names = _wp.wave_lanes_persistent, _wp.KERNEL_NAMES
                before = getattr(real, cnt)
                out = wave_lanes_persistent(
                    *ins[:6], A, B, **consts, W=self.W, P=P, L=self._L,
                    reverse=reverse, layout=self.layout, awst=ins[6],
                    bwst=ins[7], **kw)
            else:
                real, names = _wc.wave_lanes, _wc.KERNEL_NAMES
                before = getattr(real, cnt)
                out = wave_lanes(*ins[:6], A, B, **consts, W=self.W, P=P,
                                 reverse=reverse, layout=self.layout, **kw)
        self.launches[names[self.layout]] += getattr(real, cnt) - before
        self._step("pull")
        return out

    # ---- full Local_Alignment over a batch of seeds ----

    def local_alignment_batch(self, Adev, Bdev, Anp, Bnp, seeds):
        """seeds: list of dicts with abase, alen, bbase, blen, diag, anti,
        flags.  Adev/Bdev are the uint8 sequence memories (with `4`
        sentinels) on the engine's device; Anp/Bnp the same as host numpy
        (for fallback + trace walking).  Returns list of (apath, bpath)."""
        _t0 = time.perf_counter()
        try:
            with spans.span("engine.batch"):
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
        self._clk = spans.now()
        self._entry = None
        TS = self.spec.trace_space
        out = [None] * n
        dump = os.environ.get("DAMAPPER_WAVE_DUMP")
        if dump:
            # every round's seeds, tiny host rounds included, appended as
            # one pickle a call (the JAX engine's format) for an offline
            # engine-against-oracle replay (tools.wave_replay); a round is
            # one call however many dp shards its launches take
            with open(dump, "ab") as fh:
                pickle.dump(seeds, fh)

        if n < self.host_min:
            self.n_hostmin += n
            self._kit_entry("host", n, False)
            res = [self._oracle(Anp, Bnp, s) for s in seeds]
            self._step("oracle")
            return res
        if self.persistent:
            # one window length for the whole round and its redo rounds
            self._L = window_length(max(s["alen"] for s in seeds))

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

        # the round's paths, a column a field; the traces stay flat
        # (trace_walk) until the paths are built at the round's end
        lib = self._trace_lib()
        orc = f.overflow.copy()         # the lanes the oracle re-aligns
        ab, bb, ae, be, df = (np.zeros(n, np.int64) for _ in range(5))
        live = np.flatnonzero(~orc)
        trim = _reach_select(f, live, self.spec.reach)
        fwa, fwa_off, fwb, fwb_off, low = self._walk(
            _tw.forward, lib, f.pool, live, trim, anti[live])
        ae[live], be[live], df[live] = trim[:3]
        low2 = np.zeros(n, np.int32)
        low2[live] = low
        self._step("trace")

        r = self._run("rev", abase, bbase, anti, low2, aoffp, boffp,
                      Adev, Bdev,
                      sortkey=np.minimum((anti + low2) // 2,
                                         (anti - low2) // 2))
        orc |= r.overflow
        tra, trb = _tw.RoundTraces(n), _tw.RoundTraces(n)
        lanes = np.flatnonzero(~orc)
        pos = np.searchsorted(live, lanes)      # the lanes' forward walks
        trim = _reach_select(r, lanes, self.spec.reach)
        ta, oa, tb, ob = self._walk(
            _tw.reverse, lib, r.pool, lanes, trim, TS, aoffp[lanes],
            boffp[lanes], (fwa, fwa_off[pos], fwa_off[pos + 1],
                           fwb, fwb_off[pos], fwb_off[pos + 1]))
        ab[lanes], bb[lanes] = trim[:2]
        df[lanes] += trim[2]
        tra.put(lanes, ta, oa)
        trb.put(lanes, tb, ob)
        self._step("trace")

        # fshort/rshort double-pass refinement (align.c:1810-1854)
        fshort = ~orc & ((ae + be) - anti < _host.DUB_TRIM)
        rshort = ~orc & (anti - (ab + bb) < _host.DUB_TRIM)
        both = fshort & rshort
        ae[both] = ab[both] = (ab[both] + ae[both]) // 2
        be[both] = bb[both] = (bb[both] + be[both]) // 2
        tra.clear(both)
        trb.clear(both)
        redo_f = np.flatnonzero(fshort & ~rshort)
        redo_r = np.flatnonzero(rshort & ~fshort)
        self._step("refine")

        if len(redo_f):
            idx = redo_f
            d2 = (ab - bb)[idx].astype(np.int32)
            a2 = (ab + bb)[idx].astype(np.int32)
            f2 = self._run("fwd", abase[idx], bbase[idx], a2, d2,
                           aoffp[idx], boffp[idx], Adev, Bdev,
                           sortkey=np.minimum(alen[idx] - (a2 + d2) // 2,
                                              blen[idx] - (a2 - d2) // 2))
            orc[idx[f2.overflow]] = True
            j = np.flatnonzero(~f2.overflow)
            lanes = idx[j]
            trim = _reach_select(f2, j, self.spec.reach)
            ta, oa, tb, ob, _ = self._walk(_tw.forward, lib, f2.pool, j,
                                           trim, a2[j])
            ae[lanes], be[lanes], df[lanes] = trim[:3]
            tra.put(lanes, ta, oa)
            trb.put(lanes, tb, ob)
            self._step("refine")

        if len(redo_r):
            idx = redo_r
            d2 = (ae - be)[idx].astype(np.int32)
            a2 = (ae + be)[idx].astype(np.int32)
            r2 = self._run("rev", abase[idx], bbase[idx], a2, d2,
                           aoffp[idx], boffp[idx], Adev, Bdev,
                           sortkey=np.minimum((a2 + d2) // 2,
                                              (a2 - d2) // 2))
            orc[idx[r2.overflow]] = True
            j = np.flatnonzero(~r2.overflow)
            lanes = idx[j]
            trim = _reach_select(r2, j, self.spec.reach)
            ta, oa, tb, ob = self._walk(_tw.reverse, lib, r2.pool, j, trim,
                                        TS, aoffp[lanes], boffp[lanes])
            ab[lanes], bb[lanes], df[lanes] = trim[:3]
            tra.put(lanes, ta, oa)
            trb.put(lanes, tb, ob)
            self._step("refine")

        # the paths' finish (finalize_paths, align.c:1857-1912) over the
        # round: coordinate flips, and the (d, b) pairs reversed of the A
        # trace of an ACOMP lane and of the B trace of a COMP lane
        lanes = np.flatnonzero(~orc)
        fl, al, bl = flags[lanes], alen[lanes], blen[lanes]
        acomp = (fl & _host.ACOMP_FLAG) != 0
        comp = ~acomp & ((fl & _host.COMP_FLAG) != 0)
        ab, bb, ae, be = ab[lanes], bb[lanes], ae[lanes], be[lanes]
        # (abpos, bbpos, aepos, bepos, diffs) of each lane's two paths
        acols = [c.tolist() for c in (
            np.where(acomp, al - ae, ab), np.where(acomp, bl - be, bb),
            np.where(acomp, al - ab, ae), np.where(acomp, bl - bb, be),
            df[lanes])]
        bcols = [c.tolist() for c in (
            np.where(comp, bl - be, bb), np.where(comp, al - ae, ab),
            np.where(comp, bl - bb, be), np.where(comp, al - ab, ae),
            df[lanes])]
        ta, tb = tra.lists(lanes, acomp), trb.lists(lanes, comp)
        for k, i in enumerate(lanes.tolist()):
            out[i] = (_host.PathRec(*(c[k] for c in acols), ta[k]),
                      _host.PathRec(*(c[k] for c in bcols), tb[k]))
        self._step("trace")
        for i in np.flatnonzero(orc).tolist():
            self.n_fallback += 1
            out[i] = self._oracle(Anp, Bnp, seeds[i])
        self._step("oracle")
        return out

    def _trace_lib(self):
        """The native trace walk, or None where it cannot be loaded (the
        plain walk of ops.wave then walks every lane)."""
        if self._tlib is None:
            try:
                self._tlib = native.trace_lib()
            except (OSError, ImportError, FileNotFoundError):
                self._tlib = False
        return self._tlib or None

    @staticmethod
    def _walk(fn, lib, pool, lanes, *args):
        """One walk (trace_walk.forward or .reverse) of a pass's lanes,
        counted ("engine.walk_lanes", "engine.walk_native_lanes")."""
        spans.count("engine.walk_lanes", len(lanes))
        spans.count("engine.walk_native_lanes",
                    len(lanes) if lib is not None else 0)
        return fn(lib, pool, lanes, *args)


def trace_offsets(flags, alen, blen, trace_space):
    """Trace-line phase of the complemented sides (aoffp, boffp): int32
    arrays."""
    flags = np.asarray(flags)
    aoffp = np.where(flags & _host.ACOMP_FLAG,
                     np.asarray(alen) % trace_space, 0)
    boffp = np.where(flags & _host.COMP_FLAG,
                     np.asarray(blen) % trace_space, 0)
    return aoffp.astype(np.int32), boffp.astype(np.int32)


def _reach_select(res: WaveResult, lanes, reach: bool):
    """REACH boundary selection (align.c:907-915 / 1561-1569) of ``lanes``:
    (trimx, trimy, trimd, trimha, trimhb), int64 arrays."""
    m = (res.morem[lanes] >= 0) & reach

    def pick(more, trim):
        return np.where(m, more[lanes], trim[lanes]).astype(np.int64)

    trimy = pick(res.morey, res.trimy)
    return (pick(res.morea, res.trima) - trimy, trimy,
            pick(res.mored, res.trimd), pick(res.moreha, res.trimha),
            pick(res.morehb, res.trimhb))


def local_alignment_batch(spec: AlignSpec, Anp, Bnp, seeds, device=None,
                          host_min=None, band_cap=None,
                          pool_cap: int = 2048, **mode):
    """One-shot batched Local_Alignment: uploads the sequence memories to
    ``device`` (None: the CUDA card) and aligns every seed.  mode: the
    engine's persistent/packops/lanepack switches.  Returns (list of
    (apath, bpath), engine)."""
    eng = WaveEngine(spec, band_cap=band_cap, pool_cap=pool_cap,
                     device=device, host_min=host_min, **mode)
    Adev = eng.upload(Anp)
    Bdev = Adev if Bnp is Anp else eng.upload(Bnp)
    return eng.local_alignment_batch(Adev, Bdev, Anp, Bnp, seeds), eng

"""Where a wave's time goes on one card, by section of the wave body.

    python3 -m damapper_tpu_torch.tools.wave_clocks [--seed 42] [--out FILE]

Builds ``csrc/wave.cu`` and ``csrc/wave_persistent.cu`` with
``-DWAVE_SECTION_CLOCKS`` (see the section clocks of ``csrc/wave_body.cuh``)
into ``build/torch_kernels/lib*_clocks.so`` and runs chip smoke's phase-3
lanes through them, 128 lanes of 3-9 kb reads at ~15% error from
``--seed``: the classic plain kernel at W=128 and W=64 and the persistent
plain kernel (W=64, windows through the ring of shared-memory chunks),
each in both directions.  The persistent case also reads the ring's clocks
(``wave_ring_clocks`` of ``csrc/wave_persistent.cu``): per lane the cycles
from the block's start until wave 0 may read (``stage``: the ring's
barriers set up, its first fills issued), the most cycles one of its
threads waited for a fill (``ring_wait``: before refilling a slot, and at
the lane's end; no read waits), and the share of its window words read
from the ring rather than in place (``ring_share``).
The lane-packed layouts run these W=64 kernels (one lane a 64-thread
block), so the two W=64 cases clock rows 3 and 6 too.  In each case the
clocked build's outputs must equal the default build's; one launch gives
every lane's cycles per section; both builds are timed (median of 7
launches, CUDA events); and a timed spin of known cycles gives the SM
clock.  Per case it prints, for the lane with the most waves (the one that
sets a launch's time), ns per wave in each section and their sum, beside
the measured ns per wave (the default build's ms over that lane's waves);
one JSON record per case is printed and appended to --out.  Without a CUDA
card it exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import sys

import numpy as np

from .probe_run import card, emit, open_card, out_file

# the sections of csrc/wave_body.cuh, in its SEC_* order
SECTIONS = ("prologue", "store", "pick", "snake", "round_a", "drops",
            "trigger", "round_b", "clip", "tail")
# (mode, layout, W); every case runs one lane a block
CASES = (("classic", "plain", 128), ("classic", "plain", 64),
         ("persistent", "plain", 64))
P = 512             # the pool bucket of <=9 kb reads
SPIN_CYCLES = 100_000_000
LEAD_CYCLES = 20_000_000


def summarize(clocks, waves, hz):
    """Per-wave account of one launch.  clocks: (lanes, len(SECTIONS))
    cycles; waves: (lanes,) waves per lane; hz: the SM clock.  Returns
    {"lane", "waves", "prologue_ns", "ns_per_wave": {section: ns}, "sum_ns"}
    for the lane with the most waves, and "all_lanes_ns": ns per wave per
    section over every lane (sums of cycles over sums of waves)."""
    clocks = np.asarray(clocks, dtype=np.int64)
    waves = np.asarray(waves, dtype=np.int64)
    i = int(np.argmax(waves))
    w = max(int(waves[i]), 1)
    ns = 1e9 / hz
    per = {s: float(clocks[i, k] * ns / w)
           for k, s in enumerate(SECTIONS) if s != "prologue"}
    tot = max(int(waves.sum()), 1)
    return {"lane": i, "waves": int(waves[i]),
            "prologue_ns": float(clocks[i, 0] * ns),
            "ns_per_wave": per, "sum_ns": float(sum(per.values())),
            "all_lanes_ns": {s: float(clocks[:, k].sum() * ns / tot)
                             for k, s in enumerate(SECTIONS)
                             if s != "prologue"}}


def _clocked(mod, src, stem):
    """The clocked build of csrc/<src>, bound like mod's own library."""
    from ..ops.wave_cuda import CSRC_DIR, nvcc_build
    so = nvcc_build(CSRC_DIR / src, f"lib{stem}_clocks.so",
                    flags=("-DWAVE_SECTION_CLOCKS",))
    lib = mod.bind(ctypes.CDLL(str(so)))
    lib.wave_section_clocks_take.argtypes = [ctypes.c_void_p]
    lib.wave_section_clocks_take.restype = ctypes.c_int
    lib.wave_section_clocks_shape.argtypes = [ctypes.c_void_p]
    lib.wave_section_clocks_shape.restype = ctypes.c_int
    dims = (ctypes.c_int * 2)()
    lib.wave_section_clocks_shape(dims)
    if dims[1] != len(SECTIONS):
        raise RuntimeError(f"{so.name} counts {dims[1]} sections, this tool "
                           f"knows {len(SECTIONS)}")
    lib.clk_lanes = dims[0]
    if hasattr(lib, "wave_ring_clocks_take"):
        lib.wave_ring_clocks_take.argtypes = [ctypes.c_void_p]
        lib.wave_ring_clocks_take.restype = ctypes.c_int
    return lib


def _take(lib):
    """The lanes' section cycles since the last take (then zeroed), and
    for a ring build the lanes' (stage, ring_wait) cycles, else None."""
    buf = np.zeros((lib.clk_lanes, len(SECTIONS)), dtype=np.int64)
    rc = lib.wave_section_clocks_take(buf.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"reading the section clocks failed: {rc}")
    if not hasattr(lib, "wave_ring_clocks_take"):
        return buf, None
    ring = np.zeros((lib.clk_lanes, 4), dtype=np.uint64)
    rc = lib.wave_ring_clocks_take(ring.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"reading the ring clocks failed: {rc}")
    return buf, ring.astype(np.int64)


def ring_summary(ring, lane, hz):
    """The ring's clocks of one launch: stage and ring_wait in ns of the
    given lane (the one with the most waves) and their median and max over
    the lanes, and ring_share, the window words read from the ring over all
    window words read, of that lane and of all lanes.  ring: (lanes, 4):
    stage cycles, wait cycles, words from the ring, words in place."""
    ns = 1e9 / hz
    ring = np.asarray(ring, dtype=np.int64)
    out = {f"{k}_ns": {"lane": float(ring[lane, j] * ns),
                       "median": float(np.median(ring[:, j]) * ns),
                       "max": float(ring[:, j].max() * ns)}
           for j, k in enumerate(("stage", "ring_wait"))}
    words = ring[:, 2] + ring[:, 3]
    out["ring_share"] = {
        "lane": float(ring[lane, 2] / max(int(words[lane]), 1)),
        "all": float(ring[:, 2].sum() / max(int(words.sum()), 1))}
    return out


@contextlib.contextmanager
def _launching_from(mod, lib):
    """mod's wrappers launch from lib while the block runs."""
    mod._load()
    saved, mod._lib = mod._lib, lib
    try:
        yield
    finally:
        mod._lib = saved


def _ms(torch, fn, reps=7):
    """Median ms of one call of fn (CUDA events, after a warm-up, behind a
    spin so that the host's enqueue does not show), and the last result."""
    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(LEAD_CYCLES)
    for e0, e1 in ev:
        e0.record()
        out = fn()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev])), out


def _sm_hz(torch, reps=3):
    """The SM clock: SPIN_CYCLES over the spin's time (CUDA events)."""
    hz = []
    for _ in range(reps):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        torch.cuda._sleep(SPIN_CYCLES)
        e1.record()
        torch.cuda.synchronize()
        hz.append(SPIN_CYCLES / (e0.elapsed_time(e1) / 1e3))
    return float(np.median(hz))


def _same(torch, a, b):
    """Every output field, and every pool cell below avail, equal."""
    from ..ops.wave_cuda import OUT_FIELDS
    if not all(torch.equal(a[f], b[f]) for f in OUT_FIELDS):
        return False
    below = (torch.arange(b["pool"].shape[1], device=b["pool"].device)
             [None, :] < b["avail"].to(torch.int64)[:, None])[:, :, None]
    return torch.equal(a["pool"] * below, b["pool"] * below)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None, help="append the records here")
    args = ap.parse_args(argv)
    torch = open_card("wave_clocks")
    if torch is None:
        return 2
    from ..convert import lanes_from_numpy
    from ..ops import wave_cuda, wave_persistent
    from ..ops.spec import new_align_spec
    from ..utils.sim import make_lane_cases

    mods = {"classic": (wave_cuda, "wave.cu", "wave"),
            "persistent": (wave_persistent, "wave_persistent.cu",
                           "wave_persistent")}
    libs = {m: _clocked(*v) for m, v in mods.items()}
    info = card(torch)
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    consts = dict(ts=spec.trace_space, pave=spec.ave_path, msc=spec.mscore,
                  dsc=spec.dscore)
    dev = torch.device("cuda")
    seqmem, insts = make_lane_cases(args.seed, 128, glen=200_000, rlen=9000,
                                    rmin=3000, mix=True, err=0.15)
    n = len(insts)
    L = wave_persistent.window_length(max(s["blen"] for s in insts))
    hz0 = _sm_hz(torch)
    fh = out_file(args.out)
    try:
        for mode, layout, W in CASES:
            mod, lib = mods[mode][0], libs[mode]
            for reverse in (False, True):
                if mode == "classic":
                    lanes = lanes_from_numpy(insts, seqmem, dev)
                    kw = dict(consts, W=W, P=P, reverse=reverse,
                              layout=layout)

                    def fn():
                        return wave_cuda.wave_lanes(**lanes, **kw)
                else:
                    lanes = lanes_from_numpy(insts, seqmem, dev, L=L,
                                             reverse=reverse)
                    kw = dict(consts, W=W, P=P, L=L, reverse=reverse,
                              layout=layout)

                    def fn():
                        return wave_persistent.wave_lanes_persistent(
                            **lanes, **kw)
                ms, ref = _ms(torch, fn)
                with _launching_from(mod, lib):
                    _take(lib)
                    out = fn()
                    torch.cuda.synchronize()
                    clocks, ring = _take(lib)
                    clocks = clocks[:n]
                    ms_clk, _ = _ms(torch, fn)
                    _take(lib)
                if not _same(torch, out, ref):
                    raise RuntimeError(f"the clocked {mode} {layout} W={W} "
                                       f"build differs from the default")
                hz = _sm_hz(torch)
                acc = summarize(clocks, out["waves"].cpu().numpy(), hz)
                rec = {"mode": mode, "layout": layout, "W": W,
                       "dir": "rev" if reverse else "fwd", "lanes": n,
                       "ms": ms, "ms_clocked": ms_clk,
                       "measured_ns_per_wave": 1e6 * ms / acc["waves"],
                       "sm_hz": hz, "sm_hz_first": hz0, **acc, **info}
                if ring is not None:
                    rec.update(ring_summary(ring[:n], acc["lane"], hz))
                emit(rec, fh)
                print(f"{mode} {layout} W={W} {rec['dir']}: lane "
                      f"{acc['lane']}, {acc['waves']} waves; ns per wave "
                      + ", ".join(f"{s} {v:.1f}" for s, v in
                                  acc["ns_per_wave"].items())
                      + f"; sum {acc['sum_ns']:.1f}, measured "
                      f"{rec['measured_ns_per_wave']:.1f} (default {ms:.4f} "
                      f"ms, clocked {ms_clk:.4f} ms, SM {hz / 1e6:.0f} MHz)"
                      + ("" if ring is None else
                         "; ring ns: " + ", ".join(
                             f"{k[:-3]} lane {v['lane']:.0f}, median "
                             f"{v['median']:.0f}, max {v['max']:.0f}"
                             for k, v in rec.items() if k in (
                                 "stage_ns", "ring_wait_ns"))
                         + f"; words from the ring: lane "
                         f"{rec['ring_share']['lane']:.4f}, all "
                         f"{rec['ring_share']['all']:.4f}"),
                      flush=True)
    finally:
        if fh is not None:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

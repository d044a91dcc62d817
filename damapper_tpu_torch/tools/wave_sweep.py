"""Shape sweep of the classic wave engine, and the dense twin's switch.

    python -m damapper_tpu_torch.tools.wave_sweep [ncases] [rlen]
        [--dense 128,256,512,768,1024,2048,4096] [--no-shape] [--reps 3]
        [--log FILE] [--device cpu]

Shape: the classic plain engine (wave_lanes) over tools.tuning.lane_cases
(ncases, rlen) (defaults 256 and 6,000), run as rounds of 1, 2, 4, ...
lanes (the last takes the rest), so that host_min decides which rounds go
to the host oracle, at every band_cap (64, 128) x pool_cap (1,024, 2,048) x
host_min (0, 16, 64); the default shape (the card's band, 2,048, 16) first.
Each shape: a warm-up run, then the best of --reps; its records must equal
the default shape's.

Dense switch (on the card only): csrc/wave.cu runs its dense W=128 kernel
(wave_lanes_dense_kernel, 7 lanes an SM) for launches of more lanes than
the unbounded kernel holds on the card at once.  The tool builds wave.cu
twice more with -DWAVE_DENSE_ABOVE (0: every launch dense; 2^31-1: none),
into build/torch_kernels/libwave_dense_*.so, and runs the classic engine at
band 128 on the first n lanes of --dense's largest count, for each count n,
with the default build and the two forced builds; each build's records must
equal the default build's.  The kernel ms of the round's two n-lane launches
(fwd and rev, from the engine's kit log) decide: the measured switch is the
smallest count from which the dense build wins at every larger count.

Every run is a row with "sweep": true (the shape or the build, ms a lane,
kernel ms, fallbacks, card and power limit), printed and appended to --log
(default tools/wave_mode_results.jsonl on the card; with --device cpu only
an explicit --log).  Exits 1 if any records differ.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import sys
import time

from . import tuning

DENSE_COUNTS = (128, 256, 512, 768, 1024, 2048, 4096)
# the forced builds: -DWAVE_DENSE_ABOVE values
DENSE_BUILDS = {"dense": 0, "unbounded": (1 << 31) - 1}
SHAPES = [(b, p, h) for b in (128, 64) for p in (2048, 1024)
          for h in (16, 0, 64)]


def doubling_rounds(n):
    """Round sizes 1, 2, 4, ... summing to n (the last takes the rest)."""
    out, k = [], 1
    while sum(out) < n:
        out.append(min(k, n - sum(out)))
        k *= 2
    return out


def shape_sweep(dev, ncases, rlen, reps, info):
    """(rows, mismatching shapes) over SHAPES, the default shape first."""
    from ..ops.wave_engine import default_band
    seqmem, insts = tuning.lane_cases(ncases, rlen)
    rounds = doubling_rounds(ncases)
    band0 = default_band(dev.type, False, False)
    shapes = sorted(SHAPES, key=lambda s: s != (band0, 2048, 16))
    rows, bad, golden = [], [], None
    for band, pool, hmin in shapes:
        eng = tuning.engine(dev, "classic", band=band, host_min=hmin,
                            pool_cap=pool)
        dt, got, kms, fb, _ = tuning.best_of(eng, dev, seqmem, insts, reps,
                                             rounds)
        keys = [tuning.key(r) for r in got]
        golden = golden or keys
        mism = sum(a != b for a, b in zip(golden, keys))
        print(f"band={band} pool={pool} host_min={hmin}: warm {dt:.4f} s, "
              f"{1e3 * dt / ncases:.4f} ms/lane, kernel {kms:.3f} ms, "
              f"fallback={fb}, host lanes {eng.n_hostmin // (reps + 1)}, "
              f"{mism} records differ", flush=True)
        if mism:
            bad.append((band, pool, hmin))
        rows.append(dict(mode="classic", sweep=True, **tuning.triple(
            "classic"), band_cap=band, pool_cap=pool, host_min=hmin,
            rounds=len(rounds), ncases=ncases, rlen=rlen, mix=True, **info,
            total_s=dt, ms_per_lane=1e3 * dt / ncases, kernel_ms=kms,
            fallback=fb, mismatches=mism, reps=reps, ts=time.time()))
    return rows, bad


def build_forced() -> dict:
    """{name: library path} of the forced dense-switch builds of wave.cu,
    compiled side by side (each skipped while it is newer than its
    sources)."""
    import concurrent.futures
    from ..ops import wave_cuda
    with concurrent.futures.ThreadPoolExecutor(len(DENSE_BUILDS)) as ex:
        jobs = {name: ex.submit(wave_cuda.nvcc_build,
                                wave_cuda.CSRC_DIR / "wave.cu",
                                f"libwave_dense_{name}.so", False,
                                (f"-DWAVE_DENSE_ABOVE={v}",))
                for name, v in DENSE_BUILDS.items()}
        return {name: j.result() for name, j in jobs.items()}


def _forced_builds():
    """{name: bound library} of the forced dense-switch builds."""
    from ..ops import wave_cuda
    return {name: wave_cuda.bind(ctypes.CDLL(str(so)))
            for name, so in build_forced().items()}


def _main_launch_ms(eng, dev, seqmem, insts, reps):
    """Best of ``reps`` runs after a warm-up: (wall s, kernel ms of the
    round's launches of all its lanes, records)."""
    n = len(insts)
    eng.kit_log = collections.deque()
    tuning.timed_batch(eng, dev, seqmem, insts)
    best = None
    for _ in range(reps):
        eng.kit_log.clear()
        dt, got, _, _, _ = tuning.timed_batch(eng, dev, seqmem, insts)
        ms = sum(e["kernel_ms"] for e in eng.kit_log if e["lanes"] == n)
        if best is None or ms < best[1]:
            best = (dt, ms, got)
    return best


def dense_sweep(dev, counts, rlen, reps, info):
    """(rows, mismatching (count, build)s, measured switch count or None)."""
    from ..ops import wave_cuda
    from .wave_clocks import _launching_from
    libs = _forced_builds()
    seqmem, pool = tuning.lane_cases(max(counts), rlen)
    rows, bad, wins = [], [], {}
    for n in counts:
        insts = pool[:n]
        runs = {}
        for build in ("default", *libs):
            eng = tuning.engine(dev, "classic", band=128)
            if build == "default":
                runs[build] = _main_launch_ms(eng, dev, seqmem, insts, reps)
            else:
                with _launching_from(wave_cuda, libs[build]):
                    runs[build] = _main_launch_ms(eng, dev, seqmem, insts,
                                                  reps)
        golden = [tuning.key(r) for r in runs["default"][2]]
        for build, (dt, ms, got) in runs.items():
            mism = sum(a != tuning.key(b) for a, b in zip(golden, got))
            if mism:
                bad.append((n, build))
            rows.append(dict(mode="classic", sweep=True, **tuning.triple(
                "classic"), band_cap=128, dense_build=build,
                dense_above=DENSE_BUILDS.get(build), ncases=n, rlen=rlen,
                mix=True, **info, total_s=dt, ms_per_lane=1e3 * dt / n,
                kernel_ms=ms, mismatches=mism, reps=reps, ts=time.time()))
        wins[n] = runs["dense"][1] < runs["unbounded"][1]
        print(f"{n} lanes: fwd+rev kernel ms default "
              f"{runs['default'][1]:.3f}, dense {runs['dense'][1]:.3f}, "
              f"unbounded {runs['unbounded'][1]:.3f}; dense "
              f"{'wins' if wins[n] else 'loses'}", flush=True)
    switch = next((n for n in counts
                   if all(wins[m] for m in counts if m >= n)), None)
    return rows, bad, switch


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ncases", type=int, nargs="?", default=256)
    ap.add_argument("rlen", type=int, nargs="?", default=6000)
    ap.add_argument("--dense", default=",".join(map(str, DENSE_COUNTS)))
    ap.add_argument("--no-shape", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = tuning.open_device(args.device)
    info = tuning.card_info(dev)
    log = args.log or (tuning.RESULTS_FILE if dev.type == "cuda" else None)
    print(f"wave sweep on {info}", flush=True)
    bad = []
    if not args.no_shape:
        rows, b = shape_sweep(dev, args.ncases, args.rlen, args.reps, info)
        tuning.append_rows(log, rows)
        bad += b
    counts = sorted(int(x) for x in args.dense.split(",") if x)
    if counts and dev.type == "cuda":
        rows, b, switch = dense_sweep(dev, counts, args.rlen, args.reps,
                                      info)
        tuning.append_rows(log, rows)
        bad += b
        print(f"dense switch: the dense kernel wins from "
              f"{switch if switch is not None else 'no count'} lanes on "
              f"(counts {counts})", flush=True)
    elif counts:
        print("dense switch: card only (the plain version has no dense "
              "twin)", flush=True)
    if bad:
        print(f"records differ: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

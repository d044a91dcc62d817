"""Engine-level A/B of the wave modes: warm ms a lane of each mode on one
batch of lanes, records held equal across modes.

    python -m damapper_tpu_torch.tools.wave_modes [ncases] [rlen]
        [--modes all] [--reps 3] [--log FILE] [--device cpu]

The lanes are tools.tuning.lane_cases(ncases, rlen): make_lane_cases(777,
ncases, glen=4*rlen, rlen, err=0.15, mix=True), ncases lanes of
reads of 1.5 kb to rlen (defaults 64 and 6,000), as the JAX package's
wave_ab draws them.  Each requested mode (tools.tuning.MODES, a comma list
or "all"; default all) runs on an engine pinned to it (its triple, its
built-in band, host_min=0: no environment variable and no mode file can
relabel a row) over the lanes as one round: a warm-up run, then the best of
--reps timed runs.  Every mode's records must equal the first mode's.  One
row a mode, with the JAX tool's fields (mode, persistent, lanepack, packops,
group, ncases, rlen, mix, platform, total_s, ms_per_lane, fallback, ts) and
band_cap, card, power_limit_w, kernel_ms (the engine's CUDA events) and
reps, is printed and appended to --log (default
tools/wave_mode_results.jsonl on the card; with --device cpu only an
explicit --log); tools/pick_wave_mode.py picks the default mode from them.
A mode whose records differ writes no row; the exit code is then 1.
(tools/wave_ab.py is another tool: it times builds of the kernel sources
against each other.)
"""

from __future__ import annotations

import argparse
import sys
import time

from . import tuning


def measure(dev, modes, ncases, rlen, reps):
    """(rows, mismatching modes): one row a mode whose records equal the
    first mode's."""
    seqmem, insts = tuning.lane_cases(ncases, rlen)
    info = tuning.card_info(dev)
    rows, bad, first = [], [], None
    for mode in modes:
        eng = tuning.engine(dev, mode)
        dt, got, kms, fb, launches = tuning.best_of(eng, dev, seqmem, insts,
                                                    reps)
        keys = [tuning.key(r) for r in got]
        if first is None:
            first = keys
        mism = sum(a != b for a, b in zip(first, keys))
        print(f"{mode} (W={eng.W}): warm {dt:.4f} s, "
              f"{1e3 * dt / ncases:.4f} ms/lane, kernel {kms:.3f} ms, "
              f"fallback={fb}, launches "
              f"{ {k: v for k, v in launches.items() if v} }, "
              f"{mism} records differ from {modes[0]}", flush=True)
        if mism:
            bad.append(mode)
            continue
        rows.append(dict(mode=mode, **tuning.triple(mode), group=None,
                         band_cap=eng.W, ncases=ncases, rlen=rlen, mix=True,
                         **info, total_s=dt, ms_per_lane=1e3 * dt / ncases,
                         kernel_ms=kms, fallback=fb, reps=reps,
                         ts=time.time()))
    return rows, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ncases", type=int, nargs="?", default=64)
    ap.add_argument("rlen", type=int, nargs="?", default=6000)
    ap.add_argument("--modes", default="all")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--log", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    modes = tuning.mode_names(args.modes)
    dev = tuning.open_device(args.device)
    print(f"{args.ncases} lanes, reads <= {args.rlen} bp, on "
          f"{tuning.card_info(dev)}", flush=True)
    rows, bad = measure(dev, modes, args.ncases, args.rlen, args.reps)
    tuning.append_rows(args.log or (tuning.RESULTS_FILE
                                    if dev.type == "cuda" else None), rows)
    if bad:
        print(f"records differ from {modes[0]}'s in {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""Where the wave engine's time goes: in-kernel compute against the host.

    python -m damapper_tpu_torch.tools.wave_kit [ncases] [rlen] [rmin]
        [--mode classic] [--band W] [--reps 3] [--out FILE] [--device cpu]

Runs the engine with its kit log on (ops.wave_engine, DAMAPPER_WAVE_KIT)
over tools.tuning.lane_cases-style lanes: make_lane_cases(777, ncases,
glen=4*rlen, rlen, err=0.15, mix=True, rmin) (defaults 1,024 lanes of 3-9 kb
reads, the size of bench.py's default run: 1,037 lanes of 3-9 kb reads), as
one round on an engine pinned to --mode (default classic, the mode's own
band unless --band), host_min=0.  After a warm-up, the minimum of --reps
warm runs (by wall) is reported: the total waves (the sum of the log's
per-lane waves, equal to the engine's total_waves), the longest lane's
waves, and for the launch that holds it its kernel ms (CUDA events) and the
us a wave of that lane (the launch's kernel ms over the lane's waves: the
longest lane sets a launch's time); every launch's direction, lanes and
kernel ms; and the engine's host seconds by step (upload, pull, trace,
refine, oracle: ops.wave_engine.HOST_STEPS) against the wall.  One JSON
record, printed and appended to --out.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time

from . import tuning


def summarize(log, wall) -> dict:
    """The kit's account of one run from its log entries."""
    from ..ops.wave_engine import HOST_STEPS
    dev_entries = [e for e in log if e["dir"] != "host"]
    total = int(sum(int(e["waves"].sum()) for e in log))
    host = {s: float(sum(e["host_s"][s] for e in log)) for s in HOST_STEPS}
    out = {"wall_s": wall, "total_waves": total, "host_s": host,
           "host_sum_s": float(sum(host.values())),
           "kernel_ms": float(sum(e["kernel_ms"] for e in log)),
           "launches": [{"dir": e["dir"], "lanes": e["lanes"],
                         "persistent": e["persistent"],
                         "kernel_ms": e["kernel_ms"],
                         "longest_waves": int(e["waves"].max(initial=0))}
                        for e in dev_entries]}
    if dev_entries:
        top = max(dev_entries, key=lambda e: int(e["waves"].max(initial=0)))
        w = int(top["waves"].max(initial=0))
        out.update(longest_lane_waves=w, longest_launch_ms=top["kernel_ms"],
                   longest_launch_dir=top["dir"],
                   us_per_wave_longest=1e3 * top["kernel_ms"] / max(w, 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("ncases", type=int, nargs="?", default=1024)
    ap.add_argument("rlen", type=int, nargs="?", default=9000)
    ap.add_argument("rmin", type=int, nargs="?", default=3000)
    ap.add_argument("--mode", default="classic", choices=list(tuning.MODES))
    ap.add_argument("--band", type=int, default=None)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    dev = tuning.open_device(args.device)
    info = tuning.card_info(dev)
    seqmem, insts = tuning.lane_cases(args.ncases, args.rlen,
                                      rmin=args.rmin)
    eng = tuning.engine(dev, args.mode, band=args.band)
    eng.kit_log = collections.deque()
    tuning.timed_batch(eng, dev, seqmem, insts)
    best = None
    for _ in range(args.reps):
        eng.kit_log.clear()
        w0 = eng.total_waves
        dt, *_ = tuning.timed_batch(eng, dev, seqmem, insts)
        rec = summarize(eng.kit_log, dt)
        if rec["total_waves"] != eng.total_waves - w0:
            raise RuntimeError("the kit's waves differ from total_waves")
        if best is None or dt < best["wall_s"]:
            best = rec
    rec = dict(mode=args.mode, band_cap=eng.W, ncases=args.ncases,
               rlen=args.rlen, rmin=args.rmin, reps=args.reps, **info,
               **best, ts=time.time())
    print(f"{args.mode} W={eng.W}: {args.ncases} lanes, warm "
          f"{rec['wall_s']:.4f} s (min of {args.reps}); waves "
          f"{rec['total_waves']}, longest lane {rec.get('longest_lane_waves')}"
          f" waves in a {rec.get('longest_launch_dir')} launch of "
          f"{rec.get('longest_launch_ms', 0):.3f} ms = "
          f"{rec.get('us_per_wave_longest', 0):.3f} us a wave; kernel "
          f"{rec['kernel_ms']:.3f} ms in {len(rec['launches'])} launches; "
          f"host s " + ", ".join(f"{k} {v:.4f}" for k, v in
                                 rec["host_s"].items())
          + f" (sum {rec['host_sum_s']:.4f})", flush=True)
    tuning.append_rows(args.out, [rec])
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

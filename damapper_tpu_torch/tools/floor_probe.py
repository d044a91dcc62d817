"""The while-loop iteration floor on the card: the counterpart of the JAX
package's ``tools/mosaic_floor.py``.

    python3 -m damapper_tpu_torch.tools.floor_probe [niter] [nops] [--out FILE]

Times one launch of ``ops.probes.floor_probe`` (``csrc/probes.cu``): niter
iterations of nops//4 quads of chained int32 operations on a (G, W) array,
"mix" (x+1; where; roll by one column; max(x, x^2)) or "add" (x+1, ^3, +7,
^5).  Shapes: mosaic_floor.py's, plus the wave launch's own (G=128, W=64
and 128); each under the kernel's two row layouts in turns (``block``: one
row per block of W threads, the roll a shared-memory exchange between two
barriers; ``warp``: one row per warp, W/32 columns a lane in registers,
the roll one shuffle).  Each record times niter and 5·niter iterations
with CUDA events after a warm-up and takes the slope, as mosaic_floor.py's
slope cancels the launch.  Records (JSON lines, printed, and appended to
--out when given): mosaic_floor.py's keys plus ``device``,
``power_limit``, ``barrier`` and ``bound_ms`` (the least time of the niter
launch).  Without a CUDA card it exits non-zero.
"""

from __future__ import annotations

import argparse
import sys

from .probe_run import card, emit, open_card, out_file, slope

# mosaic_floor.py:93-98, and the wave launch's shapes
SHAPES = {"mix": ((8, 64), (8, 128), (16, 128), (8, 256), (32, 128),
                  (64, 128), (128, 128), (128, 64)),
          "add": ((8, 128), (64, 128), (128, 64), (128, 128))}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("niter", nargs="?", type=int, default=20000)
    ap.add_argument("nops", nargs="?", type=int, default=96)
    ap.add_argument("--out", default=None, help="append the records here")
    args = ap.parse_args(argv)
    torch = open_card("floor_probe")
    if torch is None:
        return 2
    from ..ops.probes import SERVED, bound_ms, floor_probe

    dev = torch.device("cuda")
    info = card(torch)
    fh = out_file(args.out)
    try:
        for variant, shapes in SHAPES.items():
            for G, W in shapes:
                x = torch.zeros((G, W), dtype=torch.int32, device=dev)
                for barrier in SERVED["floor_probe"]:
                    ms, per_iter = slope(torch, lambda n: floor_probe(
                        x, n, args.nops, variant, barrier), args.niter)
                    emit({"G": G, "W": W, "niter": args.niter,
                          "nops": args.nops, "variant": variant,
                          "total_s": ms / 1e3,
                          "us_per_iter": 1e6 * per_iter,
                          "ns_per_op": 1e9 * per_iter / args.nops, **info,
                          "barrier": barrier,
                          "bound_ms": bound_ms("floor", variant, G, W,
                                               args.niter, args.nops)[0]},
                         fh)
    finally:
        if fh is not None:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

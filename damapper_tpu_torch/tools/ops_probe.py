"""Per-op-class cost on the card: the counterpart of the JAX package's
``tools/mosaic_ops.py``.

    python3 -m damapper_tpu_torch.tools.ops_probe [niter] [reps] [--out FILE]

For each pattern of mosaic_ops.py's ``mk_patterns`` (elemwise, roll,
reduce_row, reduce_scal, onehot_grab, scal_arith, cond, butterfly), times
one launch of ``ops.probes.ops_probe`` (``csrc/probes.cu``) whose loop
applies the pattern reps times per iteration (butterfly max(1, reps//7)
times) on x (G, W) and s (G, 1), both ones as in mosaic_ops.py.  Shapes:
mosaic_ops.py's, plus the wave launch's (G=128, W=64); each under the
kernel's two row layouts in turns (``block``: one row per block of W
threads, rolls and reductions through shared memory and block barriers;
``warp``: one row per warp, columns in registers, shuffles and
``redux.sync``, no barrier).  The slope of niter and 5·niter iterations
(CUDA events, after a warm-up) gives ns per application.  Records:
mosaic_ops.py's keys (``ns_per_app``) plus ``us_per_iter``, ``ms`` (the
niter launch), ``device``, ``power_limit``, ``barrier`` and ``bound_ms``;
printed, and appended to --out when given.  Without a CUDA card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import sys

from .probe_run import card, emit, open_card, out_file, slope

# mosaic_ops.py:161, and the wave launch's G=128, W=64
SHAPES = ((8, 128), (32, 128), (128, 128), (8, 64), (32, 64), (128, 64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("niter", nargs="?", type=int, default=3000)
    ap.add_argument("reps", nargs="?", type=int, default=28)
    ap.add_argument("--out", default=None, help="append the records here")
    args = ap.parse_args(argv)
    torch = open_card("ops_probe")
    if torch is None:
        return 2
    from ..ops.probes import (OPS_PATTERNS, SERVED, bound_ms,
                              butterfly_apps, ops_probe)

    dev = torch.device("cuda")
    info = card(torch)
    fh = out_file(args.out)
    try:
        for G, W in SHAPES:
            x = torch.ones((G, W), dtype=torch.int32, device=dev)
            s = torch.ones((G, 1), dtype=torch.int32, device=dev)
            for name in OPS_PATTERNS:
                apps = butterfly_apps(args.reps) if name == "butterfly" \
                    else args.reps
                for barrier in SERVED["ops_probe"]:
                    ms, per_iter = slope(torch, lambda n: ops_probe(
                        x, s, n, args.reps, name, barrier), args.niter)
                    emit({"G": G, "W": W, "pat": name,
                          "ns_per_app": 1e9 * per_iter / apps,
                          "us_per_iter": 1e6 * per_iter, "ms": ms, **info,
                          "barrier": barrier,
                          "bound_ms": bound_ms("ops", name, G, W, args.niter,
                                               reps=args.reps)[0]}, fh)
    finally:
        if fh is not None:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Structural loop costs on the card (carry width, small-minor 3D arrays,
minor-axis concats, one-hot row writes): the counterpart of the JAX
package's ``tools/mosaic_carry.py``.

    python3 -m damapper_tpu_torch.tools.carry_probe [niter] [--out FILE]

For each body of mosaic_carry.py's ``main`` (carry60, 3d_minor4, concat2w,
dbuf_write, dbuf_soa), times one launch of ``ops.probes.carry_probe``
(``csrc/probes.cu``) from mosaic_carry.py's own state (x0 = 0).  Shapes:
mosaic_carry.py's (G = 8, 32, 128 at W=128), plus the wave launch's
(G=128, W=64); each under the kernel's two row layouts in turns
(``block``: one row per block of W threads, the dbuf row max through
shared memory between two barriers; ``warp``: one row per warp, W/32
columns a lane in registers, the row max one ``redux.sync``).  The slope
of niter and 5·niter iterations (CUDA events, after a warm-up) gives µs
per iteration.
Records: mosaic_carry.py's keys (``us_per_iter``) plus ``ms`` (the niter
launch), ``device``, ``power_limit``, ``barrier`` and ``bound_ms``;
printed, and appended to --out when given.  Without a CUDA card it exits
non-zero.
"""

from __future__ import annotations

import argparse
import sys

from .probe_run import card, emit, open_card, out_file, slope

# mosaic_carry.py:70-71, and the wave launch's G=128, W=64
SHAPES = ((8, 128), (32, 128), (128, 128), (128, 64))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("niter", nargs="?", type=int, default=3000)
    ap.add_argument("--out", default=None, help="append the records here")
    args = ap.parse_args(argv)
    torch = open_card("carry_probe")
    if torch is None:
        return 2
    from ..ops.probes import CARRY_BODIES, SERVED, bound_ms, carry_probe

    dev = torch.device("cuda")
    info = card(torch)
    fh = out_file(args.out)
    try:
        for G, W in SHAPES:
            x0 = torch.zeros((G, W), dtype=torch.int32, device=dev)
            for name in CARRY_BODIES:
                for barrier in SERVED["carry_probe"]:
                    ms, per_iter = slope(torch, lambda n: carry_probe(
                        x0, n, name, barrier), args.niter)
                    emit({"name": name, "G": G, "W": W,
                          "us_per_iter": 1e6 * per_iter, "ms": ms, **info,
                          "barrier": barrier,
                          "bound_ms": bound_ms("carry", name, G, W,
                                               args.niter)[0]}, fh)
    finally:
        if fh is not None:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Command-line entry point.

    python -m damapper_tpu_torch.cli damapper [...]   — the mapper (reference damapper.c CLI)

The run is on the CUDA card; set DAMAPPER_DEVICE=cpu to run it on the CPU
(plain PyTorch path).  DAMAPPER_WAVE_PERSISTENT=1 runs the persistent wave
kernels (each lane against its sequence windows in shared memory) in place of
the classic ones; DAMAPPER_WAVE_PACKOPS=1 or DAMAPPER_WAVE_LANEPACK=1 picks
the packed or lane-packed layout of either.  DAMAPPER_INDEX=host|device picks
where the k-mer index and seed match run (default: device on the card, host
on the CPU), DAMAPPER_CHAIN=host|device where the chain sweep runs (default
host), DAMAPPER_JOIN=bsearch|merge|scan|sortg|sort the device join (default
bsearch), and DAMAPPER_PACK_UPLOAD=1 uploads sequences 2-bit packed
instead of as plain bytes.  -v prints the wave mode and these four choices.
"""

from __future__ import annotations

import sys


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "damapper":
        from .pipeline.mapper import main_damapper
        return main_damapper(rest)
    print(f"unknown command {cmd}", file=sys.stderr)
    return 1


if __name__ == "__main__":
    raise SystemExit(main())

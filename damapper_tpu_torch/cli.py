"""Command-line entry point.

    python -m damapper_tpu_torch.cli damapper [...]   — the mapper (reference damapper.c CLI)

The wave engine runs on the CUDA card; set DAMAPPER_DEVICE=cpu to run it on
the CPU (plain PyTorch path).  DAMAPPER_WAVE_PERSISTENT=1 runs the persistent
wave kernels (each lane against its sequence windows in shared memory) in
place of the classic ones; DAMAPPER_WAVE_PACKOPS=1 or DAMAPPER_WAVE_LANEPACK=1
picks the packed or lane-packed layout of either; -v prints the mode.
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

"""A run of the harness with the timed path broken underneath.

    python benchmark/tests/bm_faults.py <fault> <benchmark.run arguments>

from the repository's root.  Faults, each planted in the program before the
run starts:

  half       the .las writer keeps the records of half the block's reads
             (half of the batch left out);
  altered    one record's diffs is off by one where the reporter makes it
             (an answer altered where it is produced);
  unchanged  the chain step returns its state unchanged (no candidate is
             ever added, so no read is aligned).
"""

import sys


def plant(fault: str) -> None:
    from damapper_tpu_torch.io import las as lasio
    from damapper_tpu_torch.ops.chain import ChainState
    from damapper_tpu_torch.pipeline import reporter

    if fault == "half":
        write = lasio.write_las

        def write_half(path, las, tspace):
            write(path, [o for o in las if o.aread % 2 == 0], tspace)
        lasio.write_las = write_half
    elif fault == "altered":
        to_la = reporter.Reporter._to_la

        def to_la_altered(self, m, aread_global, start, best, a_side):
            la = to_la(self, m, aread_global, start, best, a_side)
            if aread_global == 3:
                la.diffs += 1
            return la
        reporter.Reporter._to_la = to_la_altered
    elif fault == "unchanged":
        ChainState.process_hits = lambda self, *a, **k: None
    else:
        raise SystemExit(f"no fault {fault!r}")


if __name__ == "__main__":
    plant(sys.argv[1])
    from benchmark import run
    sys.exit(run.main(sys.argv[2:]))

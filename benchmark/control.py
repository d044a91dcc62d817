"""The control of the comparison: the reference with one guarantee broken.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

For each seed it draws the cell's data as a run does, takes the sample a
run takes when every distinct block was mapped in the window, and puts the
plain reference in the program's place at the cell's own size twice: as it
is, and as the control (ref/mapper.py ``control_wave``: the wave's
give-up lag cut from 250 to 200 antidiagonals, the step a kernel could take
to end its lanes sooner; the configuration states damapper's records
exactly).
It prints one JSON line a seed with the numbers check.py compares, which
the control has to fail.  The program is not run.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import shutil
import sys
import tempfile
import time

from . import cells, check, dazz, gen


def control_numbers(seed: int, cfg: dict, traffic: dict, device,
                    work: pathlib.Path) -> dict:
    genome, blocks = gen.draw_cell(seed, cfg, traffic)
    ref_cut = dazz.write_dam(str(work / "ref"), genome,
                             int(cfg["ref_block_bases"]))
    read_cut = dazz.write_reads(str(work / "reads"), blocks,
                                int(traffic["block_bases"]))
    sample = check.draw_sample(seed, traffic, blocks, range(len(blocks)))
    args = (sample, genome, blocks, ref_cut, read_cut, cfg["options"], work,
            device)
    t0 = time.perf_counter()
    expect = check.reference_answers(*args)
    t1 = time.perf_counter()
    got = check.reference_answers(*args, control=True)
    reads, profiles = check.compare(got, expect)
    return {"seed": seed, "reads": len(sample),
            "records": sum(len(v[0]) for v in expect.values()),
            "reads_differ": reads,
            "profiles_differ": profiles if cfg["options"]["profile"]
            else None,
            "reference_s": t1 - t0, "control_s": time.perf_counter() - t1}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    cat = cells.Catalog()
    wl = cat.workload(args.workload)
    cfg, traffic = cat.config(wl["config"]), cat.traffic(wl["traffic"])
    for seed in args.seeds:
        work = pathlib.Path(tempfile.mkdtemp(prefix="benchmark-control-"))
        try:
            row = control_numbers(seed, cfg, traffic,
                                  torch.device("cuda"), work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

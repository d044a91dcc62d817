"""Time the harness's own set-up of a cell, without the program.

    python3 -m benchmark.setup_time --config <file> --traffic <name> \
        --seed <n> [--check-on cuda|cpu [--check-workers <n> [<n> ...]]]

With glibc's malloc held as ``benchmark/run.py`` holds it (steady_malloc),
it draws the cell's data from the seed and writes its DAZZ files exactly as
``run.py`` does (gen.draw_cell, dazz.write_dam, dazz.write_reads) into a
directory under TMPDIR, and prints the seconds of each step and the
process's peak resident memory by then (``resource.getrusage``).  With
``--check-on`` it also times the plain reference's answers for the sample
that ``check.draw_sample`` draws over read block 0, called as
``run.verify`` calls it, on that device: once for each ``--check-workers``
count (1 runs every read's task in this process; by default as many
workers as ``run.py`` takes, one a CPU this process may run on), each with
a SHA-256 of its answers in order of their keys.  It imports nothing of the
program, so the seconds are the harness's alone; the last line of standard
output is one JSON object of them.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

from . import cells, dazz, gen  # noqa: E402
from .heap import steady_malloc  # noqa: E402


def peak_rss_gb() -> float:
    """This process's peak resident memory so far, in GB (Linux reports
    kilobytes)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def answers_sha256(answers: dict) -> str:
    """A SHA-256 of the reference's answers, {(block, read): (records, -p
    bytes or None)}, in order of their keys."""
    return hashlib.sha256(repr(sorted(answers.items())).encode()).hexdigest()


def measure(cfg: dict, traffic: dict, seed: int, check_on=None,
            check_workers=(None,)) -> dict:
    out = {"start_s": time.perf_counter() - _T0}
    work = pathlib.Path(tempfile.mkdtemp(prefix="setup-time-",
                                         dir=os.environ.get("TMPDIR")))
    try:
        t0 = time.perf_counter()
        genome, blocks = gen.draw_cell(seed, cfg, traffic)
        t1 = time.perf_counter()
        ref_cut = dazz.write_dam(str(work / "ref"), genome,
                                 int(cfg["ref_block_bases"]))
        t2 = time.perf_counter()
        read_cut = dazz.write_reads(str(work / "reads"), blocks,
                                    int(traffic["block_bases"]))
        t3 = time.perf_counter()
        out.update(data_s=t1 - t0, write_dam_s=t2 - t1,
                   write_reads_s=t3 - t2, files_s=t3 - t1,
                   peak_rss_gb=peak_rss_gb(),
                   genome_bases=int(genome.offs[-1]),
                   ref_blocks=len(ref_cut) - 1,
                   block_reads=blocks[0].nreads,
                   block_bases=int(blocks[0].lens.sum()))
        if check_on:
            # the reference loads torch, whose libraries would count in the
            # peak above
            import torch
            from . import check
            device = torch.device(check_on)
            if device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError("no CUDA device is available")
            from .ref.mapper import pool_size
            sample = check.draw_sample(seed, traffic, blocks, [0])
            checks = []
            for workers in check_workers:
                t4 = time.perf_counter()
                expect = check.reference_answers(
                    sample, genome, blocks, ref_cut, read_cut,
                    cfg["options"], work, device, workers=workers)
                if device.type == "cuda":
                    torch.cuda.synchronize()
                checks.append({"workers": workers or pool_size(),
                               "check_s": time.perf_counter() - t4,
                               "answers_sha256": answers_sha256(expect)})
            out.update(check_s=checks[0]["check_s"], checks=checks,
                       cpus=pool_size(), check_reads=len(sample),
                       check_records=sum(len(v[0])
                                         for v in expect.values()),
                       check_device=(torch.cuda.get_device_name(device)
                                     if device.type == "cuda" else "cpu"),
                       peak_rss_gb_with_check=peak_rss_gb())
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.setup_time")
    ap.add_argument("--config", required=True,
                    help="a configuration's file (JSON)")
    ap.add_argument("--traffic", required=True,
                    help="a traffic mix's name (benchmark/traffic/)")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--check-on", choices=("cuda", "cpu"),
                    help="also time the plain reference's check there")
    ap.add_argument("--check-workers", type=int, nargs="+", default=[None],
                    help="the check's worker processes, one check a count")
    args = ap.parse_args(argv)
    steady_malloc()
    cfg = json.loads(pathlib.Path(args.config).read_text())
    traffic = cells.Catalog().traffic(args.traffic)
    out = measure(cfg, traffic, args.seed, args.check_on,
                  args.check_workers)
    print(f"setup_time: {cfg.get('name', args.config)} x {args.traffic} "
          f"seed {args.seed}: start {out['start_s']:.3f} s, data "
          f"{out['data_s']:.3f} s, files {out['files_s']:.3f} s "
          f"(write_dam {out['write_dam_s']:.3f} s, write_reads "
          f"{out['write_reads_s']:.3f} s), peak RSS "
          f"{out['peak_rss_gb']:.3f} GB", file=sys.stderr)
    if args.check_on:
        took = ", ".join(f"{c['check_s']:.3f} s with {c['workers']} "
                         f"workers (answers {c['answers_sha256'][:16]})"
                         for c in out["checks"])
        print(f"setup_time: the reference's {out['check_reads']} reads of "
              f"block 0 hold {out['check_records']} records; it took "
              f"{took} on {out['check_device']}, {out['cpus']} CPUs",
              file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

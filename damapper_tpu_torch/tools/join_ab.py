"""A/B of the seed match's join strategies at a read block's real size.

    python -m damapper_tpu_torch.tools.join_ab [dataset_dir] [reads_block]
        [--ref ref.dam] [--modes bsearch,merge,scan,sortg,sort] [--reps 3]
        [--timeout 900] [--out FILE] [--device cpu]

Times ops.device_index.device_match_seeds_pair (both orientations against
one forward reference index) warm under each DAMAPPER_JOIN mode
(device_index.JOIN_MODES), every call ended by a synchronize: a warm-up
call, then the best of --reps.  Each mode runs in its own process with its
own time limit (--timeout seconds), which loads the blocks, builds the
three indexes (reads forward and reverse-complement from one upload, the
reference) and saves its hits, so a mode that runs away is recorded as
such and cannot hang the tool.  The hit lists must be equal across modes,
field by field (aread, bread, apos, diag), as in the JAX package's tool.

The default dataset is the port bench's 50k-read one (BENCH_NREADS=50000
BENCH_RBSIZE=50000000: 140 Mb in 280 contigs, reads in 50 Mb blocks, under
build/bench/, drawn by damapper_tpu_torch.bench's build_dataset when
missing) and its block reads.1 against the reference.  One row a mode
(seconds, samples, hit counts, query and reference k-mers, index seconds,
max_memory_allocated, whether the hits equal the first mode's, card and
power limit) is printed and appended to --out (default
tools/join_ab_results.jsonl on the card; with --device cpu only an explicit
--out).  Exits 1 if a mode fails, runs out of time or gives other hits.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import tuning

RESULTS = tuning.TOOLS / "join_ab_results.jsonl"
FIELDS = ("aread", "bread", "apos", "diag")


def default_dataset() -> pathlib.Path:
    """The bench's 50k-read dataset, drawn if it is not there yet."""
    from ..bench import Knobs, build_dataset
    k = Knobs(nreads=50_000, rbsize=50_000_000)
    work = k.work()
    build_dataset(work, k)
    return work


def load_indexes(ds, block, ref, dev):
    """(reads fwd index, reads rc index, reference index, db bytes, index
    seconds) of a reads block and the reference on ``dev``."""
    import torch
    from ..ops import device_index as dix
    from ..pipeline import mapper
    reads = mapper.read_block(str(ds / block), [], 20)
    refdb = mapper.read_block(str(ds / ref), [], 20)
    tuning.sync(dev)
    t0 = time.perf_counter()
    rseq = dix.device_upload_seq(reads, dev)
    bf = dix.device_sort_kmers(reads, 20, seq_dev=rseq)
    bc = dix.device_sort_kmers(reads, 20, comp=True, seq_dev=rseq)
    del rseq
    aidx = dix.device_sort_kmers(refdb, 20, device=dev)
    tuning.sync(dev)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return (bf, bc, aidx, reads.sizeof() + refdb.sizeof(),
            time.perf_counter() - t0)


def child(mode, ds, block, ref, reps, hits_path, device) -> dict:
    """One mode in this process: its timing row; saves its hits."""
    import torch
    from ..ops import device_index as dix
    from ..pipeline import mapper
    dev = tuning.open_device(device)
    bf, bc, aidx, dbb, t_index = load_indexes(ds, block, ref, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    os.environ["DAMAPPER_JOIN"] = mode
    mem = mapper._physical_memory()
    ts = []
    for _ in range(reps + 1):
        tuning.sync(dev)
        t0 = time.perf_counter()
        hf, hc = dix.device_match_seeds_pair(bf, bc, aidx, mem, dbb)
        tuning.sync(dev)
        ts.append(time.perf_counter() - t0)
    np.savez(hits_path, **{f"{o}_{f}": getattr(h, f)
                           for o, h in (("f", hf), ("c", hc))
                           for f in FIELDS})
    return {"mode": mode, "seconds": min(ts[1:]), "samples": ts[1:],
            "first_s": ts[0], "nhits_f": int(len(hf.aread)),
            "nhits_c": int(len(hc.aread)), "nq": int(bf.n + bc.n),
            "nref": int(aidx.n), "index_s": t_index,
            "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                     if dev.type == "cuda" else None)}


def run_mode(mode, args, hits_path) -> dict:
    """A mode's row from its own process, bounded by --timeout."""
    cmd = [sys.executable, "-m", "damapper_tpu_torch.tools.join_ab",
           str(args.dataset), args.block, "--ref", args.ref, "--reps",
           str(args.reps), "--child", mode, "--hits", str(hits_path)]
    if args.device:
        cmd += ["--device", args.device]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=args.timeout,
                           cwd=str(tuning.TOOLS.parent.parent))
    except subprocess.TimeoutExpired:
        return {"mode": mode, "status": f"timeout after {args.timeout}s"}
    lines = r.stdout.strip().splitlines()
    if r.returncode != 0 or not lines:
        tail = (r.stderr or "").strip().splitlines()
        return {"mode": mode, "status": f"exit {r.returncode}: "
                + (tail[-1][:300] if tail else "")}
    return dict(json.loads(lines[-1]), status="ok")


def same_hits(a, b) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return set(x.files) == set(y.files) and all(
            np.array_equal(x[f], y[f]) for f in x.files)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", nargs="?", default=None)
    ap.add_argument("block", nargs="?", default="reads.1")
    ap.add_argument("--ref", default="ref.dam")
    ap.add_argument("--modes", default="bsearch,merge,scan,sortg,sort")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=900)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--child", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--hits", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print(json.dumps(child(args.child, pathlib.Path(args.dataset),
                               args.block, args.ref, args.reps, args.hits,
                               args.device)), flush=True)
        return 0
    from ..ops.device_index import JOIN_MODES
    modes = [m for m in args.modes.split(",") if m]
    if not modes or any(m not in JOIN_MODES for m in modes):
        raise ValueError(f"--modes must name some of {JOIN_MODES}")
    dev = tuning.open_device(args.device)
    info = tuning.card_info(dev)
    args.dataset = pathlib.Path(args.dataset or default_dataset())
    out = args.out or (RESULTS if dev.type == "cuda" else None)
    rows, failed = [], []
    with tempfile.TemporaryDirectory(prefix="join_ab_") as tmp:
        first = None
        for mode in modes:
            hits = pathlib.Path(tmp) / f"{mode}.npz"
            rec = run_mode(mode, args, hits)
            if rec["status"] == "ok":
                first = first or hits
                rec["identical_across_modes"] = same_hits(first, hits)
            if rec["status"] != "ok" or not rec["identical_across_modes"]:
                failed.append(mode)
            rec.update(dataset=args.dataset.name, block=args.block, **info,
                       ts=time.time())
            print(json.dumps(rec), flush=True)
            rows.append(rec)
    tuning.append_rows(out, rows)
    print(f"join A/B on {args.dataset.name}/{args.block}: "
          + ", ".join(f"{r['mode']} {r.get('seconds', float('nan')):.4f} s"
                      for r in rows)
          + f"; failed or other hits: {failed or 'none'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

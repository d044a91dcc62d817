"""The device index's build and match, step by step.

    python -m damapper_tpu_torch.tools.index_profile [dataset_dir]
        [reads_block] [--ref ref.dam] [--reps 2] [--out FILE] [--device cpu]

Times, each call ended by a synchronize (torch.cuda.synchronize on the
card), --reps calls of every step of ops.device_index on one reads block
and the reference, as the mapper runs them: the reference's upload
(device_upload_seq) and the reads block's, device_sort_kmers for the reads
(forward and reverse-complement, from the reads' upload) and for the
reference (forward, and comp: the complement-strand index derived from the
same upload), and the match (device_match_seeds_pair under DAMAPPER_JOIN,
default bsearch).  Prints every call's seconds, the k-mer and hit counts
and max_memory_allocated; one JSON record, printed and appended to --out.
The default dataset is bench.py's default (140 Mb in 280 contigs, 1,000
reads, under build/bench/, drawn by damapper_tpu_torch.bench's
build_dataset when missing) and its one reads block; the 50k block is
``<50k dataset> reads.1`` (tools/join_ab.py draws that dataset).
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

from . import tuning


def timed(dev, label, fn, reps, out):
    """reps synchronized calls of fn; their seconds go to out[label]."""
    res = None
    for i in range(reps):
        tuning.sync(dev)
        t0 = time.perf_counter()
        res = fn()
        tuning.sync(dev)
        dt = time.perf_counter() - t0
        out.setdefault(label, []).append(dt)
        print(f"  {label} [{i}]: {dt:.4f} s", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dataset", nargs="?", default=None)
    ap.add_argument("block", nargs="?", default="reads")
    ap.add_argument("--ref", default="ref.dam")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    import torch
    from ..bench import Knobs, build_dataset
    from ..ops import device_index as dix
    from ..pipeline import mapper
    dev = tuning.open_device(args.device)
    info = tuning.card_info(dev)
    if args.dataset is None:
        k = Knobs()
        build_dataset(k.work(), k)
        args.dataset = k.work()
    ds = pathlib.Path(args.dataset)
    t0 = time.perf_counter()
    reads = mapper.read_block(str(ds / args.block), [], 20)
    ref = mapper.read_block(str(ds / args.ref), [], 20)
    print(f"{info}: load {time.perf_counter() - t0:.2f} s, "
          f"{reads.nreads} reads ({reads.totlen:,} bp), reference "
          f"{ref.totlen:,} bp", flush=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    s = {}
    seq = timed(dev, "upload_ref", lambda: dix.device_upload_seq(ref, dev),
                args.reps, s)
    rseq = timed(dev, "upload_reads",
                 lambda: dix.device_upload_seq(reads, dev), args.reps, s)
    bf = timed(dev, "sort_kmers_reads_fwd", lambda: dix.device_sort_kmers(
        reads, 20, seq_dev=rseq), args.reps, s)
    bc = timed(dev, "sort_kmers_reads_rc", lambda: dix.device_sort_kmers(
        reads, 20, comp=True, seq_dev=rseq), args.reps, s)
    del rseq
    aidx = timed(dev, "sort_kmers_ref_fwd", lambda: dix.device_sort_kmers(
        ref, 20, seq_dev=seq), args.reps, s)
    comp = timed(dev, "sort_kmers_ref_comp", lambda: dix.device_sort_kmers(
        ref, 20, comp=True, seq_dev=seq), args.reps, s)
    ncomp = comp.n
    del seq, comp
    dbb = reads.sizeof() + ref.sizeof()
    mem = mapper._physical_memory()
    hf, hc = timed(dev, "match_pair", lambda: dix.device_match_seeds_pair(
        bf, bc, aidx, mem, dbb), args.reps, s)
    rec = dict(dataset=ds.name, block=args.block, join=dix._join_mode(),
               nreads=reads.nreads, reads_bp=int(reads.totlen),
               ref_bp=int(ref.totlen), kmers_reads_fwd=int(bf.n),
               kmers_reads_rc=int(bc.n), kmers_ref_fwd=int(aidx.n),
               kmers_ref_comp=int(ncomp), hits_f=int(len(hf.aread)),
               hits_c=int(len(hc.aread)), seconds=s,
               best={k: min(v) for k, v in s.items()},
               max_memory_allocated=(torch.cuda.max_memory_allocated()
                                     if dev.type == "cuda" else None),
               **info, ts=time.time())
    print(f"hits {rec['hits_f']:,} + {rec['hits_c']:,}; k-mers reads "
          f"{rec['kmers_reads_fwd']:,} + {rec['kmers_reads_rc']:,}, ref "
          f"{rec['kmers_ref_fwd']:,}; max_memory_allocated "
          f"{rec['max_memory_allocated']}", flush=True)
    tuning.append_rows(args.out, [rec])
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of damapper_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed 42] [--nreads 1000] [--glen 4600000]

Phases, in order; any failure exits non-zero and prints no result line:

  1. device   — the card's name, count, and nvidia-smi name and power limit;
                no card is a failure.
  2. build    — nvcc builds csrc/wave.cu for sm_90a (ptxas report printed)
                while g++ builds the native host libraries.
  3. kernel   — the wave kernel against its plain PyTorch version on the
                same CUDA tensors: >=128 lanes of 3-9 kb reads at ~15%
                error plus seeds next to contig ends, W=128, both
                directions.  Every output field and the pool must be equal
                (tolerance 0: integer outputs).
  4. mapping  — the default damapper path (host index and seed match,
                native chain sweep, reporter, wave engine on the card) on
                BASELINE config 1: a 4.6 Mb reference in contigs and 1,000
                simulated PacBio reads of 3-9 kb at ~15% error, -k20
                -e.85.  The wave kernel must have been launched; 64 of the
                run's device lanes, sampled from --seed, are re-aligned by
                the host oracle and must match path and trace.
  5. las      — a small dataset mapped with the card's wave engine and with
                the host oracle: identical .las records and -p track bytes.
  6. kernels  — one JSON line with each ported kernel's launches on the
                mapping run, its agreement with the plain version, and its
                time beside its bound and the plain version's time.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import copy
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory (data sheet)
# H100 SXM float32 peak outside the tensor cores (data sheet); its int32
# rate is no higher, so the time from this rate stays a lower bound
OPS_PER_S = 67e12


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def phase(name):
    print(f"\n=== {name} ===", flush=True)


def phase_device(torch):
    phase("1 device")
    check(torch.cuda.is_available(), "no CUDA device is available")
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(f"device: {name}  count: {count}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return name, count, card


def phase_build():
    phase("2 build")
    from damapper_tpu_torch import native
    from damapper_tpu_torch.ops import wave_cuda
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        jobs = [ex.submit(wave_cuda.build, True), ex.submit(native.kmer_lib),
                ex.submit(native.chain_lib), ex.submit(native.radix_lib)]
        for j in jobs:
            j.result()
    print(f"built in {time.time() - t0:.1f}s")


def _cuda_ms(torch, fn, reps):
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    ev0.record()
    for _ in range(reps):
        out = fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps, out


def _bound(lanes, out):
    """Least time for the work of one launch: each lane must read the A
    and B bases from its seed to its end point once, read its 6 inputs and
    write its 14 results and its pool rows; per wave it does at least one
    operation per byte it compares.  Returns (ms, "bytes"|"operations")."""
    mida = lanes["mida"].cpu().numpy().astype(np.int64)
    k0 = lanes["k0"].cpu().numpy().astype(np.int64)
    o = {f: out[f].cpu().numpy().astype(np.int64)
         for f in ("trima", "trimy", "morem", "morea", "morey", "avail",
                   "waves")}
    reach = o["morem"] >= 0
    ye = np.where(reach, o["morey"], o["trimy"])
    xe = np.where(reach, o["morea"], o["trima"]) - ye
    x0, y0 = (mida + k0) // 2, (mida - k0) // 2
    seq = int(np.abs(xe - x0).sum() + np.abs(ye - y0).sum())
    n = len(mida)
    nbytes = 6 * 4 * n + seq + 14 * 4 * n + 16 * int(o["avail"].sum())
    nops = seq + int(o["waves"].sum())
    tb, to = nbytes / HBM_BYTES_PER_S, nops / OPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def phase_kernel(torch, seed):
    phase("3 kernel vs plain version")
    from damapper_tpu_torch.convert import lanes_from_numpy
    from damapper_tpu_torch.ops.spec import new_align_spec
    from damapper_tpu_torch.ops.wave_cuda import (OUT_FIELDS, wave_lanes,
                                                  wave_lanes_ref)
    from damapper_tpu_torch.utils.sim import make_lane_cases

    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    consts = dict(ts=spec.trace_space, pave=spec.ave_path, msc=spec.mscore,
                  dsc=spec.dscore)
    W, P = 128, 512     # the card's band; the pool bucket of <=9 kb reads
    dev = torch.device("cuda")
    sets = {
        "reads": make_lane_cases(seed, 128, glen=200_000, rlen=9000,
                                 rmin=3000, mix=True, err=0.15),
        # reads spanning almost all of a short contig: every lane clips on
        # the sequence ends in both directions
        "ends": make_lane_cases(seed + 1, 32, glen=9400, rlen=9000,
                                rmin=8500, mix=True, err=0.15),
    }
    timing = {"ms": [], "plain_ms": [], "bound_ms": [], "bound_by": []}
    max_err = 0
    for nm, (seqmem, insts) in sets.items():
        lanes = lanes_from_numpy(insts, seqmem, dev)
        for reverse in (False, True):
            args = dict(consts, W=W, P=P, reverse=reverse)
            wave_lanes(**lanes, **args)          # warm-up
            ms, k = _cuda_ms(torch, lambda: wave_lanes(**lanes, **args), 5)
            t0 = time.time()
            r = wave_lanes_ref(**lanes, **args)
            torch.cuda.synchronize()
            plain_ms = 1e3 * (time.time() - t0)
            bad = {}
            for f in OUT_FIELDS:
                d = (k[f].to(torch.int64) - r[f].to(torch.int64)).abs()
                max_err = max(max_err, int(d.max()))
                bad[f] = int((d != 0).sum())
            dp = (k["pool"].to(torch.int64) - r["pool"]).abs()
            max_err = max(max_err, int(dp.max()))
            bad["pool"] = int((dp != 0).any(2).any(1).sum())
            bms, bby = _bound(lanes, k)
            print(f"{nm} {'rev' if reverse else 'fwd'}: {len(insts)} lanes, "
                  f"waves max {int(k['waves'].max())}, overflow "
                  f"{int(k['overflow'].sum())}; kernel {ms:.3f} ms, plain "
                  f"{plain_ms:.1f} ms, bound {bms:.6f} ms ({bby}); "
                  f"mismatching lanes per field {bad}")
            check(not any(bad.values()),
                  f"kernel and plain version differ on {nm} "
                  f"{'rev' if reverse else 'fwd'}: {bad}")
            if nm == "reads":
                timing["ms"].append(ms)
                timing["plain_ms"].append(plain_ms)
                timing["bound_ms"].append(bms)
                timing["bound_by"].append(bby)
    return dict(max_abs_err=max_err,
                ms=float(np.mean(timing["ms"])),
                plain_ms=float(np.mean(timing["plain_ms"])),
                bound_ms=float(np.mean(timing["bound_ms"])),
                bound_by=timing["bound_by"][0])


def _write_dataset(work, seed, glen, ncontigs, nreads, min_len, max_len,
                   bsize):
    from damapper_tpu_torch.io import db as dbio
    from damapper_tpu_torch.io import fasta
    from damapper_tpu_torch.utils.sim import sim_genome, sim_read
    rng = np.random.default_rng(seed)
    genome = sim_genome(rng, glen)
    clen = glen // ncontigs
    entries = [fasta.FastaEntry(f"ctg{i}", genome[i * clen:(i + 1) * clen])
               for i in range(ncontigs)]
    reads = []
    for _ in range(nreads):
        ci = int(rng.integers(0, ncontigs))
        r, *_ = sim_read(rng, entries[ci].seq, min_len=min_len,
                         max_len=max_len)
        reads.append(r)
    dbio.create_dam(str(work / "ref.dam"), entries, bsize=bsize)
    dbio.create_db(str(work / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)])


def phase_mapping(torch, work, seed, glen, nreads):
    phase("4 mapping: BASELINE config 1")
    from damapper_tpu_torch.ops import wave as host_wave
    from damapper_tpu_torch.ops import wave_engine
    from damapper_tpu_torch.ops.wave_cuda import wave_lanes
    from damapper_tpu_torch.pipeline import mapper

    t0 = time.time()
    _write_dataset(work, seed, glen, max(2, glen // 500_000), nreads,
                   3000, 9000, 260_000_000)
    print(f"dataset: {glen:,} bp reference, {nreads} reads "
          f"({time.time() - t0:.1f}s to simulate and write)")

    # keep each device round's seeds and results for the oracle check (as
    # copies: the reporter fuses paths in place)
    rounds = []
    orig = wave_engine.WaveEngine._batch_inner

    def recording(self, Adev, Bdev, Anp, Bnp, seeds):
        res = orig(self, Adev, Bdev, Anp, Bnp, seeds)
        if len(seeds) >= self.host_min:
            rounds.append((self.spec, Anp, Bnp, seeds, copy.deepcopy(res)))
        return res

    wave_engine.WaveEngine._batch_inner = recording
    try:
        cfg = mapper.DamapperConfig(kmer=20, ave_error=.85)
        torch.cuda.reset_peak_memory_stats()
        wave_lanes.launches = 0
        t0 = time.time()
        a_path, _ = mapper.run_damapper(str(work / "ref.dam"),
                                        str(work / "reads.db"), cfg,
                                        out_dir=str(work))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = wave_lanes.launches
    finally:
        wave_engine.WaveEngine._batch_inner = orig
    st = dict(mapper.LAST_STATS)
    peak = torch.cuda.max_memory_allocated()
    from damapper_tpu_torch.io import las as lasio
    recs, _ = lasio.read_las(a_path)
    ndev = st["n_lanes"] - st["n_fallback"] - st["n_hostmin"]
    print("stage seconds: " + "  ".join(f"{k}={v:.2f}"
                                        for k, v in st["times"].items()))
    print(f"wall {wall:.2f}s  reads/s {nreads / wall:.1f}  "
          f"records {len(recs)}")
    print(f"lanes: {st['n_lanes']} total, {ndev} device, "
          f"{st['n_fallback']} overflow-fallback, {st['n_hostmin']} "
          f"tiny-round host")
    print(f"wave_lanes launches {launches}  kernel time {st['kernel_ms']:.1f}"
          f" ms (CUDA events)  waves {st['total_waves']}  cell updates "
          f"{st['cell_updates']}  align device {st['align_device_s']}s "
          f"host {st['align_host_s']}s")
    print(f"max_memory_allocated {peak} bytes")
    check(launches > 0, "the mapping run launched no wave kernel")
    check(ndev > 0, "no lane of the mapping run ran on the card")
    check(len(recs) > 0, "the mapping run wrote no .las record")

    lanes = [(sp, A, B, s, res) for sp, A, B, seeds, out in rounds
             for s, res in zip(seeds, out)]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(lanes), size=min(64, len(lanes)), replace=False)
    nbad = 0
    for i in pick:
        sp, A, B, s, (ga, gb) = lanes[int(i)]
        ea, eb = host_wave.local_alignment(
            A[s["abase"]:s["abase"] + s["alen"]],
            B[s["bbase"]:s["bbase"] + s["blen"]], sp, int(s["diag"]),
            int(s["diag"]), int(s["anti"]), -1, -1, int(s["flags"]))
        for e, g in ((ea, ga), (eb, gb)):
            nbad += ((e.abpos, e.bbpos, e.aepos, e.bepos, e.diffs,
                      list(e.trace))
                     != (g.abpos, g.bbpos, g.aepos, g.bepos, g.diffs,
                         list(g.trace)))
    print(f"oracle re-alignment of {len(pick)} sampled device lanes: "
          f"{nbad} paths differ")
    check(len(pick) > 0 and nbad == 0,
          "sampled lanes differ from the host oracle")
    return launches


def phase_las(work):
    phase("5 .las identity: wave engine on the card vs host oracle")
    from damapper_tpu_torch.io import las as lasio
    from damapper_tpu_torch.pipeline import mapper
    _write_dataset(work, 11, 60_000, 2, 12, 2000, 6000, 70_000)
    outs = {}
    for nm, kw in (("card", dict(host_min=0)),
                   ("oracle", dict(wave_backend="oracle"))):
        d = work / nm
        d.mkdir()
        a_path, _ = mapper.run_damapper(
            str(work / "ref.dam"), str(work / "reads.db"),
            mapper.DamapperConfig(profile=True, **kw), out_dir=str(d))
        recs, tspace = lasio.read_las(a_path)
        outs[nm] = (tspace, [r.key() for r in recs],
                    [(d / f".reads{e}").read_bytes()
                     for e in (".prof.anno", ".prof.data")])
        if nm == "card":
            check(mapper.LAST_STATS["n_lanes"] > 0,
                  "the card run aligned no lane on the card")
    same_las = outs["card"][:2] == outs["oracle"][:2]
    same_prof = outs["card"][2] == outs["oracle"][2]
    print(f"records {len(outs['card'][1])}: las identical {same_las}, "
          f"-p track identical {same_prof}")
    check(len(outs["card"][1]) > 0, "the small dataset mapped no record")
    check(same_las and same_prof, "card and oracle outputs differ")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--nreads", type=int, default=1000)
    ap.add_argument("--glen", type=int, default=4_600_000)
    args = ap.parse_args(argv)

    if not (HERE / "damapper_tpu_torch" / "csrc" / "wave.cu").exists():
        print("chip_smoke: damapper_tpu_torch is not beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    t_start = time.time()
    name, count, card = phase_device(torch)
    phase_build()
    kern = phase_kernel(torch, args.seed)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "map").mkdir()
        (tmp / "las").mkdir()
        launches = phase_mapping(torch, tmp / "map", args.seed, args.glen,
                                 args.nreads)
        phase_las(tmp / "las")
    phase("6 kernels")
    print(f"total {time.time() - t_start:.1f}s")
    print(card)
    print(json.dumps({"kernels": [dict(
        name="wave_lanes", route="cuda",
        source="damapper_tpu_torch/csrc/wave.cu",
        replaces="damapper_tpu/ops/wave_pallas.py:1524",
        launches=launches, match=kern["max_abs_err"] == 0, **kern,
        library_ms=None)]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of damapper_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py [--seed 42] [--nreads 1000] [--glen 4600000]

Phases, in order; any failure exits non-zero, prints no result line and
ends with {"ok": false, "phase": <the phase>, "error": <the exception>}:

  1. device   — the card's name, count, and nvidia-smi name and power limit;
                no card is a failure.
  2. build    — nvcc builds csrc/wave.cu, csrc/wave_persistent.cu and
                csrc/probes.cu for sm_90a, each in its own process (ptxas
                reports printed), while g++ builds the native host
                libraries.
  3. kernel   — every wave kernel against its plain PyTorch version on the
                same CUDA tensors (tolerance 0: integer outputs; every
                output field and every pool cell below avail), both
                directions: the three classic kernels (plain, packed,
                lanepack) on 128 lanes of 3-9 kb reads at ~15% error, on
                seeds next to contig ends and on the adversarial set
                (utils/sim.py: exact repeats, exact runs of 60-600 bases,
                seeds next to the sequence memory's ends), plain and packed
                at W=128 (the card's band) and W=64, lanepack (one lane a
                64-thread block) at W=64, and all three at W=64 on 8 lanes
                of 40-45 kb reads; the three persistent kernels at W=64 on
                the same sets (the long reads at L=65536), on the 3-9 kb
                reads with a window too small for them (misses), on a
                sequence memory that is a view at byte offset 7 (no bulk
                copy) and on 131,072-base windows that run past the
                memory's end, each with the shipped ring of window chunks,
                and on the reads, long, adversarial and past-the-end sets
                with one 128-byte slot a window too; the lanes an SM holds
                at L = 16,384 and 65,536.  Each launch prints its time and
                ns per wave of its longest lane.
                Then the three op-cost probe kernels (csrc/probes.cu, the
                loops of tools/mosaic_{floor,ops,carry}.py): every pattern
                against its plain version on seeded int32 inputs at G=9
                and G=128 under each kernel's two barrier policies, block
                and warp, at W=64, 128 and, floor only, 256 (G=128, W=128:
                the launches timed for the kernels line, both policies in
                turns; tolerance 0); the SASS of every instantiation
                checked for the pattern's instructions, ptxas's registers
                and spills printed, no barrier in a warp-policy kernel and
                no shared memory in its loops (the carry dbuf bodies'
                slot stores excepted), no half-block barrier left, and the
                block instantiations' parent SASS digests; the three probe
                tools run at their full shapes (their path; records under
                a temporary directory), ns per application and bound
                printed per pattern; and carry60's adds a clock an SM from
                the carry tool's block record, beside the SM clock read
                under load, held under the integer peak of peaks.py.
  4. mapping  — the damapper path (device index and seed match on the card,
                native chain sweep, reporter, wave engine on the card) on
                BASELINE config 1: a 4.6 Mb reference in contigs and 1,000
                simulated PacBio reads of 3-9 kb at ~15% error, -k20 -e.85,
                in six wave modes: classic (the default), classic + packops,
                classic + lanepack, persistent, persistent + packops,
                persistent + lanepack; then classic with the host index and
                classic with the device chain sweep.  Each mode's kernel
                must have been launched, every device index must lie on the
                card; every run's .las records must equal the classic run's;
                64 of each run's device lanes, sampled from --seed, are
                re-aligned by the host oracle and must match path and trace.
                The classic run dumps its rounds (DAMAPPER_WAVE_DUMP), and
                the port's replay tool (tools/wave_replay.py) replays every
                dumped seed on the card, each round as its own batch, and
                holds the lanes of the first 100 reads (an abase range in
                each orientation) to the oracle: no lane may differ.
  4b. genome  — bench.py's default dataset (140 Mb reference in 280 contigs,
                the same reads): classic with the device index twice (the
                second run must hit the reference-index cache) and with the
                host index; identical .las records; then each device-index
                program timed at this size, the join under every
                DAMAPPER_JOIN mode held to the default's.
  5. las      — a small dataset mapped with the card's wave engine in the
                six modes (device index), in the six modes again with the
                packed uploads (DAMAPPER_PACK_UPLOAD=1) and classic with
                the host index, and with the host oracle: identical .las
                records and -p track bytes.
  7. plan     — the plan path on phase 4's DBs: the reads split by the
                port's dbsplit into 4 or 5 blocks, a JSON plan from the
                port's plan subcommand (one block a job, -k20 -e.85), run by
                parallel.launch over two torch.distributed (gloo) ranks that
                share the card, rank 0 running lacheck and lamerge.  Every
                rank must map on the card and launch the classic kernel; the
                merged .las must equal a direct run of the whole DB on the
                card record for record, pass lacheck -vS, and give the same
                lashow -ca bytes; wall times and reads/s of both printed.
  8. mesh     — the sharded mesh path (parallel.mesh) on virtual shards of
                the card: (a) parallel.mesh.dryrun(8) on eight shards of
                cuda:0 as a (dp=4, ref=2) mesh, the 1 Mb repeat-family genome
                and 100 reads mapped single-device and on the mesh, .las
                record-identical; (b) phase 4b's 140 Mb dataset on a (dp=2,
                ref=2) mesh of cuda:0 (sharded reads and reference indexes,
                two sharded matches a block, dp-sharded wave lanes), .las
                record-identical to phase 4b's direct run, then the sharded
                match of both frames timed beside the pair match on the same
                indexes (their hits equal); (c) phase 7's blocks run as a
                plan with launch --global-index over two gloo ranks sharing
                the card (the reference index sharded over the ranks), the
                merged .las equal to phase 7's direct run; each rank's
                mapping wall and cross-rank bytes a job printed.
  9. bench    — the port's timed entry point, python -m
                damapper_tpu_torch.bench, in a subprocess on BASELINE config
                1 (BENCH_GLEN=--glen, BENCH_NREADS=--nreads, two repeats,
                both variants, BENCH_GATE=sample): its JSON line, printed,
                must have no error, .las records equal to its gate runs' for
                the run, -n.95 -C (both files) and -p (and the -p track's
                bytes), no sampled lane differing from the oracle, and
                wave_lanes launched.
  10. tune    — the port's roundout of its tuning tools (damapper_tpu_torch/
                tools/), their records under a temporary directory: the
                build gate of all six wave modes (each built and run on 8
                lanes against the oracle in its own process), the clip fuzz
                of all six modes over 2 seeds x 256 clip cases (0
                mismatches with the oracle), the engine-level mode A/B at
                256 lanes of 6 kb reads (records equal across modes), the
                picker on those rows and the gate's status with --dry-run
                (the pick, and whether it matches the committed mode file),
                the join A/B on phase 4b's 140 Mb block (hits equal in all
                five joins) and the dense twin's switch swept at 128-2,048
                lanes (records equal across the three builds).
  6. kernels  — one JSON line with each ported kernel's launches on its
                path's run (a wave kernel's mapping run; the probe tools'
                run), its agreement with the plain version, and its time
                beside its bound and the plain version's time; launches_plan
                is its count over phase 7's ranks, launches_mesh over phase
                8b's mesh run, launches_coop over phase 8c's ranks,
                launches_bench over phase 9's best timed repeat,
                launches_tune over phase 10's in-process tools (the clip
                fuzz, the mode A/B and the sweep).

Phase 1 also prints the measured mode file and the mode a default engine
resolves to (ops.wave_engine.resolve_wave_mode); from phase 3 on the run pins
the classic mode (DAMAPPER_WAVE_PERSISTENT/PACKOPS/LANEPACK=0, which an
explicit mode argument still overrides), so that a mode file cannot change
what the phases count as the classic mode's launches.

The last line is {"ok": true, "device": {"platform": "gpu", ...}}.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import copy
import io
import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
# ~10 ms of device spin queued ahead of the timed calls: the host enqueues
# all of them meanwhile, so the events time the kernels alone
LEAD_CYCLES = 20_000_000
# copies of phase 3's 128 read lanes in one launch: 1,024 lanes, more than
# the card holds at once at W=128 (csrc/wave.cu's dense kernel)
TILES = 8
# phase 4b's reference: bench.py's default dataset, the BASELINE config-3
# genome size
GENOME_LEN = 140_000_000


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# the phase running now, named by the failure line
PHASE = {"name": "0 setup"}


def phase(name):
    PHASE["name"] = name
    print(f"\n=== {name} ===", flush=True)


def failure_line(exc) -> str:
    """The last line of a failed run: the phase and the exception."""
    return json.dumps({"ok": False, "phase": PHASE["name"],
                       "error": f"{type(exc).__name__}: {exc}"[:500]})


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
    default_mode(torch)
    return name, count, card


def phase_build():
    """Builds every library at once; returns ptxas's report of probes.cu,
    whose registers and spills phase 3 prints."""
    phase("2 build")
    from damapper_tpu_torch import native
    from damapper_tpu_torch.ops import probes, wave_cuda, wave_persistent
    from damapper_tpu_torch.tools import wave_sweep
    t0 = time.time()
    with concurrent.futures.ThreadPoolExecutor(7) as ex:
        probe_job = ex.submit(probes.build_report)
        jobs = [ex.submit(wave_cuda.build, True),
                ex.submit(wave_persistent.build, True),
                ex.submit(native.kmer_lib), ex.submit(native.chain_lib),
                ex.submit(native.radix_lib), ex.submit(native.trace_lib),
                # phase 10's forced builds of the dense twin's switch
                ex.submit(wave_sweep.build_forced)]
        for j in jobs:
            j.result()
        _, report = probe_job.result()
    print(report.strip())
    print(f"built in {time.time() - t0:.1f}s")
    return report


def _cuda_ms(torch, fn, reps=7):
    """Median time of one call of fn (CUDA events around each of `reps`
    calls, after one warm-up call and behind a LEAD_CYCLES spin), and the
    last call's result."""
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(LEAD_CYCLES)
    for e0, e1 in ev:
        e0.record()
        out = fn()
        e1.record()
    torch.cuda.synchronize()
    return float(np.median([e0.elapsed_time(e1) for e0, e1 in ev])), out


def _bound(lanes, out):
    """Least time for the work of one launch: each lane must read the A
    and B bases from its seed to its end point once, read its 6 inputs and
    write its 14 results and its pool rows; per wave it does at least one
    operation per byte it compares.  The same for every kernel: a
    persistent kernel's window staging is its design's cost, not the
    function's.  Returns (ms, "bytes"|"operations")."""
    from damapper_tpu_torch.peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S
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
    tb, to = nbytes / HBM_BYTES_PER_S, nops / INT32_OPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def _path_per_wave(lanes, out):
    """(waves, sequence columns advanced per wave) of the lane with the
    most waves: the wave count that sets a launch's time, and the
    end-to-end advance of that lane's path, in bases of A and B over 2."""
    mida = lanes["mida"].cpu().numpy().astype(np.int64)
    k0 = lanes["k0"].cpu().numpy().astype(np.int64)
    o = {f: out[f].cpu().numpy().astype(np.int64)
         for f in ("trima", "trimy", "morem", "morea", "morey", "waves")}
    i = int(np.argmax(o["waves"]))
    reach = o["morem"][i] >= 0
    ye = o["morey"][i] if reach else o["trimy"][i]
    xe = (o["morea"][i] if reach else o["trima"][i]) - ye
    x0, y0 = (mida[i] + k0[i]) // 2, (mida[i] - k0[i]) // 2
    w = int(o["waves"][i])
    return w, (abs(xe - x0) + abs(ye - y0)) / 2 / max(w, 1)


def _mismatch(torch, k, r):
    """Per-field counts of lanes where kernel k and plain version r differ
    (pool: cells below avail), and the largest absolute difference."""
    from damapper_tpu_torch.ops.wave_cuda import OUT_FIELDS
    bad, err = {}, 0
    for f in OUT_FIELDS:
        d = (k[f].to(torch.int64) - r[f].to(torch.int64)).abs()
        err = max(err, int(d.max()))
        bad[f] = int((d != 0).sum())
    P = r["pool"].shape[1]
    below = torch.arange(P, device=r["pool"].device)[None, :] \
        < r["avail"].to(torch.int64)[:, None]
    dp = (k["pool"].to(torch.int64) - r["pool"].to(torch.int64)).abs() \
        * below[:, :, None]
    err = max(err, int(dp.max()))
    bad["pool"] = int((dp != 0).any(2).any(1).sum())
    return bad, err


def phase_kernel(torch, seed):
    """The three classic kernels against their one plain version, run once
    per set, direction and band.  The reads set also runs TILES times over
    (1,024 lanes), more lanes than the card holds at once at W=128, so
    those launches run the dense W=128 kernel; each copy must equal the
    plain version's lanes."""
    phase("3 kernel vs plain version: classic")
    from damapper_tpu_torch.convert import lanes_from_numpy
    from damapper_tpu_torch.ops.spec import new_align_spec
    from damapper_tpu_torch.ops.wave_cuda import (IN_FIELDS, LAYOUTS,
                                                  OUT_FIELDS, pack_record,
                                                  wave_lanes, wave_lanes_ref)
    from damapper_tpu_torch.utils.sim import (make_adversarial_lane_cases,
                                              make_lane_cases,
                                              make_long_lane_cases)

    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    consts = dict(ts=spec.trace_space, pave=spec.ave_path, msc=spec.mscore,
                  dsc=spec.dscore)
    dev = torch.device("cuda")
    sets = {
        "reads": make_lane_cases(seed, 128, glen=200_000, rlen=9000,
                                 rmin=3000, mix=True, err=0.15),
        # reads spanning almost all of a short contig: every lane clips on
        # the sequence ends in both directions
        "ends": make_lane_cases(seed + 1, 32, glen=9400, rlen=9000,
                                rmin=8500, mix=True, err=0.15),
        # exact repeats, long exact runs, seeds next to the memory's ends
        "adversarial": make_adversarial_lane_cases(seed),
        # 40-45 kb reads (W=64 only; the engine's pool cap)
        "long": make_long_lane_cases(seed + 2, 8)[:2],
    }
    # the band each layout's row reports: the engine's default for it
    band = {"plain": 128, "packed": 128, "lanepack": 64}
    per = {lay: {"ms": {}, "plain_ms": [], "bound_ms": [], "bound_by": [],
                 "max_abs_err": 0} for lay in LAYOUTS}
    for nm, (seqmem, insts) in sets.items():
        lanes = lanes_from_numpy(insts, seqmem, dev)
        rec = pack_record([lanes[f] for f in IN_FIELDS])
        tiled = None
        if nm == "reads":
            tiled = {f: v.repeat(TILES) if f in IN_FIELDS else v
                     for f, v in lanes.items()}
            tiled_rec = pack_record([tiled[f] for f in IN_FIELDS])
        # the pool bucket of <=9 kb reads; 45 kb reads drop ~900 pebbles
        P = 2048 if nm == "long" else 512
        for reverse in (False, True):
            d = "rev" if reverse else "fwd"
            for W in ((64,) if nm == "long" else (128, 64)):
                args = dict(consts, W=W, P=P, reverse=reverse)
                torch.cuda.synchronize()
                t0 = time.time()
                r = wave_lanes_ref(**lanes, **args)
                torch.cuda.synchronize()
                pms = 1e3 * (time.time() - t0)
                wmax, cols = _path_per_wave(lanes, r)
                line = [f"{nm} {d} W={W}: {len(insts)} lanes, waves max "
                        f"{wmax} ({cols:.3f} columns per wave), overflow "
                        f"{int(r['overflow'].sum())}, plain {pms:.1f} ms"]
                for lay in LAYOUTS:
                    if lay == "lanepack" and W != 64:
                        continue
                    # the packed kernel reads the record the engine uploads
                    kw = dict(layout=lay)
                    if lay == "packed":
                        kw["record"] = rec
                    ms, k = _cuda_ms(torch, lambda: wave_lanes(
                        **lanes, **args, **kw))
                    bad, err = _mismatch(torch, k, r)
                    q = per[lay]
                    q["max_abs_err"] = max(q["max_abs_err"], err)
                    line.append(f"  {lay}: {ms:.4f} ms, "
                                f"{1e6 * ms / max(wmax, 1):.1f} ns per wave "
                                f"of the longest lane, mismatching lanes per "
                                f"field {bad}")
                    check(not any(bad.values()),
                          f"classic {lay} kernel and plain version differ "
                          f"on {nm} {d} W={W}: {bad}")
                    if tiled is not None:
                        kwt = dict(kw, record=tiled_rec) if "record" in kw \
                            else kw
                        kt = wave_lanes(**tiled, **args, **kwt)
                        rt = {f: r[f].repeat(TILES, *[1] * (r[f].dim() - 1))
                              for f in (*OUT_FIELDS, "pool")}
                        bad, err = _mismatch(torch, kt, rt)
                        q["max_abs_err"] = max(q["max_abs_err"], err)
                        line.append(f"  {lay}, these lanes {TILES} times over "
                                    f"({TILES * len(insts)} lanes): "
                                    f"mismatching lanes per field {bad}")
                        check(not any(bad.values()),
                              f"classic {lay} kernel and plain version "
                              f"differ on {nm} x{TILES} {d} W={W}: {bad}")
                    if nm == "reads":
                        q["ms"].setdefault(W, []).append(ms)
                        if W == band[lay]:
                            bms, bby = _bound(lanes, k)
                            q["plain_ms"].append(pms)
                            q["bound_ms"].append(bms)
                            q["bound_by"].append(bby)
                print("\n".join(line), flush=True)
    out = {}
    for lay in LAYOUTS:
        q = per[lay]
        print(f"classic {lay}: " + ", ".join(
            f"W={W} {np.mean(v):.4f} ms (fwd, rev {v[0]:.4f}, {v[1]:.4f})"
            for W, v in sorted(q["ms"].items())) + f"; bound "
            f"{np.mean(q['bound_ms']):.6f} ms ({q['bound_by'][0]})")
        out[lay] = dict(max_abs_err=q["max_abs_err"],
                        ms=float(np.mean(q["ms"][band[lay]])),
                        plain_ms=float(np.mean(q["plain_ms"])),
                        bound_ms=float(np.mean(q["bound_ms"])),
                        bound_by=q["bound_by"][0])
    return out


def phase_persistent_kernels(torch, seed):
    """The three persistent kernels against their one plain version.  The
    plain version runs once per set and direction; all layouts and ring
    geometries are held against that one run."""
    phase("3 kernel vs plain version: persistent")
    from damapper_tpu_torch.convert import lanes_from_numpy
    from damapper_tpu_torch.ops.spec import new_align_spec
    from damapper_tpu_torch.ops.wave_cuda import IN_FIELDS, pack_record
    from damapper_tpu_torch.ops.wave_persistent import (
        KERNEL_NAMES, LAYOUTS, lanes_per_sm, ring_bytes,
        wave_lanes_persistent, wave_lanes_persistent_ref, window_length)
    from damapper_tpu_torch.utils.sim import (make_adversarial_lane_cases,
                                              make_lane_cases,
                                              make_long_lane_cases)

    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    consts = dict(ts=spec.trace_space, pave=spec.ave_path, msc=spec.mscore,
                  dsc=spec.dscore)
    W, P = 64, 512
    dev = torch.device("cuda")
    for lay in ("plain", "packed"):
        print(f"{KERNEL_NAMES[lay]}: {ring_bytes()} bytes of ring a lane, "
              f"lanes an SM (fwd, rev) at L = 16,384: "
              f"{lanes_per_sm(16384, lay, False)}, "
              f"{lanes_per_sm(16384, lay, True)}; at L = 65,536: "
              f"{lanes_per_sm(65536, lay, False)}, "
              f"{lanes_per_sm(65536, lay, True)}")

    def with_L(cases):
        seqmem, insts = cases
        return seqmem, insts, window_length(max(s["blen"] for s in insts))

    reads = with_L(make_lane_cases(seed, 128, glen=200_000, rlen=9000,
                                   rmin=3000, mix=True, err=0.15))
    long_ = make_long_lane_cases(seed + 2, 8)
    past = make_lane_cases(seed + 3, 33, glen=60_000, rlen=6000, rmin=300,
                           mix=True, err=0.15)
    sets = {
        "reads": reads,
        "ends": with_L(make_lane_cases(seed + 1, 32, glen=9400, rlen=9000,
                                       rmin=8500, mix=True, err=0.15)),
        # the engine's pool cap: 45 kb reads drop ~900 pebbles a direction
        "long": (long_[0], long_[1], long_[2], 2048),
        # the same reads against windows too small for them
        "miss": (reads[0], reads[1], 2048),
        "adversarial": with_L(make_adversarial_lane_cases(seed)),
        # a sequence memory that is a view at byte offset 7 (not 16-byte
        # aligned: no bulk copy, every read in place)
        "unaligned": with_L(make_lane_cases(seed + 4, 32, err=0.15,
                                            mix=True, rmin=300)),
        # windows of 131,072 bases over a memory of a length no multiple
        # of 16: their tails run past its end
        "past": (np.concatenate([past[0], np.full(7, 4, np.uint8)]),
                 past[1], 131072),
    }
    per = {lay: {"ms": [], "ms_ring128": [], "bound_ms": [], "bound_by": [],
                 "max_abs_err": 0} for lay in LAYOUTS}
    plain_ms = []
    for nm, (seqmem, insts, L, *pool) in sets.items():
        Pn = pool[0] if pool else P
        for reverse in (False, True):
            d = "rev" if reverse else "fwd"
            lanes = lanes_from_numpy(insts, seqmem, dev, L=L,
                                     reverse=reverse)
            if nm == "unaligned":
                base = torch.full((len(seqmem) + 16,), 4, dtype=torch.uint8,
                                  device=dev)
                view = base[7:7 + len(seqmem)]
                view.copy_(lanes["A"])
                check(view.data_ptr() % 16 != 0, "the view is aligned")
                lanes["A"] = lanes["B"] = view
            args = dict(consts, W=W, P=Pn, L=L, reverse=reverse)
            torch.cuda.synchronize()
            t0 = time.time()
            r = wave_lanes_persistent_ref(**lanes, **args)
            torch.cuda.synchronize()
            pms = 1e3 * (time.time() - t0)
            if nm == "reads":
                plain_ms.append(pms)
            # the packed kernel reads the record the engine uploads
            rec = pack_record([lanes[f] for f in IN_FIELDS + ("awst",
                                                              "bwst")])
            wmax = max(int(r["waves"].max()), 1)
            line = [f"{nm} {d}: {len(insts)} lanes, L={L}, plain "
                    f"{pms:.1f} ms, overflow {int(r['overflow'].sum())}, "
                    f"waves max {wmax}"]
            for lay in LAYOUTS:
                # the shipped ring everywhere, and one 128-byte slot a
                # window (an advance at every chunk edge, long runs past
                # the ring) on the reads, long, adversarial and past sets
                rings = ((None, (128, 1)) if nm in ("reads", "long",
                                                    "adversarial", "past")
                         else (None,))
                for ring in rings:
                    kw = dict(layout=lay, ring=ring)
                    if lay == "packed":
                        kw["record"] = rec
                    ms, k = _cuda_ms(torch, lambda: wave_lanes_persistent(
                        **lanes, **args, **kw))
                    if nm == "reads":
                        per[lay]["ms" if ring is None
                                 else "ms_ring128"].append(ms)
                    bad, err = _mismatch(torch, k, r)
                    per[lay]["max_abs_err"] = max(per[lay]["max_abs_err"],
                                                  err)
                    geo = "ring" if ring is None else f"ring{ring}"
                    line.append(f"  {lay}/{geo}: {ms:.4f} ms, "
                                f"{1e6 * ms / wmax:.1f} ns per wave of the "
                                f"longest lane, mismatching lanes "
                                f"{sum(bad.values())}")
                    check(not any(bad.values()),
                          f"persistent {lay} kernel ({geo}) and plain "
                          f"version differ on {nm} {d}: {bad}")
                    if nm == "reads" and ring is None:
                        bms, bby = _bound(lanes, k)
                        per[lay]["bound_ms"].append(bms)
                        per[lay]["bound_by"].append(bby)
            print("\n".join(line), flush=True)
    out = {}
    for lay in LAYOUTS:
        q = per[lay]
        print(f"{KERNEL_NAMES[lay]}: {np.mean(q['ms']):.4f} ms (fwd, rev "
              f"{q['ms'][0]:.4f}, {q['ms'][1]:.4f}), one 128-byte slot "
              f"{np.mean(q['ms_ring128']):.4f} ms, bound "
              f"{np.mean(q['bound_ms']):.6f} ms ({q['bound_by'][0]})")
        out[lay] = dict(max_abs_err=q["max_abs_err"],
                        ms=float(np.mean(q["ms"])),
                        plain_ms=float(np.mean(plain_ms)),
                        bound_ms=float(np.mean(q["bound_ms"])),
                        bound_by=q["bound_by"][0])
    return out


# the probe kernels and the TPU kernels' pallas_calls they replace
PROBES = {"probe_floor": "tools/mosaic_floor.py:62",
          "probe_ops": "tools/mosaic_ops.py:123",
          "probe_carry": "tools/mosaic_carry.py:44"}
# (W, barrier policy) of each probe kernel, as its launchers serve them
PROBE_CASES = {
    "floor": ((64, "block"), (64, "warp"), (128, "block"), (128, "warp"),
              (256, "block"), (256, "warp")),
    "ops": ((64, "block"), (64, "warp"), (128, "block"), (128, "warp")),
    "carry": ((64, "block"), (64, "warp"), (128, "block"), (128, "warp"))}
PROBE_ROW_N = 100   # iterations of the launches timed for the kernels line
# the policy of each probe's route, which the kernels line reports: floor
# and ops on one warp a row; carry by body, the dbuf bodies' row max on one
# warp, the carried adds on a block of W threads, which issues them from
# W/32 warps where one warp would issue them all
PROBE_ROW_BARRIER = {"floor": dict.fromkeys(("mix", "add"), "warp"),
                     "ops": dict.fromkeys(
                         ("elemwise", "roll", "reduce_row", "reduce_scal",
                          "onehot_grab", "scal_arith", "cond", "butterfly"),
                         "warp"),
                     "carry": {"carry60": "block", "3d_minor4": "block",
                               "concat2w": "block", "dbuf_write": "warp",
                               "dbuf_soa": "warp"}}
# carry60 at G=128, W=128 (one row an SM) gives the adds a clock an SM
CARRY_RATE_SHAPE = (128, 128)
CARRY_CLOCK_N = 60_000_000   # iterations of the launch the clock is read under


# SASS the loop bodies of each pattern's kernel must hold under the block
# policy: (regular expression, least count); W-dependent counts are
# callables of W.  MNMX matches VIMNMX and the fused VIADDMNMX; carry60
# must add 1 to each of its sixty carried registers on every trip of its
# loop.
SASS_NEEDS = {
    ("floor", "mix"): ((r"BAR\.SYNC", 2), (r"LDS", 1), (r"STS", 1),
                       (r"MNMX", 1)),
    ("floor", "add"): ((r"LOP3", 2), (r"IADD", 2)),
    ("ops", "elemwise"): ((r"MNMX", 1),),
    ("ops", "roll"): ((r"BAR\.SYNC", 2), (r"LDS", 1), (r"STS", 1)),
    ("ops", "reduce_row"): ((r"SHFL", 5), (r"BAR\.SYNC", 2)),
    ("ops", "reduce_scal"): ((r"SHFL", 5), (r"BAR\.SYNC", 2)),
    ("ops", "onehot_grab"): ((r"SHFL", 5), (r"BAR\.SYNC", 2)),
    ("ops", "scal_arith"): ((r"MNMX", 1),),
    ("ops", "cond"): ((r"BAR\.RED", 1),),
    ("ops", "butterfly"): ((r"BAR\.SYNC",
                            lambda W: 2 * (W.bit_length() - 1)),
                           (r"MNMX", 1)),
    ("carry", "carry60"): ((r"(?:IADD3|VIADD)\s+(R\d+), \1, 0x1\b", 60),),
    ("carry", "3d_minor4"): ((r"IADD", 2),),
    ("carry", "concat2w"): ((r"IADD", 2),),
    ("carry", "dbuf_write"): ((r"SHFL", 5), (r"BAR\.SYNC", 2), (r"STS", 1)),
    ("carry", "dbuf_soa"): ((r"SHFL", 5), (r"BAR\.SYNC", 2), (r"STS", 1)),
}
# ... and under the warp policy (one row a warp), where no kernel may hold
# a barrier or touch shared memory in its loops (but the dbuf bodies, which
# store their slot there and never load it in the loop): the roll and the
# grab one shuffle, the butterfly 6·W/32 - 1 shuffles an application, a row
# reduction one redux.sync, cond one vote, carry60 60·W/32 in-place adds
WARP_SASS_NEEDS = {
    ("floor", "mix"): ((r"SHFL", 1), (r"MNMX", 1)),
    ("floor", "add"): ((r"LOP3", 2), (r"IADD", 2)),
    ("ops", "elemwise"): ((r"MNMX", 1),),
    ("ops", "roll"): ((r"SHFL", 1),),
    ("ops", "reduce_row"): ((r"REDUX", 1),),
    ("ops", "reduce_scal"): ((r"REDUX", 1),),
    ("ops", "onehot_grab"): ((r"SHFL", 1),),
    ("ops", "scal_arith"): ((r"MNMX", 1),),
    ("ops", "cond"): ((r"VOTE", 1),),
    ("ops", "butterfly"): ((r"SHFL", lambda W: 6 * (W // 32) - 1),
                           (r"MNMX", 1)),
    ("carry", "carry60"): ((r"(?:IADD3|VIADD)\s+(R\d+), \1, 0x1\b",
                            lambda W: 60 * (W // 32)),),
    ("carry", "3d_minor4"): ((r"IADD", 2),),
    ("carry", "concat2w"): ((r"IADD", 2),),
    ("carry", "dbuf_write"): ((r"REDUX", 1), (r"SHFL", 1), (r"STS", 1)),
    ("carry", "dbuf_soa"): ((r"REDUX", 1), (r"SHFL", 1), (r"STS", 1)),
}
# the warp kernels that store to shared memory in their loops
WARP_LOOP_STORES = {("carry", "dbuf_write"), ("carry", "dbuf_soa")}
# SASS digests (tools/wave_ab.py sass_digest) of the block-policy
# instantiations as the parent commit of the warp policy (d5f6e6f) built
# them on the H100 machine's nvcc: the warp kernels were added beside them,
# so they must compile to the same code
PROBE_SASS_NVCC = "Build cuda_12.9.r12.9/compiler.36037853_0"
PROBE_PARENT_SASS = {
    "floor add W=64 block": "4f9b106cb19596c7",
    "floor add W=128 block": "3dac94c7126caed6",
    "floor add W=256 block": "a50aec911b6a75b7",
    "floor mix W=64 block": "19853d00d8d18b19",
    "floor mix W=128 block": "349129bfb800a8d5",
    "floor mix W=256 block": "31a1eaab4017b116",
    "ops butterfly W=64 block": "0668c3e7399839d0",
    "ops butterfly W=128 block": "3c5828722cfb18ba",
    "ops cond W=64 block": "7a1021400d6a5720",
    "ops cond W=128 block": "8ff9a36e745dc1a7",
    "ops elemwise W=64 block": "8b2de2ca62c306d7",
    "ops elemwise W=128 block": "89d708db7e34ef90",
    "ops onehot_grab W=64 block": "58f9cddf603e4351",
    "ops onehot_grab W=128 block": "12dd6eabd408c1f0",
    "ops reduce_row W=64 block": "78d259056cd843a1",
    "ops reduce_row W=128 block": "3dd6d5c9d977d7bf",
    "ops reduce_scal W=64 block": "84a76c31a39a230c",
    "ops reduce_scal W=128 block": "05e86ada5a2a0988",
    "ops roll W=64 block": "a378451d52341609",
    "ops roll W=128 block": "c4e0b6cd78dd0a8d",
    "ops scal_arith W=64 block": "5ee2cf7fe64a1886",
    "ops scal_arith W=128 block": "350eb3967acddf63",
    "carry 3d_minor4 W=64 block": "c436681526a038c0",
    "carry 3d_minor4 W=128 block": "ad2612443912a8ca",
    "carry carry60 W=64 block": "83beea3150d0ff53",
    "carry carry60 W=128 block": "a4146c42aa7a502a",
    "carry concat2w W=64 block": "e35cba059fc35954",
    "carry concat2w W=128 block": "dd1a706f41e1058e",
    "carry dbuf_soa W=64 block": "b9a9ec9371d3c331",
    "carry dbuf_soa W=128 block": "d4f920b7c996be14",
    "carry dbuf_write W=64 block": "e4dde4e8443c3c76",
    "carry dbuf_write W=128 block": "1c9a716556430bb3",
}


def _probe_names(probes):
    return {"floor": probes.FLOOR_VARIANTS, "ops": probes.OPS_PATTERNS,
            "carry": probes.CARRY_BODIES}


def _probe_call(probes, kind, name, inp, n, barrier, plain=False):
    """One probe launch (or its plain version) on inp, a (G, W) x or
    (x, s); returns its outputs as a tuple."""
    if kind == "floor":
        return ((probes.floor_probe_ref(inp, n, 96, name),) if plain else
                (probes.floor_probe(inp, n, 96, name, barrier),))
    if kind == "ops":
        return (probes.ops_probe_ref(*inp, n, 28, name) if plain else
                probes.ops_probe(*inp, n, 28, name, barrier))
    return (probes.carry_probe_ref(inp, n, name) if plain else
            probes.carry_probe(inp, n, name, barrier))


def _probe_sass(probes, report):
    """Checks the loop bodies of every instantiation's SASS for its
    pattern's instructions (nvcc must not have deleted or merged the work
    being timed), that no warp-policy kernel holds a barrier or touches
    shared memory in its loops (the dbuf bodies' slot stores excepted), that
    no half-block barrier is left, and that the block instantiations compile
    to the parent's SASS; prints the counts and, from ptxas's report of the
    build, the registers and spills of each."""
    import re
    from damapper_tpu_torch.tools.probe_ab import kernel_key
    from damapper_tpu_torch.tools.wave_ab import (_nvcc, bar_counts,
                                                  loop_ops, ptxas_report,
                                                  sass_counts, sass_digest)
    sass = sass_counts(probes.build())
    names = _probe_names(probes)
    regs = {kernel_key(sym, names): r
            for sym, r in ptxas_report(report).items()}
    nvcc = subprocess.run([_nvcc()[0], "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    check(nvcc == PROBE_SASS_NVCC, f"the parent's probe SASS digests were "
          f"taken with nvcc {PROBE_SASS_NVCC!r}, this is {nvcc!r}: take "
          f"them anew with tools/probe_ab.py")
    half = [sym for sym in sass if "HalfBar" in sym]
    check(not half, f"half-block barrier kernels in the build: {half}")
    seen, same = set(), 0
    for sym, (cnt, text) in sorted(sass.items()):
        key = kernel_key(sym, names)
        if key is None:
            continue
        kind, pat, W, bar = key
        label = f"{kind} {pat} W={W} {bar}"
        ops = loop_ops(text)
        needs = (WARP_SASS_NEEDS if bar == "warp" else SASS_NEEDS)[
            (kind, pat)]
        counts = {}
        for op, least in needs:
            counts[op] = sum(bool(re.search(op, ln)) for ln in ops)
            need = least(W) if callable(least) else least
            check(counts[op] >= need, f"SASS of {label}: {counts[op]} of "
                  f"{op} in its loops, the pattern needs {need}")
        if bar == "warp":
            bars = bar_counts(text.splitlines())
            shared = r"\bLDS" if (kind, pat) in WARP_LOOP_STORES \
                else r"\b(?:LDS|STS)"
            nsh = sum(bool(re.search(shared, ln)) for ln in ops)
            check(not bars and not nsh, f"SASS of {label}: BAR {bars} in "
                  f"the kernel, {nsh} of {shared} in its loops")
        else:
            dig = sass_digest(text)
            check(PROBE_PARENT_SASS.get(label) == dig, f"SASS of {label}: "
                  f"digest {dig}, the parent's "
                  f"{PROBE_PARENT_SASS.get(label)}")
            same += 1
        check(key in regs, f"ptxas's report has no registers for {label}")
        r, st, ld = regs[key]
        print(f"sass {label}: {cnt} instructions, {len(ops)} in loops: "
              + ", ".join(f"{op} {c}" for op, c in counts.items())
              + f"; {r} registers, spill stores {st} B, loads {ld} B")
        seen.add(label)
    want = sum(len(PROBE_CASES[k]) * len(v) for k, v in names.items())
    check(len(seen) == want, f"SASS of {len(seen)} probe kernels found, "
          f"{want} built")
    check(same == len(PROBE_PARENT_SASS), f"{same} block instantiations "
          f"found, the parent built {len(PROBE_PARENT_SASS)}")
    print(f"probe SASS: {want} kernels; the {same} block instantiations "
          f"compile to the parent's SASS ({nvcc})")


def _carry_rate(torch, probes, path):
    """carry60's adds a clock an SM (60·W adds an iteration on the one
    row an SM holds at G=128), from the carry tool's block record at
    CARRY_RATE_SHAPE and one long carry60 launch, each over the SM clock
    nvidia-smi reads while that launch runs (a read counts only if the
    launch had begun before it and had not ended after it, and it must be
    within 10% of the card's maximum clock); held under the integer peak
    of peaks.py."""
    from damapper_tpu_torch.peaks import INT32_OPS_PER_S, SM_CLOCK_HZ, SMS
    G, W = CARRY_RATE_SHAPE
    rec = next(r for r in map(json.loads, path.read_text().splitlines())
               if (r["name"], r["G"], r["W"], r["barrier"])
               == ("carry60", G, W, "block"))
    x0 = torch.zeros((G, W), dtype=torch.int32, device="cuda")
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    probes.carry_probe(x0, CARRY_CLOCK_N, "carry60", "block")
    e1.record()
    clocks = []
    while not e1.query():
        began = e0.query()
        smi = subprocess.run(["nvidia-smi",
                              "--query-gpu=clocks.sm,clocks.max.sm",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=60)
        check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
        if began and not e1.query():
            clocks.append(tuple(float(v) for v in
                                smi.stdout.splitlines()[0].split(",")))
    torch.cuda.synchronize()
    check(clocks, f"no SM clock read while the {CARRY_CLOCK_N}-iteration "
          f"carry60 launch ran")
    clk, clk_max = clocks[len(clocks) // 2]
    check(clk >= 0.9 * clk_max, f"SM clock {clk:.0f} MHz under the carry60 "
          f"launch, not near its maximum {clk_max:.0f} MHz (reads {clocks})")
    long_us = 1e3 * e0.elapsed_time(e1) / CARRY_CLOCK_N
    peak = INT32_OPS_PER_S / (SMS * SM_CLOCK_HZ)
    rates = [60 * W / (us * 1e-6 * clk * 1e6)
             for us in (rec["us_per_iter"], long_us)]
    print(f"carry60 G={G} W={W} block: {rates[0]:.2f} adds a clock an SM "
          f"({rec['us_per_iter']:.5f} us an iteration, the tool's slope; "
          f"one launch of {CARRY_CLOCK_N} iterations {long_us:.5f} us, "
          f"{rates[1]:.2f} adds a clock) at SM clock {clk:.0f} MHz, the "
          f"median of {len(clocks)} reads under that launch (max "
          f"{clk_max:.0f} MHz); peaks.py: {peak:.0f} a clock an SM",
          flush=True)
    check(max(rates) <= peak, f"carry60 adds {max(rates):.2f} a clock an "
          f"SM, over the integer peak of peaks.py ({peak:.0f})")


def phase_probes(torch, seed, work, report):
    """The three probe kernels against their plain versions, their SASS
    (with ptxas's report of the build), then the probe tools at their full
    shapes (their path).  Returns the
    kernels-line fields of each probe kernel and its launches in the tools'
    run."""
    phase("3 kernel vs plain version: probes")
    t_phase = time.time()
    from damapper_tpu_torch.ops import probes
    from damapper_tpu_torch.tools import carry_probe, floor_probe, ops_probe

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    names = _probe_names(probes)
    wrappers = {"floor": probes.floor_probe, "ops": probes.ops_probe,
                "carry": probes.carry_probe}

    def ints(shape):
        return torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                             dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def inputs(kind, G, W, neg_s=False):
        if kind != "ops":
            return ints((G, W))
        s = ints((G, 1))
        return ints((G, W)), (-s.abs() if neg_s else s)

    err = {k: 0 for k in names}

    def compare(kind, name, k, r, where):
        """Holds kernel outputs k against plain outputs r (tolerance 0)."""
        torch.cuda.synchronize()
        for a, b in zip(k, r):
            check(a.shape == b.shape, f"{kind} {name} shapes")
            e = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            err[kind] = max(err[kind], e)
            check(e == 0, f"probe {kind} {name} {where}: kernel and plain "
                  f"version differ by {e}")

    # G=9: the last warp-policy block has warps past G; G=128: the tools'
    # rows under every policy and W
    for kind, pats in names.items():
        cases = [(G, n, W, bar) for G, n in ((9, 5), (128, PROBE_ROW_N))
                 for W, bar in PROBE_CASES[kind]]
        for G, n, W, bar in cases:
            for name in pats:
                for neg in (False, True) if name == "cond" else (False,):
                    inp = inputs(kind, G, W, neg)
                    compare(kind, name,
                            _probe_call(probes, kind, name, inp, n, bar),
                            _probe_call(probes, kind, name, inp, n, bar,
                                        plain=True), f"G={G} W={W} {bar}")
        print(f"probe_{kind}: every pattern equal to the plain version at "
              f"(G, n, W, barrier) {cases}", flush=True)
    _probe_sass(probes, report)

    # the path: the three tools at their full shapes
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    outs = {}
    for kind, tool in (("floor", floor_probe), ("ops", ops_probe),
                       ("carry", carry_probe)):
        outs[kind] = work / f"{kind}.jsonl"
        check(tool.main(["--out", str(outs[kind])]) == 0,
              f"the {kind} probe tool failed")
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"probe tools: {time.time() - t0:.1f}s, launches {launches}")
    for kind, path in outs.items():
        recs = [json.loads(ln) for ln in path.read_text().splitlines()]
        check(recs and launches[kind] > 0, f"the {kind} tool launched "
              f"nothing")
        print(f"{kind} records on {recs[0]['device']}, "
              f"{recs[0]['power_limit']}")
        key = {"floor": "ns_per_op", "ops": "ns_per_app",
               "carry": "us_per_iter"}[kind]
        check(all(np.isfinite(r[key]) and np.isfinite(r["bound_ms"])
                  for r in recs), f"the {kind} tool's records are not "
              f"finite")
        for r in recs:
            if r["G"] == 128 or kind == "floor":
                nm = r.get("variant") or r.get("pat") or r.get("name")
                per = "" if key == "us_per_iter" else \
                    f"{key} {r[key]:.4f}, "
                print(f"{kind} {nm} G={r['G']} W={r['W']} {r['barrier']}: "
                      f"{per}us/iter {r['us_per_iter']:.4f}, bound "
                      f"{r['bound_ms']:.6f} ms")
    _carry_rate(torch, probes, outs["carry"])

    # the kernels line: one launch per pattern at G=128, W=128,
    # PROBE_ROW_N iterations, under each policy the kernel serves in turns,
    # timed, and each output held against the plain version's on the same
    # inputs; a kernel's ms is the mean under its routes
    # (PROBE_ROW_BARRIER), the block policy's mean printed beside it.  No
    # launch may beat its bound.
    out = {}
    for kind, pats in names.items():
        served = probes.SERVED[wrappers[kind].__name__]
        ms = {bar: [] for bar in served}
        rms, pms, bms, bby = [], [], [], []
        for name in pats:
            inp = inputs(kind, 128, 128)
            k = {}
            for bar in served:
                t, k[bar] = _cuda_ms(torch, lambda: _probe_call(
                    probes, kind, name, inp, PROBE_ROW_N, bar))
                ms[bar].append(t)
            torch.cuda.synchronize()
            t0 = time.time()
            r = _probe_call(probes, kind, name, inp, PROBE_ROW_N, "block",
                            plain=True)
            torch.cuda.synchronize()
            pms.append(1e3 * (time.time() - t0))
            for bar in served:
                compare(kind, name, k[bar], r, f"G=128 W=128 {bar} (timed)")
            b, by = probes.bound_ms(kind, name, 128, 128, PROBE_ROW_N)
            rms.append(ms[PROBE_ROW_BARRIER[kind][name]][-1])
            check(min(m[-1] for m in ms.values()) >= b, f"probe {kind} "
                  f"{name}: {min(m[-1] for m in ms.values()):.6f} ms, under "
                  f"its bound {b:.6f} ms: the bound is not one")
            bms.append(b)
            bby.append(by)
        for bar in served:
            print(f"probe_{kind} G=128 W=128 n={PROBE_ROW_N} {bar}: "
                  + ", ".join(f"{nm} {m:.4f} ms"
                              for nm, m in zip(pats, ms[bar]))
                  + f"; mean {np.mean(ms[bar]):.4f} ms")
        print(f"probe_{kind} G=128 W=128 n={PROBE_ROW_N} routes: "
              + ", ".join(f"{nm} {PROBE_ROW_BARRIER[kind][nm]} {m:.4f} ms "
                          f"(plain {p:.1f}, bound {b:.6f})"
                          for nm, m, p, b in zip(pats, rms, pms, bms))
              + f"; mean {np.mean(rms):.4f} ms (block "
              f"{np.mean(ms['block']):.4f} ms)")
        out["probe_" + kind] = dict(
            max_abs_err=err[kind], ms=float(np.mean(rms)),
            plain_ms=float(np.mean(pms)), bound_ms=float(np.mean(bms)),
            bound_by=max(set(bby), key=bby.count))
    print(f"probe phase {time.time() - t_phase:.1f}s")
    return out, {"probe_" + k: v for k, v in launches.items()}


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


# the wave modes of the mapping runs: (name, DamapperConfig switches, the
# kernel the mode must launch)
MODES = tuple(
    (("persistent" if pers else "classic")
     + {"plain": "", "packed": "+packops", "lanepack": "+lanepack"}[lay],
     dict(persistent=pers, packops=lay == "packed",
          lanepack=lay == "lanepack"),
     ("wave_persistent" if pers else "wave_lanes")
     + {"plain": "", "packed": "_packed", "lanepack": "_lanepack"}[lay])
    for pers in (False, True) for lay in ("plain", "packed", "lanepack"))


def _counters():
    """(wrapper, layout, kernel name) of every wave kernel's launch count."""
    from damapper_tpu_torch.ops import wave_cuda, wave_persistent
    return [(mod_fn, lay, names[lay])
            for mod_fn, names in ((wave_cuda.wave_lanes,
                                   wave_cuda.KERNEL_NAMES),
                                  (wave_persistent.wave_lanes_persistent,
                                   wave_persistent.KERNEL_NAMES))
            for lay in wave_cuda.LAYOUTS]


def _zero_launches():
    for fn, lay, _ in _counters():
        setattr(fn, "launches_" + lay, 0)


def _read_launches():
    return {nm: getattr(fn, "launches_" + lay) for fn, lay, nm in
            _counters()}


def _map_once(torch, work, seed, nreads, mode, switches, kernel, tag=None,
              dump=None):
    """One mapping run of the dataset in `work` in one wave mode, with the
    oracle check of 64 sampled device lanes; tag names the run when it is
    not the mode's own.  The index backend is the default (device) unless
    switches ask for the host; every index built must lie on the card.
    dump: a file the run's rounds are dumped to (DAMAPPER_WAVE_DUMP).
    Returns (launches by kernel, .las record keys, LAST_STATS)."""
    from damapper_tpu_torch.io import las as lasio
    from damapper_tpu_torch.ops import device_index as dix
    from damapper_tpu_torch.ops import wave as host_wave
    from damapper_tpu_torch.ops import wave_engine
    from damapper_tpu_torch.pipeline import mapper

    # keep each device round's seeds and results for the oracle check (as
    # copies: the reporter fuses paths in place)
    rounds = []
    orig = wave_engine.WaveEngine._batch_inner
    orig_sort = dix.device_sort_kmers
    built = []

    def recording(self, Adev, Bdev, Anp, Bnp, seeds):
        res = orig(self, Adev, Bdev, Anp, Bnp, seeds)
        if len(seeds) >= self.host_min:
            rounds.append((self.spec, Anp, Bnp, seeds, copy.deepcopy(res)))
        return res

    def recording_sort(*a, **kw):
        idx = orig_sort(*a, **kw)
        built.append((idx.key.device.type, idx.pos.device.type))
        return idx

    tag = tag or mode
    out = work / tag.replace("+", "_").replace(" ", "_")
    out.mkdir()
    wave_engine.WaveEngine._batch_inner = recording
    dix.device_sort_kmers = recording_sort
    if dump is not None:
        os.environ["DAMAPPER_WAVE_DUMP"] = str(dump)
    try:
        cfg = mapper.DamapperConfig(kmer=20, ave_error=.85, **switches)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        t0 = time.time()
        a_path, _ = mapper.run_damapper(str(work / "ref.dam"),
                                        str(work / "reads.db"), cfg,
                                        out_dir=str(out))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = _read_launches()
    finally:
        wave_engine.WaveEngine._batch_inner = orig
        dix.device_sort_kmers = orig_sort
        os.environ.pop("DAMAPPER_WAVE_DUMP", None)
    st = dict(mapper.LAST_STATS)
    peak = torch.cuda.max_memory_allocated()
    recs, _ = lasio.read_las(a_path)
    ndev = st["n_lanes"] - st["n_fallback"] - st["n_hostmin"]
    print(f"--- {tag} (wave_mode {st['wave_mode']}, W={st['band_cap']}, "
          f"index {st['index_backend']}, chain {st['chain_backend']}, "
          f"ref index builds {st['ref_index_builds']}, cache hits "
          f"{st['ref_index_cache_hits']})")
    print("stage seconds: " + "  ".join(f"{k}={v:.2f}"
                                        for k, v in st["times"].items()))
    print(f"wall {wall:.2f}s  reads/s {nreads / wall:.1f}  "
          f"records {len(recs)}")
    want = switches.get("index_backend", "device")
    check(st["index_backend"] == want, f"the {tag} run took the "
          f"{st['index_backend']} index, not the {want} index")
    if want == "device":
        check(built and all(d == ("cuda", "cuda") for d in built),
              f"the {tag} run's device indexes lay on {built}")
    else:
        check(not built, f"the {tag} run built a device index")
    print(f"lanes: {st['n_lanes']} total, {ndev} device, {st['n_winmiss']} "
          f"retried on the classic kernel, {st['n_fallback']} "
          f"overflow-fallback, {st['n_hostmin']} tiny-round host")
    print(f"launches {launches}  kernel time {st['kernel_ms']:.1f} ms "
          f"(CUDA events)  waves {st['total_waves']}  cell updates "
          f"{st['total_waves'] * st['band_cap']}  align device {st['align_device_s']}s "
          f"host {st['align_host_s']}s")
    print(f"max_memory_allocated {peak} bytes")
    check(st["wave_mode"] == mode, f"the run took wave mode "
          f"{st['wave_mode']}, not {mode}")
    check(launches[kernel] > 0, f"the {mode} run launched no {kernel}")
    check(st["kernel_launches"][kernel] == launches[kernel],
          "the engine's launch count disagrees with the wrapper's")
    check(ndev > 0, "no lane of the mapping run ran on the card")
    check(len(recs) > 0, "the mapping run wrote no .las record")

    lanes = [(sp, A, B, s, res) for sp, A, B, seeds, res_ in rounds
             for s, res in zip(seeds, res_)]
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
          f"{nbad} paths differ", flush=True)
    check(len(pick) > 0 and nbad == 0,
          "sampled lanes differ from the host oracle")
    return launches, [r.key() for r in recs], st


# the reads whose lanes the replay of phase 4's dump holds to the oracle
REPLAY_READS = 100


def _replay(torch, work, dump, st):
    """Replay the classic run's dumped rounds with the port's replay tool
    on the card: the engine replays every seed, each as its round's batch,
    and the oracle checks the lanes of the first REPLAY_READS reads (an
    abase range in each orientation); no lane may differ."""
    from damapper_tpu_torch.ops.spec import new_align_spec
    from damapper_tpu_torch.pipeline import mapper
    from damapper_tpu_torch.tools import wave_replay
    t0 = time.time()
    calls = wave_replay.read_dump(dump)
    nseeds = sum(map(len, calls))
    check(nseeds == st["n_lanes"], f"the dump holds {nseeds} seeds, the run "
          f"aligned {st['n_lanes']} lanes")
    reads = mapper.read_block(str(work / "reads.db"), [], 0)
    ref = mapper.read_block(str(work / "ref.dam"), [], 0)
    hi = int(reads.reads["boff"][min(REPLAY_READS, reads.nreads - 1)])
    comp = len(reads.seq)
    ranges = [f"0:{hi}", f"{comp}:{comp + hi}"]
    spec = new_align_spec(.85, 100, ref.freq, True)
    bad, checked, eng = wave_replay.replay(calls, reads, ref, spec, None,
                                           wave_replay.parse_ranges(ranges))
    for ci, li, s, fld, _, _ in bad[:10]:
        print(f"LANE MISMATCH call {ci} lane {li} field {fld} seed {s}")
    print(f"replay of the classic run's dump: {len(calls)} calls, {nseeds} "
          f"seeds replayed on {eng.device} (launches "
          f"{ {k: v for k, v in eng.launches.items() if v} }), {checked} "
          f"lanes of the first {REPLAY_READS} reads ({ranges}) held to the "
          f"oracle, {len(bad)} differ; {time.time() - t0:.1f}s", flush=True)
    check(eng.device.type == "cuda" and eng.launches["wave_lanes"] > 0,
          "the replay launched no wave_lanes on the card")
    check(checked > 0 and not bad, f"{len(bad)} replayed lanes differ from "
          f"the oracle")


# runs of the classic mode beside the six wave modes: (name, switches)
CLASSIC_RUNS = (("classic, host index", dict(index_backend="host")),
                ("classic, device chain", dict(chain_backend="device")))


def phase_mapping(torch, work, seed, glen, nreads):
    phase("4 mapping: BASELINE config 1, six wave modes, device index")
    t_phase = t0 = time.time()
    _write_dataset(work, seed, glen, max(2, glen // 500_000), nreads,
                   3000, 9000, 260_000_000)
    print(f"dataset: {glen:,} bp reference, {nreads} reads "
          f"({time.time() - t0:.1f}s to simulate and write)")
    launches, keys, stats = {}, {}, {}
    dump = work / "classic_rounds.pkl"
    for mode, switches, kernel in MODES:
        got, keys[mode], stats[mode] = _map_once(
            torch, work, seed, nreads, mode, switches, kernel,
            dump=dump if mode == "classic" else None)
        launches[kernel] = got[kernel]
        if mode == "classic":
            _replay(torch, work, dump, stats[mode])
    for tag, switches in CLASSIC_RUNS:
        _, keys[tag], stats[tag] = _map_once(
            torch, work, seed, nreads, "classic", switches, "wave_lanes",
            tag=tag)
    for mode in [m for m, _, _ in MODES[1:]] + [t for t, _ in CLASSIC_RUNS]:
        same = keys[mode] == keys["classic"]
        print(f"{mode}: .las records identical to the classic run: {same}")
        check(same, f"the {mode} run's .las records differ from the classic "
              f"run's")
    c, h, d = (stats[k]["times"] for k in ("classic", CLASSIC_RUNS[0][0],
                                           CLASSIC_RUNS[1][0]))
    print(f"index + match seconds: device {c['index']:.3f} + "
          f"{c['match']:.3f}, host {h['index']:.3f} + {h['match']:.3f}; "
          f"chain seconds: host sweep {c['chain']:.3f}, device sweep "
          f"{d['chain']:.3f}")
    print(f"mapping phase {time.time() - t_phase:.1f}s")
    return launches


def _sync_ms(torch, fn, reps=3):
    """Median wall of `reps` calls of fn, each between two synchronizes
    (host clock: the calls pull scalars or hits and wait for the card
    anyway), and the last call's result."""
    ts = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ts.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(ts)), out


def _index_programs(torch, work, dev):
    """The device index's programs at the dataset's full size, each timed
    (median of 3 synchronized calls) on the block the mapping runs index:
    the packed and plain uploads and the unpack alone, the three index
    builds, the join under every DAMAPPER_JOIN mode (its b-ranges held to
    the default's) and the pair match under every mode (its hits held to
    the default's), the count epilogue, the -M limit, the emission of
    each orientation.  Returns {program: ms}."""
    from damapper_tpu_torch.ops import device_index as dix
    from damapper_tpu_torch.pipeline import mapper
    reads = mapper.read_block(str(work / "reads.db"), [], 20)
    ref = mapper.read_block(str(work / "ref.1.dam"), [], 20)
    ms = {}
    ms["upload_plain_ref"], seq = _sync_ms(
        torch, lambda: dix.device_upload_seq(ref, dev))
    os.environ["DAMAPPER_PACK_UPLOAD"] = "1"
    try:
        ms["upload_packed_ref"], packed = _sync_ms(
            torch, lambda: dix.device_upload_seq(ref, dev))
    finally:
        del os.environ["DAMAPPER_PACK_UPLOAD"]
    check(torch.equal(seq, packed), "the packed and plain uploads differ")
    del packed
    cap = seq.shape[0]
    b = np.asarray(ref.reads["boff"], np.int64)
    rcap = dix._bucket(len(b), lo=1 << 8)
    st = np.zeros(rcap, np.int32)
    en = np.zeros(rcap, np.int32)
    st[:len(b)] = b
    en[:len(b)] = b + ref.reads["rlen"]
    pk = torch.from_numpy(dix.pack_seq(ref.seq, cap)).to(dev)
    st, en = torch.from_numpy(st).to(dev), torch.from_numpy(en).to(dev)
    ms["unpack_ref"], un = _sync_ms(
        torch, lambda: dix.unpack_seq_dev(pk, st, en))
    check(torch.equal(un, seq), "the unpack differs from the upload")
    del pk, un
    rseq = dix.device_upload_seq(reads, dev)
    ms["build_ref"], aidx = _sync_ms(
        torch, lambda: dix.device_sort_kmers(ref, 20, seq_dev=seq))
    del seq
    ms["build_reads_fwd"], bf = _sync_ms(
        torch, lambda: dix.device_sort_kmers(reads, 20, seq_dev=rseq))
    ms["build_reads_rc"], bc = _sync_ms(
        torch, lambda: dix.device_sort_kmers(reads, 20, comp=True,
                                             seq_dev=rseq))
    del rseq
    btight = dix._tight_bucket(aidx.n, aidx.key.shape[0])
    bkey = aidx.key[:btight]
    q = torch.cat([bf.key, bc.key])
    nq = bf.key.shape[0]
    mem = mapper._physical_memory()
    db_bytes = reads.sizeof() + ref.sizeof()
    base = hits0 = None
    for mode in ("bsearch", "merge", "scan", "sortg", "sort"):
        ms[f"join_{mode}"], rng_ = _sync_ms(torch, lambda: dix._join_ranges(
            bkey, aidx.n, q, mode, qsplit=nq if mode == "merge" else None))
        if base is None:
            base = rng_
        check(all(torch.equal(x, y) for x, y in zip(base, rng_)),
              f"join {mode} gives other b-ranges than bsearch")
        os.environ["DAMAPPER_JOIN"] = mode
        try:
            ms[f"match_pair_{mode}"], hits = _sync_ms(
                torch, lambda: dix.device_match_seeds_pair(
                    bf, bc, aidx, mem, db_bytes), reps=1)
        finally:
            del os.environ["DAMAPPER_JOIN"]
        if hits0 is None:
            hits0 = hits
        check(all(np.array_equal(getattr(x, f), getattr(y, f))
                  for x, y in zip(hits0, hits)
                  for f in ("aread", "bread", "apos", "diag")),
              f"the pair match under join {mode} gives other hits")
    b_lo, b_hi = base
    ms["count_epilogue"], (cb, ct, gram) = _sync_ms(
        torch, lambda: dix._count_epilogue(bf.key, bf.n, b_lo[:nq],
                                           b_hi[:nq], True))
    avail = dix._avail_budget(mem, db_bytes, bf.n, aidx.n)
    ms["device_limit"], limit = _sync_ms(
        torch, lambda: dix._device_limit(gram, min(max(avail, 0),
                                                   dix._IMAX)))
    ms["emit_fwd"], hf = _sync_ms(torch, lambda: dix._finish_match(
        bf, aidx, b_lo[:nq], cb, ct, gram, mem, db_bytes, False))
    cb2, ct2, gram2 = dix._count_epilogue(bc.key, bc.n, b_lo[nq:],
                                          b_hi[nq:], True)
    ms["emit_comp"], hc = _sync_ms(torch, lambda: dix._finish_match(
        bc, aidx, b_lo[nq:], cb2, ct2, gram2, mem, db_bytes, True))
    check(len(hf) == len(hits0[0]) and len(hc) == len(hits0[1]),
          "the emission's hit counts differ from the pair match's")
    print(f"index programs at {len(ref.seq):,} reference bases (cap "
          f"{aidx.key.shape[0]:,}, {aidx.n:,} k-mers, tight {btight:,}), "
          f"{len(reads.seq):,} read bases ({bf.n:,} + {bc.n:,} k-mers), "
          f"{len(hf):,} + {len(hc):,} hits; ms per call:")
    print("  " + "  ".join(f"{k}={v:.2f}" for k, v in ms.items()))
    return ms


def phase_genome(torch, work, seed, glen, nreads):
    """The BASELINE config-3 genome size (bench.py's default dataset):
    mapped with the device index (twice: the second run hits the
    reference-index cache) and with the host index, classic wave; the
    .las records must be identical.  Then the index programs timed."""
    phase(f"4b mapping: {glen:,} bp genome, device vs host index")
    t_phase = t0 = time.time()
    _write_dataset(work, seed, glen, max(2, glen // 500_000), nreads,
                   3000, 9000, 260_000_000)
    print(f"dataset: {glen:,} bp reference, {nreads} reads "
          f"({time.time() - t0:.1f}s to simulate and write)")
    keys, stats = {}, {}
    for tag, switches in (("device index", {}),
                          ("device index, cached", {}),
                          ("host index", dict(index_backend="host"))):
        _, keys[tag], stats[tag] = _map_once(
            torch, work, seed, nreads, "classic", switches, "wave_lanes",
            tag=tag)
    check((stats["device index"]["ref_index_builds"],
           stats["device index, cached"]["ref_index_cache_hits"]) == (1, 1),
          "the second device-index run did not hit the reference-index "
          "cache")
    for tag in ("device index, cached", "host index"):
        same = keys[tag] == keys["device index"]
        print(f"{tag}: .las records identical to the device-index run: "
              f"{same}")
        check(same, f"the {tag} run's .las records differ")
    torch.cuda.reset_peak_memory_stats()
    progs = _index_programs(torch, work, torch.device("cuda"))
    print(f"index programs: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes")
    print(f"genome phase {time.time() - t_phase:.1f}s")
    return progs, keys["device index"]


def phase_las(work):
    phase("5 .las identity: wave engine on the card vs host oracle")
    from damapper_tpu_torch.io import las as lasio
    from damapper_tpu_torch.pipeline import mapper
    _write_dataset(work, 11, 60_000, 2, 12, 2000, 6000, 70_000)
    outs = {}
    runs = [(f"card_{mode.replace('+', '_')}", dict(host_min=0, **switches))
            for mode, switches, _ in MODES]
    runs.append(("card_classic_host_index",
                 dict(host_min=0, index_backend="host")))
    # the packed uploads (DAMAPPER_PACK_UPLOAD=1): bucket-padded sections
    # with a sentinel tail, which every wave kernel must read as it reads
    # the plain bytes
    runs += [(f"card_{mode.replace('+', '_')}_packed_upload",
              dict(host_min=0, pack_upload=True, **switches))
             for mode, switches, _ in MODES]
    for nm, kw in runs + [("oracle", dict(wave_backend="oracle"))]:
        d = work / nm
        d.mkdir()
        kw = dict(kw)
        if kw.pop("pack_upload", False):
            os.environ["DAMAPPER_PACK_UPLOAD"] = "1"
        try:
            a_path, _ = mapper.run_damapper(
                str(work / "ref.dam"), str(work / "reads.db"),
                mapper.DamapperConfig(profile=True, **kw), out_dir=str(d))
        finally:
            os.environ.pop("DAMAPPER_PACK_UPLOAD", None)
        recs, tspace = lasio.read_las(a_path)
        outs[nm] = (tspace, [r.key() for r in recs],
                    [(d / f".reads{e}").read_bytes()
                     for e in (".prof.anno", ".prof.data")])
        if nm != "oracle":
            check(mapper.LAST_STATS["n_lanes"] > 0,
                  f"the {nm} run aligned no lane on the card")
        want = kw.get("index_backend", "device")
        check(mapper.LAST_STATS["index_backend"] == want,
              f"the {nm} run took the {mapper.LAST_STATS['index_backend']} "
              f"index, not the {want} index")
    for nm, _ in runs:
        same_las = outs[nm][:2] == outs["oracle"][:2]
        same_prof = outs[nm][2] == outs["oracle"][2]
        print(f"{nm}: records {len(outs[nm][1])}, las identical {same_las}, "
              f"-p track identical {same_prof}")
        check(len(outs[nm][1]) > 0, "the small dataset mapped no record")
        check(same_las and same_prof, f"{nm} and oracle outputs differ")


def _rank_lines(log, rank, what):
    """The rest of each of rank's log lines that start with `what`."""
    head = f"[rank {rank}] {what} "
    return [ln[len(head):] for ln in log.splitlines() if ln.startswith(head)]


def _lashow_ca(env, dbs, las_dir):
    """Start `lashow -ca` of las_dir/reads.ref.las (named relative to
    las_dir, so both runs print the same header) in its own process."""
    return subprocess.Popen(
        [sys.executable, "-m", "damapper_tpu_torch.cli", "lashow", "-ca",
         str(dbs / "ref.dam"), str(dbs / "reads.db"), "reads.ref.las"],
        cwd=str(las_dir), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)


def phase_plan(torch, src, work, nreads, name):
    """The plan path: phase 4's DBs split into blocks, planned and run over
    two ranks on the one card, held to a direct run of the whole DB."""
    phase("7 plan: BASELINE config 1 over two ranks on one card")
    from damapper_tpu_torch import cli
    from damapper_tpu_torch.io import db as dbio
    from damapper_tpu_torch.io import las as lasio
    from damapper_tpu_torch.parallel import launch
    from damapper_tpu_torch.pipeline import mapper
    t_phase = time.time()
    for f in src.iterdir():
        if f.is_file():
            shutil.copy2(f, work / f.name)
    cwd = os.getcwd()
    os.chdir(work)
    try:
        # blocks of 1/4.5 of the reads' bases: 4 or 5 blocks
        totlen = dbio.DazzDB.open("reads.db").totlen
        check(cli.main(["dbsplit", f"-s{totlen / 4.5e6:.6f}",
                        "reads.db"]) == 0, "dbsplit failed")
        nblocks = dbio.read_stub("reads.db").nblocks
        check(nblocks >= 4, f"dbsplit made {nblocks} blocks, not 4 or more")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["plan", "-fjson", "-B1", "-k20", "-e.85", "ref",
                           "reads"])
        check(rc == 0, "the plan subcommand failed")
    finally:
        os.chdir(cwd)
    plan = json.loads(buf.getvalue())
    check(len(plan["jobs"]) == nblocks and plan["merge"],
          "the plan has not one job a block and a merge")
    print(f"{nblocks} blocks; jobs: "
          + "; ".join(j["cmd"] for j in plan["jobs"]))
    res = launch.run_plan_multihost(json.dumps(plan), nprocs=2,
                                    workdir=str(work))
    for r, log in enumerate(res["logs"]):
        print(f"--- rank {r} log ---\n{log.rstrip()}")
    check(res["rc"] == 0, f"the plan run exited {res['rc']}")
    launches, rank_s = {}, []
    for r, log in enumerate(res["logs"]):
        check(_rank_lines(log, r, "exit") == ["rc=0"],
              f"rank {r} did not exit 0")
        mapped = _rank_lines(log, r, "blocks")
        mine = [j["blocks"] for j in plan["jobs"] if j["host"] % 2 == r]
        check(len(mapped) == len(mine) + 1 and all(
            ln.endswith(f" on cuda:0 ({name})") for ln in mapped[:-1]),
            f"rank {r}'s log does not name the card for each of its "
            f"{len(mine)} jobs")
        rank_s.append(float(mapped[-1].split(" in ")[1].rstrip("s")))
        got = json.loads(_rank_lines(log, r, "launches")[0])
        check(got["wave_lanes"] > 0, f"rank {r} launched no wave_lanes")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
    merged = work / "reads.ref.las"
    check(cli.main(["lacheck", "-vS", str(merged)]) == 0,
          "lacheck -vS fails on the merged .las")

    direct = work / "direct"
    direct.mkdir()
    cfg = mapper.DamapperConfig(kmer=20, ave_error=.85)
    torch.cuda.synchronize()
    t0 = time.time()
    a_path, _ = mapper.run_damapper(str(work / "ref.dam"),
                                    str(work / "reads.db"), cfg,
                                    out_dir=str(direct))
    torch.cuda.synchronize()
    direct_s = time.time() - t0
    recs, tspace = lasio.read_las(str(merged))
    drecs, dtspace = lasio.read_las(a_path)
    same = tspace == dtspace and lasio.las_equal(recs, drecs)
    print(f"merged .las: {len(recs)} records, identical to the direct "
          f"run's {len(drecs)}: {same}")
    check(same and len(recs) > 0, "the merged .las differs from the direct "
          "run's")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(HERE) + os.pathsep + env.get("PYTHONPATH", "")
    shows = [_lashow_ca(env, work, d) for d in (work, direct)]
    try:
        outs = [p.communicate(timeout=600) for p in shows]
    finally:
        for p in shows:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(shows, outs):
        check(p.returncode == 0, f"lashow -ca failed: {err.decode()[-500:]}")
    print(f"lashow -ca: {len(outs[0][0])} bytes, identical: "
          f"{outs[0][0] == outs[1][0]}")
    check(outs[0][0] == outs[1][0], "lashow -ca of the merged and the "
          "direct .las differ")
    print(f"plan wall {res['seconds']:.2f}s (rank walls "
          + ", ".join(f"{s:.2f}s" for s in rank_s)
          + f"): reads/s {nreads / res['seconds']:.1f}; direct run "
          f"{direct_s:.2f}s: reads/s {nreads / direct_s:.1f}")
    print(f"plan launches {launches}")
    print(f"plan phase {time.time() - t_phase:.1f}s")
    return launches, (dtspace, [r.key() for r in drecs])


def _sharded_match_ms(torch, work, mesh):
    """Phase 4b's block matched by the sharded match (both frames) and by
    the pair match on the same indexes, each timed (median of 3
    synchronized calls); their hits must be equal.  Returns {step: ms}."""
    from damapper_tpu_torch.ops import device_index as dix
    from damapper_tpu_torch.pipeline import mapper
    reads = mapper.read_block(str(work / "reads.db"), [], 20)
    ref = mapper.read_block(str(work / "ref.1.dam"), [], 20)
    dev = torch.device("cuda")
    rseq = dix.device_upload_seq(reads, dev)
    bf = dix.device_sort_kmers(reads, 20, seq_dev=rseq)
    bc = dix.device_sort_kmers(reads, 20, comp=True, seq_dev=rseq)
    del rseq
    aidx = dix.device_sort_kmers(ref, 20, device=dev)
    mem = mapper._physical_memory()
    db_bytes = reads.sizeof() + ref.sizeof()
    ms = {}
    ms["shard_index"], (sf, sc, sa) = _sync_ms(torch, lambda: (
        dix.shard_index(bf, mesh, "dp"), dix.shard_index(bc, mesh, "dp"),
        dix.shard_index(aidx, mesh, "ref")))
    ms["match_sharded_fwd"], hf = _sync_ms(
        torch, lambda: dix.device_match_seeds_sharded(sf, sa, mesh, mem,
                                                      db_bytes))
    ms["match_sharded_comp"], hc = _sync_ms(
        torch, lambda: dix.device_match_seeds_sharded(
            sc, sa, mesh, mem, db_bytes, comp_frame=True))
    ms["match_pair"], (pf, pc) = _sync_ms(
        torch, lambda: dix.device_match_seeds_pair(bf, bc, aidx, mem,
                                                   db_bytes))
    check(all(np.array_equal(getattr(x, f), getattr(y, f))
              for x, y in ((hf, pf), (hc, pc))
              for f in ("aread", "bread", "apos", "diag")),
          "the sharded match's hits differ from the pair match's")
    print(f"sharded match at {len(ref.seq):,} reference bases on a "
          f"{mesh.shape} mesh: {len(hf):,} + {len(hc):,} hits (equal to the "
          f"pair match's); ms per call: "
          + "  ".join(f"{k}={v:.2f}" for k, v in ms.items()))
    return ms


def _coop_plan(torch, src, work, direct, nreads, name):
    """Phase 7's blocks and plan, run with launch --global-index over two
    ranks sharing the card; the merged .las must equal phase 7's direct
    run.  Returns the ranks' summed launches."""
    from damapper_tpu_torch import cli
    from damapper_tpu_torch.io import las as lasio
    from damapper_tpu_torch.parallel import launch
    for f in src.iterdir():
        if f.is_file() and (f.name.startswith(".")
                            or f.suffix in (".db", ".dam")):
            shutil.copy2(f, work / f.name)
    plan = json.loads((src / "plan.json").read_text())
    res = launch.run_plan_multihost(json.dumps(plan), nprocs=2,
                                    workdir=str(work), global_index=True)
    for r, log in enumerate(res["logs"]):
        print(f"--- rank {r} log ---\n{log.rstrip()}")
    check(res["rc"] == 0, f"the --global-index plan run exited {res['rc']}")
    launches, rank_s, gloo = {}, [], []
    for r, log in enumerate(res["logs"]):
        check(_rank_lines(log, r, "exit") == ["rc=0"],
              f"rank {r} did not exit 0")
        mapped = _rank_lines(log, r, "blocks")
        check(len(mapped) == len(plan["jobs"]) + 1 and all(
            ln.endswith(f" on cuda:0 ({name}) (global mesh)")
            for ln in mapped[:-1]),
            f"rank {r} did not run every job on the card's global mesh")
        rank_s.append(float(mapped[-1].split(" in ")[1].rstrip("s")))
        got = json.loads(_rank_lines(log, r, "launches")[0])
        check(got["wave_lanes"] > 0, f"rank {r} launched no wave_lanes")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        gloo.append([json.loads(x) for x in _rank_lines(log, r, "gloo")])
        check(len(gloo[-1]) == len(plan["jobs"])
              and all(g["bytes"] > 0 for g in gloo[-1]),
              f"rank {r}'s jobs moved no bytes across the ranks")
    merged = work / "reads.ref.las"
    check(cli.main(["lacheck", "-vS", str(merged)]) == 0,
          "lacheck -vS fails on the merged .las")
    recs, tspace = lasio.read_las(str(merged))
    same = (tspace, [r.key() for r in recs]) == direct
    print(f"merged .las: {len(recs)} records, identical to phase 7's "
          f"direct run's {len(direct[1])}: {same}")
    check(same and len(recs) > 0, "the --global-index .las differs from "
          "the direct run's")
    per_job = [g["bytes"] for g in gloo[0]]
    print(f"coop plan wall {res['seconds']:.2f}s (rank mapping walls "
          + ", ".join(f"{s:.2f}s" for s in rank_s)
          + f"): reads/s {nreads / res['seconds']:.1f}; cross-rank bytes "
          f"a job (rank 0; one reference block a job) {per_job}, "
          f"collectives {[g['collectives'] for g in gloo[0]]}")
    print(f"coop launches {launches}")
    return launches


def phase_mesh(torch, tmp, seed, nreads, name, genome_keys, direct):
    """The sharded mesh path on virtual shards of the card."""
    from damapper_tpu_torch.parallel import mesh as pmesh
    t_phase = time.time()
    phase("8a mesh: dryrun(8) on eight virtual shards of cuda:0")
    t0 = time.time()
    out = pmesh.dryrun_multichip(8)
    for nm in ("single", "mesh"):
        st = out[nm]
        print(f"--- dryrun {nm} (mesh {st['mesh']}): stage seconds "
              + "  ".join(f"{k}={v:.2f}" for k, v in st["times"].items())
              + f"; lanes {st['n_lanes']}, launches "
              f"{st['kernel_launches']}")
    check(out["mesh"]["mesh"] == {"dp": 4, "ref": 2},
          f"the dryrun's mesh was {out['mesh']['mesh']}")
    check(out["mesh"]["kernel_launches"]["wave_lanes"] > 0,
          "the dryrun's mesh run launched no wave_lanes")
    print(f"dryrun(8): {out['records']} records, identical; "
          f"{time.time() - t0:.1f}s")

    phase("8b mesh: phase 4b's genome on a (dp=2, ref=2) mesh of cuda:0")
    work = tmp / "genome"
    mesh = pmesh.make_mesh(4, ref_shards=2, devices=["cuda:0"] * 4)
    check(mesh.shape == {"dp": 2, "ref": 2}, f"mesh {mesh.shape}")
    launches, keys, st = _map_once(torch, work, seed, nreads, "classic",
                                   dict(mesh=mesh), "wave_lanes",
                                   tag="mesh dp2 ref2")
    check(st["mesh"] == mesh.shape and st["ref_index_builds"] == 1
          and st["ref_index_cache_hits"] == 0,
          "the mesh run did not build its sharded index")
    same = keys == genome_keys
    print(f"mesh run: .las records identical to phase 4b's direct run "
          f"({len(genome_keys)} records): {same}")
    check(same, "the mesh run's .las records differ from phase 4b's")
    torch.cuda.reset_peak_memory_stats()
    _sharded_match_ms(torch, work, mesh)
    print(f"sharded match timing: max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} bytes")

    phase("8c mesh: config-1 plan with --global-index over two ranks on "
          "one card")
    (tmp / "coop").mkdir()
    coop = _coop_plan(torch, tmp / "plan", tmp / "coop", direct, nreads,
                      name)
    print(f"mesh phase {time.time() - t_phase:.1f}s")
    return launches, coop


def phase_bench(torch, work, seed, glen, nreads):
    """The port's timed entry point (damapper_tpu_torch.bench) in a
    subprocess on BASELINE config 1, two repeats, both variants, the
    sample gate; its JSON line must show every gate passed and row 1
    launched.  Returns its JSON line."""
    phase("9 bench: damapper_tpu_torch.bench on BASELINE config 1")
    t0 = time.time()
    torch.cuda.empty_cache()
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "DAMAPPER_"))}
    env.update(CLASSIC_PIN,
               BENCH_GLEN=str(glen), BENCH_NREADS=str(nreads),
               BENCH_SEED=str(seed), BENCH_REPEATS="2", BENCH_VARIANTS="1",
               BENCH_GATE="sample", BENCH_DATA=str(work),
               PYTHONPATH=str(HERE) + os.pathsep + env.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "damapper_tpu_torch.bench"],
                       cwd=str(work), env=env, capture_output=True, text=True,
                       timeout=600)
    print(r.stderr[-3000:], end="")
    lines = r.stdout.strip().splitlines()
    check(bool(lines), f"the bench printed nothing (exit {r.returncode})")
    res = json.loads(lines[-1])
    print(lines[-1])
    print(f"bench phase {time.time() - t0:.1f}s")
    check("error" not in res, f"the bench failed: {res.get('error')}")
    check(r.returncode == 0, f"the bench exited {r.returncode}")
    var = res.get("variants", {})
    check(res["las_identical"] and set(var) == {"n95_C", "profile"}
          and all(v["las_identical"] for v in var.values()),
          "a bench run's .las records differ from its gate's")
    check(var["profile"]["profile_track_identical"],
          "the -p track differs from its gate's")
    check(all(x["oracle_sample"]["lanes"] > 0
              and x["oracle_sample"]["differ"] == 0
              for x in (res, *var.values())),
          "sampled lanes differ from the oracle")
    check(res["wave_lanes"] > 0 and res["kernel_launches"]["wave_lanes"] > 0,
          "the bench's timed run launched no wave_lanes")
    check(res["platform"] == "gpu", "the bench did not run on the card")
    return res


# the classic mode, pinned for every phase from 3 on (an explicit mode
# argument still wins over it)
CLASSIC_PIN = {"DAMAPPER_WAVE_PERSISTENT": "0", "DAMAPPER_WAVE_PACKOPS": "0",
               "DAMAPPER_WAVE_LANEPACK": "0"}


def default_mode(torch):
    """Print the measured mode file and the mode a default engine on the
    card resolves to, before the classic mode is pinned."""
    from damapper_tpu_torch.ops import wave_engine as we
    mf = we.mode_file_for(torch.device("cuda"))
    try:
        raw = json.loads(we.MODE_FILE.read_text())
    except (OSError, ValueError):
        raw = None
    knobs, src = we.resolve_wave_mode("cuda", {}, os.environ, mf)
    mode = (("persistent" if knobs["persistent"] else "classic")
            + ("+lanepack" if knobs["lanepack"] else
               "+packops" if knobs["packops"] else ""))
    print(f"mode file {we.MODE_FILE.name}: {raw if raw else 'none'}"
          f"{'' if mf or not raw else ' (not for this card)'}; a default "
          f"engine runs {mode} (W={knobs['band_cap']}, host_min="
          f"{knobs['host_min']}) from {src['mode']}")
    return mode


@contextlib.contextmanager
def pinned(env):
    """os.environ with ``env`` set, restored afterwards."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# phase 10's sizes: clip fuzz seeds x cases, mode A/B lanes of RLEN bases,
# the dense switch's lane counts
TUNE_FUZZ = (2, 256)
TUNE_LANES, TUNE_RLEN = 256, 6000
TUNE_DENSE = "128,256,512,768,1024,2048"


def _tool(mod, argv, what):
    """Run a tool's main in this process; a non-zero exit fails the
    phase."""
    print(f"--- {mod.__name__.rsplit('.', 1)[-1]} {' '.join(argv)}",
          flush=True)
    t0 = time.time()
    rc = mod.main(argv)
    print(f"({time.time() - t0:.1f}s)", flush=True)
    check(rc == 0, f"{what} (exit {rc})")


def phase_tune(torch, work, genome):
    """The tuning tools on the card (phase 10); their records under work.
    Returns the wave kernels' launches by the tools run in this process."""
    phase("10 tune: build gate, clip fuzz, mode A/B, pick, join A/B, "
          "dense switch")
    from damapper_tpu_torch.tools import (clip_fuzz, pick_wave_mode,
                                          wave_modes, wave_sweep)
    t0 = time.time()
    status, rows = work / "wave_build_status.json", work / "modes.jsonl"
    r = subprocess.run([sys.executable, "-m",
                        "damapper_tpu_torch.tools.wave_build_gate",
                        "--status", str(status), "--timeout", "180"],
                       cwd=str(HERE), capture_output=True, text=True,
                       timeout=1200)
    print(r.stdout[-4000:], end="")
    gate = json.loads(status.read_text()) if status.exists() else {}
    check(r.returncode == 0 and len(gate) == 6
          and all(v["status"] == "ok" for v in gate.values()),
          f"the build gate failed: {r.stderr[-500:]}")
    _zero_launches()
    os.environ.update(FUZZ_CASES=str(TUNE_FUZZ[1]), FUZZ_W="128")
    try:
        _tool(clip_fuzz, [str(TUNE_FUZZ[0]), "--mode", "all"],
              "the clip fuzz found mismatches")
    finally:
        for k in ("FUZZ_CASES", "FUZZ_W"):
            os.environ.pop(k, None)
    _tool(wave_modes, [str(TUNE_LANES), str(TUNE_RLEN), "--reps", "1",
                       "--log", str(rows)],
          "the mode A/B's records differ across modes")
    _tool(pick_wave_mode, [str(rows), "--status", str(status), "--dry-run"],
          "the picker refused")
    _tool(wave_sweep, ["--no-shape", "--dense", TUNE_DENSE, "--reps", "1",
                       "--log", str(work / "sweep.jsonl")],
          "the dense switch's builds gave other records")
    launches = _read_launches()
    r = subprocess.run([sys.executable, "-m",
                        "damapper_tpu_torch.tools.join_ab", str(genome),
                        "reads", "--reps", "1", "--timeout", "300", "--out",
                        str(work / "join.jsonl")],
                       cwd=str(HERE), capture_output=True, text=True,
                       timeout=1800)
    print(r.stdout[-4000:], end="")
    check(r.returncode == 0, f"the join A/B failed or its hits differ: "
          f"{r.stderr[-500:]}")
    joins = [json.loads(x) for x in (work / "join.jsonl").read_text()
             .splitlines()]
    check(len(joins) == 5 and all(j["identical_across_modes"]
                                  for j in joins),
          "the five joins' hits are not all equal")
    print(f"tune phase {time.time() - t0:.1f}s")
    return launches


def run(torch, args) -> None:
    """Every phase, then the kernels line and the passing last line."""
    t_start = time.time()
    name, count, card = phase_device(torch)
    probe_report = phase_build()
    with pinned(CLASSIC_PIN):
        _run_pinned(torch, args, t_start, name, count, card, probe_report)


def _run_pinned(torch, args, t_start, name, count, card, probe_report):
    """Phases 3 to 10 and the kernels line, with the classic mode pinned."""
    from damapper_tpu_torch.ops import wave_cuda, wave_persistent
    kern = {}
    for lay, k in phase_kernel(torch, args.seed).items():
        kern[wave_cuda.KERNEL_NAMES[lay]] = k
    for lay, k in phase_persistent_kernels(torch, args.seed).items():
        kern[wave_persistent.KERNEL_NAMES[lay]] = k
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = pathlib.Path(tmp)
        for d in ("probes", "map", "las", "plan"):
            (tmp / d).mkdir()
        probe_kern, probe_launches = phase_probes(
            torch, args.seed, tmp / "probes", probe_report)
        kern.update(probe_kern)
        launches = phase_mapping(torch, tmp / "map", args.seed, args.glen,
                                 args.nreads)
        launches.update(probe_launches)
        (tmp / "genome").mkdir()
        _, genome_keys = phase_genome(torch, tmp / "genome", args.seed,
                                          GENOME_LEN, args.nreads)
        phase_las(tmp / "las")
        plan_launches, direct = phase_plan(
            torch, tmp / "map", tmp / "plan", args.nreads, name)
        mesh_launches, coop_launches = phase_mesh(
            torch, tmp, args.seed, args.nreads, name, genome_keys, direct)
        (tmp / "bench").mkdir()
        bench = phase_bench(torch, tmp / "bench", args.seed, args.glen,
                            args.nreads)
        (tmp / "tune").mkdir()
        tune_launches = phase_tune(torch, tmp / "tune", tmp / "genome")
    phase("6 kernels")
    print(f"total {time.time() - t_start:.1f}s")
    src = "damapper_tpu_torch/csrc/"
    rows = [("wave_lanes", "wave.cu", 1524),
            ("wave_lanes_packed", "wave.cu", 1457),
            ("wave_lanes_lanepack", "wave.cu", 1413),
            ("wave_persistent", "wave_persistent.cu", 2104),
            ("wave_persistent_packed", "wave_persistent.cu", 2031),
            ("wave_persistent_lanepack", "wave_persistent.cu", 1981)]
    rows = [(nm, f, f"damapper_tpu/ops/wave_pallas.py:{line}")
            for nm, f, line in rows]
    rows += [(nm, "probes.cu", tpu) for nm, tpu in PROBES.items()]
    kernels = [dict(name=nm, route="cuda", source=src + f, replaces=tpu,
                    launches=launches[nm],
                    launches_plan=plan_launches.get(nm, 0),
                    launches_mesh=mesh_launches.get(nm, 0),
                    launches_coop=coop_launches.get(nm, 0),
                    launches_bench=bench["kernel_launches"].get(nm, 0),
                    launches_tune=tune_launches.get(nm, 0),
                    match=kern[nm]["max_abs_err"] == 0, **kern[nm],
                    library_ms=None)
               for nm, f, tpu in rows]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--nreads", type=int, default=1000)
    ap.add_argument("--glen", type=int, default=4_600_000)
    args = ap.parse_args(argv)

    PHASE["name"] = "0 setup"
    if not (HERE / "damapper_tpu_torch" / "csrc" / "wave.cu").exists():
        msg = "damapper_tpu_torch is not beside this script"
        print(f"chip_smoke: {msg}", file=sys.stderr)
        print(failure_line(SmokeFailure(msg)), flush=True)
        return 2
    import torch
    if not torch.cuda.is_available():
        msg = "no CUDA device is available"
        print(f"chip_smoke: {msg}", file=sys.stderr)
        print(failure_line(SmokeFailure(msg)), flush=True)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        run(torch, args)
    except Exception as e:
        # the run's one boundary: name the phase that failed, as the last
        # line, after the traceback
        traceback.print_exc()
        sys.stderr.flush()
        print(failure_line(e), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Multi-host plan execution: the cluster runtime replacing HPC script
submission (reference HPC.damapper.c:359-498, README.md:79-89).

The reference's cluster model is embarrassingly-parallel `damapper` jobs
over read-block ranges, coordinated only by script barriers and the
filesystem.  Here each job is owned by a rank of a `torch.distributed`
process group: workers join the group, map their owned read blocks through
the real pipeline on their device (the CUDA card; DAMAPPER_DEVICE=cpu for
the CPU), meet at a barrier, and rank 0 performs the house-keeping block:
LAcheck over every output plus the cross-host `.las` merge (the LAcat step
of damapper.c:893-910).

With ``--global-index`` (cooperative mode, BASELINE config 5) every rank
runs every job instead, on one (dp, ref) mesh whose "ref" axis spans the
ranks (parallel.mesh.coop_mesh): each rank builds the same indexes, keeps
its shard of each reference block's index, and the seed match's counts,
per-shard totals and emission buffers cross the ranks; rank 0 writes the
output.  Each job ends with a status round, and a rank that fails tells
its peers at their next cross-rank step, so they stop instead of waiting.

The group uses the gloo backend: it carries the barriers and, in
cooperative mode, the seed match's collectives, all from host copies.  No
collective runs on a card, so ranks that share one card each open their
own context on it (NCCL cannot place two ranks on one GPU).

`run_plan_multihost` is the single-machine launcher used by tests and small
clusters: it spawns one worker process per rank on localhost.  On a real
cluster each host runs `python -m damapper_tpu_torch.parallel.launch --rank R
...` with the address of host 0 as `--coord`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import shlex
import subprocess
import sys
import tempfile
import time

def _job_argv(cmd: str) -> list[str]:
    """Strip the launcher prefix off a plan job command, returning damapper
    CLI argv (the plan emits '... cli damapper <opts> <ref> <reads>...')."""
    toks = shlex.split(cmd)
    if "damapper" in toks:
        return toks[toks.index("damapper") + 1:]
    return toks


def _launches() -> dict:
    """Each wave kernel's launch count in this process (its wrapper's)."""
    from ..ops import wave_cuda, wave_persistent
    return {names[lay]: getattr(fn, "launches_" + lay)
            for fn, names in ((wave_cuda.wave_lanes, wave_cuda.KERNEL_NAMES),
                              (wave_persistent.wave_lanes_persistent,
                               wave_persistent.KERNEL_NAMES))
            for lay in wave_cuda.LAYOUTS}


def _device_name(dev) -> str:
    """The device a rank maps on, with the card's name."""
    import torch
    if dev.type == "cuda":
        i = torch.cuda.current_device() if dev.index is None else dev.index
        return f"cuda:{i} ({torch.cuda.get_device_name(i)})"
    return str(dev)


def worker_main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--nprocs", type=int, required=True)
    ap.add_argument("--coord", required=True, help="host:port of rank 0")
    ap.add_argument("--plan", required=True, help="plan JSON file")
    ap.add_argument("--out", default=".")
    ap.add_argument("--global-index", action="store_true",
                    help="cooperative mode: every rank runs every job on "
                         "ONE (dp, ref) mesh whose ref axis spans the "
                         "ranks: the reference k-mer index is sharded over "
                         "them and the seed match sums its counts across "
                         "them (BASELINE config 5).  Needs the device "
                         "index (the default on the card; "
                         "DAMAPPER_INDEX=device on the CPU).")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    with open(args.plan) as fp:
        plan = json.load(fp)
    dist.init_process_group("gloo", init_method=f"tcp://{args.coord}",
                            rank=args.rank, world_size=args.nprocs)

    from ..ops.wave_engine import resolve_device
    from ..pipeline.mapper import main_damapper
    from . import mesh as pmesh

    os.chdir(args.out)
    if args.global_index:
        # cooperative mode: the mapper's mesh spans the ranks
        os.environ["DAMAPPER_COOP"] = "1"
    rc = 0
    err = None
    t0 = time.time()
    try:
        # no card and no DAMAPPER_DEVICE=cpu raises here; the error still
        # reaches the barriers below, or the other ranks would deadlock
        dev = resolve_device(os.environ.get("DAMAPPER_DEVICE") or None)
        for job in plan["jobs"]:
            if args.global_index:
                # every rank runs the job over the one cross-rank mesh; the
                # status round at its end keeps the ranks in step
                print(f"[rank {args.rank}] blocks {job['blocks']} on "
                      f"{_device_name(dev)} (global mesh)", flush=True)
                before = dict(pmesh.COOP_STATS)
                rc |= main_damapper(_job_argv(job["cmd"]))
                pmesh.sync_point()
                print(f"[rank {args.rank}] gloo " + json.dumps(
                    {k: v - before[k] for k, v in pmesh.COOP_STATS.items()}),
                    flush=True)
                continue
            if job["host"] % args.nprocs != args.rank:
                continue
            print(f"[rank {args.rank}] blocks {job['blocks']} on "
                  f"{_device_name(dev)}", flush=True)
            rc |= main_damapper(_job_argv(job["cmd"]))
    except Exception as e:
        print(f"[rank {args.rank}] failed: {e!r}", flush=True)
        err, rc = e, 1
        if args.global_index and not isinstance(e, pmesh.PeerFailed):
            # the peers wait in a cross-rank step: meet them there
            try:
                pmesh.signal_failure()
            except Exception as e2:
                print(f"[rank {args.rank}] could not signal the failure: "
                      f"{e2!r}", flush=True)
    print(f"[rank {args.rank}] launches {json.dumps(_launches())}",
          flush=True)
    # every rank's blocks complete before house-keeping
    print(f"[rank {args.rank}] blocks done rc={rc} in "
          f"{time.time() - t0:.2f}s", flush=True)
    dist.barrier()

    if args.rank == 0 and rc == 0:
        # house-keeping: LAcheck every block output, then the cross-host
        # merge into one .las; errors must still reach the final barrier
        # or the other ranks deadlock
        try:
            from ..cli import main as cli_main

            for cmd in plan.get("check", ()):
                toks = shlex.split(cmd)
                rc |= cli_main(toks[toks.index("lacheck"):])
            merge = plan.get("merge")
            if merge:
                toks = shlex.split(merge)
                rc |= cli_main(toks[toks.index("lamerge"):])
        except Exception as e:
            print(f"[rank 0] house-keeping failed: {e}", flush=True)
            rc = 1
    dist.barrier()
    print(f"[rank {args.rank}] exit rc={rc}", flush=True)
    dist.destroy_process_group()
    if err is not None:
        raise err
    return rc


def run_plan_multihost(plan_json: str, nprocs: int, workdir: str,
                       port: int | None = None,
                       env_extra: dict | None = None,
                       global_index: bool = False) -> dict:
    """Launch a plan across nprocs localhost worker processes, each with the
    caller's environment (plus env_extra).  Returns {"seconds": wall,
    "rc": int, "logs": [each rank's output]}.

    global_index=True runs every job cooperatively on one mesh across the
    ranks (the reference index sharded over them) instead of distributing
    the jobs over the ranks."""
    import socket

    if port is None:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
    wd = pathlib.Path(workdir)
    planp = wd / "plan.json"
    planp.write_text(plan_json)

    env = dict(os.environ)
    repo = str(pathlib.Path(__file__).resolve().parents[2])
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    if env_extra:
        env.update(env_extra)

    t0 = time.time()
    procs = []
    rc = 0
    logs = []
    # each rank logs into a file of its own: a rank blocked on a full pipe
    # while the launcher waits on another would stall the barriers
    with contextlib.ExitStack() as stack:
        try:
            for r in range(nprocs):
                log = stack.enter_context(tempfile.TemporaryFile())
                argv = [sys.executable, "-m",
                        "damapper_tpu_torch.parallel.launch",
                        "--rank", str(r), "--nprocs", str(nprocs),
                        "--coord", f"127.0.0.1:{port}", "--plan", str(planp),
                        "--out", str(wd)] + (["--global-index"]
                                             if global_index else [])
                procs.append((subprocess.Popen(
                    argv, env=env, cwd=str(wd), stdout=log,
                    stderr=subprocess.STDOUT), log))
            deadline = time.time() + 900
            for p, log in procs:
                p.wait(timeout=max(deadline - time.time(), 1))
                log.seek(0)
                logs.append(log.read().decode(errors="replace"))
                rc |= p.returncode
        finally:
            for p, _ in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return {"seconds": time.time() - t0, "rc": rc, "logs": logs}


if __name__ == "__main__":
    sys.exit(worker_main())

"""Build gate of the wave modes: which of the six modes build and run right
on this card.

    python -m damapper_tpu_torch.tools.wave_build_gate [--modes all]
        [--timeout 420] [--status FILE] [--device cpu]

For each mode (tools.tuning.MODES, the JAX package's compile gate's names),
a subprocess with its own time limit (all of them side by side) builds the
mode's kernel library
(csrc/wave.cu, and for the persistent modes csrc/wave_persistent.cu too)
and runs 8 lanes of 2 kb reads (tools.tuning.lane_cases) through an engine
pinned to that mode; every lane's record must equal the host oracle's and
the mode's kernel must have launched.  A build that fails, a launch that
fails, a record that differs or a subprocess past its limit is recorded as
"fail" with its reason, never as "ok".  Each mode's entry (status, reason,
s, card, nvcc, ts) goes into --status (default tools/wave_build_status.json
on the card; with --device cpu, where the plain versions run and nothing is
built, only an explicit --status is written).  bench.py embeds the file and
tools/pick_wave_mode.py refuses to pick while a mode that builds has no
measurement.  Exits 1 if any mode failed.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import pathlib
import subprocess
import sys
import time

from . import tuning

STATUS_FILE = tuning.STATUS_FILE
GATE_LANES = 8
GATE_RLEN = 2000


def probe(mode, device=None) -> None:
    """Build ``mode``'s library and run the gate's lanes through it; raises
    on any fault."""
    from ..ops import wave_cuda, wave_persistent
    dev = tuning.open_device(device)
    if dev.type == "cuda":
        wave_cuda._load()
        if tuning.triple(mode)["persistent"]:
            wave_persistent._load()
    seqmem, insts = tuning.lane_cases(GATE_LANES, GATE_RLEN)
    eng = tuning.engine(dev, mode)
    _, got, _, fb, launches = tuning.timed_batch(eng, dev, seqmem, insts)
    sp = tuning.spec()
    bad = [i for i, s in enumerate(insts)
           if tuning.key(got[i]) != tuning.oracle_key(seqmem, s, sp)]
    if bad:
        raise RuntimeError(f"{mode}: lanes {bad} differ from the oracle")
    kernel = tuning.MODE_KERNEL[mode]
    if dev.type == "cuda" and launches[kernel] == 0:
        raise RuntimeError(f"{mode}: {kernel} never launched ({fb} of "
                           f"{len(insts)} lanes fell back to the oracle)")
    print(f"{mode}: {len(insts)} lanes equal to the oracle, {launches[kernel]}"
          f" launches of {kernel}, {fb} fallbacks", flush=True)


def nvcc_version():
    """nvcc's last version line ("Build cuda_..."), or None without it."""
    nvcc = os.environ.get("NVCC") or (
        "/usr/local/cuda/bin/nvcc"
        if os.path.exists("/usr/local/cuda/bin/nvcc") else "nvcc")
    try:
        r = subprocess.run([nvcc, "--version"], capture_output=True,
                           text=True, timeout=60)
    except OSError:
        return None
    lines = r.stdout.strip().splitlines()
    return lines[-1].strip() if r.returncode == 0 and lines else None


def gate(mode, timeout, device=None) -> dict:
    """One mode's entry: the probe in its own process, bounded by
    ``timeout`` seconds."""
    cmd = [sys.executable, "-m", "damapper_tpu_torch.tools.wave_build_gate",
           "--probe", mode] + (["--device", device] if device else [])
    t0 = time.time()
    try:
        r = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=timeout,
                           cwd=str(tuning.TOOLS.parent.parent))
    except subprocess.TimeoutExpired:
        return {"status": "fail", "reason": f"timeout after {timeout}s",
                "s": time.time() - t0}
    dt = time.time() - t0
    if r.returncode == 0:
        return {"status": "ok", "reason": None, "s": dt}
    tail = [ln.strip() for ln in (r.stderr or "").splitlines() if ln.strip()]
    reason = next((ln for ln in reversed(tail)
                   if "Error" in ln or "error" in ln or "failed" in ln),
                  tail[-1] if tail else f"exit {r.returncode}")
    return {"status": "fail", "reason": reason[:300], "rc": r.returncode,
            "s": dt}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modes", default="all")
    ap.add_argument("--timeout", type=float, default=420)
    ap.add_argument("--status", default=None)
    ap.add_argument("--device", default=None)
    ap.add_argument("--probe", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.probe:
        probe(args.probe, args.device)
        return 0
    names = tuning.mode_names(args.modes)
    dev = tuning.open_device(args.device)
    info = tuning.card_info(dev)
    nvcc = nvcc_version() if dev.type == "cuda" else None
    path = args.status or (STATUS_FILE if dev.type == "cuda" else None)
    status = {}
    if path is not None and pathlib.Path(path).exists():
        try:
            status = json.loads(pathlib.Path(path).read_text())
        except ValueError:
            status = {}
    # the probes run side by side: each is its own process, so a mode that
    # crashes or hangs takes no other down
    with concurrent.futures.ThreadPoolExecutor(len(names)) as ex:
        jobs = {n: ex.submit(gate, n, args.timeout, args.device)
                for n in names}
        for name in names:
            status[name] = dict(jobs[name].result(), card=info["card"],
                                nvcc=nvcc, ts=time.time())
            print(f"== build gate: {name} ==\n   {status[name]}", flush=True)
    if path is not None:
        pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(path).write_text(json.dumps(status, indent=1) + "\n")
    bad = [n for n in names if status[n]["status"] != "ok"]
    print(f"gate: {len(names) - len(bad)}/{len(names)} modes build and run "
          f"right on {info['card']}; failing: {bad or 'none'}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

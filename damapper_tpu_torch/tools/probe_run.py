"""What the three probe tools (floor_probe, ops_probe, carry_probe) share:
the card's name and power limit, the slope timing, and the record file."""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys

import numpy as np


def open_card(tool):
    """torch with a CUDA card, or None after a message (no card)."""
    import torch
    if not torch.cuda.is_available():
        print(f"{tool}: no CUDA device is available", file=sys.stderr)
        return None
    return torch


def card(torch):
    """{"device": torch's name, "power_limit": nvidia-smi's}."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    return {"device": torch.cuda.get_device_name(0),
            "power_limit": line.split(",")[-1].strip() if line else None}


def slope(torch, launch, n, repeats=3):
    """Time launch(n) and launch(5n) with CUDA events after a warm-up and
    take the slope, which cancels the launch: returns (median ms of the n
    launch, median seconds per iteration)."""
    launch(n)
    torch.cuda.synchronize()
    t1, t5 = [], []
    for _ in range(repeats):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        launch(n)
        ev[1].record()
        launch(5 * n)
        ev[2].record()
        torch.cuda.synchronize()
        t1.append(ev[0].elapsed_time(ev[1]))
        t5.append(ev[1].elapsed_time(ev[2]))
    per_iter = (np.median(t5) - np.median(t1)) / (4 * n) / 1e3
    return float(np.median(t1)), float(per_iter)


def emit(rec, fh):
    """Print one record and append it to the --out file, if any."""
    line = json.dumps(rec)
    print(line, flush=True)
    if fh is not None:
        fh.write(line + "\n")


def out_file(path):
    """The --out file opened for appending (its directory made), or
    None."""
    if not path:
        return None
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    return p.open("a")

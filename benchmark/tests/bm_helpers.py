"""Helpers of the harness's own tests."""

import subprocess
import sys

from conftest import REPO


def run_harness(args, cwd=REPO, env=None):
    """python3 -m benchmark.run in a fresh process: (rc, stdout, stderr)."""
    p = subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                       cwd=cwd, capture_output=True, text=True, env=env,
                       timeout=600)
    return p.returncode, p.stdout, p.stderr


def tiny_args(tiny, seed, trace=0, device="cpu"):
    bench, traffic = tiny
    return ["--workload", "tiny.rb", "--seed", str(seed), "--seconds", "1",
            "--trace", str(trace), "--device", device, "--benchmark",
            str(bench), "--traffic-dir", str(traffic)]

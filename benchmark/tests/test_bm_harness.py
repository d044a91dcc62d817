"""The harness end to end on a tiny CPU cell (``--device cpu``, tests
only): the last line's contract, its check, what it refuses to print, and
the faults it must catch."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from bm_helpers import run_harness, tiny_args
from conftest import BENCH, REPO

DEVICE_METRICS = {"engine_device_ms_per_kread", "wave_kernel_ms_per_kread",
                  "wave_roofline", "device_idle_pct", "peak_mem_gb"}
CHECK = ["records_malformed", "repeats_differ", "reads_differ",
         "profiles_differ"]


def last_line(stdout):
    lines = stdout.strip().splitlines()
    assert lines, "no result line"
    return json.loads(lines[-1])


@pytest.mark.parametrize("trace", [0, 1])
def test_tiny_cell_prints_a_line_that_meets_the_contract(tiny, trace):
    rc, out, err = run_harness(tiny_args(tiny, 2**33 + 7, trace))
    assert rc == 0, err[-3000:]
    r = last_line(out)
    assert list(r)[-1] == "check"
    for key in ("correct", "attempted", "failed", "metrics", "device"):
        assert key in r
    assert r["correct"] is True, r
    assert r["attempted"] > 0 and r["failed"] == 0
    want = {m["name"] for m in BENCH["per_layer" if trace else "end_to_end"]}
    got = set(r["metrics"])
    assert got <= want and not got & DEVICE_METRICS
    if not trace:
        assert got == {"reads_per_s", "setup_s"}
    for name, m in r["metrics"].items():
        assert set(m) == {"value", "unit"}
        # the program rounds the engine's two terms that the reporter's
        # time leaves out to 10 ms a block, which a tiny block can exceed
        assert m["value"] >= 0 or name == "reporter_ms_per_kread"
    assert r["device"]["platform"] == "cpu"
    assert list(r["check"]) == CHECK
    assert all(v == {"value": 0, "limit": 0} for v in r["check"].values())
    tail = err.strip().splitlines()[-len(CHECK):]
    assert tail == [f"check {k} 0 limit 0" for k in CHECK]


def test_no_card_and_no_test_argument_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    rc, out, err = run_harness(["--workload", BENCH["workloads"][0]["name"],
                                "--seed", "1", "--seconds", "1",
                                "--trace", "0"], env=env)
    assert rc != 0 and out.strip() == ""
    assert "no CUDA device" in err


def test_without_the_program_no_result(tmp_path, tiny):
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    rc, out, err = run_harness(tiny_args(tiny, 1), cwd=tmp_path)
    assert rc != 0 and out.strip() == ""
    assert "damapper_tpu_torch" in err


@pytest.mark.parametrize("fault", ["half", "altered", "unchanged"])
def test_a_broken_timed_path_is_not_correct(tiny, fault):
    p = subprocess.run(
        [sys.executable, str(REPO / "benchmark" / "tests" / "bm_faults.py"),
         fault, *tiny_args(tiny, 2**33 + 7)], cwd=REPO, capture_output=True,
        text=True, timeout=600, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert p.returncode == 0, p.stderr[-3000:]
    r = last_line(p.stdout)
    assert r["correct"] is False
    assert any(v["value"] > v["limit"] for v in r["check"].values())


def test_steady_malloc_keeps_freed_arrays_in_the_heap():
    """After run.steady_malloc a freed 64 MiB array stays in malloc's heap
    as free bytes (by default it is its own mmap, returned on free)."""
    code = (
        "import ctypes\n"
        "import numpy as np\n"
        "from benchmark import run\n"
        "class Info(ctypes.Structure):\n"
        "    _fields_ = [(f, ctypes.c_size_t) for f in ('arena', 'ordblks',"
        " 'smblks', 'hblks', 'hblkhd', 'usmblks', 'fsmblks', 'uordblks',"
        " 'fordblks', 'keepcost')]\n"
        "libc = ctypes.CDLL('libc.so.6')\n"
        "libc.mallinfo2.argtypes = []\n"
        "libc.mallinfo2.restype = Info\n"
        "run.steady_malloc()\n"
        "a = np.ones(1 << 23)\n"
        "del a\n"
        "print(libc.mallinfo2().fordblks)\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert int(p.stdout.split()[-1]) >= 1 << 26

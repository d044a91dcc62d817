"""Nothing the harness runs loads jax, jaxlib, flax or the JAX package
(top-level names compared whole: damapper_tpu_torch is not damapper_tpu),
and the reference loads nothing of the program."""

import os
import subprocess
import sys

from bm_helpers import run_harness, tiny_args
from conftest import REPO

REFERENCE_RUN = """
import sys, tempfile, pathlib, torch
from benchmark import check, control, dazz, gen
cfg = {"contigs": [["a", 200000], ["b", 200000]],
       "ref_block_bases": 200000,
       "options": {"kmer": 20, "ave_error": 0.85, "spacing": 100,
                   "profile": True, "mem_limit_gb": 16}}
traffic = {"read_len": {"mean": 2000, "sd": 500, "min": 1000},
           "error_rate": 0.15,
           "ins_share": 0.55, "del_share": 0.25, "block_bases": 8000,
           "distinct_blocks": 1, "check_reads": 3}
row = control.control_numbers(1, cfg, traffic, torch.device("cpu"),
                              pathlib.Path(tempfile.mkdtemp()))
assert row["records"] > 0, row
top = {m.split(".")[0] for m in sys.modules}
print(sorted(top & {"jax", "jaxlib", "flax", "damapper_tpu",
                    "damapper_tpu_torch"}))
"""


def test_the_reference_loads_nothing_of_either_package():
    p = subprocess.run([sys.executable, "-c", REFERENCE_RUN], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


def test_a_run_loads_no_jax(tiny):
    # run.main refuses to print a result (exit 3) when jax, jaxlib, flax or
    # damapper_tpu is in sys.modules once the window has closed
    rc, out, err = run_harness(tiny_args(tiny, 3))
    assert rc == 0, err[-3000:]
    assert out.strip()


def test_the_check_catches_a_loaded_jax_package(tiny):
    p = subprocess.run(
        [sys.executable, "-c",
         "import sys, types; sys.modules['damapper_tpu'] = "
         "types.ModuleType('damapper_tpu'); from benchmark import run; "
         f"sys.exit(run.main({tiny_args(tiny, 3)!r}))"],
        cwd=REPO, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "damapper_tpu" in p.stderr

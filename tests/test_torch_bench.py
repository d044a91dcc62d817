"""The port's timed entry point, damapper_tpu_torch.bench, on the CPU.

Held against the repository's bench.py (imported with jax on the CPU, as
the conftest sets it): the same knobs draw byte-identical datasets, one
reads block and split by BENCH_RBSIZE; a run with DAMAPPER_DEVICE=cpu
prints bench.py's JSON fields (and the port's own) as its last line with
every gate passed, writes the .las records of bench.py's time_ours for the
plain run and for -n.95 -C, and builds the reference index once in every
repeat; without a card and without DAMAPPER_DEVICE=cpu it prints "error"
and exits non-zero."""

import importlib
import json
import os
import pathlib
import subprocess
import sys

import pytest

from damapper_tpu_torch import bench as tbench
from damapper_tpu_torch.io import db as tdb
from damapper_tpu_torch.io import las as tlas

REPO = pathlib.Path(__file__).resolve().parent.parent
GLEN, NREADS = 200_000, 20
BENCH_FIELDS = ("metric", "value", "unit", "vs_baseline", "seconds_samples",
                "stage_seconds", "ref_index_cache_hits", "ref_index_builds",
                "align_device_s", "align_host_s", "cell_updates_per_sec",
                "wave_lanes", "variants")
PORT_FIELDS = ("device", "wave_mode", "kernel_launches", "kernel_ms",
               "n_fallback", "n_winmiss", "n_hostmin", "max_memory_allocated",
               "gate", "gate_seconds", "las_identical", "build_seconds")


def _jax_bench(monkeypatch, rbsize=0):
    """The root bench.py with its knobs set as the port's test run sets
    them."""
    jb = importlib.import_module("bench")
    for name, val in dict(GLEN=GLEN, NREADS=NREADS, SEED=42,
                          BSIZE=260_000_000, RBSIZE=rbsize).items():
        monkeypatch.setattr(jb, name, val)
    return jb


def _env(data, **extra):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("BENCH_", "DAMAPPER_"))}
    env.update(BENCH_GLEN=str(GLEN), BENCH_NREADS=str(NREADS),
               BENCH_DATA=str(data), OMP_NUM_THREADS="1",
               PYTHONPATH=str(REPO), **extra)
    return env


@pytest.mark.parametrize("rbsize", [0, 40_000], ids=["one_block", "split"])
def test_dataset_bytes_equal_bench_py(tmp_path, monkeypatch, rbsize):
    """(a) The same knobs write the same files, byte for byte: the .dam and
    .db stubs, their hidden .idx and .bps files and the marker, in a
    directory named as bench.py names its own."""
    jb = _jax_bench(monkeypatch, rbsize)
    k = tbench.Knobs(glen=GLEN, nreads=NREADS, rbsize=rbsize, data=tmp_path)
    assert k.work().name == f"ds_42_{GLEN}_{NREADS}" + (
        f"_r{rbsize}" if rbsize else "")
    jb.build_dataset(tmp_path / "jax")
    tbench.build_dataset(tmp_path / "torch", k)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "torch").iterdir())
    assert {".ref.idx", ".ref.bps", ".reads.idx", ".reads.bps", "ref.dam",
            "reads.db"} <= set(names)
    for nm in names:
        assert ((tmp_path / "jax" / nm).read_bytes()
                == (tmp_path / "torch" / nm).read_bytes()), nm
    nblocks = tdb.read_stub(str(tmp_path / "torch" / "reads.db")).nblocks
    assert (nblocks > 1) == bool(rbsize)
    assert tbench._reads_blocks(tmp_path / "torch", k) == (
        [f"reads.{i}" for i in range(1, nblocks + 1)] if rbsize
        else ["reads"])


@pytest.fixture(scope="module")
def cpu_run(tmp_path_factory):
    """One run of the port's bench on the CPU: both variants, two repeats,
    the oracle gate, the device index's PyTorch ops on CPU tensors (so the
    reference-index cache is in play).  Returns (exit code, stdout,
    stderr, the dataset's directory)."""
    data = tmp_path_factory.mktemp("torch_bench")
    r = subprocess.run(
        [sys.executable, "-m", "damapper_tpu_torch.bench"], cwd=str(data),
        env=_env(data, DAMAPPER_DEVICE="cpu", DAMAPPER_INDEX="device",
                 BENCH_REPEATS="2", BENCH_VARIANTS="1",
                 BENCH_GATE="oracle"),
        capture_output=True, text=True, timeout=600)
    k = tbench.Knobs(glen=GLEN, nreads=NREADS, data=data)
    return r.returncode, r.stdout, r.stderr, k.work()


def _line(cpu_run):
    rc, out, err, _ = cpu_run
    assert rc == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


def test_cpu_run_json_line(cpu_run):
    """(b) One JSON last line with bench.py's fields and the port's, every
    gate passed, no reference numbers, exit code 0."""
    res = _line(cpu_run)
    assert "error" not in res
    for f in BENCH_FIELDS + PORT_FIELDS:
        assert f in res, f
    assert "reference_reads_per_sec" not in res
    assert res["vs_baseline"] is None
    assert "no C reference" in res["metric"]
    assert res["unit"] == "reads/s" and res["value"] > 0
    assert res["platform"] == "cpu" and res["device"] == "cpu"
    assert res["max_memory_allocated"] is None
    assert len(res["seconds_samples"]) == 2
    # value comes from the best repeat's unrounded seconds
    assert res["value"] == pytest.approx(
        NREADS / min(res["seconds_samples"]), rel=1e-3)
    assert {"index", "match", "chain", "align"} <= set(res["stage_seconds"])
    assert res["wave_lanes"] > 0 and res["cell_updates_per_sec"] > 0
    assert res["wave_mode"] == "classic"
    # the CPU runs the plain version: no kernel launches
    assert set(res["kernel_launches"]) >= {"wave_lanes"}
    assert not any(res["kernel_launches"].values())
    assert res["gate"] == "oracle" and res["las_identical"] is True
    assert set(res["variants"]) == {"n95_C", "profile"}
    for name, v in res["variants"].items():
        assert v["las_identical"] is True, name
        assert v["value"] > 0 and v["vs_baseline"] is None
    assert res["variants"]["profile"]["profile_track_identical"] is True


@pytest.mark.parametrize("variant", ["plain", "n95_C"])
def test_las_equals_jax_time_ours(cpu_run, monkeypatch, variant):
    """(c) The port's timed run writes the records of bench.py's time_ours
    on the same dataset: the plain run, and -n.95 -C with both files."""
    _line(cpu_run)
    work = cpu_run[3]
    jb = _jax_bench(monkeypatch)
    kw = tbench.VARIANT_KW.get(variant)
    sub = "torch_ours" + ("_nC" if kw else "")
    _, jpath, _ = jb.time_ours(work, kw, repeats=1, subdir=f"jax_{variant}")
    files = ["reads.ref.las"] + (["ref.reads.las"] if kw else [])
    assert jpath == work / f"jax_{variant}" / files[0]
    for f in files:
        jrecs, jt = tlas.read_las(str(work / f"jax_{variant}" / f))
        trecs, tt = tlas.read_las(str(work / sub / f))
        assert jrecs and jt == tt
        assert [r.key() for r in trecs] == [r.key() for r in jrecs], f


def test_ref_index_cold_every_repeat(cpu_run):
    """(d) Each repeat builds the reference index once and hits no cache:
    the cache is emptied before every repeat."""
    res = _line(cpu_run)
    assert res["ref_index_builds_samples"] == [1, 1]
    assert res["ref_index_builds"] == 1
    assert res["ref_index_cache_hits"] == 0


def test_without_card_prints_error(tmp_path):
    """(e) No card and no DAMAPPER_DEVICE=cpu: the JSON line carries the
    error, the exit code is non-zero, and no dataset is drawn."""
    r = subprocess.run(
        [sys.executable, "-m", "damapper_tpu_torch.bench"], cwd=str(tmp_path),
        env=_env(tmp_path, CUDA_VISIBLE_DEVICES=""), capture_output=True,
        text=True, timeout=300)
    assert r.returncode != 0
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert "no CUDA device" in res["error"]
    assert res["value"] == 0.0
    assert not any(tmp_path.iterdir())

"""The port stands alone and never falls back silently.

damapper_tpu_torch imports neither jax nor anything of damapper_tpu nor
the JAX package's tools/, and with no CUDA card its entry points raise
unless the caller asks for the CPU."""

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

import damapper_tpu_torch
from damapper_tpu_torch.ops import (chain_device, device_index, probes,
                                    wave_cuda, wave_engine, wave_persistent)
from damapper_tpu_torch.pipeline import mapper
from damapper_tpu_torch.tools import (carry_probe, clip_fuzz, floor_probe,
                                      index_profile, join_ab, ops_probe,
                                      pick_wave_mode, sort_floor, tuning,
                                      wave_build_gate, wave_clocks, wave_kit,
                                      wave_modes, wave_sweep)

PKG = pathlib.Path(damapper_tpu_torch.__file__).resolve().parent
REPO = PKG.parent
SOURCES = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _modules():
    return sorted(
        "damapper_tpu_torch" + "".join(
            "." + p for p in f.relative_to(PKG).with_suffix("").parts
            if p != "__init__")
        for f in PKG.rglob("*.py"))


def _forbidden(name):
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == "damapper_tpu" or name.startswith("damapper_tpu.")
            or name == "tools" or name.startswith("tools.")
            or name == "tests" or name.startswith("tests."))


def test_entry_points_are_covered():
    """The timed entry point and the replay tool are among the modules and
    sources the checks below walk."""
    for mod in ("damapper_tpu_torch.bench",
                "damapper_tpu_torch.tools.wave_replay"):
        assert mod in _modules()
        assert PKG.parent / (mod.replace(".", "/") + ".py") in SOURCES


TUNING_TOOLS = (clip_fuzz, index_profile, join_ab, pick_wave_mode,
                sort_floor, tuning, wave_build_gate, wave_kit, wave_modes,
                wave_sweep)


@pytest.mark.parametrize("mod", TUNING_TOOLS,
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_tuning_tools_are_covered(mod):
    """The tuning tools and the engine's mode file are among the modules
    and sources the checks below walk."""
    assert mod.__name__ in _modules()
    assert pathlib.Path(mod.__file__).resolve() in SOURCES


TOOL_RUNS = {
    "clip_fuzz": (clip_fuzz, ["1"]),
    "wave_build_gate": (wave_build_gate, ["--modes", "classic"]),
    "wave_modes": (wave_modes, ["4", "1200"]),
    "wave_sweep": (wave_sweep, ["4", "1200"]),
    "wave_kit": (wave_kit, ["4", "1200", "1000"]),
    "join_ab": (join_ab, ["/nonexistent", "reads"]),
    "index_profile": (index_profile, ["/nonexistent", "reads"]),
    "sort_floor": (sort_floor, ["0.01", "0.01", "0.01"]),
    "pick_wave_mode": (pick_wave_mode, []),
}


@pytest.mark.parametrize("name", sorted(TOOL_RUNS))
def test_tuning_tool_without_card_raises(monkeypatch, name, tmp_path):
    """With no card and no --device cpu, a tuning tool raises and writes
    no record."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tuning, "RESULTS_FILE", tmp_path / "r.jsonl")
    monkeypatch.setattr(tuning, "STATUS_FILE", tmp_path / "s.json")
    mod, argv = TOOL_RUNS[name]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(argv)
    assert not list(tmp_path.iterdir())


def test_importing_every_module_loads_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib')) or m == 'damapper_tpu' or "
            "m.startswith('damapper_tpu.') or m == 'tools' or "
            "m.startswith('tools.') or m == 'tests' or "
            "m.startswith('tests.'))\n"
            "print(len(sys.modules), bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for nm in names:
            assert not _forbidden(nm), f"{path}:{node.lineno} imports {nm}"


def test_config_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapper.DamapperConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wave_engine.WaveEngine(None, device="cuda")
    assert mapper.DamapperConfig(device="cpu").device.type == "cpu"


class _CudaTyped:
    """Stands in for a CUDA tensor on a machine without a card."""
    device = torch.device("cuda", 0)
    shape = (8,)


def test_wave_lanes_cuda_request_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA request")

    monkeypatch.setattr(wave_cuda, "wave_lanes_ref", no_plain)
    t = _CudaTyped()
    for layout in wave_cuda.LAYOUTS:
        cnt = "launches_" + layout
        launches = getattr(wave_cuda.wave_lanes, cnt)
        kw = dict(W=64, P=512, reverse=False, layout=layout)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            wave_cuda.wave_lanes(t, t, t, t, t, t, t, t, 100, 50, 100, 900,
                                 **kw)
        # a CPU sequence memory with CUDA lane inputs is no CPU request
        # either
        cpu = torch.zeros(8, dtype=torch.uint8)
        with pytest.raises(ValueError, match="all lie on the CPU"):
            wave_cuda.wave_lanes(t, t, t, t, t, t, cpu, cpu, 100, 50, 100,
                                 900, **kw)
        assert getattr(wave_cuda.wave_lanes, cnt) == launches


@pytest.mark.parametrize("layout", wave_persistent.LAYOUTS)
def test_wave_lanes_persistent_cuda_request_without_card_raises(monkeypatch,
                                                               layout):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA request")

    monkeypatch.setattr(wave_persistent, "wave_lanes_persistent_ref",
                        no_plain)
    monkeypatch.setattr(wave_persistent, "wave_lanes_ref", no_plain)
    t = _CudaTyped()
    ins = (t, t, t, t, t, t)
    kw = dict(W=64, P=512, L=2048, reverse=False, layout=layout,
              awst=t, bwst=t)
    cnt = "launches_" + layout
    launches = getattr(wave_persistent.wave_lanes_persistent, cnt)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wave_persistent.wave_lanes_persistent(*ins, t, t, 100, 50, 100, 900,
                                              **kw)
    cpu = torch.zeros(8, dtype=torch.uint8)
    with pytest.raises(ValueError, match="all lie on the CPU"):
        wave_persistent.wave_lanes_persistent(*ins, cpu, cpu, 100, 50, 100,
                                              900, **kw)
    assert getattr(wave_persistent.wave_lanes_persistent, cnt) == launches


def test_persistent_engine_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wave_engine.WaveEngine(None, persistent=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapper.DamapperConfig(persistent=True, lanepack=True)


PROBE_CALLS = {
    "floor_probe": lambda t: probes.floor_probe(t, 10),
    "ops_probe": lambda t: probes.ops_probe(t, t, 10),
    "carry_probe": lambda t: probes.carry_probe(t, 10, "carry60"),
}


@pytest.mark.parametrize("name", sorted(PROBE_CALLS))
def test_probe_cuda_request_without_card_raises(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA request")

    for ref in ("floor_probe_ref", "ops_probe_ref", "carry_probe_ref"):
        monkeypatch.setattr(probes, ref, no_plain)
    wrapper = getattr(probes, name)
    launches = wrapper.launches
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PROBE_CALLS[name](_CudaTyped())
    # CUDA and CPU tensors mixed are no CPU request either
    if name == "ops_probe":
        with pytest.raises(ValueError, match="all lie on the CPU"):
            probes.ops_probe(_CudaTyped(), torch.zeros((8, 1),
                                                       dtype=torch.int32), 1)
    assert wrapper.launches == launches


def test_probe_wrappers_never_fall_back():
    """No try in the probe module: a CUDA request launches or raises."""
    tree = ast.parse(pathlib.Path(probes.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("mod", [device_index, chain_device],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_device_modules_never_fall_back(mod):
    """No try in the device-index or device-chain modules: a CUDA request
    runs on the card or raises, never on the host instead."""
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


def test_device_index_without_card_raises(monkeypatch, tmp_path):
    """DAMAPPER_INDEX=device with no card raises (the config and every
    device-index entry point); with device="cpu" it is a CPU request."""
    from damapper_tpu_torch.io import db as dbio
    from damapper_tpu_torch.io import fasta
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("DAMAPPER_INDEX", "device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mapper.DamapperConfig()
    assert mapper.DamapperConfig(device="cpu").index_backend == "device"
    dbio.create_db(str(tmp_path / "r.db"),
                   [fasta.FastaEntry("r0", "ACGT" * 100)])
    db = dbio.DazzDB.open(str(tmp_path / "r.db"))
    db.trim()
    db.load_bases()
    for call in (lambda: device_index.device_upload_seq(db),
                 lambda: device_index.device_sort_kmers(db, 12),
                 lambda: device_index.device_upload_seq(db, "cuda")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


@pytest.mark.parametrize("tool", [floor_probe, ops_probe, carry_probe,
                                  wave_clocks],
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_probe_tool_without_card_exits_nonzero(monkeypatch, tmp_path, tool,
                                               capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "r.jsonl"
    assert tool.main(["--out", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()


def test_tool_chain_runs_where_jax_cannot_import(tmp_path):
    """The port's CLI maps, sorts, merges, checks, shows and plans in
    processes where importing jax or damapper_tpu fails."""
    from damapper_tpu_torch.io import db as dbio
    from damapper_tpu_torch.io import fasta
    from damapper_tpu_torch.utils.sim import sim_genome, sim_read
    import numpy as np

    block = tmp_path / "block"
    for pkg in ("jax", "damapper_tpu"):
        (block / pkg).mkdir(parents=True)
        (block / pkg / "__init__.py").write_text(
            f"raise ImportError('{pkg} is not installed here')\n")
    data = tmp_path / "data"
    data.mkdir()
    rng = np.random.default_rng(4)
    genome = sim_genome(rng, 20_000)
    reads = [sim_read(rng, genome, min_len=1500, max_len=3000)[0]
             for _ in range(6)]
    dbio.create_dam(str(data / "ref.dam"), [fasta.FastaEntry("g", genome)])
    dbio.create_db(str(data / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r) for i, r in enumerate(reads)],
                   bsize=6_000)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=os.pathsep.join([str(block), str(REPO)]),
               DAMAPPER_DEVICE="cpu", OMP_NUM_THREADS="1")
    probe = subprocess.run([sys.executable, "-c", "import jax"], cwd=data,
                           env=env, capture_output=True, text=True)
    assert probe.returncode != 0 and "not installed here" in probe.stderr
    # the plan first: it refuses to plan over blocks already mapped
    steps = [["plan", "-fjson", "ref", "reads"],
             ["damapper", "-k14", "ref", "reads.@"],
             ["lasort", "reads.@.ref"],
             ["lamerge", "all", "reads.@.ref.S"],
             ["lacheck", "-vS", "all"],
             ["lashow", "-caG", "ref", "reads", "all.las"],
             ["dbshow", "reads", "1"]]
    outs = []
    for argv in steps:
        r = subprocess.run([sys.executable, "-m", "damapper_tpu_torch.cli",
                            *argv], cwd=data, env=env, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode == 0, f"{argv}: {r.stdout}{r.stderr}"
        outs.append(r.stdout)
    assert "damapper_tpu_torch.cli lamerge" in outs[0]
    assert " diffs\n" in outs[5]
    assert outs[6].startswith(">")

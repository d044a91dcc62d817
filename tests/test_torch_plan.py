"""The port's plan generator (damapper_tpu_torch.parallel.plan and the
`plan` subcommand) against damapper_tpu's on the same DBs: the port's
text must equal JAX's with `damapper_tpu.cli` replaced by
`damapper_tpu_torch.cli`, and nothing else may differ (errors, JSON keys,
-f bundles, LSF/SLURM decorations).  Then the port's plan lines run
through the port's CLI on the CPU, and each block's .las must equal a
direct run of the port and the JAX oracle's run."""

import json
import os
import subprocess
import sys

import pytest

from damapper_tpu import cli as jcli
from damapper_tpu.io import las as jlasio
from damapper_tpu.parallel import plan as jplan
from damapper_tpu.pipeline.mapper import DamapperConfig as JaxConfig
from damapper_tpu.pipeline.mapper import expand_db_block_arg as jexpand
from damapper_tpu.pipeline.mapper import run_damapper as jax_run
from damapper_tpu_torch import cli as tcli
from damapper_tpu_torch.io import db as dbio
from damapper_tpu_torch.io import fasta
from damapper_tpu_torch.io import las as lasio
from damapper_tpu_torch.parallel import plan as tplan
from damapper_tpu_torch.pipeline import mapper as tmapper
from tests import helpers


def _jax_text(s):
    return s.replace("damapper_tpu.cli", "damapper_tpu_torch.cli")


@pytest.fixture()
def dbs(tmp_path):
    genome, reads = helpers.sim_dataset(seed=5, glen=30000, nreads=12)
    dbio.create_dam(str(tmp_path / "ref.dam"),
                    [fasta.FastaEntry("g", genome)])
    dbio.create_db(str(tmp_path / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r) for i, r in enumerate(reads)],
                   bsize=20000)   # multiple blocks
    assert dbio.read_stub(str(tmp_path / "reads.db")).nblocks > 2
    return tmp_path


def test_cli_prefix():
    assert tplan.CLI == "python -m damapper_tpu_torch.cli"


PLANS = {
    "sh": dict(bunit=2),
    "sh_default": dict(),
    "sh_range": dict(first_block=1, last_block=2, opts="-k14 -e.8"),
    "json_hosts": dict(bunit=1, nhosts=2, fmt="json"),
    "json_one_job": dict(bunit=9, fmt="json", opts="-v"),
    "lsf": dict(bunit=2, submit="lsf"),
    "slurm": dict(bunit=2, submit="slurm", opts="-T8 -M32"),
    "slurm_default": dict(bunit=2, submit="slurm", opts="-T6"),
    "lacheck_z": dict(opts="-z"),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_text_equal(dbs, monkeypatch, case):
    monkeypatch.chdir(dbs)
    kw = PLANS[case]
    got = tplan.generate_plan("ref.dam", "reads.db", **kw)
    assert got == _jax_text(jplan.generate_plan("ref.dam", "reads.db", **kw))
    assert "damapper_tpu_torch.cli" in got
    assert "damapper_tpu.cli" not in got
    if kw.get("fmt") == "json":
        plan = json.loads(got)
        assert plan["resume"]["first_block"] == 1
        assert {j["host"] for j in plan["jobs"]} <= {0, 1}


def test_plan_unblocked_and_paths(tmp_path, monkeypatch):
    """A one-block reads DB (no block suffixes, no merge) and DBs named by
    path from another directory."""
    genome, reads = helpers.sim_dataset(seed=8, glen=20000, nreads=4)
    sub = tmp_path / "d"
    sub.mkdir()
    dbio.create_dam(str(sub / "ref.dam"), [fasta.FastaEntry("g", genome)])
    dbio.create_db(str(sub / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r) for i, r in enumerate(reads)])
    monkeypatch.chdir(tmp_path)
    for fmt in ("sh", "json"):
        got = tplan.generate_plan("d/ref", "d/reads.db", fmt=fmt)
        assert got == _jax_text(jplan.generate_plan("d/ref", "d/reads.db",
                                                    fmt=fmt))
    assert json.loads(got)["merge"] is None


def test_plan_errors_equal(dbs, monkeypatch):
    monkeypatch.chdir(dbs)
    calls = [dict(first_block=2),                 # block 1's .las missing
             dict(first_block=3, last_block=2),   # empty range
             dict(last_block=99)]                 # out of bounds
    for kw in calls:
        with pytest.raises(Exception) as je:
            jplan.generate_plan("ref.dam", "reads.db", **kw)
        with pytest.raises(Exception) as te:
            tplan.generate_plan("ref.dam", "reads.db", **kw)
        assert (type(te.value).__name__, str(te.value)) == \
            (type(je.value).__name__, str(je.value))
    with pytest.raises(ValueError, match="against itself"):
        tplan.generate_plan("reads.db", "reads.db")
    # the resume contract: block 1 present lets the range start at 2, and
    # block 2 present refuses it
    (dbs / "reads.1.ref.las").write_bytes(b"\0" * 12)
    assert tplan.generate_plan("ref.dam", "reads.db", first_block=2) == \
        _jax_text(jplan.generate_plan("ref.dam", "reads.db", first_block=2))
    (dbs / "reads.2.ref.las").write_bytes(b"\0" * 12)
    with pytest.raises(FileExistsError):
        tplan.generate_plan("ref.dam", "reads.db", first_block=2)


def test_plan_file_bundles_equal(dbs, monkeypatch):
    (dbs / "jax").mkdir()
    (dbs / "torch").mkdir()
    for side, gen in (("jax", jplan.generate_plan),
                      ("torch", tplan.generate_plan)):
        monkeypatch.chdir(dbs)
        assert gen("ref.dam", "reads.db", bunit=2,
                   oname=f"{side}/NAME") == ""
    for ext in ("01.OVL", "02.CHECK.OPT"):
        got = (dbs / "torch" / f"NAME.{ext}").read_text()
        assert got == _jax_text((dbs / "jax" / f"NAME.{ext}").read_text())
    assert "lacheck -vaS" in got


PLAN_ARGV = {
    "default": ["ref", "reads"],
    "json": ["-B1", "-fjson", "-k14", "ref.dam", "reads.db"],
    "sh_range": ["-B2", "-fsh", "-v", "-e.8", "ref", "reads", "1-2"],
    "one_block": ["ref", "reads", "1"],
    "lsf": ["--lsf", "-B3", "ref", "reads"],
    "slurm": ["--slurm", "-T8", "-M32", "ref", "reads"],
    "usage": ["ref.dam"],
}


@pytest.mark.parametrize("case", sorted(PLAN_ARGV))
def test_plan_subcommand_equal(dbs, monkeypatch, capsys, case):
    monkeypatch.chdir(dbs)
    monkeypatch.setattr("damapper_tpu.utils.cache.enable_compile_cache",
                        lambda *a, **kw: None)
    got = []
    for main in (jcli.main, tcli.main):
        rc = main(["plan", *PLAN_ARGV[case]])
        out, err = capsys.readouterr()
        got.append((rc, out, err))
    (jrc, jout, jerr), (rc, out, err) = got
    assert (rc, out, err) == (jrc, _jax_text(jout), jerr)
    if case == "usage":
        assert rc == 1 and err and not out
    else:
        assert rc == 0 and "damapper_tpu_torch.cli damapper" in out


def test_db_block_arg_expansion_equal(tmp_path):
    """'@' DB block-range arguments (Parse_Block_DB_Arg DB.c:2822-2923):
    the port's expansion equals JAX's, errors included."""
    import numpy as np
    rng = np.random.default_rng(3)
    reads = [helpers.sim_genome(rng, 3000) for _ in range(12)]
    dbio.create_db(str(tmp_path / "rd.db"),
                   [fasta.FastaEntry(f"r{i}", r) for i, r in enumerate(reads)],
                   bsize=9_000)
    base = str(tmp_path / "rd")
    for arg in (base, base + ".@", base + ".@2", base + ".@2-3"):
        assert tmapper.expand_db_block_arg(arg) == jexpand(arg)
    assert len(tmapper.expand_db_block_arg(base + ".@")) >= 3
    for arg, exc in ((base + ".@3-2", ValueError),
                     (str(tmp_path / "nope") + ".@", FileNotFoundError)):
        with pytest.raises(exc) as je:
            jexpand(arg)
        with pytest.raises(exc) as te:
            tmapper.expand_db_block_arg(arg)
        assert str(te.value) == str(je.value)


def test_plan_execution_end_to_end(tmp_path, monkeypatch):
    """The port's plan (job lines and the LAcheck block) run with the port's
    CLI on the CPU: each block's .las must equal a direct port run of the
    block, and the blocks together the JAX oracle's single-shot run (the
    reference's cluster workflow, README.md:79-104)."""
    genome, reads = helpers.sim_dataset(seed=6, glen=15000, nreads=6,
                                        min_len=1500, max_len=3000)
    dbio.create_dam(str(tmp_path / "ref.dam"),
                    [fasta.FastaEntry("g", genome)])
    dbio.create_db(str(tmp_path / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)],
                   bsize=5000)   # several blocks
    nblocks = dbio.read_stub(str(tmp_path / "reads.db")).nblocks
    assert nblocks > 1
    monkeypatch.chdir(tmp_path)
    plan = tplan.generate_plan("ref.dam", "reads.db", bunit=1)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(helpers.REPO)] + env.get("PYTHONPATH", "").split(os.pathsep))
    env["DAMAPPER_DEVICE"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    lines = [ln for ln in plan.splitlines() if not ln.startswith("#")]
    assert len(lines) == nblocks + 1 and "lacheck -vaS" in lines[-1]
    for ln in lines:
        assert ln.startswith("python -m damapper_tpu_torch.cli ")
        cmd = ln.replace("python ", f"{sys.executable} ", 1)
        r = subprocess.run(cmd, shell=True, cwd=tmp_path, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, f"{ln}\n{r.stdout}\n{r.stderr}"

    cfg = tmapper.DamapperConfig(device="cpu")
    per_block = []
    for k in range(1, nblocks + 1):
        recs, ts = lasio.read_las(str(tmp_path / f"reads.{k}.ref.las"))
        out = tmp_path / f"direct{k}"
        out.mkdir()
        a, _ = tmapper.run_damapper(str(tmp_path / "ref.dam"),
                                    str(tmp_path / f"reads.{k}"), cfg,
                                    out_dir=str(out))
        direct, dts = lasio.read_las(a)
        assert (ts, [r.key() for r in recs]) == \
            (dts, [r.key() for r in direct])
        per_block.extend(recs)
    assert per_block

    out = tmp_path / "oracle"
    out.mkdir()
    a, _ = jax_run(str(tmp_path / "ref.dam"), str(tmp_path / "reads.db"),
                   JaxConfig(wave_backend="oracle"), out_dir=str(out))
    oracle, _ = jlasio.read_las(a)
    assert [r.key() for r in per_block] == [r.key() for r in oracle]

"""The port's plan runner (damapper_tpu_torch.parallel.launch) on
torch.distributed: two gloo processes on the CPU run a plan of the port,
and the merged .las must be record-identical to one process and to a
direct single-process run of the whole reads DB.  --global-index is not
ported and must fail with its message; a rank with no card that was not
asked for the CPU must fail, not map on the host."""

import json
import os

import pytest

from damapper_tpu_torch.io import las as lasio
from damapper_tpu_torch.parallel import launch
from damapper_tpu_torch.parallel.plan import generate_plan
from damapper_tpu_torch.pipeline import mapper as tmapper
from tests.test_multihost import make_blocked_dataset

CPU = {"DAMAPPER_DEVICE": "cpu", "OMP_NUM_THREADS": "1"}


def _plan(tmp_path, **kw):
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        return generate_plan("ref.dam", "reads.db", fmt="json", **kw)
    finally:
        os.chdir(cwd)


def _fresh_dir(tmp_path, name):
    d = tmp_path / name
    d.mkdir()
    for f in tmp_path.iterdir():
        if f.is_file() and (f.name.startswith(".")
                            or f.name in ("ref.dam", "reads.db")):
            os.link(f, d / f.name)
    return d


def test_two_process_plan_matches_single(tmp_path):
    nblocks = make_blocked_dataset(tmp_path)
    plan = _plan(tmp_path, bunit=1, nhosts=2, opts="-k14")
    pland = json.loads(plan)
    assert len(pland["jobs"]) == nblocks and pland["merge"]
    assert all("damapper_tpu_torch.cli" in j["cmd"] for j in pland["jobs"])

    res2 = launch.run_plan_multihost(plan, nprocs=2, workdir=str(tmp_path),
                                     env_extra=CPU)
    assert res2["rc"] == 0, "\n".join(res2["logs"])
    for r, log in enumerate(res2["logs"]):
        # each rank maps the jobs it owns, on the device it names
        mine = [j["blocks"] for j in pland["jobs"] if j["host"] % 2 == r]
        for blocks in mine:
            assert f"[rank {r}] blocks {blocks} on cpu\n" in log
        assert f"[rank {r}] blocks done rc=0" in log
        assert f"[rank {r}] exit rc=0" in log
        assert f"[rank {r}] launches " in log
    recs2, ts2 = lasio.read_las(str(tmp_path / "reads.ref.las"))
    assert len(recs2) > 0

    single = _fresh_dir(tmp_path, "single")
    res1 = launch.run_plan_multihost(plan, nprocs=1, workdir=str(single),
                                     env_extra=CPU)
    assert res1["rc"] == 0, "\n".join(res1["logs"])
    recs1, ts1 = lasio.read_las(str(single / "reads.ref.las"))
    assert ts1 == ts2
    assert lasio.las_equal(recs1, recs2)

    direct = _fresh_dir(tmp_path, "direct")
    a, _ = tmapper.run_damapper(str(direct / "ref.dam"),
                                str(direct / "reads.db"),
                                tmapper.DamapperConfig(device="cpu", kmer=14),
                                out_dir=str(direct))
    recsd, tsd = lasio.read_las(a)
    assert tsd == ts2
    assert lasio.las_equal(recsd, recs2)


def test_global_index_fails_with_its_message(tmp_path, capsys):
    make_blocked_dataset(tmp_path, glen=40_000, nreads=8)
    plan = _plan(tmp_path, bunit=4, nhosts=1, opts="-k14")
    with pytest.raises(NotImplementedError, match="--global-index"):
        launch.run_plan_multihost(plan, nprocs=2, workdir=str(tmp_path),
                                  env_extra=CPU, global_index=True)
    assert not (tmp_path / "plan.json").exists()
    (tmp_path / "plan.json").write_text(plan)
    rc = launch.worker_main(["--rank", "0", "--nprocs", "2", "--coord",
                             "127.0.0.1:1", "--plan",
                             str(tmp_path / "plan.json"), "--out",
                             str(tmp_path), "--global-index"])
    assert rc != 0
    assert launch.GLOBAL_INDEX_UNSUPPORTED in capsys.readouterr().err
    assert not list(tmp_path.glob("*.las"))


def test_rank_without_card_fails(tmp_path, monkeypatch):
    """No card and no DAMAPPER_DEVICE=cpu: every rank raises (and still
    meets the others at the barriers), the run fails, nothing is merged."""
    monkeypatch.delenv("DAMAPPER_DEVICE", raising=False)
    make_blocked_dataset(tmp_path, glen=40_000, nreads=8)
    plan = _plan(tmp_path, bunit=1, nhosts=2, opts="-k14")
    res = launch.run_plan_multihost(plan, nprocs=2, workdir=str(tmp_path),
                                    env_extra={"OMP_NUM_THREADS": "1"})
    assert res["rc"] != 0
    for r, log in enumerate(res["logs"]):
        assert "no CUDA device is available" in log, log
        assert f"[rank {r}] exit rc=1" in log
        assert " on cpu" not in log
    assert not list(tmp_path.glob("*.las"))


def test_job_argv():
    assert launch._job_argv(
        "python -m damapper_tpu_torch.cli damapper -k14 ref reads.3") == \
        ["-k14", "ref", "reads.3"]
    assert launch._job_argv("x y") == ["x", "y"]

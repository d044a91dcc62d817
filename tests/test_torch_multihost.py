"""The port's plan runner (damapper_tpu_torch.parallel.launch) on
torch.distributed: two gloo processes on the CPU run a plan of the port,
and the merged .las must be record-identical to one process and to a
direct single-process run of the whole reads DB.  With --global-index the
two ranks run every job on one mesh across them (the reference index
sharded over the ranks) and must write the same .las, and a rank that fails
inside the cooperative match must stop every rank.  A rank with no card
that was not asked for the CPU must fail, not map on the host."""

import json
import os
import pathlib

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


def _global_index_dataset(tmp_path):
    make_blocked_dataset(tmp_path, glen=40_000, nreads=8)
    return _plan(tmp_path, bunit=4, nhosts=1, opts="-k14")


COOP = dict(CPU, DAMAPPER_INDEX="device")


def test_global_index_plan_matches_single(tmp_path):
    """--global-index over two gloo ranks (DAMAPPER_DEVICE=cpu,
    DAMAPPER_INDEX=device): every rank runs every job on one mesh whose
    "ref" axis spans the ranks, the seed match's counts, per-shard totals
    and emission buffers cross them, and the merged .las equals a
    single-rank run of the plan and damapper_tpu's single-process run."""
    plan = _global_index_dataset(tmp_path)
    pland = json.loads(plan)
    res2 = launch.run_plan_multihost(plan, nprocs=2, workdir=str(tmp_path),
                                     env_extra=COOP, global_index=True)
    assert res2["rc"] == 0, "\n".join(res2["logs"])
    for r, log in enumerate(res2["logs"]):
        for j in pland["jobs"]:
            assert (f"[rank {r}] blocks {j['blocks']} on cpu (global mesh)"
                    in log), log
        gloo = [json.loads(ln.split(" gloo ", 1)[1])
                for ln in log.splitlines()
                if ln.startswith(f"[rank {r}] gloo ")]
        assert len(gloo) == len(pland["jobs"])
        # three collectives a sharded match, two matches a read block
        assert all(g["collectives"] > 0 and g["collectives"] % 6 == 0
                   and g["bytes"] > 0 for g in gloo)
        assert f"[rank {r}] exit rc=0" in log
    recs2, ts2 = lasio.read_las(str(tmp_path / "reads.ref.las"))
    assert len(recs2) > 0

    single = _fresh_dir(tmp_path, "single")
    res1 = launch.run_plan_multihost(plan, nprocs=1, workdir=str(single),
                                     env_extra=COOP)
    assert res1["rc"] == 0, "\n".join(res1["logs"])
    recs1, ts1 = lasio.read_las(str(single / "reads.ref.las"))
    assert ts1 == ts2
    assert lasio.las_equal(recs1, recs2)

    from damapper_tpu.io import las as jlas
    from damapper_tpu.pipeline import mapper as jmapper
    jdir = _fresh_dir(tmp_path, "jax")
    a, _ = jmapper.run_damapper(
        str(jdir / "ref.dam"), str(jdir / "reads.db"),
        jmapper.DamapperConfig(kmer=14, wave_backend="oracle",
                               index_backend="device", mesh=None),
        out_dir=str(jdir))
    jrecs, jts = jlas.read_las(a)
    assert jts == ts2
    assert [r.key() for r in jrecs] == [r.key() for r in recs2]


RANK_SCRIPT = """import sys
from damapper_tpu_torch.ops import device_index as dix
from damapper_tpu_torch.parallel import launch
argv = sys.argv[1:]
if argv[argv.index("--rank") + 1] == "1":
    def fail(*a, **kw):
        raise RuntimeError("rank 1 failed inside the sharded match")
    dix._emit_shard = fail
sys.exit(launch.worker_main(argv))
"""


def test_global_index_rank_failure_stops_every_rank(tmp_path):
    """Rank 1 fails inside the cooperative seed match, between two of its
    cross-rank steps, while rank 0 waits in the next one: rank 0 learns of
    it there and stops (PeerFailed), both meet at the barriers, both exit
    non-zero, and nothing is written or merged."""
    import socket
    import subprocess
    import sys
    plan = _global_index_dataset(tmp_path)
    (tmp_path / "plan.json").write_text(plan)
    (tmp_path / "rank.py").write_text(RANK_SCRIPT)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ, **COOP)
    env["PYTHONPATH"] = str(pathlib.Path(launch.__file__).resolve()
                            .parents[2])
    procs = [subprocess.Popen(
        [sys.executable, str(tmp_path / "rank.py"), "--rank", str(r),
         "--nprocs", "2", "--coord", f"127.0.0.1:{port}", "--plan",
         str(tmp_path / "plan.json"), "--out", str(tmp_path),
         "--global-index"], env=env, cwd=str(tmp_path),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode != 0 for p in procs), outs
    assert "[rank 1] failed: RuntimeError('rank 1 failed inside" in outs[1]
    assert "[rank 0] failed: PeerFailed(" in outs[0], outs[0]
    for r, log in enumerate(outs):
        assert f"[rank {r}] exit rc=1" in log, log
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

"""The port's (dp, ref) mesh path against the JAX package's, on the CPU.

The port's meshes here are virtual shards of the CPU (one device named n
times); JAX runs on the conftest's eight virtual CPU devices.  Held: the
mesh layout rule, the dp-sharded wave engine against the unsharded one,
the mapper's .las on a (4, 2) mesh and on a dp-only mesh of 8 against
damapper_tpu's on the same mesh shape, the real-mapper dryrun, and that a
mesh that cannot be built raises where the JAX package falls back."""

import numpy as np
import pytest
import torch

from damapper_tpu.io import db as dbio
from damapper_tpu.io import fasta
from damapper_tpu.io import las as lasio
from damapper_tpu.parallel import mesh as jmesh
from damapper_tpu.pipeline import mapper as jmapper
from damapper_tpu_torch.convert import mesh_like
from damapper_tpu_torch.ops import wave_cuda as twc
from damapper_tpu_torch.ops import wave_engine as twe
from damapper_tpu_torch.ops.spec import new_align_spec
from damapper_tpu_torch.parallel import mesh as tmesh
from damapper_tpu_torch.pipeline import mapper as tmapper
from damapper_tpu_torch.utils.sim import make_lane_cases
from tests import helpers

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8


@pytest.mark.parametrize("ref_shards", [None, 1, 2, 4])
@pytest.mark.parametrize("n", range(1, 9))
def test_make_mesh_matches_jax(n, ref_shards):
    """make_mesh's shape and layout equal damapper_tpu's make_mesh over the
    first n devices; where JAX cannot lay the devices out, the port raises
    too."""
    try:
        jm = jmesh.make_mesh(n, ref_shards=ref_shards)
    except ValueError:
        with pytest.raises(ValueError):
            tmesh.make_mesh(n, ref_shards=ref_shards, devices=CPU8)
        return
    tm = tmesh.make_mesh(n, ref_shards=ref_shards, devices=CPU8)
    assert tm.shape == dict(jm.shape)
    assert tm.axis_names == tuple(jm.axis_names)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(
        tmesh._layout(n, ref_shards, np.zeros(n, np.int64)), ids)
    assert not tm.is_multiprocess()
    assert len(tm.local_positions()) == n


def test_layout_across_ranks():
    """When the devices span ranks, "ref" crosses the ranks and "dp" stays
    within each (damapper_tpu/parallel/mesh.py:54-59); one ref shard turns
    into one a rank."""
    ranks = np.array([0, 0, 1, 1])
    np.testing.assert_array_equal(tmesh._layout(4, None, ranks),
                                  [[0, 2], [1, 3]])
    np.testing.assert_array_equal(tmesh._layout(4, 1, ranks), [[0, 1, 2, 3]])
    m = tmesh.make_mesh(2, devices=["cpu", "cpu"], ranks=[0, 1])
    assert m.shape == {"dp": 1, "ref": 2}
    assert m.ranks.tolist() == [[0, 1]] and m.is_multiprocess()
    assert m.local_positions() == [(0, 0)]


def test_mesh_naming_cuda_without_card_raises(monkeypatch):
    """A mesh of CUDA devices, or the default mesh (every card), raises
    without a card: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh(2, devices=["cuda:0", "cuda:0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.dryrun_multichip(8)


def test_auto_mesh_raises_where_jax_returns_none(monkeypatch):
    """damapper_tpu's _auto_mesh swallows a failed mesh build and maps on
    one device; the port's raises.  DAMAPPER_COOP=1 without a process group
    raises too; one device gives no mesh."""
    def broken(*a, **kw):
        raise ValueError("no mesh")
    monkeypatch.setattr(jmesh, "make_mesh", broken)
    monkeypatch.setattr(tmesh, "make_mesh", broken)
    assert jmapper._auto_mesh() is None
    cpu = torch.device("cpu")
    assert tmapper._auto_mesh(cpu) is None
    monkeypatch.setattr(tmapper, "_local_devices", lambda d: [d, d])
    with pytest.raises(ValueError, match="no mesh"):
        tmapper._auto_mesh(cpu)
    monkeypatch.setenv("DAMAPPER_COOP", "1")
    with pytest.raises(RuntimeError, match="process group"):
        tmapper._auto_mesh(cpu)


@pytest.mark.parametrize("mode", ["classic", "classic+packops",
                                  "persistent"])
def test_dp_sharded_engine_matches_unsharded(monkeypatch, mode):
    """The engine on a dp mesh of 3 virtual shards (7 lanes: two filler
    lanes) gives the unsharded engine's paths and telemetry; each round
    launches one kernel per shard on an equal share of the lanes, and the
    engine counts a launch per shard."""
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    seqmem, insts = make_lane_cases(77, 7, glen=3000, rlen=1200,
                                    rmin=800, err=0.15)
    kw = dict(persistent=mode == "persistent",
              packops=mode == "classic+packops")
    calls = []
    real = twe.wave_lanes

    def counting(*a, layout="plain", **k):
        calls.append(int(a[0].shape[0]))
        out = real(*a, layout=layout, **k)
        twc.count_launch(twc.wave_lanes, layout)   # a stand-in launch
        return out
    monkeypatch.setattr(twe, "wave_lanes", counting)
    outs = {}
    for nm, mesh in (("single", None),
                     ("dp3", tmesh.Mesh(np.array(["cpu"] * 3, object),
                                        ("dp",)))):
        eng = twe.WaveEngine(spec, device="cpu", host_min=0, mesh=mesh, **kw)
        mem = eng.upload(seqmem)
        calls.clear()
        res = eng.local_alignment_batch(mem, mem, seqmem, seqmem, insts)
        outs[nm] = ([(p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs,
                      list(p.trace)) for pair in res for p in pair],
                    eng.total_waves, eng.n_fallback, eng.n_winmiss,
                    eng.n_total)
        if mode != "persistent":
            assert len(calls) >= 2
            nshard = 1 if mesh is None else 3
            assert len(calls) % nshard == 0
            if mesh is not None:
                # the first round: 7 lanes padded to 9, 3 a shard
                assert calls[:3] == [3, 3, 3]
            assert sum(eng.launches.values()) == len(calls)
    assert outs["dp3"] == outs["single"]
    assert outs["single"][1] > 0


def test_engine_rejects_a_mesh_across_ranks():
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    m = tmesh.make_mesh(2, devices=["cpu", "cpu"], ranks=[0, 1])
    with pytest.raises(ValueError, match="unsharded on every rank"):
        twe.WaveEngine(spec, device="cpu", mesh=m)


@pytest.fixture(scope="module")
def sharding_dbs(tmp_path_factory):
    """tests/test_sharding.py's dataset: a 40 kb genome, 8 reads."""
    tmp = tmp_path_factory.mktemp("torch_mesh")
    rng = np.random.default_rng(21)
    genome = helpers.sim_genome(rng, 40_000)
    reads = [helpers.sim_read(rng, genome, min_len=2000, max_len=5000)[0]
             for _ in range(8)]
    dbio.create_dam(str(tmp / "ref.dam"), [fasta.FastaEntry("ctg0", genome)])
    dbio.create_db(str(tmp / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)])
    return tmp


def _keys(path):
    recs, tspace = lasio.read_las(path)
    return tspace, [r.key() for r in recs]


@pytest.mark.parametrize("shape", ["dp4_ref2", "dp8"])
def test_run_damapper_on_mesh_matches_jax(sharding_dbs, monkeypatch, shape):
    """run_damapper on a (4, 2) mesh (sharded index and match, dp-sharded
    wave) and on a dp-only mesh of 8 (dp-sharded wave, unsharded index)
    writes damapper_tpu's .las on the same mesh shape (its host oracle
    wave, device index)."""
    import jax
    from jax.sharding import Mesh as JaxMesh
    jm = (jmesh.make_mesh(8) if shape == "dp4_ref2"
          else JaxMesh(np.array(jax.devices()), ("dp",)))
    ref, reads = str(sharding_dbs / "ref.dam"), str(sharding_dbs / "reads.db")
    monkeypatch.setattr(tmapper, "_ref_index_cache", {})
    monkeypatch.setattr(tmapper, "_ref_index_cache_bytes", [0])
    outs = {}
    for nm in ("jax", "mesh"):
        d = sharding_dbs / f"{shape}_{nm}"
        d.mkdir()
        if nm == "jax":
            a, _ = jmapper.run_damapper(ref, reads, jmapper.DamapperConfig(
                wave_backend="oracle", index_backend="device", mesh=jm),
                out_dir=str(d))
        else:
            mesh = mesh_like(jm.shape, CPU8)
            a, _ = tmapper.run_damapper(ref, reads, tmapper.DamapperConfig(
                device="cpu", index_backend="device", host_min=0,
                mesh=mesh), out_dir=str(d))
            st = tmapper.LAST_STATS
            assert st["mesh"] == dict(jm.shape)
            assert st["n_lanes"] > 0 and st["n_hostmin"] == 0
            assert (st["ref_index_builds"], st["ref_index_cache_hits"]) == \
                (1, 0)
            # the sharded index never enters the cache; the dp-only mesh's
            # unsharded one does
            assert len(tmapper._ref_index_cache) == (shape == "dp8")
        outs[nm] = _keys(a)
    assert outs["jax"][1], "no record mapped"
    assert outs["mesh"] == outs["jax"]


def test_dryrun_8_on_cpu_virtual_shards():
    """The port's dryrun(8) on eight virtual shards of the CPU: the real
    mapper on a (4, 2) mesh writes the single-device run's .las (asserted
    inside), over the sharded match and the dp-sharded engine."""
    out = tmesh.dryrun_multichip(8, "cpu")
    assert out["records"] > 0
    assert out["mesh"]["mesh"] == {"dp": 4, "ref": 2}
    assert out["single"]["mesh"] is None
    assert out["mesh"]["n_lanes"] == out["single"]["n_lanes"] > 0
    assert out["mesh"]["total_waves"] == out["single"]["total_waves"]

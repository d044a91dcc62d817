"""The port's wave dump hook and its replay tool, on the CPU.

DAMAPPER_WAVE_DUMP makes the wave engine append every round's seeds to a
file (ops/wave_engine.py, as damapper_tpu/ops/wave_jax.py does), and
damapper_tpu_torch.tools.wave_replay replays such a dump, the engine
(plain PyTorch wave on the CPU here) against the host oracle.  Held: the
port's dump equals damapper_tpu's on the same run, call by call and seed by
seed (a tiny host round included); the replay finds no mismatch, and finds
exactly the lane whose engine result a test alters; its A and B memories
are the reporter's; a dp-sharded engine dumps a round once."""

import contextlib
import copy
import io
import pickle

import numpy as np
import pytest
import torch

from damapper_tpu.io import db as dbio
from damapper_tpu.io import fasta
from damapper_tpu.pipeline.mapper import DamapperConfig as JaxConfig
from damapper_tpu.pipeline.mapper import run_damapper as jax_run
from damapper_tpu_torch.ops import wave_engine as twe
from damapper_tpu_torch.ops.spec import new_align_spec
from damapper_tpu_torch.parallel import mesh as tmesh
from damapper_tpu_torch.pipeline import mapper as tmapper
from damapper_tpu_torch.pipeline import reporter as treporter
from damapper_tpu_torch.tools import wave_replay
from damapper_tpu_torch.utils.sim import make_lane_cases
from tests import helpers

torch.set_num_threads(1)


def _write_dataset(tmp, seed=5, glen=60_000, nreads=16):
    """Two contigs whose first holds four copies of one 4 kb stretch, and
    16 reads of 2-6 kb: the mapping takes a round of 32 seeds and a round
    of one (a tiny round, which the engine sends to the host oracle)."""
    rng = np.random.default_rng(seed)
    g = list(helpers.sim_genome(rng, glen))
    for k in range(4):
        g[10_000 + 12_000 * k:14_000 + 12_000 * k] = g[2_000:6_000]
    g = "".join(g)
    half = glen // 2
    entries = [fasta.FastaEntry(f"ctg{i}", g[i * half:(i + 1) * half])
               for i in range(2)]
    reads = [helpers.sim_read(rng, entries[int(rng.integers(0, 2))].seq,
                              min_len=2000, max_len=6000)[0]
             for _ in range(nreads)]
    dbio.create_dam(str(tmp / "ref.dam"), entries, bsize=70_000)
    dbio.create_db(str(tmp / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)])


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Both packages' dumps of one mapping of the dataset, and what the
    port's reporter handed the engine (A, B on the device and the host)."""
    tmp = tmp_path_factory.mktemp("wave_dump")
    _write_dataset(tmp)
    mp = pytest.MonkeyPatch()
    try:
        (tmp / "jax").mkdir()
        mp.setenv("DAMAPPER_WAVE_DUMP", str(tmp / "jax.pkl"))
        jax_run(str(tmp / "ref.dam"), str(tmp / "reads.db"),
                JaxConfig(wave_backend="pallas", index_backend="host",
                          mesh=None), out_dir=str(tmp / "jax"))
        seen = []
        real = twe.WaveEngine.local_alignment_batch

        def recording(self, Adev, Bdev, Anp, Bnp, seeds):
            seen.append((Adev, Bdev, Anp, Bnp))
            return real(self, Adev, Bdev, Anp, Bnp, seeds)

        mp.setattr(twe.WaveEngine, "local_alignment_batch", recording)
        (tmp / "torch").mkdir()
        mp.setenv("DAMAPPER_WAVE_DUMP", str(tmp / "torch.pkl"))
        # the port at its own tiny-round threshold (16): the engine reads
        # DAMAPPER_WAVE_HOSTMIN, which the test configuration sets to 0
        mp.delenv("DAMAPPER_WAVE_HOSTMIN", raising=False)
        tmapper.run_damapper(str(tmp / "ref.dam"), str(tmp / "reads.db"),
                             tmapper.DamapperConfig(device="cpu"),
                             out_dir=str(tmp / "torch"))
        stats = dict(tmapper.LAST_STATS)
    finally:
        mp.undo()
    return tmp, seen, stats


@pytest.fixture(scope="module")
def replayed(dumps):
    """One run of the replay tool over the port's dump with --device cpu:
    its exit code and output, the memories it uploaded and handed the
    engine, and the engine's results of every call."""
    tmp, _, _ = dumps
    uploads, handed, results = [], [], []
    real_up = treporter._upload_section
    real_batch = twe.WaveEngine.local_alignment_batch

    def upload(flat, boffs, rlens, device):
        out = real_up(flat, boffs, rlens, device)
        uploads.append(out)
        return out

    def batch(self, Adev, Bdev, Anp, Bnp, seeds):
        handed.append((Adev, Bdev, Anp, Bnp))
        res = real_batch(self, Adev, Bdev, Anp, Bnp, seeds)
        results.append(copy.deepcopy(res))
        return res

    mp = pytest.MonkeyPatch()
    out = io.StringIO()
    try:
        mp.setattr(treporter, "_upload_section", upload)
        mp.setattr(twe.WaveEngine, "local_alignment_batch", batch)
        with contextlib.redirect_stdout(out):
            rc = wave_replay.main([str(tmp / "torch.pkl"), str(tmp / "reads"),
                                   str(tmp / "ref"), "--device", "cpu"])
    finally:
        mp.undo()
    return rc, out.getvalue(), uploads, handed, results


def test_dump_equals_jax_dump(dumps):
    """(a) Call by call and seed by seed, the port's dump is damapper_tpu's;
    the tiny round the port sends to the host oracle is in it."""
    tmp, seen, stats = dumps
    jcalls = wave_replay.read_dump(tmp / "jax.pkl")
    tcalls = wave_replay.read_dump(tmp / "torch.pkl")
    assert [len(c) for c in tcalls] == [len(c) for c in jcalls]
    assert len(tcalls) >= 2 and min(map(len, tcalls)) < 16
    for jc, tc in zip(jcalls, tcalls):
        for js, ts in zip(jc, tc):
            assert {k: int(v) for k, v in js.items()} == ts
    assert len(seen) == len(tcalls)
    assert stats["n_hostmin"] == min(map(len, tcalls)) > 0
    # one pickle a call, as the JAX engine writes it
    with open(tmp / "torch.pkl", "rb") as fh:
        assert pickle.load(fh) == tcalls[0]


def test_replay_finds_no_mismatch(replayed, dumps):
    """(b) Every dumped seed replays on the engine (host_min=0: the tiny
    round too) and every lane equals the oracle's; exit code 0."""
    rc, text, _, _, results = replayed
    tmp, _, _ = dumps
    calls = wave_replay.read_dump(tmp / "torch.pkl")
    n = sum(map(len, calls))
    assert rc == 0, text
    assert f"0 mismatching lanes of {n} checked, {n} replayed on cpu" in text
    assert "LANE MISMATCH" not in text
    assert [len(r) for r in results] == [len(c) for c in calls]


@pytest.mark.parametrize("where", [(0, 5), (1, 0)], ids=["round0", "round1"])
def test_replay_reports_an_altered_lane(replayed, dumps, monkeypatch,
                                        capsys, where):
    """(c) With one lane's engine result altered (its A path one diff
    more), the tool reports exactly that lane and exits 1."""
    _, _, _, _, results = replayed
    tmp, _, _ = dumps
    calls = enumerate(copy.deepcopy(results))
    ci, li = where

    def altered(self, Adev, Bdev, Anp, Bnp, seeds):
        k, res = next(calls)
        if k == ci:
            res[li][0].diffs += 1
        return res

    monkeypatch.setattr(twe.WaveEngine, "local_alignment_batch", altered)
    rc = wave_replay.main([str(tmp / "torch.pkl"), str(tmp / "reads"),
                           str(tmp / "ref"), "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 1
    bad = [ln for ln in text.splitlines() if ln.startswith("LANE MISMATCH")]
    assert len(bad) == 1
    assert bad[0].startswith(f"LANE MISMATCH call {ci} lane {li} field "
                             f"a.diffs ")
    assert "1 mismatching lanes of" in text


def test_replay_range_bounds_the_oracle_only(replayed, dumps, monkeypatch,
                                             capsys):
    """An abase range bounds the oracle's lanes; the engine still replays
    every seed, and a lane altered outside the range goes unreported."""
    _, _, _, _, results = replayed
    tmp, _, _ = dumps
    seeds = wave_replay.read_dump(tmp / "torch.pkl")
    calls = iter(copy.deepcopy(results))
    first = seeds[0][0]["abase"]
    inside = sum(s["abase"] == first for c in seeds for s in c)
    handed = []

    def altered(self, Adev, Bdev, Anp, Bnp, seeds_):
        handed.append(len(seeds_))
        res = next(calls)
        for i, s in enumerate(seeds_):
            if s["abase"] != first:
                res[i][0].diffs += 1
        return res

    monkeypatch.setattr(twe.WaveEngine, "local_alignment_batch", altered)
    rc = wave_replay.main([str(tmp / "torch.pkl"), str(tmp / "reads"),
                           str(tmp / "ref"), f"{first}:{first + 1}",
                           "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0, text
    assert handed == [len(c) for c in seeds]
    assert f"0 mismatching lanes of {inside} checked" in text


def test_replay_memories_are_the_reporters(replayed, dumps):
    """(d) The tool's A and B memories, host and device, equal those the
    port's reporter handed the engine: A = [reads | comp reads] (the
    reporter's flat_a), B = the reference's sequence."""
    _, _, uploads, handed, _ = replayed
    _, seen, _ = dumps
    Adev, Bdev, Anp, Bnp = seen[0]
    tA, tB, tAnp, tBnp = handed[0]
    np.testing.assert_array_equal(tAnp, Anp)
    np.testing.assert_array_equal(tBnp, Bnp)
    assert torch.equal(tA, Adev) and torch.equal(tB, Bdev)
    assert [u.shape[0] for u in uploads] == [len(Anp), len(Bnp)]
    assert all(h[0] is tA and h[1] is tB for h in handed)


def test_mesh_engine_dumps_a_round_once(tmp_path, monkeypatch):
    """A dp-sharded engine (3 virtual CPU shards) writes one dump entry a
    round, the unsharded engine's, not one a shard."""
    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    seqmem, insts = make_lane_cases(77, 7, glen=3000, rlen=1200, rmin=800,
                                    err=0.15)
    got = {}
    for nm, mesh in (("single", None),
                     ("dp3", tmesh.Mesh(np.array(["cpu"] * 3, object),
                                        ("dp",)))):
        path = tmp_path / f"{nm}.pkl"
        monkeypatch.setenv("DAMAPPER_WAVE_DUMP", str(path))
        eng = twe.WaveEngine(spec, device="cpu", host_min=0, mesh=mesh)
        mem = eng.upload(seqmem)
        eng.local_alignment_batch(mem, mem, seqmem, seqmem, insts)
        eng.local_alignment_batch(mem, mem, seqmem, seqmem, insts[:2])
        got[nm] = wave_replay.read_dump(path)
    assert got["dp3"] == got["single"] == [insts, insts[:2]]

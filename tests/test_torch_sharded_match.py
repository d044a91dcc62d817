"""The port's sharded seed match (ops.device_index.shard_index,
device_match_seeds_sharded) against damapper_tpu's, on the CPU.

Both packages match the same indexes: damapper_tpu's device indexes, carried
into the port by convert.device_index_from_numpy.  JAX runs its shard_map
programs on the conftest's eight virtual CPU devices; the port runs its
meshes on eight virtual shards of the CPU.  Hits must be equal array for
array, in order (tolerance 0), on meshes (8, 1), (4, 2), (2, 4) and (1, 8),
in both frames, with -M unbounded, biting and raising; and equal to the
port's own single-device device_match_seeds."""

import numpy as np
import pytest
import torch

from damapper_tpu.io import db as jdbio
from damapper_tpu.io import fasta
from damapper_tpu.ops import device_index as jdx
from damapper_tpu.parallel import mesh as jmesh
from damapper_tpu_torch import convert
from damapper_tpu_torch.ops import device_index as tdx
from tests import helpers
from tests.test_torch_device_index import _assert_hits, _load, _write

torch.set_num_threads(1)
CPU8 = ["cpu"] * 8
MESHES = [(8, 1), (4, 2), (2, 4), (1, 8)]
_JAX_MESHES = {}


def _meshes(shape):
    """(JAX mesh, the port's mesh) of a (dp, ref) shape; the JAX mesh is
    made once (its sharded programs are cached on it)."""
    if shape not in _JAX_MESHES:
        _JAX_MESHES[shape] = jmesh.make_mesh(8, ref_shards=shape[1])
    jm = _JAX_MESHES[shape]
    assert (jm.shape["dp"], jm.shape["ref"]) == shape
    return jm, convert.mesh_like(jm.shape, CPU8)


def _port(j):
    """damapper_tpu's DeviceKmerIndex as the port's, on the CPU."""
    return convert.device_index_from_numpy(
        np.asarray(j.hi), np.asarray(j.lo), np.asarray(j.pos), j.n,
        np.asarray(j.boffs), j.kmer, np.asarray(j.rlens), "cpu")


class _Set:
    """One dataset's indexes in both packages: reads fwd, reads revcomp,
    ref fwd, and the DBs' byte size (the -M accounting)."""

    def __init__(self, path, k):
        jr, jd = (_load(jdbio, path / f) for f in ("reads.db", "ref.dam"))
        self.j = (jdx.device_sort_kmers(jr, k),
                  jdx.device_sort_kmers(jr, k, comp=True),
                  jdx.device_sort_kmers(jd, k))
        self.t = tuple(_port(x) for x in self.j)
        self.db_bytes = jr.sizeof() + jd.sizeof()


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    out = {}
    tmp = tmp_path_factory.mktemp("torch_shard_match")
    _write(tmp, 11, 40_000, 10)
    out["plain"] = _Set(tmp, 16)
    tmp = tmp_path_factory.mktemp("torch_shard_repeat")
    _write(tmp, 3, 16_000, 6, repeat=True)
    out["repeat"] = _Set(tmp, 14)
    return out


def _both(s, shape, comp, mem, db_bytes):
    """(JAX hits, the port's hits) of one sharded match; a MemoryError of
    either is returned in place of its hits."""
    jm, tm = _meshes(shape)
    ja = s.j[1] if comp else s.j[0]
    ta = s.t[1] if comp else s.t[0]
    out = []
    for mod, m, a, b in ((jdx, jm, ja, s.j[2]), (tdx, tm, ta, s.t[2])):
        try:
            out.append(mod.device_match_seeds_sharded(
                mod.shard_index(a, m, "dp"), mod.shard_index(b, m, "ref"), m,
                mem, db_bytes, comp_frame=comp))
        except MemoryError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("frame", ["fwd", "comp"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"dp{s[0]}_ref{s[1]}")
def test_sharded_match_matches_jax(sets, shape, frame):
    """Unbounded, biting (-M on a repetitive genome) and raising (a zero
    budget over unique k-mer pairs): the port's hits equal JAX's, and its
    single-device match's; where JAX raises MemoryError, so does the
    port."""
    comp = frame == "comp"
    for name, set_, mem in (("unbounded", "plain", 0),
                            ("biting", "repeat", None),
                            ("raising", "plain", None)):
        s = sets[set_]
        a, b = s.t[1 if comp else 0], s.t[2]
        db_bytes = s.db_bytes
        if name == "biting":
            # a budget of about half the unbounded hits (map.c:2992-3012)
            full = len(tdx.device_match_seeds(a, b, comp_frame=comp))
            mem = db_bytes + 16 * (a.n + b.n + full // 2)
        elif name == "raising":
            mem = db_bytes + 16 * (a.n + b.n)
        jh, th = _both(s, shape, comp, mem, db_bytes)
        if name == "raising":
            assert isinstance(jh, MemoryError), name
            assert isinstance(th, MemoryError), name
            continue
        _assert_hits(jh, th, f"{name} jax")
        single = tdx.device_match_seeds(a, b, mem, db_bytes, comp_frame=comp)
        _assert_hits(single, th, f"{name} single-device")
        assert len(th) > 0
        if name == "biting":
            assert len(th) < full


def test_negative_budget_parts_the_two_device_paths(sets):
    """A budget below zero: the sharded path takes the host match_limit
    and raises MemoryError (JAX and the port); the single-device path
    clamps the budget to zero and matches (JAX and the port, equal)."""
    s = sets["repeat"]
    for comp in (False, True):
        jh, th = _both(s, (4, 2), comp, s.db_bytes, s.db_bytes)
        assert isinstance(jh, MemoryError) and isinstance(th, MemoryError)
        a, ja = (s.t[1], s.j[1]) if comp else (s.t[0], s.j[0])
        _assert_hits(jdx.device_match_seeds(ja, s.j[2], s.db_bytes,
                                            s.db_bytes, comp_frame=comp),
                     tdx.device_match_seeds(a, s.t[2], s.db_bytes,
                                            s.db_bytes, comp_frame=comp),
                     "single-device")


@pytest.mark.parametrize("frame", ["fwd", "comp"])
def test_sort_keys_unique_and_order_free(sets, monkeypatch, frame):
    """The five sort keys (aread, bread, apos, tie1, tie2) are unique over
    the real hits, so the order in which the positions' buffers are
    concatenated does not matter: reversed, the hits are the same."""
    comp = frame == "comp"
    s = sets["plain"]
    _, tm = _meshes((2, 4))
    a = tdx.shard_index(s.t[1] if comp else s.t[0], tm, "dp")
    b = tdx.shard_index(s.t[2], tm, "ref")
    real = tdx._sort_hits
    seen = []

    def reversed_order(bufs, *args):
        h = torch.cat(bufs, 1)
        live = h[:, h[0] != tdx._IMAX]
        seen.append((live.shape[1],
                     len(set(map(tuple, live[:5].T.tolist())))))
        return real(bufs[::-1], *args)
    want = tdx.device_match_seeds_sharded(a, b, tm, comp_frame=comp)
    monkeypatch.setattr(tdx, "_sort_hits", reversed_order)
    got = tdx.device_match_seeds_sharded(a, b, tm, comp_frame=comp)
    _assert_hits(want, got, "reversed")
    (nreal, nuniq), = seen
    assert nreal == nuniq == len(want) > 0


def test_shard_index_views_replicas_and_no_mutation(sets):
    """On virtual shards every shard is a view of the index (no copy), the
    read tables are the index's own tensors, a sharded match leaves every
    tensor as it was, and a length that does not split raises."""
    s = sets["plain"]
    _, tm = _meshes((4, 2))
    a = tdx.shard_index(s.t[0], tm, "dp")
    b = tdx.shard_index(s.t[2], tm, "ref")
    per = s.t[0].key.shape[0] // 4
    for (i, _), (key, pos) in a.parts.items():
        assert key.data_ptr() == s.t[0].key[i * per:].data_ptr()
        assert key.shape[0] == per and pos.shape[0] == per
    assert len(a.parts) == len(b.parts) == 8
    (boffs, rlens), = a.reps.values()
    assert boffs is s.t[0].boffs and rlens is s.t[0].rlens
    before = [x.clone() for x in (s.t[0].key, s.t[0].pos, s.t[2].key,
                                  s.t[2].pos, s.t[2].boffs, s.t[2].rlens)]
    for comp in (False, True):
        tdx.device_match_seeds_sharded(a, b, tm, 1 << 34, 1000,
                                       comp_frame=comp)
    for x, y in zip(before, (s.t[0].key, s.t[0].pos, s.t[2].key,
                             s.t[2].pos, s.t[2].boffs, s.t[2].rlens)):
        assert torch.equal(x, y)
    # index lengths are 2^k or 3 * 2^k: never a multiple of 5
    with pytest.raises(ValueError, match="does not split"):
        tdx.shard_index(s.t[0], convert.mesh_like((5, 1), CPU8), "dp")


def test_k32_sentinel_keys_in_every_shard(tmp_path):
    """k=32 over a genome with a 300 bp run of T: real all-T 32-mers carry
    the sentinel key that the trailing ref shards' pads carry too; the
    search stops at each shard's live entries, so no pad is matched."""
    rng = np.random.default_rng(5)
    g = helpers.sim_genome(rng, 20_000)
    genome = g[:10_000] + "T" * 300 + g[10_000:]
    reads = [genome[9_500:11_000], genome[9_900:10_500]]
    reads += [helpers.sim_read(rng, genome, min_len=1500, max_len=3000)[0]
              for _ in range(4)]
    jdbio.create_dam(str(tmp_path / "ref.dam"),
                     [fasta.FastaEntry("ctg0", genome)])
    jdbio.create_db(str(tmp_path / "reads.db"),
                    [fasta.FastaEntry(f"r{i}", r)
                     for i, r in enumerate(reads)])
    s = _Set(tmp_path, 32)
    sent = tdx.SENT
    assert int((s.t[2].key[:s.t[2].n] == sent).sum()) >= 200
    assert int((s.t[0].key[:s.t[0].n] == sent).sum()) >= 200
    # eight ref shards: the trailing ones hold the pads
    for comp in (False, True):
        jh, th = _both(s, (1, 8), comp, 0, 0)
        _assert_hits(jh, th, f"comp={comp}")
        _assert_hits(tdx.device_match_seeds(
            s.t[1] if comp else s.t[0], s.t[2], comp_frame=comp), th,
            "single-device")
        assert len(th) > 0

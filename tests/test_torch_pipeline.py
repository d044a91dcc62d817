"""The port's mapper against the JAX package's, end to end on the CPU.

One small simulated dataset (60 kb genome in 2 contigs, 12 reads of 2-6 kb)
is mapped by damapper_tpu (pallas wave engine on its XLA path, host index,
no mesh) and by damapper_tpu_torch (wave engine on the CPU, plain PyTorch
wave).  The .las records must be identical, and the -p track byte for byte.
"""

import dataclasses

import numpy as np
import pytest

from damapper_tpu.io import db as dbio
from damapper_tpu.io import fasta
from damapper_tpu.io import las as lasio
from damapper_tpu.ops.spec import new_align_spec
from damapper_tpu.pipeline.mapper import DamapperConfig as JaxConfig
from damapper_tpu.pipeline.mapper import run_damapper as jax_run
from damapper_tpu_torch.convert import align_spec_from_numpy
from damapper_tpu_torch.ops.spec import AlignSpec as TorchAlignSpec
from damapper_tpu_torch.pipeline import mapper as tmapper
from tests import helpers


def _write_dataset(tmp, seed=11, glen=60_000, ncontigs=2, nreads=12):
    rng = np.random.default_rng(seed)
    genome = helpers.sim_genome(rng, glen)
    clen = glen // ncontigs
    entries = [fasta.FastaEntry(f"ctg{i}", genome[i * clen:(i + 1) * clen])
               for i in range(ncontigs)]
    reads = []
    for _ in range(nreads):
        ci = int(rng.integers(0, ncontigs))
        r, *_ = helpers.sim_read(rng, entries[ci].seq, min_len=2000,
                                 max_len=6000)
        reads.append(r)
    # one reference block, and the same reference in two blocks
    dbio.create_dam(str(tmp / "ref.dam"), entries, bsize=70_000)
    dbio.create_dam(str(tmp / "refmb.dam"), entries, bsize=25_000)
    dbio.create_db(str(tmp / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)])


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_pipeline")
    _write_dataset(tmp)
    assert dbio.read_stub(str(tmp / "refmb.dam")).nblocks > 1
    return tmp


def _keys(path):
    recs, tspace = lasio.read_las(path)
    return tspace, [r.key() for r in recs]


@pytest.mark.parametrize("variant", ["default_p", "C", "n95", "multiblock"])
def test_las_identical_to_jax(dataset, variant):
    """(d) Record-identical .las for the default run (with the -p profile
    track, byte-identical), -C (both .las files), -n.95, and a reference
    in two blocks."""
    kw = {"default_p": dict(profile=True), "C": dict(do_b=True),
          "n95": dict(best_tie=.95), "multiblock": {}}[variant]
    ref = "refmb.dam" if variant == "multiblock" else "ref.dam"
    jdir, tdir = dataset / f"jax_{variant}", dataset / f"torch_{variant}"
    jdir.mkdir()
    tdir.mkdir()
    jout = jax_run(str(dataset / ref), str(dataset / "reads.db"),
                   JaxConfig(wave_backend="pallas", index_backend="host",
                             mesh=None, **kw), out_dir=str(jdir))
    tout = tmapper.run_damapper(str(dataset / ref),
                                str(dataset / "reads.db"),
                                tmapper.DamapperConfig(device="cpu",
                                                       host_min=0, **kw),
                                out_dir=str(tdir))
    stats = tmapper.LAST_STATS
    assert stats["n_lanes"] > 0 and stats["n_hostmin"] == 0
    for jp, tp in zip(jout, tout):
        assert (jp is None) == (tp is None)
        if jp is None:
            continue
        jt, jk = _keys(jp)
        tt, tk = _keys(tp)
        assert jt == tt and len(jk) > 0
        assert jk == tk
    if kw.get("profile"):
        for ext in (".prof.anno", ".prof.data"):
            assert ((jdir / f".reads{ext}").read_bytes()
                    == (tdir / f".reads{ext}").read_bytes()), ext


@pytest.mark.parametrize("params", [(0.85, 100, (.25, .25, .25, .25)),
                                    (0.70, 50, (.30, .20, .20, .30)),
                                    (0.95, 200, (.20, .30, .30, .20))])
def test_align_spec_from_numpy_round_trip(params):
    """(e) A JAX-side AlignSpec's fields carried over as plain numpy give the
    port's AlignSpec field for field, and a second trip changes nothing."""
    ave, space, freq = params
    jspec = new_align_spec(ave, space, np.array(freq), True)
    fields = {f.name: np.asarray(getattr(jspec, f.name))
              for f in dataclasses.fields(jspec)}
    tspec = align_spec_from_numpy(fields)
    assert isinstance(tspec, TorchAlignSpec)
    again = align_spec_from_numpy(tspec)
    for f in dataclasses.fields(jspec):
        want = np.asarray(getattr(jspec, f.name))
        for got in (getattr(tspec, f.name), getattr(again, f.name)):
            got = np.asarray(got)
            assert got.dtype == want.dtype, f.name
            np.testing.assert_array_equal(got, want, err_msg=f.name)

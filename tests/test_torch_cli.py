"""The port's host subcommands (damapper_tpu_torch.cli) against
damapper_tpu.cli on the same files, tolerance 0 (bytes).

Each case copies one small dataset (a 30 kb reference, 9 reads in three
blocks, each block mapped by the port on the CPU, a corrupt .las, two
fasta files) into two directories, runs the same argv through each CLI in
its own directory, and requires equal exit codes, stdout and stderr bytes,
raised errors and every file left in the directory: the eight subcommands,
their '@' block ranges, and their illegal-option and usage paths."""

import dataclasses
import shutil

import numpy as np
import pytest

from damapper_tpu import cli as jcli
from damapper_tpu_torch import cli as tcli
from damapper_tpu_torch.io import db as dbio
from damapper_tpu_torch.io import fasta
from damapper_tpu_torch.io import las as lasio
from damapper_tpu_torch.pipeline import mapper as tmapper
from tests import helpers


def _write_fasta(path, entries):
    with open(path, "w") as fh:
        for nm, seq in entries:
            fh.write(f">{nm}\n")
            for i in range(0, len(seq), 70):
                fh.write(seq[i:i + 70] + "\n")


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli") / "data"
    d.mkdir()
    rng = np.random.default_rng(23)
    genome = helpers.sim_genome(rng, 30_000)
    reads = [helpers.sim_read(rng, genome, min_len=1500, max_len=3000)[0]
             for _ in range(9)]
    dbio.create_dam(str(d / "ref.dam"), [fasta.FastaEntry("ctg0", genome)])
    dbio.create_db(str(d / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r) for i, r in enumerate(reads)],
                   bsize=7_000)
    nblocks = dbio.read_stub(str(d / "reads.db")).nblocks
    assert nblocks == 3
    cfg = tmapper.DamapperConfig(device="cpu", kmer=14)
    for k in range(1, nblocks + 1):
        tmapper.run_damapper(str(d / "ref.dam"), str(d / f"reads.{k}"), cfg,
                             out_dir=str(d))
    recs, tspace = lasio.read_las(str(d / "reads.1.ref.las"))
    assert recs
    bad = [dataclasses.replace(recs[0], abpos=recs[0].aepos)] + recs[1:]
    lasio.write_las(str(d / "bad.las"), bad, tspace)
    _write_fasta(d / "genome.fasta", [("g/0", genome[:12_000]),
                                      ("g/1", genome[12_000:])])
    _write_fasta(d / "reads.fasta", [(f"m/{i}/0_{len(r)}", r)
                                     for i, r in enumerate(reads[:4])])
    return d


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def _run(main, argv, capsysbinary):
    try:
        rc = main(list(argv))
        raised = None
    except SystemExit as e:
        rc, raised = e.code, None
    except Exception as e:   # the same error from both is the result
        rc, raised = None, (type(e).__name__, str(e))
    out, err = capsysbinary.readouterr()
    return rc, raised, out, err


def _both(dataset, tmp_path, argv, capsysbinary, monkeypatch):
    """argv through damapper_tpu's CLI and the port's, each in its own copy
    of the dataset: [(rc, raised, stdout, stderr, files)] for each."""
    monkeypatch.setattr("damapper_tpu.utils.cache.enable_compile_cache",
                        lambda *a, **kw: None)
    got = []
    for name, main in (("jax", jcli.main), ("torch", tcli.main)):
        d = tmp_path / name
        shutil.copytree(dataset, d)
        monkeypatch.chdir(d)
        got.append(_run(main, argv, capsysbinary) + (_files(d),))
    return got


CASES = {
    "lasort_scan": ["lasort", "reads.@.ref"],
    "lasort_range": ["lasort", "-a", "-v", "reads.@2-3.ref.las"],
    "lasort_from": ["lasort", "reads.@2.ref"],
    "lasort_missing_block": ["lasort", "reads.@1-5.ref"],
    "lacat_scan": ["lacat", "reads.@.ref"],
    "lacat_files": ["lacat", "-v", "reads.3.ref", "reads.1.ref.las"],
    "lamerge_scan": ["lamerge", "merged", "reads.@.ref"],
    "lamerge_range": ["lamerge", "-a", "-v", "merged.las", "reads.@1-2.ref"],
    "lacheck_good": ["lacheck", "-vS", "reads.@.ref"],
    "lacheck_bad": ["lacheck", "-vaS", "reads.@1-2.ref", "bad"],
    "dbsplit_size": ["dbsplit", "-s0.005", "reads.db"],
    "dbsplit_cutoff_all": ["dbsplit", "-x2500", "-a", "-s0.008", "reads"],
    "dbsplit_dam": ["dbsplit", "-s0.01", "ref.dam"],
    "dbsplit_illegal": ["dbsplit", "-q", "reads.db"],
    "dbsplit_usage": ["dbsplit"],
    "dbsplit_usage_two": ["dbsplit", "reads.db", "ref.dam"],
    "dbshow_all": ["dbshow", "reads.db"],
    "dbshow_select": ["dbshow", "-U", "-w60", "reads.db", "1", "3"],
    "dbshow_block": ["dbshow", "reads.2"],
    "dbshow_dam": ["dbshow", "-w100", "ref.dam"],
    "dbshow_out_of_range": ["dbshow", "reads.db", "99"],
    "dbshow_illegal": ["dbshow", "-q", "reads.db"],
    "dbshow_usage": ["dbshow", "-U"],
    "fasta2dam": ["fasta2dam", "new.dam", "genome.fasta"],
    "fasta2db": ["fasta2db", "new", "reads.fasta"],
    "unknown_command": ["lashows", "x"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_subcommand_equal(dataset, tmp_path, case, capsysbinary,
                          monkeypatch):
    (jrc, jraise, jout, jerr, jfiles), torch_side = _both(
        dataset, tmp_path, CASES[case], capsysbinary, monkeypatch)
    rc, raised, out, err, files = torch_side
    assert (rc, raised) == (jrc, jraise)
    assert out == jout
    assert err == jerr
    assert files.keys() == jfiles.keys()
    for nm in files:
        assert files[nm] == jfiles[nm], nm
    # each case does what its name says: a result, or a failure with a
    # message on stderr (or a raised error)
    if case.endswith(("illegal", "usage", "usage_two", "missing_block",
                      "_bad", "command")):
        assert rc == 1 and err
    elif case.endswith("out_of_range"):
        assert raised and raised[0] == "ValueError"
    else:
        assert rc == 0 and raised is None
        # lacheck passes silently; every other case prints or writes
        assert out or files != _files(dataset) or case == "lacheck_good"


def test_docstring_lists_every_subcommand():
    """The port's help names each of damapper_tpu's subcommands, under the
    port's module."""
    want = [ln.replace("damapper_tpu.cli", "damapper_tpu_torch.cli")
            for ln in jcli.__doc__.splitlines() if "python -m" in ln]
    assert len(want) == 11
    have = tcli.__doc__.splitlines()
    for ln in want:
        assert ln in have
    assert "DAMAPPER_DEVICE=cpu" in tcli.__doc__

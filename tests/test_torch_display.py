"""The port's alignment display (damapper_tpu_torch.io.display) against
damapper_tpu.io.display on the same records, tolerance 0 (bytes): the six
cases of tests/test_display.py with the port's text equal to JAX's, and
`lashow` through both CLIs on the golden_small dataset, stdout, stderr
and exit code equal."""

import dataclasses
import io
import os

import pytest

from damapper_tpu import cli as jcli
from damapper_tpu.io import display as JD
from damapper_tpu.io import las as lasio
from damapper_tpu.ops import trace as JT
from damapper_tpu.ops.wave import PathRec as JPathRec
from damapper_tpu_torch import cli as tcli
from damapper_tpu_torch.io import db as tdbio
from damapper_tpu_torch.io import display as TD
from damapper_tpu_torch.ops import trace as TT
from damapper_tpu_torch.ops.wave import COMP_FLAG
from damapper_tpu_torch.ops.wave import PathRec as TPathRec
from tests.test_trace import decode_script


def _alns(reads_db, ref_db, o, tspace, exact=True):
    """The record as damapper_tpu's and the port's Alignment (each over its
    own PathRec, the same sequences)."""
    aseq = reads_db.read_seq(o.aread)
    bseq = ref_db.read_seq(o.bread)
    if o.flags & COMP_FLAG:
        bseq = tdbio.complement_numeric(bseq)
    out = []
    for PathRec, T, D in ((JPathRec, JT, JD), (TPathRec, TT, TD)):
        path = PathRec(abpos=o.abpos, bbpos=o.bbpos, aepos=o.aepos,
                       bepos=o.bepos, diffs=o.diffs,
                       trace=[int(v) for v in o.trace])
        if exact:
            T.compute_trace_pts(path, aseq, bseq, tspace, T.GREEDIEST)
        out.append(D.Alignment(aseq.copy(), bseq.copy(), len(aseq),
                               len(bseq), path, o.flags))
    return out


def _text(fn_name, alns, *args, **kw):
    """fn_name of both modules on their alignment; the two texts."""
    texts = []
    for D, aln in zip((JD, TD), alns):
        buf = io.StringIO()
        getattr(D, fn_name)(buf, aln, *args, **kw)
        texts.append(buf.getvalue())
    return texts


def test_print_alignment_rows_equal(golden_small):
    reads_db, ref_db, recs, tspace = golden_small
    for o in recs[:3]:
        jt, tt = _text("print_alignment", _alns(reads_db, ref_db, o, tspace),
                       indent=2, width=80, border=8, coord=7)
        assert tt == jt
        assert "|" in tt


def test_print_alignment_one_row_equal(golden_small):
    reads_db, ref_db, recs, tspace = golden_small
    for upper in (False, True):
        jt, tt = _text("print_alignment",
                       _alns(reads_db, ref_db, recs[0], tspace), indent=0,
                       width=10 ** 9, border=0, coord=0, upper=upper)
        assert tt == jt
        assert 0 < float(tt.strip().rsplit(" ", 1)[-1].rstrip("%")) < 40


def test_cartoon_equal(golden_small):
    reads_db, ref_db, recs, tspace = golden_small
    for o in recs[:4]:
        jt, tt = _text("alignment_cartoon",
                       _alns(reads_db, ref_db, o, tspace, exact=False), 2, 8)
        assert tt == jt
        assert "dif/(len1+len2)" in tt


def _flip_both(alns):
    for D, aln in zip((JD, TD), alns):
        D.flip_alignment(aln, True)


def _state(aln):
    return (dataclasses.astuple(aln.path), aln.aseq.tobytes(),
            aln.bseq.tobytes(), aln.alen, aln.blen, aln.flags)


def test_flip_alignment_all_records(golden_small):
    reads_db, ref_db, recs, tspace = golden_small
    for o in recs:
        alns = _alns(reads_db, ref_db, o, tspace)
        d0 = alns[1].path.diffs
        _flip_both(alns)
        assert _state(alns[1]) == _state(alns[0])
        aln = alns[1]
        if o.flags & COMP_FLAG:
            aln.aseq = tdbio.complement_numeric(aln.aseq)
            aln.bseq = tdbio.complement_numeric(aln.bseq)
        assert decode_script(aln.aseq, aln.bseq, aln.path)[1] == d0


def test_flip_alignment_roundtrip(golden_small):
    reads_db, ref_db, recs, tspace = golden_small
    alns = _alns(reads_db, ref_db, recs[0], tspace)
    orig = _state(alns[1])
    _flip_both(alns)
    _flip_both(alns)
    assert _state(alns[1]) == _state(alns[0]) == orig


def test_print_reference_equal(golden_small):
    reads_db, ref_db, recs, tspace = golden_small
    for block in (50, 100):
        jt, tt = _text("print_reference",
                       _alns(reads_db, ref_db, recs[0], tspace), indent=2,
                       block=block, border=8, coord=7)
        assert tt == jt
        assert len([ln for ln in tt.split("\n") if ln.strip()]) % 3 == 0


@pytest.fixture(scope="module")
def lashow_files(golden_small, tmp_path_factory):
    """(ref, reads, las) paths of the golden_small dataset."""
    reads_db, ref_db, recs, tspace = golden_small
    las = tmp_path_factory.mktemp("lashow") / "reads.ref.las"
    lasio.write_las(str(las), recs, tspace)
    return (os.path.dirname(ref_db.path) + "/ref.dam",
            os.path.dirname(reads_db.path) + "/reads.db", str(las))


def _cli_both(argv, capsys, monkeypatch):
    """argv through damapper_tpu's and the port's CLI: [(rc, out, err)]."""
    monkeypatch.setattr("damapper_tpu.utils.cache.enable_compile_cache",
                        lambda *a, **kw: None)
    got = []
    for main in (jcli.main, tcli.main):
        rc = main(list(argv))
        out, err = capsys.readouterr()
        got.append((rc, out, err))
    return got


@pytest.mark.parametrize("flags", [["-c"], ["-a"], ["-caU"], ["-caF"],
                                   ["-caUFG"], ["-c", "-a", "-i2", "-w60",
                                                "-b5"]],
                         ids=lambda f: "".join(f))
def test_lashow_stdout_equal(lashow_files, flags, capsys, monkeypatch):
    jax_side, torch_side = _cli_both(["lashow", *flags, *lashow_files],
                                     capsys, monkeypatch)
    assert torch_side == jax_side
    rc, out, err = torch_side
    assert rc == 0 and err == ""
    assert out.count(" diffs\n") == len(lasio.read_las(lashow_files[2])[0])


@pytest.mark.parametrize("argv", [["-q"], ["-x7"], []],
                         ids=["illegal", "illegal_value", "usage"])
def test_lashow_error_paths_equal(lashow_files, argv, capsys, monkeypatch):
    files = list(lashow_files) if argv else list(lashow_files[:2])
    jax_side, torch_side = _cli_both(["lashow", *argv, *files], capsys,
                                     monkeypatch)
    assert torch_side == jax_side
    assert torch_side[0] == 1 and torch_side[2]

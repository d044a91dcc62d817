"""The port's exact trace computation (damapper_tpu_torch.ops.trace) against
damapper_tpu.ops.trace on the same inputs, tolerance 0: the cases of
tests/test_trace.py, each run through both modules, with every emitted
script, diff count and error equal (and each script still a valid
alignment, checked by test_trace.decode_script)."""

import dataclasses

import numpy as np
import pytest

from damapper_tpu.io import db as dbio
from damapper_tpu.ops import trace as JT
from damapper_tpu.ops.wave import PathRec as JPathRec
from damapper_tpu_torch.ops import trace as TT
from damapper_tpu_torch.ops.wave import PathRec as TPathRec
from tests.test_trace import decode_script, levenshtein, sim_pair

MODES = [JT.GREEDIEST, JT.UPPERMOST, JT.LOWERMOST]


def _paths(**kw):
    """The same path as damapper_tpu's and the port's PathRec."""
    kw.setdefault("trace", [])
    return JPathRec(**dict(kw, trace=list(kw["trace"]))), \
        TPathRec(**dict(kw, trace=list(kw["trace"])))


def _same(jp, tp):
    assert dataclasses.astuple(jp) == dataclasses.astuple(tp)


def test_constants_equal():
    for nm in ("LOWERMOST", "GREEDIEST", "UPPERMOST", "PLUS_ALIGN",
               "PLUS_TRACE", "DIFF_ONLY", "DIFF_ALIGN", "DIFF_TRACE",
               "TP_ALIGN", "TP_ERROR"):
        assert getattr(TT, nm) == getattr(JT, nm)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", MODES)
def test_iter_np_equal(seed, mode):
    rng = np.random.default_rng(seed)
    a, b = sim_pair(rng, n=120)
    dmax = max(len(a), len(b))
    jout, tout = [], []
    jd = JT.iter_np(a, b, 0, 0, mode, dmax, jout)
    td = TT.iter_np(a, b, 0, 0, mode, dmax, tout)
    assert (td, tout) == (jd, jout)
    assert td == levenshtein(a, b)
    path = TPathRec(abpos=0, bbpos=0, aepos=len(a), bepos=len(b),
                    diffs=td, trace=tout)
    assert decode_script(a, b, path)[1] == td


@pytest.mark.parametrize("seed", [0, 4])
@pytest.mark.parametrize("mode", MODES)
def test_middle_np_equal(seed, mode):
    rng = np.random.default_rng(50 + seed)
    a, b = sim_pair(rng, n=150)
    dmax = max(len(a), len(b))
    assert TT.middle_np(a, b, 0, 0, mode, dmax) == \
        JT.middle_np(a, b, 0, 0, mode, dmax)


def test_iter_np_dmax_exceeded():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 2, 60).astype(np.uint8)
    b = 3 - a        # every position differs
    with pytest.raises(JT.TraceError) as je:
        JT.iter_np(a, b, 0, 0, JT.GREEDIEST, 4, [])
    with pytest.raises(TT.TraceError) as te:
        TT.iter_np(a, b, 0, 0, TT.GREEDIEST, 4, [])
    assert str(te.value) == str(je.value)


def _pipeline_seqs(reads_db, ref_db, o):
    aseq = reads_db.read_seq(o.aread)
    bseq = ref_db.read_seq(o.bread)
    if o.flags & 0x1:
        bseq = dbio.complement_numeric(bseq)
    return aseq, bseq


def _rec_paths(o):
    return _paths(abpos=o.abpos, bbpos=o.bbpos, aepos=o.aepos, bepos=o.bepos,
                  trace=[int(v) for v in o.trace])


@pytest.mark.parametrize("mode", MODES)
def test_compute_trace_pts_from_pipeline(golden_small, mode):
    reads_db, ref_db, recs, tspace = golden_small
    for o in recs[:8]:
        aseq, bseq = _pipeline_seqs(reads_db, ref_db, o)
        jp, tp = _rec_paths(o)
        JT.compute_trace_pts(jp, aseq, bseq, tspace, mode)
        TT.compute_trace_pts(tp, aseq, bseq, tspace, mode)
        _same(jp, tp)
        assert decode_script(aseq, bseq, tp)[1] == tp.diffs


def _irregular(o, tspace):
    """The record's trace points as (a-advance, b-advance) pairs, the input
    of compute_trace_irr."""
    cuts = [o.abpos] + list(range((o.abpos // tspace + 1) * tspace, o.aepos,
                                  tspace)) + [o.aepos]
    tr = []
    for a0, a1, b in zip(cuts, cuts[1:], [int(v) for v in o.trace[1::2]]):
        tr += [a1 - a0, b]
    return tr


def test_compute_trace_mid_irr_from_pipeline(golden_small):
    reads_db, ref_db, recs, tspace = golden_small
    for o in recs[:4]:
        aseq, bseq = _pipeline_seqs(reads_db, ref_db, o)
        jp, tp = _rec_paths(o)
        JT.compute_trace_mid(jp, aseq, bseq, tspace, JT.GREEDIEST)
        TT.compute_trace_mid(tp, aseq, bseq, tspace, TT.GREEDIEST)
        _same(jp, tp)
        assert decode_script(aseq, bseq, tp)[1] == tp.diffs
        box = dict(abpos=o.abpos, bbpos=o.bbpos, aepos=o.aepos,
                   bepos=o.bepos, trace=_irregular(o, tspace))
        jp, tp = _paths(**box)
        JT.compute_trace_irr(jp, aseq, bseq)
        TT.compute_trace_irr(tp, aseq, bseq)
        _same(jp, tp)
        assert decode_script(aseq, bseq, tp)[1] == tp.diffs


def test_split_nd_equal():
    rng = np.random.default_rng(9)
    a, b = sim_pair(rng, n=200)
    assert TT.split_nd(a, b) == JT.split_nd(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_compute_alignment_tasks(seed):
    rng = np.random.default_rng(100 + seed)
    a, b = sim_pair(rng, n=240)
    box = dict(abpos=3, bbpos=2, aepos=len(a) - 2, bepos=len(b) - 1)
    sub_lev = levenshtein(a[3:len(a) - 2], b[2:len(b) - 1])

    # DIFF_ONLY, then PLUS_ALIGN reusing its midpoint through the work area
    jp, tp = _paths(**box)
    jw, tw = JT.AlignWork(), TT.AlignWork()
    for task in (JT.DIFF_ONLY, JT.PLUS_ALIGN):
        JT.compute_alignment(jp, a, b, task, 100, jw)
        TT.compute_alignment(tp, a, b, task, 100, tw)
        _same(jp, tp)
    assert tp.diffs == sub_lev
    for task in (JT.DIFF_ALIGN, JT.DIFF_TRACE):
        jp, tp = _paths(**box)
        JT.compute_alignment(jp, a, b, task, 100)
        TT.compute_alignment(tp, a, b, task, 100)
        _same(jp, tp)
        assert tp.diffs == sub_lev
    # the DIFF_TRACE trace points recomputed as an exact trace
    jp2, tp2 = _paths(**box, trace=tp.trace)
    JT.compute_trace_pts(jp2, a, b, 100, JT.GREEDIEST)
    TT.compute_trace_pts(tp2, a, b, 100, TT.GREEDIEST)
    _same(jp2, tp2)

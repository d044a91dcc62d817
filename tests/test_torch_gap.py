"""The port's gap improver (damapper_tpu_torch.ops.gap) against
damapper_tpu.ops.gap on the same traces, tolerance 0: the cases of
tests/test_gap.py that need no reference binary, plus the inputs of its
reference differential, each improved by both modules with the rewritten
script and diff count equal (and still a valid alignment)."""

import dataclasses

import numpy as np
import pytest

from damapper_tpu.io import db as dbio
from damapper_tpu.ops import trace as JT
from damapper_tpu.ops.gap import gap_improver as jax_gap
from damapper_tpu.ops.wave import COMP_FLAG
from damapper_tpu.ops.wave import PathRec as JPathRec
from damapper_tpu_torch.ops import gap as TG
from damapper_tpu_torch.ops.wave import PathRec as TPathRec
from tests.test_gap import gap_metric
from tests.test_trace import decode_script, sim_pair


def _improve_both(a, b, box, trace, diffs):
    jp = JPathRec(**box, diffs=diffs, trace=list(trace))
    tp = TPathRec(**box, diffs=diffs, trace=list(trace))
    before = gap_metric(tp)
    jax_gap(a, b, jp)
    TG.gap_improver(a, b, tp)
    assert dataclasses.astuple(tp) == dataclasses.astuple(jp)
    assert decode_script(a, b, tp)[1] == tp.diffs
    assert gap_metric(tp) <= before
    return tp


def _greedy(a, b, dmax):
    out = []
    d = JT.iter_np(a, b, 0, 0, JT.GREEDIEST, dmax, out)
    return dict(abpos=0, bbpos=0, aepos=len(a), bepos=len(b)), out, d


def test_long_snake_equal():
    assert TG.LONG_SNAKE == 50


def test_gap_improver_consolidates_scattered_gaps():
    rng = np.random.default_rng(5)
    a = rng.integers(0, 4, 200).astype(np.uint8)
    b = np.concatenate([a[:50], rng.integers(0, 4, 2).astype(np.uint8),
                        a[50:60], a[62:]])
    _improve_both(a, b, *_greedy(a, b, 50))


@pytest.mark.parametrize("seed,n,err", [(200, 400, 0.2), (201, 400, 0.2),
                                        (202, 400, 0.2), (203, 400, 0.2),
                                        (700, 500, 0.22), (701, 500, 0.22),
                                        (702, 500, 0.22), (705, 500, 0.22)])
def test_gap_improver_random_equal(seed, n, err):
    """test_gap.py's random cases (seeds 200-203) and the inputs of its
    reference differential (seeds 700-705)."""
    rng = np.random.default_rng(seed)
    a, b = sim_pair(rng, n=n, err=err)
    _improve_both(a, b, *_greedy(a, b, max(len(a), len(b))))


def test_gap_improver_on_pipeline_traces(golden_small):
    reads_db, ref_db, recs, tspace = golden_small
    for o in recs[:6]:
        aseq = reads_db.read_seq(o.aread)
        bseq = ref_db.read_seq(o.bread)
        if o.flags & COMP_FLAG:
            bseq = dbio.complement_numeric(bseq)
        box = dict(abpos=o.abpos, bbpos=o.bbpos, aepos=o.aepos,
                   bepos=o.bepos)
        path = JPathRec(**box, trace=[int(v) for v in o.trace])
        JT.compute_trace_pts(path, aseq, bseq, tspace, JT.GREEDIEST)
        _improve_both(aseq, bseq, box, path.trace, path.diffs)

"""The program's spans in the benchmark: the idle time named by span
(spantrace.py), the window's span totals (spanstats.py) and the metrics
that read them, on the tiny CPU cell."""

import json

import pytest

from benchmark import devtrace, spanstats, spantrace
from bm_helpers import run_harness, tiny_args
from test_bm_devtrace import Ev

MS = 1_000_000
SPAN_METRICS = ("index_ms_per_kread", "match_ms_per_kread",
                "ref_load_ms_per_kread", "chain_push_ms_per_kread",
                "reporter_self_ms_per_kread", "profile_ms_per_kread",
                "write_ms_per_kread", "outside_spans_ms_per_kread")


def _events():
    return [Ev("void k1<int>(int*)", 0, 10 * MS),
            Ev("Memcpy HtoD (Pageable -> Device)", 40 * MS, 5 * MS),
            Ev("void k2(int*)", 100 * MS, 1 * MS),
            Ev("void k3(int*)", 130 * MS, 1 * MS),
            Ev("a range", 0, 200 * MS, annotation=True)]


def test_idle_time_goes_to_the_innermost_span():
    """Window [-10, 131] ms: block 0-112 holds engine.batch 10-60 (holding
    engine.trace 12-38) and write 101-110; the idle stretches go to the
    innermost span over them, what no span covers to "outside the
    program", and each gap between device events is named by the span
    with most of it."""
    recs = [("block", 1, -1, 0, 112 * MS),
            ("engine.batch", 1, 0, 10 * MS, 60 * MS),
            ("engine.trace", 1, 1, 12 * MS, 38 * MS),
            ("write", 1, 0, 101 * MS, 110 * MS)]
    t = spantrace.reduce(_events(), 0.141, spans=recs)
    assert t.busy_s == pytest.approx(0.017)
    assert t.gaps == [
        ("host work in block, then k2", pytest.approx(0.055)),
        ("host work in engine.trace, then Memcpy HtoD (Pageable -> Device)",
         pytest.approx(0.030)),
        ("host work outside the program, then k3", pytest.approx(0.029))]
    assert t.idle_by_span == [
        ("block", pytest.approx(0.042)),
        ("outside the program", pytest.approx(0.028)),
        ("engine.trace", pytest.approx(0.026)),
        ("engine.batch", pytest.approx(0.019)),
        ("write", pytest.approx(0.009))]
    assert sum(s for _, s in t.idle_by_span) == pytest.approx(
        t.window_s - t.busy_s)
    assert t.idle_outside_s == pytest.approx(0.028)
    assert t.ops == devtrace.reduce(_events(), 0.141).ops


def test_without_spans_the_reduction_is_devtraces():
    events = _events()
    assert spantrace.reduce(events, 0.2) == devtrace.reduce(events, 0.2)
    assert spantrace.reduce(events, 0.2).gaps[0][0] == \
        "host work, then k2"


def test_innermost_pieces_tile_nested_spans():
    recs = [("a", 1, -1, 0, 10), ("b", 1, 0, 2, 4), ("c", 1, 0, 4, 10),
            ("d", 2, -1, 12, 15)]
    assert spantrace.innermost(recs) == [(0, 2, "a"), (2, 4, "b"),
                                         (4, 10, "c"), (12, 15, "d")]


class _Win:
    def __init__(self, times, nblocks):
        self.stats = {"times": times}
        self.las = [None] * nblocks
        self.reads = 1000

    def per_kread(self, seconds):
        return seconds * 1e6 / self.reads


def test_window_totals_are_the_newest_calls_or_none():
    """The newest calls' totals, summed, when their stage seconds are the
    window's; None when they are not; lanes_per_launch from the counters."""
    from benchmark import cells
    from damapper_tpu_torch.utils import spans
    zero = dict.fromkeys(("load", "index", "match", "chain", "align"), 0.)
    for lanes in (300, 500):
        spans.begin_call()
        spans.count("engine.launch_lanes", lanes)
        spans.count("engine.launches", 4)
        spans.end_call()
    w = _Win(zero, 2)
    assert spanstats.window(w).counts == {"engine.launch_lanes": 800,
                                          "engine.launches": 8}
    assert cells.reader("lanes_per_launch")(w) == 100
    assert cells.reader("outside_spans_ms_per_kread")(w) == 0
    assert spanstats.window(_Win(dict(zero, chain=1.), 2)) is None


def test_the_span_metrics_read_on_the_tiny_cell(tiny):
    rc, out, err = run_harness(tiny_args(tiny, 2**33 + 9, trace=1))
    assert rc == 0, err[-3000:]
    m = json.loads(out.strip().splitlines()[-1])["metrics"]
    for name in SPAN_METRICS:
        assert m[name]["unit"] == "ms/kread" and m[name]["value"] >= 0, name
    assert m["index_ms_per_kread"]["value"] + m["match_ms_per_kread"][
        "value"] == pytest.approx(m["index_match_ms_per_kread"]["value"],
                                  rel=1e-6)
    # on the CPU the engine launches no kernel
    assert "lanes_per_launch" not in m

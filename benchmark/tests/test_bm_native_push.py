"""native_push_pct and chain_export_ms_per_kread: the share of the chain
sweep's candidates that the native push took and the export of the native
stacks, from the program's counters and spans, on a stand-in window and on
the tiny CPU cell."""

import json

import pytest

from benchmark import cells
from bm_helpers import run_harness, tiny_args
from test_bm_spans import _Win

ZERO = dict.fromkeys(("load", "index", "match", "chain", "align"), 0.)


def _calls(*calls):
    """One program call a (counts, {span: seconds}) pair."""
    from damapper_tpu_torch.utils import spans
    for counts, secs in calls:
        spans.begin_call()
        for name, n in counts.items():
            spans.count(name, n)
        for name, s in secs.items():
            spans.interval(name, 0, int(s * 1e9))
        spans.end_call()


@pytest.mark.parametrize("counts, want", [
    (({"chain.cands": 300, "chain.cands_native": 300},
      {"chain.cands": 100, "chain.cands_native": 0}), 75.0),
    (({"chain.cands": 0, "chain.cands_native": 0},), None),
    (({"engine.launches": 3},), None)])
def test_the_share_is_summed_over_the_windows_calls(counts, want):
    """Summed over the window's calls; None with no candidate emitted or
    no push counters (the parent program has none)."""
    _calls(*((c, {}) for c in counts))
    assert cells.reader("native_push_pct")(_Win(ZERO, len(counts))) == want


@pytest.mark.parametrize("secs, want", [
    (({"chain.export": 0.25}, {"chain.export": 0.5}), 750.0),
    (({"chain.sweep": 0.25},), None)])
def test_the_export_is_summed_over_the_windows_calls(secs, want):
    """The span's seconds over the window's 1,000 reads, in ms; None where
    the program has no such span (the parent program)."""
    _calls(*(({}, s) for s in secs))
    got = cells.reader("chain_export_ms_per_kread")(_Win(ZERO, len(secs)))
    assert got == (None if want is None else pytest.approx(want))


def test_without_spans_both_read_none(monkeypatch):
    """A window whose totals are not the program's reads nothing."""
    from benchmark import spanstats
    monkeypatch.setattr(spanstats, "window", lambda w: None)
    for name in ("native_push_pct", "chain_export_ms_per_kread"):
        assert cells.reader(name)(_Win(ZERO, 1)) is None


def test_both_on_the_tiny_cell(tiny):
    """The tiny cell chains on the host: the native push takes every
    candidate, and the export is reported."""
    rc, out, err = run_harness(tiny_args(tiny, 2**33 + 23, trace=1))
    assert rc == 0, err[-3000:]
    m = json.loads(out.strip().splitlines()[-1])["metrics"]
    assert m["native_push_pct"]["value"] == 100.0
    assert m["chain_export_ms_per_kread"]["value"] > 0

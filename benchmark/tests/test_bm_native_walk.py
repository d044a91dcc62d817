"""native_walk_pct: the share of the walked lanes that the wave engine's
native trace walk took, from the program's counters, on a stand-in window
and on the tiny CPU cell."""

import json
import os

import pytest

from benchmark import cells
from bm_helpers import run_harness, tiny_args
from test_bm_spans import _Win

ZERO = dict.fromkeys(("load", "index", "match", "chain", "align"), 0.)


def _calls(*counts):
    from damapper_tpu_torch.utils import spans
    for c in counts:
        spans.begin_call()
        for name, n in c.items():
            spans.count(name, n)
        spans.end_call()


@pytest.mark.parametrize("counts, want", [
    (({"engine.walk_lanes": 300, "engine.walk_native_lanes": 300},
      {"engine.walk_lanes": 100, "engine.walk_native_lanes": 0}), 75.0),
    (({"engine.walk_lanes": 0, "engine.walk_native_lanes": 0},), None),
    (({"engine.launches": 3},), None)])
def test_the_share_is_summed_over_the_windows_calls(counts, want):
    """Summed over the window's calls; None with no lane walked or no
    walk counters (the parent program has none)."""
    _calls(*counts)
    assert cells.reader("native_walk_pct")(_Win(ZERO, len(counts))) == want


@pytest.mark.parametrize("host_min, want", [("0", 100.0), (None, None)])
def test_native_walk_pct_on_the_tiny_cell(tiny, host_min, want):
    """With every round on the engine (host_min 0) the native walk takes
    every lane; by default the tiny cell's rounds are too small for the
    engine, so no lane is walked and the line leaves the metric out."""
    env = dict(os.environ)
    env.pop("DAMAPPER_WAVE_HOSTMIN", None)
    if host_min is not None:
        env["DAMAPPER_WAVE_HOSTMIN"] = host_min
    rc, out, err = run_harness(tiny_args(tiny, 2**33 + 17, trace=1), env=env)
    assert rc == 0, err[-3000:]
    m = json.loads(out.strip().splitlines()[-1])["metrics"]
    assert m.get("native_walk_pct", {}).get("value") == want

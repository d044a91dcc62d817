"""The program's span totals and counters over the window's blocks.

The port keeps the totals of its newest ``run_damapper`` calls
(``damapper_tpu_torch.utils.spans.recent``); the window's blocks are the
newest calls, one a ``.las`` file the window read, and their stage seconds
summed must equal the window's ``times`` (run.py's sum of
``LAST_STATS["times"]``), which ties the totals to the window.  A program
without spans, or totals that are not the window's, give None: a metric
reader then reports nothing.
"""

from __future__ import annotations

import math


class Totals:
    """The window's span totals ({name: {"s", "self_s", "n"}}) and counts."""

    def __init__(self, spans: dict, counts: dict):
        self.spans = spans
        self.counts = counts

    def s(self, *names) -> float:
        """The seconds of every span of these names."""
        return sum(self.spans.get(n, {}).get("s", 0.) for n in names)

    def self_s(self, name) -> float:
        return self.spans.get(name, {}).get("self_s", 0.)


def window(w) -> Totals | None:
    try:
        from damapper_tpu_torch.pipeline.mapper import STAGE_SPANS
        from damapper_tpu_torch.utils import spans
    except ImportError:
        return None
    calls = spans.recent(len(w.las))
    if not calls or len(calls) != len(w.las):
        return None
    tot, counts = {}, {}
    for c in calls:
        for name, v in c["spans"].items():
            t = tot.setdefault(name, {"s": 0., "self_s": 0., "n": 0})
            for k in t:
                t[k] += v[k]
        for name, n in c["counts"].items():
            counts[name] = counts.get(name, 0) + n
    out = Totals(tot, counts)
    for stage, names in STAGE_SPANS.items():
        if not math.isclose(out.s(*names), w.stats["times"][stage],
                            rel_tol=1e-9, abs_tol=1e-9):
            return None
    return out

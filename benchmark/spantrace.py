"""The card's idle time named by the program's spans.

``reduce(events, window_s, top, spans)`` is ``devtrace.reduce`` with the
program's span records (``damapper_tpu_torch.utils.spans.drain``: (name,
call id, parent index, t0_ns, t1_ns) on the Unix clock, which is the
clock of the profiler's kineto events).  Without records it is
``devtrace.reduce`` itself.  With them:

- the window is the ``window_s`` that ends at the later of the last device
  event and the last span (the window closes in a synchronize right after
  its last block), and its idle time is the window less the busy union;
- each idle stretch is charged to the innermost span open over it, and the
  stretches no span covers to ``outside the program`` (``idle_by_span``:
  the ``top`` names with the most idle seconds; ``idle_outside_s``);
- each of the ``top`` longest gaps between device events is named by the
  span charged with most of it: ``host work in engine.trace, then Memcpy
  HtoD (Pageable -> Device)``.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from . import devtrace

OUTSIDE = "outside the program"


@dataclass
class SpanTrace(devtrace.DeviceTrace):
    idle_by_span: list = field(default_factory=list)   # [(name, seconds)]
    idle_outside_s: float = 0.0


def innermost(records) -> list:
    """[(t0, t1, name)]: the stretches, in time order, in which one span is
    the innermost open one (spans nest; one ends no later than its
    parent)."""
    out, stack = [], []          # stack: (end, name)
    t = None
    for name, _, _, t0, t1 in sorted(records, key=lambda r: (r[3], -r[4])):
        while stack and stack[-1][0] <= t0:
            end, nm = stack.pop()
            if end > t:
                out.append((t, end, nm))
            t = end
        if stack and t0 > t:
            out.append((t, t0, stack[-1][1]))
        stack.append((min(t1, stack[-1][0]) if stack else t1, name))
        t = t0
    while stack:
        end, nm = stack.pop()
        if end > t:
            out.append((t, end, nm))
        t = end
    return out


def charge(idle, pieces) -> list:
    """For each idle stretch (a, b), {name: ns} of the pieces (innermost)
    that cover it, and what none covers under OUTSIDE."""
    ends = [p[1] for p in pieces]
    out = []
    for a, b in idle:
        got, covered = {}, 0
        k = bisect.bisect_right(ends, a)
        while k < len(pieces) and pieces[k][0] < b:
            lo, hi = max(a, pieces[k][0]), min(b, pieces[k][1])
            got[pieces[k][2]] = got.get(pieces[k][2], 0) + hi - lo
            covered += hi - lo
            k += 1
        if b - a > covered:
            got[OUTSIDE] = (b - a) - covered
        out.append(got)
    return out


def reduce(events, window_s: float, top: int = 10, spans=None):
    events = list(events)
    base = devtrace.reduce(events, window_s, top)
    if spans is None or base is None:
        return base
    dev = sorted((devtrace._ns(ev, "start"),
                  devtrace._ns(ev, "start") + devtrace._ns(ev, "duration"),
                  ev.name()) for ev in events if devtrace._is_device_work(ev))
    w1 = max(max(b for _, b, _ in dev),
             max((r[4] for r in spans), default=0))
    w0 = w1 - int(window_s * 1e9)
    # idle stretches: [w0, w1] less the busy union; the gaps between device
    # events keep the op that ended them
    idle, gaps = [], []
    end, seen = w0, False
    for a, b, n in dev:
        if a > end:
            idle.append((end, a))
            if seen:
                gaps.append((end, a, devtrace.short_name(n)))
        end, seen = max(end, b), True
    if w1 > end:
        idle.append((end, w1))
    pieces = innermost([r for r in spans if r[4] > w0 and r[3] < w1])
    per_name: dict = {}
    for got in charge(idle, pieces):
        for name, ns in got.items():
            per_name[name] = per_name.get(name, 0) + ns
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    named = []
    for (a, b, n), got in zip(gaps, charge([g[:2] for g in gaps], pieces)):
        who = max(got, key=got.get)
        where = OUTSIDE if who == OUTSIDE else f"in {who}"
        named.append((f"host work {where}, then {n}", (b - a) / 1e9))
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return SpanTrace(window_s=base.window_s, busy_s=base.busy_s, ops=base.ops,
                     gaps=named,
                     idle_by_span=[(n, t / 1e9) for n, t in ranked],
                     idle_outside_s=per_name.get(OUTSIDE, 0) / 1e9)

"""Spans and counters of the mapper's stages, on the profiler's clock.

A span is a named interval of one ``run_damapper`` call (pipeline.mapper):
``span(name)`` around a stage, or ``interval(name, t0, t1)`` for an interval
the caller timed itself (the wave engine's host steps).  Each span always
adds its seconds, its self seconds (its seconds less those of its direct
children) and one to its count to the totals of the current call, and
``count(name, n)`` adds to the call's integer counters.  ``begin_call`` and
``end_call`` bound a call; ``end_call`` returns its totals and keeps them
among the newest ``HISTORY`` calls (``recent``), for readers that see only
a call's outputs.

While recording is on (``enable``, never on by itself), every span also
becomes a record ``(name, call id, parent index, t0_ns, t1_ns)``: the call
id is shared by every span of one call, the parent index points into the
same list (-1: none), and the times are ns on the Unix clock
(``time.time_ns``), which is the clock of torch.profiler's kineto events,
so the records can be laid over a device trace.  ``drain`` hands the
records over.  The records are capped at ``CAP``; the rest are counted as
dropped.

A span opened with ``sync=True`` ends in ``torch.cuda.synchronize()``,
recorded or not, so that the device work it queued is charged to it and
not to the span that next waits on the card.

The state is the process's: one mapping at a time.
"""

from __future__ import annotations

import collections
import contextlib
import time

CAP = 1_000_000
HISTORY = 256

now = time.time_ns

_stack: list = []       # open spans: [name, t0_ns, child_ns, record index]
_totals: dict = {}      # name -> [ns, self ns, n] of the current call
_counts: dict = {}      # name -> int of the current call
_history = collections.deque(maxlen=HISTORY)
_rec = {"on": False, "records": [], "dropped": 0, "call": 0}


def begin_call() -> None:
    """Start a call: new totals and counters, a new call id."""
    _totals.clear()
    _counts.clear()
    _rec["call"] += 1


def end_call() -> dict:
    """The call's totals, {"spans": {name: {"s", "self_s", "n"}},
    "counts": {name: n}}, also kept among the newest calls."""
    out = {"spans": {k: {"s": v[0] / 1e9, "self_s": v[1] / 1e9, "n": v[2]}
                     for k, v in _totals.items()},
           "counts": dict(_counts)}
    _history.append(out)
    return out


def recent(n: int) -> list:
    """The totals of the newest ``n`` finished calls, oldest first (fewer
    when fewer are kept)."""
    return list(_history)[-n:] if n > 0 else []


def seconds(name: str) -> float:
    """The current call's seconds in span ``name`` so far."""
    return _totals.get(name, (0, 0, 0))[0] / 1e9


def count(name: str, n: int = 1) -> None:
    _counts[name] = _counts.get(name, 0) + int(n)


def _open(name: str, t0: int) -> list:
    idx = -1
    if _rec["on"]:
        recs = _rec["records"]
        if len(recs) < CAP:
            idx = len(recs)
            recs.append(None)
        else:
            _rec["dropped"] += 1
    return [name, t0, 0, idx]


def _close(s: list, t1: int) -> None:
    name, t0, child, idx = s
    d = t1 - t0
    tot = _totals.setdefault(name, [0, 0, 0])
    tot[0] += d
    tot[1] += d - child
    tot[2] += 1
    parent = _stack[-1] if _stack else None
    if parent is not None:
        parent[2] += d
    if idx >= 0:
        _rec["records"][idx] = (name, _rec["call"],
                                parent[3] if parent is not None else -1,
                                t0, t1)


@contextlib.contextmanager
def span(name: str, sync: bool = False):
    """A span around the block; ``sync``: end it in a CUDA synchronize
    (pass it only for a run on the card)."""
    s = _open(name, now())
    _stack.append(s)
    try:
        yield
    finally:
        if sync:
            import torch
            torch.cuda.synchronize()
        _stack.pop()
        _close(s, now())


def interval(name: str, t0: int, t1: int) -> None:
    """A closed span [t0, t1] (ns, ``now``'s clock), a child of the
    innermost open span."""
    _close(_open(name, t0), t1)


def _new_list() -> tuple[list, int]:
    """Start a new record list (spans open now stay out of it); returns the
    old list and its drop count."""
    old = _rec["records"], _rec["dropped"]
    _rec.update(records=[], dropped=0)
    for s in _stack:
        s[3] = -1
    return old


def enable() -> None:
    """Start recording into a new list."""
    _new_list()
    _rec["on"] = True


def disable() -> None:
    _rec["on"] = False


def drain() -> tuple[list, int]:
    """The records so far and the count dropped at the cap; recording goes
    on (if on) into a new list.  Spans still open are left out (and their
    children's parent is -1)."""
    recs, dropped = _new_list()
    new = {}
    out = []
    for i, r in enumerate(recs):
        if r is not None:
            new[i] = len(out)
            out.append(r[:2] + (new.get(r[2], -1),) + r[3:])
    return out, dropped

"""native_walk_pct: the share of the lanes the wave engine walked into
traces that its native walk took (ops/wave_engine.py,
native/trace_walk.cpp), the program's counters "engine.walk_native_lanes"
over "engine.walk_lanes" summed over the window's blocks (spanstats.py),
in %.  None where the program has no such counters or walked no lane."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    if t is None or not t.counts.get("engine.walk_lanes"):
        return None
    return (100.0 * t.counts.get("engine.walk_native_lanes", 0)
            / t.counts["engine.walk_lanes"])

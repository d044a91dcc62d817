"""lanes_per_launch: the lanes the wave engine passed to its launches,
classic retries included, over its kernel launches (ops/wave_engine.py),
the program's counters "engine.launch_lanes" and "engine.launches" summed
over the window's blocks (spanstats.py).  None where the program has no
counters or launched no kernel (the CPU runs the plain version)."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    if t is None or not t.counts.get("engine.launches"):
        return None
    return t.counts.get("engine.launch_lanes", 0) / t.counts["engine.launches"]

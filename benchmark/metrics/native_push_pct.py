"""native_push_pct: the share of the candidates that the chain sweep
emitted which the native push took (ops/chain.py, native/chain_sweep.cpp
``chain_push``), the program's counters "chain.cands_native" over
"chain.cands" summed over the window's blocks (spanstats.py), in %.  None
where the program has no such counters or emitted no candidate."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    if t is None or not t.counts.get("chain.cands"):
        return None
    return (100.0 * t.counts.get("chain.cands_native", 0)
            / t.counts["chain.cands"])

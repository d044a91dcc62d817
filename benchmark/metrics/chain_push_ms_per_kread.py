"""chain_push_ms_per_kread: the candidate push of the chain step
(ops/chain.py ``_push_candidate``: the dominance stack and the -p cover,
in Python, one call a candidate), the program's span "chain.push" summed
over the window's blocks (spanstats.py), in ms a 1,000 reads.  None where
the program has no spans."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    return None if t is None else w.per_kread(t.s("chain.push"))

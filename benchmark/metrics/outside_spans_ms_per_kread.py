"""outside_spans_ms_per_kread: the time of ``run_damapper`` calls in none
of their stage spans (pipeline/mapper.py), the self time of the program's
span "block" summed over the window's blocks (spanstats.py), in ms a
1,000 reads.  None where the program has no spans."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    return None if t is None else w.per_kread(t.self_s("block"))

"""match_ms_per_kread: the seed match (ops/device_index.py), the
program's span "match" summed over the window's blocks (spanstats.py), in
ms a 1,000 reads.  None where the program has no spans."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    return None if t is None else w.per_kread(t.s("match"))

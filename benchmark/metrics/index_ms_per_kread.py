"""index_ms_per_kread: the device index (ops/device_index.py), the
program's span "index" (the reads' index and each reference block's build
or cache hit; on the card it ends in a synchronize, so the sort's
asynchronous tail is charged here and not to "match") summed over the
window's blocks (spanstats.py), in ms a 1,000 reads.  None where the
program has no spans."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    return None if t is None else w.per_kread(t.s("index"))

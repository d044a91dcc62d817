"""reporter_self_ms_per_kread: the reporter's own time
(pipeline/reporter.py), the program's span "reporter" less the wave
engine's batches inside it (spans "engine.batch"), summed over the window's
blocks (spanstats.py), in ms a 1,000 reads.  None where the program has no
spans."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    if t is None:
        return None
    return w.per_kread(t.s("reporter") - t.s("engine.batch"))

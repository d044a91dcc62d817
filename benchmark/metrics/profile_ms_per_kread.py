"""profile_ms_per_kread: the -p repeat-profile values (pipeline/reporter.py
``special_log`` over every trace interval of every read), the program's
span "reporter.profile" summed over the window's blocks (spanstats.py), in
ms a 1,000 reads.  None where the program has no spans or the cell no
-p."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    if t is None or "reporter.profile" not in t.spans:
        return None
    return w.per_kread(t.s("reporter.profile"))

"""write_ms_per_kread: the output (pipeline/mapper.py: io/las.py's
``sort_las`` and ``write_las``, and the -p track's ``write_track``), the
program's span "write" summed over the window's blocks (spanstats.py), in
ms a 1,000 reads.  None where the program has no spans."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    return None if t is None else w.per_kread(t.s("write"))

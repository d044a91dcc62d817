"""ref_load_ms_per_kread: the reference's decode in every call
(pipeline/mapper.py read_block), the program's spans "load.ref" (each
reference block) and "load.full" (the whole reference again, when it has
more than one block) summed over the window's blocks (spanstats.py), in ms
a 1,000 reads.  None where the program has no spans."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    return None if t is None else w.per_kread(t.s("load.ref", "load.full"))

"""chain_export_ms_per_kread: the export of the native candidate stacks
into the reporter's candidates, once a block (ops/chain.py
``ChainState.finish``), the program's span "chain.export" summed over the
window's blocks (spanstats.py), in ms a 1,000 reads.  None where the
program has no spans or no such span."""

from .. import spanstats


def read(w):
    t = spanstats.window(w)
    if t is None or "chain.export" not in t.spans:
        return None
    return w.per_kread(t.s("chain.export"))

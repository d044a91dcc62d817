"""chain_ms_per_kread: chaining (ops/chain.py, native/chain_sweep.cpp),
``times["chain"]`` summed over the window's blocks, in ms a 1,000 reads."""


def read(w):
    return w.per_kread(w.stats["times"]["chain"])

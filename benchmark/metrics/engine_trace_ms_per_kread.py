"""engine_trace_ms_per_kread: the wave engine's trace extraction on the
host (ops/wave_engine.py), ``align_host_split["trace"]`` summed over the
window's blocks, in ms a 1,000 reads."""


def read(w):
    return w.per_kread(w.stats["align_host_split"]["trace"])

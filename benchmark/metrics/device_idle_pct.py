"""device_idle_pct: the share of the traced window in which no kernel,
copy or set ran on the card, from torch.profiler's device events (the union
of their intervals, devtrace.py), in %.  None without a trace."""


def read(w):
    if w.trace is None:
        return None
    return w.trace.idle_pct

"""host (CPU): the rate of a pure-Python loop on the run's host, in
millions of iterations a second, the mean of a reading just before the
window and one just after it; the mapper's host stages (trace extraction,
the reporter) slow with it, so a slow host shows beside its rate."""


def read(win):
    return win.host_rate

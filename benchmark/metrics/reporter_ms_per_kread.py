"""reporter_ms_per_kread: the reporter's own time (pipeline/reporter.py):
the align stage less the engine's device and host seconds,
``times["align"] - align_device_s - align_host_s`` summed over the window's
blocks, in ms a 1,000 reads.  The program rounds the two engine terms to
10 ms a block, so each block's share is off by up to 10 ms."""


def read(w):
    s = w.stats
    return w.per_kread(s["times"]["align"] - s["align_device_s"]
                       - s["align_host_s"])

"""engine_device_ms_per_kread: the wave engine's device side, its launches
and its waits for the pulls (ops/wave_engine.py), ``align_device_s``
summed over the window's blocks, in ms a 1,000 reads.  The program rounds it
to 10 ms a block.  None off the card."""


def read(w):
    if w.platform != "gpu":
        return None
    return w.per_kread(w.stats["align_device_s"])

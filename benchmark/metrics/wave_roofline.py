"""wave_roofline: the least time the window's wave work could take on
the card, over the wave kernels' time (``kernel_ms``), in %.  The work is
counted by roofline.py from the window's records, not from the engine's
lanes or waves; it is bound by bytes, at the peak of peaks.py.  None off
the card."""

from .. import peaks, roofline


def read(w):
    if w.platform != "gpu" or w.stats["kernel_ms"] <= 0:
        return None
    least_s = roofline.wave_bytes(w.las) / peaks.H100["hbm_bytes_per_s"]
    return 100.0 * least_s / (w.stats["kernel_ms"] / 1e3)

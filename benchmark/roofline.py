"""The bytes the window's wave work needs, counted from what it produced.

Each record of the window's .las files is one alignment that the wave
found: it has to read the A bases and the B bases it spans once, and write
its trace points (one byte each at a trace spacing of at most 125, two
above).  Alignments the reporter dropped or fused are not counted, nor are
reads of a base twice: the count is what these outputs need, whatever
band, mode or launch count the engine used, so it is a floor.
"""

from __future__ import annotations

from .dazz import TRACE_XOVR


def wave_bytes(las_files) -> int:
    total = 0
    for f in las_files:
        tb = 1 if f.tspace <= TRACE_XOVR else 2
        span = ((f.col("aepos") - f.col("abpos"))
                + (f.col("bepos") - f.col("bbpos")))
        total += int(span.sum()) + tb * int(f.col("tlen").sum())
    return total

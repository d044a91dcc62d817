"""Alignment specification: error-model scoring tables for wave trimming.

The benchmark's frozen copy of the port's ``ops/spec.py``.

Equivalent of New_Align_Spec (reference align.c:152-288).  The wave extender
reports as an alignment tip the last point whose trailing 2*TRIM_LEN edit
columns are suffix-positive under a match/mismatch scoring tuned to the target
correlation and base-composition bias.  The suffix-positivity predicate over
the last 15 columns is precomputed as two int16 tables of size 2^15 indexed by
the column bitmask (1 = match).

Table construction is vectorized (the reference builds it by recursion over
bits, set_table align.c:207-218; the result is identical).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

TRIM_LEN = 15          # align.c:162
DUB_TRIM = 45          # align.c:166 (= 3*TRIM_LEN)
PATH_LEN = 60          # align.c:168
PATH_TOP = 1 << PATH_LEN
PATH_INT = PATH_TOP - 1
TRIM_MASK = 0x7FFF
TRIM_MLAG = 250        # align.c:175
WAVE_LAG = 30          # align.c:176
FRACTION = 1000        # align.c:198

BIAS_FACTOR = np.array([.690, .690, .690, .690, .780,
                        .850, .900, .933, .966, 1.000])


@dataclass
class AlignSpec:
    ave_corr: float
    trace_space: int
    reach: bool
    freq: np.ndarray
    ave_path: int
    mscore: int         # per-match score (FRACTION*bias*(1-corr))
    dscore: int         # per-diff penalty (FRACTION - mscore)
    score: np.ndarray   # int16[2^15]: total score of the 15-column window
    table: np.ndarray   # int16[2^15]: total - max prefix score (>=0 iff all
    #                     suffixes of the window are non-negative)


def new_align_spec(ave_corr: float, trace_space: int, freq,
                   reach: bool = True) -> AlignSpec:
    freq = np.asarray(freq, dtype=np.float64)
    match = float(freq[0] + freq[3])
    if (match <= 0.0) == (match > 0.0):   # NaN guard (align.c:241)
        match = .5
    if match > .5:
        match = 1. - match
    bias = int((match + .025) * 20. - 1.)
    if match < .2:
        bias = 3

    ave_path = int(PATH_LEN * (1. - BIAS_FACTOR[bias] * (1. - ave_corr)))
    mscore = int(FRACTION * BIAS_FACTOR[bias] * (1. - ave_corr))
    dscore = FRACTION - mscore

    idx = np.arange(1 << TRIM_LEN, dtype=np.int64)
    # bit TRIM_LEN-1 of the index is the *oldest* column (first recursion bit)
    bits = (idx[:, None] >> np.arange(TRIM_LEN - 1, -1, -1)) & 1
    contrib = np.where(bits == 1, mscore, -dscore)
    cum = np.cumsum(contrib, axis=1)
    total = cum[:, -1]
    maxpref = np.maximum(cum.max(axis=1), 0)
    table = (total - maxpref).astype(np.int16)
    score = total.astype(np.int16)

    return AlignSpec(ave_corr=ave_corr, trace_space=trace_space,
                     reach=bool(reach), freq=freq.astype(np.float32),
                     ave_path=ave_path, mscore=mscore, dscore=dscore,
                     score=score, table=table)

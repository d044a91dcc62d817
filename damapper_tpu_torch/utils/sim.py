"""Simulated data: genomes, PacBio-like reads and wave-lane seed cases.

``sim_genome`` and ``sim_read`` draw exactly what the JAX package's test
helpers draw from the same numpy generator, so one seed gives both packages
the same dataset.  ``make_lane_cases`` builds a sentinel-separated sequence
memory plus one seed per read, the layout a loaded DB gives the wave;
``make_long_lane_cases`` the same for long reads, with the window length the
persistent kernels give them.
"""

from __future__ import annotations

import numpy as np

from ..io import db as dbio

BASES = "ACGT"


def sim_genome(rng: np.random.Generator, length: int) -> str:
    # vectorized but draw-identical to "".join(BASES[i] for i in draws)
    draws = rng.integers(0, 4, size=length)
    return np.frombuffer(BASES.encode(), dtype="S1")[draws].tobytes().decode()


def sim_read(rng: np.random.Generator, genome: str, min_len=2000,
             max_len=12000, err=0.15, ins_frac=0.55, del_frac=0.25):
    """Sample one PacBio-like read: substring + errors + random orientation.
    Returns (read_str, true_start, true_end, comp)."""
    L = len(genome)
    n = int(rng.integers(min_len, max_len + 1))
    n = min(n, L - 1)
    start = int(rng.integers(0, L - n))
    frag = genome[start:start + n]
    comp = bool(rng.integers(0, 2))
    if comp:
        tr = str.maketrans("ACGT", "TGCA")
        frag = frag.translate(tr)[::-1]
    out = []
    for ch in frag:
        r = rng.random()
        if r < err:
            e = rng.random()
            if e < ins_frac:                      # insertion
                out.append(BASES[rng.integers(0, 4)])
                out.append(ch)
            elif e < ins_frac + del_frac:         # deletion
                pass
            else:                                 # substitution
                out.append(BASES[(BASES.index(ch) + 1
                                  + rng.integers(0, 3)) % 4])
        else:
            out.append(ch)
    return "".join(out), start, start + n, comp


def make_lane_cases(seed, ncases, glen=6000, rlen=2500, err=0.15, mix=False,
                    rmin=1500):
    """A flat sentinel-separated sequence memory [genome | read_0 | ...]
    plus one seed per read at the read's middle true alignment point.
    mix=True draws each read's length uniformly from [min(rmin, rlen),
    rlen].  Returns (seqmem uint8, list of seed dicts with abase, alen,
    bbase, blen, diag, anti, flags); the genome is the A side."""
    rng = np.random.default_rng(seed)
    genome = sim_genome(rng, glen)
    g = dbio.seq_to_numeric(genome)

    flat = [np.array([4], np.uint8)]
    off = 1
    entries = []
    for _ in range(ncases):
        rl = (int(rng.integers(min(rmin, rlen), rlen + 1)) if mix
              else rlen)
        start = int(rng.integers(0, glen - rl))
        frag = genome[start:start + rl]
        out = []
        truth = []
        bpos = 0
        for i, ch in enumerate(frag):
            if rng.random() < err:
                t = rng.random()
                if t < 0.55:
                    out.append("ACGT"[rng.integers(0, 4)])
                    out.append(ch)
                    truth.append((start + i, bpos + 1))
                    bpos += 2
                elif t < 0.80:
                    pass
                else:
                    out.append("ACGT"[(("ACGT".index(ch)) + 1) % 4])
                    bpos += 1
            else:
                out.append(ch)
                truth.append((start + i, bpos))
                bpos += 1
        b = dbio.seq_to_numeric("".join(out))
        apos, bp = truth[len(truth) // 2]
        entries.append((b, apos + 1, bp + 1))

    gbase = off
    flat.append(g)
    off += len(g)
    insts = []
    for b, apos, bp in entries:
        flat.append(np.array([4], np.uint8))
        off += 1
        bbase = off
        flat.append(b)
        off += len(b)
        insts.append(dict(abase=gbase, alen=len(g), bbase=bbase, blen=len(b),
                          diag=apos - bp, anti=apos + bp, flags=0))
    flat.append(np.array([4], np.uint8))
    return np.concatenate(flat), insts


def make_long_lane_cases(seed, ncases, rmin=40_000, rlen=45_000, err=0.15):
    """Lanes of long reads (lengths drawn from [rmin, rlen]) on a genome
    four times the longest read, for the persistent kernels' large windows.
    Returns (seqmem, insts, L): make_lane_cases' pair plus the window
    length that covers every extension of the longest read (the B side
    here), which above ~63 kb no longer fits a block's shared memory."""
    from ..ops.wave_persistent import window_length
    seqmem, insts = make_lane_cases(seed, ncases, glen=4 * rlen, rlen=rlen,
                                    err=err, mix=True, rmin=rmin)
    return seqmem, insts, window_length(max(s["blen"] for s in insts))

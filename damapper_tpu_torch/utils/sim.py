"""Simulated data: genomes, PacBio-like reads and wave-lane seed cases.

``sim_genome`` and ``sim_read`` draw exactly what the JAX package's test
helpers draw from the same numpy generator, so one seed gives both packages
the same dataset.  ``make_lane_cases`` builds a sentinel-separated sequence
memory plus one seed per read, the layout a loaded DB gives the wave;
``make_long_lane_cases`` the same for long reads, with the window length the
persistent kernels give them; ``make_adversarial_lane_cases`` the same for
exact repeats, long exact runs and seeds next to the memory's ends;
``make_clip_cases`` lanes whose reverse wave clips at the start of A
(tools/clip_fuzz.py's cases).
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
    return _lane_memory(g, entries)


def _lane_memory(g, reads):
    """[4 | genome | 4 | read_0 | ... | 4] and one seed per read.  g: the
    genome's codes; reads: (codes, apos, bpos) with the seed point."""
    flat, off, insts = [np.array([4], np.uint8), g], 1 + len(g), []
    for b, apos, bp in reads:
        flat += [np.array([4], np.uint8), b]
        insts.append(dict(abase=1, alen=len(g), bbase=off + 1, blen=len(b),
                          diag=apos - bp, anti=apos + bp, flags=0))
        off += 1 + len(b)
    flat.append(np.array([4], np.uint8))
    return np.concatenate(flat), insts


def make_adversarial_lane_cases(seed, glen=3000):
    """Lanes that push the snake and the ends of the sequence memory: a
    genome whose [500, 1100) is repeated exactly at [1800, 2400), and reads
    that are exact copies (snakes of hundreds of bases, through the repeat),
    reads with one substitution 60, 61 or 64 bases after (or before) the
    seed (runs at the history's 61-bit edge and at whole words), reads with
    2% and 15% error across the repeat, noisy reads with exact stretches of
    300 and 600 bases that later waves walk into, and seeds on the first
    and last bases of the genome and of the reads: the genome starts at
    index 1 of the memory, and the last read ends next to its end.  Returns
    make_lane_cases' pair (seqmem, insts) from a numpy seed."""
    rng = np.random.default_rng(seed)
    g = list(sim_genome(rng, glen))
    g[1800:2400] = g[500:1100]
    genome = "".join(g)

    def read(lo, hi, err, at, fwd=(), rev=(), exact=(0, 0)):
        """The genome's [lo, hi) with errors (make_lane_cases' model) but
        none on the genome's [exact); the seed is the true pair `at` (an
        index into the read's matched pairs), and a substitution ends an
        exact run of each length in fwd after the seed point and in rev
        before it."""
        frag = list(genome[lo:hi])
        out, truth, bpos = [], [], 0
        for i, ch in enumerate(frag):
            if err and not exact[0] <= lo + i < exact[1] \
                    and rng.random() < err:
                t = rng.random()
                if t < 0.55:
                    out += ["ACGT"[rng.integers(0, 4)], ch]
                    truth.append((lo + i, bpos + 1))
                    bpos += 2
                elif t < 0.80:
                    pass
                else:
                    out.append("ACGT"[("ACGT".index(ch) + 1) % 4])
                    bpos += 1
            else:
                out.append(ch)
                truth.append((lo + i, bpos))
                bpos += 1
        apos, bp = truth[at]
        for j in [bp + 1 + r for r in fwd] + [bp - r for r in rev]:
            out[j] = "ACGT"[("ACGT".index(out[j]) + 1) % 4]
        return dbio.seq_to_numeric("".join(out)), apos + 1, bp + 1

    mid = 200
    reads = [read(0, 1500, 0.0, 0), read(0, 1500, 0.0, 2),
             read(glen - 1500, glen, 0.0, -1),
             read(450, 1150, 0.0, 350), read(1750, 2450, 0.02, 350),
             read(300, 2700, 0.15, 1200), read(0, 2000, 0.15, 1),
             read(glen - 2000, glen, 0.15, -2)]
    reads += [read(1000, 1400, 0.0, mid, (r,), (r,)) for r in (60, 61, 64)]
    reads += [read(1900, 2300, 0.0, mid, (r,)) for r in (198, 8, 7)]
    # noisy reads with an exact stretch that later waves reach: 300 bases,
    # and the whole repeat copy
    reads += [read(200, 1700, 0.15, 150, exact=(700, 1000)),
              read(200, 1700, 0.15, -150, exact=(700, 1000)),
              read(1200, 2900, 0.15, 100, exact=(1800, 2400)),
              read(1200, 2900, 0.15, -100, exact=(1800, 2400))]
    # the last read: its seed on its last base, next to the memory's end
    reads.append(read(glen - 600, glen, 0.0, -1))
    return _lane_memory(dbio.seq_to_numeric(genome), reads)


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


def make_clip_cases(seed, ncases, glen=12000, rlen=360,
                    err_head=0.22, err_tail=0.12, head=110, junk=48):
    """Reads whose reverse wave dives off the START of A and keeps going.

    Each read is [junk random bases | noisy genome fragment] with the seed
    7/8 into the read (the read is A, the genome B).  The reverse wave walks
    cleanly back to the junk head; inside the junk, A-gap-leaning paths
    touch x == 0 (clip and REACH grab) while luckier frontiers off the
    boundary keep the wave alive, so the band re-clips at successive
    diagonals over many waves: the lane class of the JAX package's 50k-read
    parity edge, where the band's prune after a clip must keep the
    diagonals just above the clip or a later, better boundary grab is lost.
    Draws what the JAX package's clip fuzz draws from the same seed, byte
    for byte.  Returns (seqmem uint8, list of seed dicts)."""
    rng = np.random.default_rng(seed)
    genome = sim_genome(rng, glen)

    flat = [np.array([4], np.uint8), dbio.seq_to_numeric(genome)]
    gbase, off = 1, 1 + glen
    insts = []
    for _ in range(ncases):
        start = int(rng.integers(0, glen - rlen - 100))
        frag = genome[start:start + rlen]
        out = []
        truth = []   # (bpos in the genome, apos in the read)
        apos = 0
        for i, ch in enumerate(frag):
            err = err_head if i < head else err_tail
            if rng.random() < err:
                t = rng.random()
                if t < 0.55:           # insertion in the read
                    out.append("ACGT"[rng.integers(0, 4)])
                    out.append(ch)
                    truth.append((start + i, apos + 1))
                    apos += 2
                elif t < 0.80:         # deletion
                    pass
                else:                  # substitution
                    out.append("ACGT"[("ACGT".index(ch) + 1) % 4])
                    apos += 1
            else:
                out.append(ch)
                truth.append((start + i, apos))
                apos += 1
        jhead = "".join("ACGT"[j] for j in rng.integers(0, 4, junk))
        read = dbio.seq_to_numeric(jhead + "".join(out))
        gpos, rpos = truth[(7 * len(truth)) // 8]
        rpos += junk
        flat.append(np.array([4], np.uint8))
        off += 1
        flat.append(read)
        insts.append(dict(abase=off, alen=len(read), bbase=gbase,
                          blen=glen, diag=rpos - gpos,
                          anti=(rpos + 1) + (gpos + 1), flags=0))
        off += len(read)
    flat.append(np.array([4], np.uint8))
    return np.concatenate(flat), insts

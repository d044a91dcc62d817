"""The benchmark's data, drawn from ``--seed`` in a few vectorised passes.

A genome of the configuration's contigs (chromosome arms at their published
lengths) of uniform random bases, into which each repeat class of the
configuration places copies of its families until they cover the class's
published share of the genome: a family is a random consensus, a copy a
stretch of it on either strand with a per-copy substitution rate.  Reads
are PacBio-like: a fragment at a uniform place in the genome (drawn again
where it runs past its contig's end) of a length from the traffic's length
model, in a random orientation, with errors at a fixed rate split into
insertions (a random base before the fragment's base), deletions and
substitutions (the base plus 1-3, mod 4), the model of the port's
``utils.sim.sim_read`` drawn over whole blocks at once (sim_read costs
~5.5 ms a read).

Every draw comes from one ``numpy.random.SeedSequence`` of the seed, the
genome from its first child and read block i from child i + 1, so one seed
gives the same bytes on any machine.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .dazz import copy_runs


def seed_sequence(seed: int) -> np.random.SeedSequence:
    """Any whole number, negative ones and those past 64 bits included."""
    return np.random.SeedSequence(int(seed) % (1 << 64))


@dataclass
class Genome:
    seq: np.ndarray        # uint8 over 0..3, the contigs back to back
    offs: np.ndarray       # int64[n + 1]: contig i is seq[offs[i]:offs[i+1]]
    names: list

    @property
    def ncontigs(self) -> int:
        return len(self.offs) - 1

    @property
    def lens(self) -> np.ndarray:
        return np.diff(self.offs)

    def contig(self, i: int) -> np.ndarray:
        return self.seq[self.offs[i]:self.offs[i + 1]]


@dataclass
class ReadBlock:
    seq: np.ndarray        # uint8, the reads back to back
    offs: np.ndarray       # int64[n + 1]: read i is seq[offs[i]:offs[i+1]]
    contig: np.ndarray     # int64[n]: where each read was drawn (truth)
    start: np.ndarray      # int64[n]: fragment start in its contig
    comp: np.ndarray       # bool[n]: drawn from the reverse strand

    @property
    def nreads(self) -> int:
        return len(self.offs) - 1

    @property
    def lens(self) -> np.ndarray:
        return np.diff(self.offs)

    def read(self, i: int) -> np.ndarray:
        return self.seq[self.offs[i]:self.offs[i + 1]]


#: the most bases one pass of the generator gathers at once
BATCH_BASES = 40_000_000
#: bases of one step inside a pass, whose temporaries stay in the cache
DRAW_STEP = 1 << 16


def draw_genome(ss: np.random.SeedSequence, cfg: dict) -> Genome:
    """cfg["contigs"] ([name, length] each) of uniform random bases with
    cfg["repeats"]'s classes placed in them (place_repeats)."""
    names = [str(c[0]) for c in cfg["contigs"]]
    offs = np.concatenate([[0], np.cumsum([int(c[1]) for c in
                                           cfg["contigs"]])]).astype(np.int64)
    rng = np.random.default_rng(ss)
    seq = uniform_bases(rng, int(offs[-1]))
    for cls in cfg.get("repeats", []):
        place_repeats(rng, seq, cls)
    return Genome(seq, offs, names)


def uniform_bases(rng, n: int) -> np.ndarray:
    """``rng.integers(0, 4, size=n, dtype=np.uint8)``, bit for bit, with
    ``rng`` left as that call leaves it, at a fraction of its cost.

    numpy draws such a base by Lemire's method, which never rejects for a
    range of 4, from one byte of a 32-bit draw: the byte's top two bits.  A
    32-bit draw is one half of a 64-bit word, the low half first, the high
    half kept for the next.  So n bases are the top two bits of each byte
    of the first n / 8 words.  A probe of the call itself, on a copy of the
    generator's state, checks that this numpy draws so, and raises
    RuntimeError where it does not."""
    bg = rng.bit_generator
    start = bg.state
    probe = rng.integers(0, 4, size=min(n, 4099), dtype=np.uint8)
    after = bg.state
    bg.state = start
    same = np.array_equal(_raw_bases(bg, len(probe)), probe) \
        and bg.state == after
    bg.state = start
    if not same:
        raise RuntimeError(
            f"numpy {np.__version__} draws integers(0, 4, uint8) otherwise "
            "than from the top bits of its 32-bit draws; uniform_bases "
            "would not give its bases")
    return _raw_bases(bg, n)


def _raw_bases(bg, n: int) -> np.ndarray:
    """uniform_bases' n bases from the bit generator's 64-bit words."""
    halves = -(-n // 4)
    words = bg.random_raw(-(-halves // 2)).astype("<u8", copy=False)
    if halves:
        st = bg.state
        st["has_uint32"] = halves % 2
        st["uinteger"] = int(words[-1] >> np.uint64(32))
        bg.state = st
    out = words.view(np.uint8)
    out >>= 6
    return out[:n]


def place_repeats(rng, seq: np.ndarray, cls: dict) -> int:
    """Copies of one repeat class written over ``seq`` until their bases
    reach cls["genome_share"] of it; returns the bases written.

    cls["families"] consensuses of lengths uniform in cls["consensus_len"]
    ([lo, hi]); a copy takes a family at random, a stretch of its consensus
    of a length uniform from min(cls["copy_len_min"], consensus) to the
    whole, at a uniform offset, on a random strand, each base substituted
    at a rate uniform in cls["divergence"] ([lo, hi]) for the copy, and
    lands at a uniform place in the genome (copies may overlap one another
    and the contigs' joins)."""
    total = len(seq)
    flo, fhi = (int(x) for x in cls["consensus_len"])
    fl = rng.integers(flo, fhi + 1, size=int(cls["families"]))
    foffs = np.concatenate([[0], np.cumsum(fl)])
    cons = rng.integers(0, 4, size=int(foffs[-1]), dtype=np.uint8)
    # a copy reads one forward run of cat: its stretch of the consensus,
    # or on the reverse strand the same stretch of the consensuses
    # reversed and complemented
    cat = np.concatenate([cons, 3 - cons[::-1]])
    cmin = np.minimum(int(cls["copy_len_min"]), fl)
    mean_copy = float(((cmin + fl) / 2).mean())
    dlo, dhi = (float(x) for x in cls["divergence"])
    target = int(float(cls["genome_share"]) * total)
    placed = 0
    while placed < target:
        n = int(min((target - placed) / mean_copy * 1.1 + 4,
                    BATCH_BASES / mean_copy + 4))
        fam = rng.integers(0, len(fl), size=n)
        lo, hi = cmin[fam], fl[fam]
        clen = lo + (rng.random(n) * (hi - lo + 1)).astype(np.int64)
        cstart = (rng.random(n) * (hi - clen + 1)).astype(np.int64)
        pos = (rng.random(n) * (total - clen + 1)).astype(np.int64)
        rev = rng.random(n) < 0.5
        div = dlo + rng.random(n) * (dhi - dlo)
        cum = placed + np.cumsum(clen)
        m = int(np.searchsorted(cum, target)) + 1 if cum[-1] >= target \
            else n
        clen, fam, cstart, pos, rev, div = (x[:m] for x in (
            clen, fam, cstart, pos, rev, div))
        coffs = np.concatenate([[0], np.cumsum(clen)])
        first = foffs[fam] + cstart
        first = np.where(rev, 2 * len(cons) - first - clen, first)
        # the copies' bases back to back, each run copied whole
        bases = np.empty(int(coffs[-1]), np.uint8)
        copy_runs(bases, coffs[:-1], cat, first, clen)
        sub = _below(rng, div, clen, coffs)
        bases[sub] = (bases[sub] + rng.integers(1, 4, size=len(sub),
                                                dtype=np.uint8)) % 4
        # in order, so that a later copy overwrites an earlier one
        copy_runs(seq, pos, bases, coffs[:-1], clen)
        placed += int(coffs[-1])
    return placed


def _below(rng, div, clen, coffs) -> np.ndarray:
    """np.flatnonzero(rng.random(coffs[-1]) < np.repeat(div, clen)): the
    same draws, made in steps of whole copies of about DRAW_STEP bases so
    that a step's temporaries stay in the cache."""
    at = np.searchsorted(coffs, np.arange(0, coffs[-1], DRAW_STEP),
                         "right") - 1
    at = np.append(np.unique(at), len(clen)).tolist()
    out = []
    for k0, k1 in zip(at[:-1], at[1:]):
        a = int(coffs[k0])
        out.append(np.flatnonzero(rng.random(int(coffs[k1]) - a)
                                  < np.repeat(div[k0:k1], clen[k0:k1])) + a)
    return np.concatenate(out)


def draw_lengths(rng, n: int, model: dict) -> np.ndarray:
    """n read lengths before errors, log-normal with the traffic's
    model["mean"] and model["sd"] (those of the lengths themselves); a
    length under model["min"] is marked 0 (the caller draws again)."""
    m, sd = float(model["mean"]), float(model["sd"])
    s2 = np.log1p((sd / m) ** 2)
    ln = np.rint(np.exp(rng.normal(np.log(m) - s2 / 2, np.sqrt(s2),
                                   size=n))).astype(np.int64)
    ln[ln < int(model["min"])] = 0
    return ln


def _error_pass(rng, frag, err, ins, dele):
    """The read model's errors over a fragment of bases: returns the read
    bases and, per fragment base, the count it emits (0, 1 or 2).  One
    uniform draw a base decides both whether it is an error and which:
    [0, err*ins) an insertion, then a deletion up to err*(ins+dele), then a
    substitution up to err."""
    u = rng.random(len(frag), dtype=np.float32)
    hit = np.flatnonzero(u < err)
    kind = u[hit]
    is_ins = hit[kind < err * ins]
    is_del = hit[(kind >= err * ins) & (kind < err * (ins + dele))]
    is_sub = hit[kind >= err * (ins + dele)]
    base = frag
    base[is_sub] = (base[is_sub]
                    + rng.integers(1, 4, size=len(is_sub), dtype=np.uint8)) % 4
    count = np.ones(len(frag), np.int8)
    count[is_ins] = 2
    count[is_del] = 0
    ends = np.cumsum(count, dtype=np.int64)
    out = np.empty(int(ends[-1]) if len(frag) else 0, np.uint8)
    keep = count > 0
    out[ends[keep] - 1] = base[keep]
    out[ends[is_ins] - 2] = rng.integers(0, 4, size=len(is_ins),
                                         dtype=np.uint8)
    return out, count


def draw_block(ss: np.random.SeedSequence, genome: Genome,
               traffic: dict) -> ReadBlock:
    """Reads until their bases reach traffic["block_bases"]: the block
    closes on the read that reaches it, as DBsplit -s closes a block."""
    rng = np.random.default_rng(ss)
    model = traffic["read_len"]
    mean = float(model["mean"])
    err = float(traffic["error_rate"])
    ins, dele = float(traffic["ins_share"]), float(traffic["del_share"])
    target = int(traffic["block_bases"])
    gtotal = int(genome.offs[-1])
    glens = genome.lens
    parts = []
    total = 0
    while total < target:
        # a batch that most likely closes the block; a short one draws more
        n = int(min((target - total) / mean * 1.1 + 4,
                    BATCH_BASES / mean + 4))
        ln = draw_lengths(rng, n, model)
        at = (rng.random(n) * gtotal).astype(np.int64)
        comp = rng.random(n) < 0.5
        ctg = np.searchsorted(genome.offs, at, "right") - 1
        start = at - genome.offs[ctg]
        ok = (ln > 0) & (start + ln <= glens[ctg])
        ln, ctg, start, comp = ln[ok], ctg[ok], start[ok], comp[ok]
        if not len(ln):
            continue
        foffs = np.concatenate([[0], np.cumsum(ln)])
        # fragment base j of read i: genome base first_i + step_i * j, with
        # step -1 from the fragment's end on the reverse strand
        first = genome.offs[ctg] + np.where(comp, start + ln - 1, start)
        step = np.where(comp, -1, 1)
        idx = np.arange(foffs[-1], dtype=np.int64)
        idx -= np.repeat(foffs[:-1], ln)
        idx *= np.repeat(step, ln)
        idx += np.repeat(first, ln)
        frag = genome.seq[idx]
        del idx
        rc = np.repeat(comp, ln)
        np.subtract(3, frag, out=frag, where=rc)
        out, count = _error_pass(rng, frag, err, ins, dele)
        rlens = np.add.reduceat(count, foffs[:-1], dtype=np.int64)
        cum = total + np.cumsum(rlens)
        m = int(np.searchsorted(cum, target)) + 1 if cum[-1] >= target \
            else len(ln)
        parts.append((out[:int(rlens[:m].sum())], rlens[:m], ctg[:m],
                      start[:m], comp[:m]))
        total = int(cum[m - 1])
    seq = np.concatenate([p[0] for p in parts])
    rlens = np.concatenate([p[1] for p in parts])
    if (rlens < 1).any():
        raise ValueError("a read lost every base to deletions")
    return ReadBlock(seq, np.concatenate([[0], np.cumsum(rlens)]),
                     *(np.concatenate([p[i] for p in parts])
                       for i in (2, 3, 4)))


def draw_cell(seed: int, cfg: dict, traffic: dict):
    """(genome, [read block, ...]) of one cell and seed."""
    kids = seed_sequence(seed).spawn(1 + int(traffic["distinct_blocks"]))
    genome = draw_genome(kids[0], cfg)
    return genome, [draw_block(k, genome, traffic) for k in kids[1:]]

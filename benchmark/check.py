"""The comparison that decides ``correct``.

Four numbers, each with the limit 0 (an exact comparison):

  records_malformed  records of every block mapped in the window that break
                     what a .las record of this cell must hold: its read in
                     the block, its contig in the reference, its intervals
                     inside both, as many trace points as its A interval
                     crosses, the trace's B steps summing to its B interval
                     and its diffs to its diffs, chain flags, map order;
  repeats_differ     blocks mapped again in the window (the traffic cycles
                     through its distinct blocks) whose .las or -p bytes
                     differ from the block's first mapping in the window;
  reads_differ       reads of a sample, drawn from the seed over every
                     distinct block mapped in the window with the longest
                     read among them, whose records (every field, the trace
                     included, in file order) differ from the plain
                     reference's (ref/);
  profiles_differ    the same sample's -p values, where the configuration
                     asks for -p.
"""

from __future__ import annotations

import filecmp

import numpy as np

from . import gen
from .ref.mapper import hidden_root, map_samples
from .dazz import NEXT_FLAG, START_FLAG, COMP_FLAG, LasFile, read_profile

LIMITS = {"records_malformed": 0, "repeats_differ": 0, "reads_differ": 0,
          "profiles_differ": 0}


def malformed(las: LasFile, rlens: np.ndarray, tfirst: int,
              ctg_lens: np.ndarray, spacing: int) -> int:
    """Records of one block's .las that break its invariants (the module's
    docstring); every record when the trace spacing is wrong."""
    n = len(las)
    if n == 0:
        return 0
    if las.tspace != spacing:
        return n
    ar, br = las.col("aread") - tfirst, las.col("bread")
    ab, ae = las.col("abpos"), las.col("aepos")
    bb, be = las.col("bbpos"), las.col("bepos")
    tlen, flags = las.col("tlen"), las.col("flags")
    ok = (ar >= 0) & (ar < len(rlens)) & (br >= 0) & (br < len(ctg_lens))
    alen = np.where(ok, rlens[np.clip(ar, 0, len(rlens) - 1)], 0)
    blen = np.where(ok, ctg_lens[np.clip(br, 0, len(ctg_lens) - 1)], 0)
    ok &= (ab >= 0) & (ab < ae) & (ae <= alen) & (bb >= 0) & (bb <= be) \
        & (be <= blen)
    ok &= tlen == 2 * ((ae - 1) // spacing - ab // spacing + 1)
    # the traces are (diffs, B step) pairs and every tlen is even, so the
    # pairs' parity is the records' own
    half = las.toff // 2
    even = np.concatenate([[0], np.cumsum(las.trace[0::2])])
    odd = np.concatenate([[0], np.cumsum(las.trace[1::2])])
    ok &= (tlen % 2 == 0)
    ok &= (even[half[1:]] - even[half[:-1]]) == las.col("diffs")
    ok &= (odd[half[1:]] - odd[half[:-1]]) == be - bb
    start, nxt = (flags & START_FLAG) != 0, (flags & NEXT_FLAG) != 0
    ok &= start != nxt
    ok[0] &= bool(start[0])
    # map order: chains keyed by (aread, abpos, bread, comp, bbpos) of
    # their first record
    heads = np.flatnonzero(start)
    key = np.stack([ar[heads], ab[heads], br[heads],
                    flags[heads] & COMP_FLAG, bb[heads]], axis=1)
    for i in np.flatnonzero([tuple(a) > tuple(b)
                             for a, b in zip(key[:-1], key[1:])]):
        ok[heads[i + 1]] = False
    return int(n - ok.sum())


def same_output(a: dict, b: dict) -> bool:
    """Two mappings of one block wrote the same bytes."""
    return all(filecmp.cmp(a[k], b[k], shallow=False) for k in a)


def draw_sample(seed: int, traffic: dict, blocks, mapped_blocks) -> list:
    """[(block, read)]: traffic["check_reads"] reads drawn from the seed
    over the distinct blocks mapped in the window, and the longest of
    them."""
    rng = np.random.default_rng(
        gen.seed_sequence(seed).spawn(2 + int(traffic["distinct_blocks"]))
        [-1])
    pool = [(b, r) for b in sorted(mapped_blocks)
            for r in range(blocks[b].nreads)]
    lens = np.array([blocks[b].lens[r] for b, r in pool])
    want = min(int(traffic["check_reads"]), len(pool))
    pick = set(rng.choice(len(pool), size=want, replace=False).tolist())
    pick.add(int(np.argmax(lens)))
    return sorted(pool[i] for i in pick)


def program_answers(sample, firsts: dict, profile: bool) -> dict:
    """{(block, read): (records, -p bytes or None)} of the program's
    outputs, ``firsts`` mapping a block to its first mapping in the window
    ({"las": LasFile, "prof": the track's root, "tfirst": int})."""
    got, tracks = {}, {}
    for b, r in sample:
        m = firsts[b]
        prof = None
        if profile:
            if b not in tracks:
                tracks[b] = read_profile(m["prof"])
            offs, data = tracks[b]
            prof = data[offs[r]:offs[r + 1]] if r + 1 < len(offs) else None
        got[(b, r)] = (m["las"].records_of(m["tfirst"] + r), prof)
    return got


def compare(got: dict, expect: dict) -> tuple[int, int]:
    """(reads_differ, profiles_differ) of two {(block, read): (records,
    -p bytes or None)}."""
    reads = sum(got[k][0] != expect[k][0] for k in expect)
    profiles = sum(got[k][1] != expect[k][1] for k in expect)
    return reads, profiles


def reference_answers(sample, genome, blocks, ref_cut, read_cut, opts,
                      work, device, control: bool = False,
                      workers: int | None = None) -> dict:
    """{(block, read): (records, -p bytes or None)} of the plain reference
    (with ``control``: of the control, ref/mapper.py control_wave) for the
    sample; ``work`` is the directory of the DAZZ files, ``workers`` the
    host processes of its per-read tasks (ref/mapper.py map_samples)."""
    paths = {"reads": hidden_root(str(work / "reads.1")),
             "ref": hidden_root(str(work / "ref.dam"))}
    parts = [(b, blocks[b], read_cut[b], [r for bb, r in sample if bb == b])
             for b in sorted({b for b, _ in sample})]
    return map_samples(genome, ref_cut, parts, opts, paths, device,
                       control=control, workers=workers)

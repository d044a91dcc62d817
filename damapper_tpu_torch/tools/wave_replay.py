"""Replay dumped wave rounds, the wave engine against the host oracle.

1. Dump: DAMAPPER_WAVE_DUMP=seeds.pkl <run the mapper on one reads block>
2. Replay:
       python -m damapper_tpu_torch.tools.wave_replay seeds.pkl READS REF
           [lo:hi ...] [--device cpu]

READS is the reads DB or block the run mapped (e.g. reads.3 for a block of a
split DB) and REF the reference DAM.  Each dumped call (one round of the
reporter) is replayed as its own batch on a WaveEngine with host_min=0, on
the CUDA card unless --device says otherwise, in the wave mode that the
DAMAPPER_WAVE_* switches select; the sequence memories are built and
uploaded as the reporter builds them: A = [reads | comp reads]
(pipeline.reporter.align_memory_a), B = the reference, each through
reporter._upload_section.  Every replayed lane whose abase lies in one of
the lo:hi ranges (all lanes when none is given) is re-aligned by the host
oracle (ops.wave.local_alignment); the ranges bound the oracle's work, never
the engine's.  Each lane whose A or B path differs is printed with its call,
index, seed and first differing field; the exit code is 1 if any does.

REPLAY_E (default .85) and REPLAY_S (default 100) give the alignment spec's
average correlation and trace spacing, as for the JAX package's tool.  A
dump of either package replays in either tool: both write one
pickle.dump(seeds) a round.
"""

from __future__ import annotations

import argparse
import os
import pickle
import sys
import time

import numpy as np

FIELDS = ("abpos", "bbpos", "aepos", "bepos", "diffs", "trace")


def read_dump(path) -> list:
    """The dumped calls, in order: each a list of seed dicts."""
    calls = []
    with open(path, "rb") as fh:
        while True:
            try:
                calls.append(pickle.load(fh))
            except EOFError:
                return calls


def path_key(p) -> tuple:
    """A path's fields, in FIELDS order, as plain Python values."""
    return (int(p.abpos), int(p.bbpos), int(p.aepos), int(p.bepos),
            int(p.diffs), tuple(int(x) for x in np.asarray(p.trace).ravel()))


def first_difference(want, got):
    """The first differing field of two (apath, bpath) results, as
    "a.diffs" or "b.trace", or None when they agree."""
    for side, w, g in (("a", want[0], got[0]), ("b", want[1], got[1])):
        for f, x, y in zip(FIELDS, path_key(w), path_key(g)):
            if x != y:
                return f"{side}.{f}"
    return None


def parse_ranges(specs) -> list:
    out = []
    for s in specs:
        lo, hi = s.split(":")
        out.append((int(lo), int(hi)))
    return out


def replay(calls, reads_db, ref_db, spec, device, ranges=()):
    """Replay every call on a host_min=0 engine on ``device`` and hold the
    lanes whose abase lies in ``ranges`` (every lane when empty) to the
    oracle.  Returns (mismatches as (call, lane, seed, field, oracle, engine)
    tuples, lanes checked, the engine)."""
    from ..ops import wave as host_wave
    from ..ops.wave_engine import WaveEngine
    from ..pipeline.reporter import _upload_section, align_memory_a

    eng = WaveEngine(spec, device=device, host_min=0)
    flat_a, _, boffs, rlens = align_memory_a(reads_db)
    flat_b = ref_db.seq
    Adev = _upload_section(flat_a, boffs, rlens, eng.device)
    Bdev = _upload_section(flat_b, ref_db.reads["boff"],
                           ref_db.reads["rlen"], eng.device)
    bad, checked = [], 0
    for ci, seeds in enumerate(calls):
        # each call is its own batch: a kernel fault may depend on the
        # round's composition (pool bucket, lane order)
        got = eng.local_alignment_batch(Adev, Bdev, flat_a, flat_b, seeds)
        for li, (s, g) in enumerate(zip(seeds, got)):
            if ranges and not any(lo <= s["abase"] < hi
                                  for lo, hi in ranges):
                continue
            checked += 1
            want = host_wave.local_alignment(
                flat_a[s["abase"]:s["abase"] + s["alen"]],
                flat_b[s["bbase"]:s["bbase"] + s["blen"]], spec,
                int(s["diag"]), int(s["diag"]), int(s["anti"]), -1, -1,
                int(s.get("flags", 0)))
            fld = first_difference(want, g)
            if fld is not None:
                bad.append((ci, li, s, fld, want, g))
    return bad, checked, eng


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dump")
    ap.add_argument("reads")
    ap.add_argument("ref")
    ap.add_argument("ranges", nargs="*", metavar="lo:hi",
                    help="abase ranges the oracle checks (default: all)")
    ap.add_argument("--device", default=None,
                    help="the engine's device (default: the CUDA card)")
    args = ap.parse_args(argv)

    from ..ops.spec import new_align_spec
    from ..pipeline.mapper import read_block

    calls = read_dump(args.dump)
    nseeds = sum(map(len, calls))
    print(f"{len(calls)} calls, {nseeds} seeds to replay", flush=True)
    t0 = time.time()
    reads_db = read_block(args.reads, [], 0)
    ref_db = read_block(args.ref, [], 0)
    spec = new_align_spec(float(os.environ.get("REPLAY_E", .85)),
                          int(os.environ.get("REPLAY_S", 100)),
                          np.asarray(ref_db.freq), True)
    bad, checked, eng = replay(calls, reads_db, ref_db, spec, args.device,
                               parse_ranges(args.ranges))
    for ci, li, s, fld, want, got in bad:
        print(f"LANE MISMATCH call {ci} lane {li} field {fld} seed {s}")
        print(f"  oracle: {path_key(want[0])[:5]} {path_key(want[1])[:5]}")
        print(f"  engine: {path_key(got[0])[:5]} {path_key(got[1])[:5]}")
    print(f"{len(bad)} mismatching lanes of {checked} checked, {nseeds} "
          f"replayed on {eng.device} (wave mode {eng.mode}; launches "
          f"{ {k: v for k, v in eng.launches.items() if v} }; fallbacks "
          f"{eng.n_fallback}, retried on classic {eng.n_winmiss}) in "
          f"{time.time() - t0:.1f}s", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

"""The plain reference: the records and -p values of a sample of reads.

For each sampled read of one read block it works out again, from the bases
the benchmark drew (the same bases its DAZZ files hold), what damapper
writes for that read: the seed hits against every reference block in both
orientations (seeds.py, PyTorch), the chains and the candidates (chain.py),
every candidate's local alignments and their selection (report.py, with
the Python wave of wave.py), sorted as LAsort -a sorts them, and the read's
-p values.  A read's result depends on the other reads of its block only
through the k-mer counts of the -M governor, which seeds.py takes over the
whole block, so a sample is checked read by read.

It imports nothing of the program.
"""

from __future__ import annotations

import os
from contextlib import contextmanager, nullcontext

import numpy as np
import torch

from .chain import ChainState
from . import wave
from ..dazz import base_freq
from .report import Reporter, sort_map_order, special_log
from .spec import new_align_spec
from .seeds import ReadIndex, block_hits, ref_codes


def db_sizeof(path: str, nreads: int, totlen: int) -> int:
    """The size the -M governor charges a loaded block (sizeof_DB,
    DB.c:1044-1076, as the program reckons it for a DB with no tracks):
    ``path`` is the block's directory joined to "." and its DB's name."""
    return 112 + 40 * (nreads + 2) + len(path) + 1 + (totlen + nreads + 4)


#: the control's give-up lag: the wave stops when no point within this
#: many antidiagonals of its best survives (TRIM_MLAG, 250 in the
#: reference); a lane ends sooner at 200, the step a kernel could take to
#: cut its waves
CONTROL_TRIM_MLAG = 200


#: (largest product of a k-mer's counts in the read block and in a
#: reference block, the -M governor's limit) of each reference block and
#: orientation of the last map_samples, for the run's log
GOVERNOR: list = []


@contextmanager
def control_wave():
    """The wave of wave.py with the control's give-up lag."""
    keep = wave.TRIM_MLAG
    wave.TRIM_MLAG = CONTROL_TRIM_MLAG
    try:
        yield
    finally:
        wave.TRIM_MLAG = keep


def map_samples(genome, ref_cut, parts, opts: dict, paths: dict, device,
                control: bool = False) -> dict:
    """{(block, read): (records, -p bytes or None)} for the sample.

    genome: gen.Genome; ref_cut: the DAM's block boundaries in contigs;
    parts: [(block number, gen.ReadBlock, its first read in the DB, [its
    sampled reads, block-local])]; opts: the configuration's damapper
    options; paths: the reads' and the reference's hidden roots as the
    program opens them ("reads", "ref"), for the governor's charge;
    control: the control's wave (control_wave).  Each reference block's
    k-mers are worked out once for every read block."""
    k = int(opts["kmer"])
    spacing = int(opts["spacing"])
    mem_limit = int(opts["mem_limit_gb"]) << 30
    spec = new_align_spec(float(opts["ave_error"]), spacing,
                          base_freq(genome.seq), reach=True)
    runs = []
    for b, block, tfirst, rows in parts:
        rows = np.asarray(rows, np.int64)
        state = ChainState(len(rows), k, profile=bool(opts["profile"]),
                           rlens=block.lens[rows], spacing=spacing)
        rix = ReadIndex(block, rows, k, device)
        rd_bytes = db_sizeof(paths["reads"], block.nreads,
                             int(block.lens.sum()))
        runs.append((b, block, tfirst, rows, state, rix, rd_bytes))
    for c0, c1 in zip(ref_cut[:-1], ref_cut[1:]):
        o0, o1 = int(genome.offs[c0]), int(genome.offs[c1])
        seq = torch.from_numpy(genome.seq[o0:o1]).to(device)
        lens = genome.lens[c0:c1]
        for comp in (0, 1):
            ref = ref_codes(seq, lens, bool(comp), k)
            for b, block, tfirst, rows, state, rix, rd_bytes in runs:
                db_bytes = rd_bytes + db_sizeof(paths["ref"], c1 - c0,
                                                o1 - o0)
                state.process_hits(block_hits(rix, ref, c0, mem_limit,
                                              db_bytes), comp)
            del ref
        del seq
    rep = Reporter(spec, k, spacing, float(opts.get("best_tie", 1.0)))
    out = {}
    for b, block, tfirst, rows, state, rix, rd_bytes in runs:
        for i, r in enumerate(rows.tolist()):
            with control_wave() if control else nullcontext():
                amatch = rep.align_read(i, block.read(r), genome.contig,
                                        state)
            recs: list[tuple] = []
            rep.select(tfirst + r, amatch, recs)
            prof = None
            if opts["profile"]:
                prof = bytes(special_log(int(x))
                             for x in np.cumsum(state.cover[i]))
            out[(b, r)] = (sort_map_order(recs), prof)
    GOVERNOR[:] = [g for run in runs for g in run[5].governor]
    return out


def hidden_root(db_path: str) -> str:
    """The path a DB block's loader keeps (the directory joined to "." and
    the DB's name, its block number stripped)."""
    pwd = os.path.dirname(db_path) or "."
    name = os.path.basename(db_path).split(".")[0]
    return os.path.join(pwd, "." + name)

"""The plain reference: the records and -p values of a sample of reads.

For each sampled read of one read block it works out again, from the bases
the benchmark drew (the same bases its DAZZ files hold), what damapper
writes for that read: the seed hits against every reference block in both
orientations (seeds.py, PyTorch), the chains and the candidates (chain.py),
every candidate's local alignments and their selection (report.py, with
the Python wave of wave.py), sorted as LAsort -a sorts them, and the read's
-p values.  A read's result depends on the other reads of its block only
through the k-mer counts of the -M governor, which seeds.py takes over the
whole block, so a sample is checked read by read: the hits in this
process, on the device, and each read's chains, alignments and selection
as a task of its own, on the host's cores.

It imports nothing of the program.
"""

from __future__ import annotations

import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
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


def pool_size() -> int:
    """The reference's workers by default: one a CPU this process may run
    on."""
    return len(os.sched_getaffinity(0))


#: what the tasks of the running map_samples read: (genome, runs, passes,
#: (k, spacing, profile), reporter); set before its pool starts, so that
#: the forked workers share the bases and the hits copy-on-write
_WORK: tuple | None = None


def _map_read(ri: int, i: int, control: bool):
    """(records, -p bytes or None) of sampled read ``i`` of run ``ri``: a
    one-read ChainState fed the read's hits of every pass in pass order,
    then the read's alignment, selection and -p values.  chain.py keeps a
    read's chains, candidates and coverage apart from every other read's,
    so this is what a state over the whole sample holds for the read."""
    genome, runs, passes, (k, spacing, profile), rep = _WORK
    b, block, tfirst, rows = runs[ri]
    r = int(rows[i])
    state = ChainState(1, k, profile=profile, rlens=block.lens[r:r + 1],
                       spacing=spacing)
    for comp, (bread, apos, diag), bounds in passes[ri]:
        s, e = bounds[i], bounds[i + 1]
        state.process_hits((np.zeros(e - s, np.int64), bread[s:e],
                            apos[s:e], diag[s:e]), comp)
    with control_wave() if control else nullcontext():
        amatch = rep.align_read(0, block.read(r), genome.contig, state)
    recs: list[tuple] = []
    rep.select(tfirst + r, amatch, recs)
    prof = None
    if profile:
        prof = bytes(special_log(int(x)) for x in np.cumsum(state.cover[0]))
    return sort_map_order(recs), prof


def map_samples(genome, ref_cut, parts, opts: dict, paths: dict, device,
                control: bool = False, workers: int | None = None) -> dict:
    """{(block, read): (records, -p bytes or None)} for the sample.

    genome: gen.Genome; ref_cut: the DAM's block boundaries in contigs;
    parts: [(block number, gen.ReadBlock, its first read in the DB, [its
    sampled reads, block-local])]; opts: the configuration's damapper
    options; paths: the reads' and the reference's hidden roots as the
    program opens them ("reads", "ref"), for the governor's charge;
    control: the control's wave (control_wave); workers: host processes
    for the reads' tasks (pool_size() when None; 1 runs them here).

    In this process, on ``device``: each read block's k-mers, then each
    reference block's in both orientations, worked out once for every read
    block, with the sampled reads' hits.  Then one task a sampled read
    (_map_read) on a pool of forked processes, which never touch
    ``device``: the costliest reads by their hits go first, and each
    worker takes the next task as it finishes one."""
    global _WORK
    k = int(opts["kmer"])
    spacing = int(opts["spacing"])
    mem_limit = int(opts["mem_limit_gb"]) << 30
    spec = new_align_spec(float(opts["ave_error"]), spacing,
                          base_freq(genome.seq), reach=True)
    runs, rixs, passes = [], [], []
    for b, block, tfirst, rows in parts:
        rows = np.asarray(rows, np.int64)
        rd_bytes = db_sizeof(paths["reads"], block.nreads,
                             int(block.lens.sum()))
        runs.append((b, block, tfirst, rows))
        rixs.append((ReadIndex(block, rows, k, device), rd_bytes))
        passes.append([])
    for c0, c1 in zip(ref_cut[:-1], ref_cut[1:]):
        o0, o1 = int(genome.offs[c0]), int(genome.offs[c1])
        seq = torch.from_numpy(genome.seq[o0:o1]).to(device)
        lens = genome.lens[c0:c1]
        for comp in (0, 1):
            ref = ref_codes(seq, lens, bool(comp), k)
            for (rix, rd_bytes), run, pas in zip(rixs, runs, passes):
                db_bytes = rd_bytes + db_sizeof(paths["ref"], c1 - c0,
                                                o1 - o0)
                aread, *cols = block_hits(rix, ref, c0, mem_limit, db_bytes)
                # sorted by read first: read i's hits are one slice
                pas.append((comp, cols, np.searchsorted(
                    aread, np.arange(len(run[3]) + 1))))
            del ref
        del seq
    GOVERNOR[:] = [g for rix, _ in rixs for g in rix.governor]
    del rixs
    tasks = [(ri, i) for ri, run in enumerate(runs)
             for i in range(len(run[3]))]
    rep = Reporter(spec, k, spacing, float(opts.get("best_tie", 1.0)))
    _WORK = (genome, runs, passes, (k, spacing, bool(opts["profile"])), rep)
    try:
        n = min(workers or pool_size(), len(tasks))
        if n <= 1:
            got = [_map_read(ri, i, control) for ri, i in tasks]
        else:
            cost = [sum(int(bd[i + 1] - bd[i]) for _, _, bd in passes[ri])
                    for ri, i in tasks]
            with ProcessPoolExecutor(
                    n, mp_context=multiprocessing.get_context("fork")) as ex:
                futs = {t: ex.submit(_map_read, *tasks[t], control)
                        for t in sorted(range(len(tasks)),
                                        key=lambda t: -cost[t])}
                got = [futs[t].result() for t in range(len(tasks))]
    finally:
        _WORK = None
    return {(runs[ri][0], int(runs[ri][3][i])): ans
            for (ri, i), ans in zip(tasks, got)}


def hidden_root(db_path: str) -> str:
    """The path a DB block's loader keeps (the directory joined to "." and
    the DB's name, its block number stripped)."""
    pwd = os.path.dirname(db_path) or "."
    name = os.path.basename(db_path).split(".")[0]
    return os.path.join(pwd, "." + name)

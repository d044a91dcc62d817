"""Multi-device execution: the (dp, ref) device mesh, the cross-rank steps
of a mesh that spans ranks, and the multichip validation run.

The reference scales three ways (SURVEY.md §2.2): pthreads inside a process,
reference-block streaming against a resident reads index, and cluster-level
data parallelism over read blocks via generated shell scripts
(HPC.damapper.c).  The equivalents wired into the real pipeline
(pipeline.mapper.run_damapper):

  * axis "dp"  — read/seed data parallelism (map.c:2966-2978,
                 HPC.damapper.c:359-443): each mesh position of a dp row
                 holds that row's shard of the reads k-mer index, and the
                 wave engine launches each dp shard of its lanes on the
                 row's device.
  * axis "ref" — reference k-mer index sharding (the memory axis of the
                 reference's block streaming, damapper.c:835-864): each
                 position holds a contiguous slice of the sorted reference
                 index; the per-group hit totals of the ref shards are
                 summed (ops.device_index.device_match_seeds_sharded) in
                 place of the coff-cache accumulation (map.c:2874-2888).

A mesh position is a torch.device.  A device list may name one device more
than once: the positions are then virtual shards of it, each holding its
own slice of the work (views of one tensor where they share the device),
as the JAX package's tests run its mesh on virtual CPU devices.  One card
runs a mesh this way; so do the CPU tests.

A mesh may span the ranks of a torch.distributed group (``launch
--global-index``): every rank holds the same host state and builds the same
indexes, keeps the shards of the positions it owns, and the steps that
need every position (the ref shards' count sum, the per-shard totals, the
emission buffers) cross the ranks on the group's gloo backend, from host
copies.  Each such step first exchanges every rank's status, so a rank that
failed meets its peers at the next step, and they stop too (``PeerFailed``)
instead of waiting on it.

``dryrun(n)`` runs the real mapper twice on a small simulated dataset —
single-device against an n-position (dp, ref) mesh with the sharded index,
match and wave — and requires record-identical ``.las`` output.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from ..ops.wave_engine import resolve_device

AXES = ("dp", "ref")
_BASES = "ACGT"


def _rank() -> int:
    """This process's rank in the torch.distributed group (0 without one)."""
    import torch.distributed as dist
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def _device(d) -> torch.device:
    """A mesh position's device: a CUDA device without a card raises; a
    CUDA device without an index is the current card."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """Devices on a grid with named axes: ("dp", "ref") for a 2-D mesh,
    ("dp",) for a 1-D one.  ``devices`` is a numpy object array of
    torch.devices; ``ranks`` (same shape) the rank owning each position,
    all 0 in one process; ``rank`` this process's rank."""

    def __init__(self, devices, axis_names=AXES, ranks=None):
        src = np.asarray(devices, dtype=object)
        arr = np.empty(src.shape, dtype=object)
        for ix in np.ndindex(src.shape):
            arr[ix] = _device(src[ix])
        if arr.ndim != len(axis_names):
            raise ValueError(f"a {arr.ndim}-D device array with axes "
                             f"{tuple(axis_names)}")
        self.devices = arr
        self.axis_names = tuple(axis_names)
        self.ranks = (np.zeros(arr.shape, np.int64) if ranks is None
                      else np.asarray(ranks, np.int64).reshape(arr.shape))
        self.rank = _rank()

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def is_multiprocess(self) -> bool:
        """True when some position belongs to another rank."""
        return bool((self.ranks != self.rank).any())

    def local_positions(self) -> list:
        """The index tuples of the positions this rank owns, in order."""
        return [ix for ix in np.ndindex(self.devices.shape)
                if self.ranks[ix] == self.rank]

    def dp_devices(self) -> list:
        """One device per dp shard: the first position of each dp row."""
        d = self.devices
        return list(d) if d.ndim == 1 else list(d[:, 0])

    def __repr__(self):
        devs = sorted(set(map(str, self.devices.flat)))
        return f"Mesh({self.shape}, devices={devs}, rank={self.rank})"


def _layout(n: int, ref_shards: int | None, ranks) -> np.ndarray:
    """(dp, ref) grid of indexes into the first n devices: ref_shards
    defaults to 2 when n is even and >= 4, else 1; when the devices span
    ranks, "ref" crosses the ranks and "dp" stays within a rank (a
    multi-rank mesh always shards the index)."""
    if ref_shards is None:
        ref_shards = 2 if n % 2 == 0 and n >= 4 else 1
    dp = n // ref_shards
    if dp * ref_shards != n:
        raise ValueError(f"{n} devices do not form a mesh of {ref_shards} "
                         f"ref shards")
    idx = np.arange(n)
    ranks = np.asarray(ranks)[:n]
    if (ranks != ranks[0]).any():
        if ref_shards == 1:
            ref_shards, dp = dp, 1
        return idx.reshape(ref_shards, dp).T
    return idx.reshape(dp, ref_shards)


def make_mesh(n_devices: int | None = None, ref_shards: int | None = None,
              devices=None, ranks=None) -> Mesh:
    """A (dp, ref) mesh over ``devices`` (default: every CUDA card of the
    process; none raises).  ``ranks``: the rank owning each device (default
    all this process's)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available for the mesh; "
                               "name its devices (devices=['cpu'] * n for "
                               "virtual shards of the CPU)")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = list(devices)
    n = len(devs) if n_devices is None else n_devices
    if not 1 <= n <= len(devs):
        raise ValueError(f"a mesh of {n} devices from a list of {len(devs)}")
    rk = np.full(n, _rank()) if ranks is None else np.asarray(ranks)[:n]
    grid = _layout(n, ref_shards, rk)
    arr = np.empty(grid.shape, dtype=object)
    for ix in np.ndindex(grid.shape):
        arr[ix] = devs[grid[ix]]
    return Mesh(arr, AXES, rk[grid])


# ---------------------------------------------------------------------------
# cross-rank steps (a mesh spanning ranks)
# ---------------------------------------------------------------------------


class PeerFailed(RuntimeError):
    """Another rank of the cooperative run failed; this one stops too."""


#: this process's cross-rank traffic: collectives run and payload bytes
#: (an all-reduce's tensor, an all-gather's gathered result)
COOP_STATS = {"collectives": 0, "bytes": 0}


def _status_round(failed: bool) -> None:
    """Every rank's status, maxed over the group: a rank that failed sends
    1 in place of the step its peers wait in, and every rank that did not
    raises PeerFailed."""
    import torch.distributed as dist
    t = torch.tensor([int(failed)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    if int(t) and not failed:
        raise PeerFailed("another rank of the cooperative run failed")


def signal_failure() -> None:
    """Tell the peers that this rank failed (its next status round)."""
    _status_round(True)


def sync_point() -> None:
    """A status round with nothing after it: the end of a cooperative
    job."""
    _status_round(False)


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of t over the ranks, on t's device (gloo, host copy)."""
    import torch.distributed as dist
    h = t.cpu().clone()
    _status_round(False)
    dist.all_reduce(h)
    COOP_STATS["collectives"] += 1
    COOP_STATS["bytes"] += h.numel() * h.element_size()
    return h.to(t.device)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's t stacked in rank order, on t's device (gloo, host
    copy; t has one shape on every rank)."""
    import torch.distributed as dist
    h = t.cpu().contiguous()
    out = [torch.empty_like(h) for _ in range(dist.get_world_size())]
    _status_round(False)
    dist.all_gather(out, h)
    res = torch.stack(out)
    COOP_STATS["collectives"] += 1
    COOP_STATS["bytes"] += res.numel() * res.element_size()
    return res.to(t.device)


def coop_mesh(device) -> Mesh:
    """The cooperative mesh of a torch.distributed group: one position per
    rank, each on its rank's ``device`` (every rank names its device the
    same way: the launcher gives every rank one environment), "ref" across
    the ranks."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("DAMAPPER_COOP=1 needs a torch.distributed "
                           "process group (parallel.launch --global-index)")
    world = dist.get_world_size()
    return make_mesh(world, devices=[device] * world, ranks=np.arange(world))


# ---------------------------------------------------------------------------
# the multichip validation run
# ---------------------------------------------------------------------------


def _sim_genome(rng, length: int) -> str:
    # draw-identical to "".join(_BASES[i] for i in draws)
    draws = rng.integers(0, 4, size=length)
    return np.frombuffer(_BASES.encode(), dtype="S1")[draws].tobytes() \
        .decode()


def _sim_read(rng, genome: str, min_len=1500, max_len=4000, err=0.15) -> str:
    L = len(genome)
    n = min(int(rng.integers(min_len, max_len + 1)), L - 1)
    start = int(rng.integers(0, L - n))
    frag = genome[start:start + n]
    if rng.integers(0, 2):
        frag = frag.translate(str.maketrans("ACGT", "TGCA"))[::-1]
    out = []
    for ch in frag:
        r = rng.random()
        if r < err:
            e = rng.random()
            if e < 0.55:
                out.append(_BASES[rng.integers(0, 4)])
                out.append(ch)
            elif e < 0.80:
                pass
            else:
                out.append(_BASES[(_BASES.index(ch) + 1
                                   + rng.integers(0, 3)) % 4])
        else:
            out.append(ch)
    return "".join(out)


def dryrun(n_devices: int, devices=None) -> dict:
    """Run the real mapper single-device and on an n-position (dp, ref)
    mesh over ``devices`` (default: every CUDA card; a list naming one
    device n times gives virtual shards) — sharded index, sharded seed
    match, dp-sharded wave lanes — and require record-identical ``.las``.
    Returns {"records": n, "single": LAST_STATS, "mesh": LAST_STATS}."""
    from ..io import db as dbio
    from ..io import fasta
    from ..io import las as lasio
    from ..pipeline import mapper

    rng = np.random.default_rng(12)
    # >=1 Mb genome with a skewed repeat family (a 500 bp unit tiled 60x):
    # large enough to exercise the matcher's emission caps under
    # non-uniform k-mer multiplicities
    glen = 1_000_000
    unit = _sim_genome(rng, 500)
    core = _sim_genome(rng, glen - 60 * 500)
    genome = core[:glen // 3] + unit * 60 + core[glen // 3:]
    entries = [fasta.FastaEntry("ctg0", genome[:glen // 2]),
               fasta.FastaEntry("ctg1", genome[glen // 2:])]
    reads = [_sim_read(rng, genome) for _ in range(100)]

    mesh = make_mesh(n_devices, ref_shards=2 if n_devices % 2 == 0 else 1,
                     devices=devices)
    home = mesh.devices.flat[0]
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        dbio.create_dam(os.path.join(tmp, "ref.dam"), entries, bsize=25_000)
        dbio.create_db(os.path.join(tmp, "reads.db"),
                       [fasta.FastaEntry(f"r{i}", r)
                        for i, r in enumerate(reads)])
        recs = {}
        for name, m in (("single", None), ("mesh", mesh)):
            d = os.path.join(tmp, name)
            os.mkdir(d)
            cfg = mapper.DamapperConfig(device=home, index_backend="device",
                                        mesh=m)
            a, _ = mapper.run_damapper(os.path.join(tmp, "ref.dam"),
                                       os.path.join(tmp, "reads.db"), cfg,
                                       out_dir=d)
            recs[name], _ = lasio.read_las(a)
            out[name] = dict(mapper.LAST_STATS)
        assert len(recs["single"]) > 0, "dryrun produced no alignments"
        assert lasio.las_equal(recs["single"], recs["mesh"]), \
            "multichip .las differs from single-device"
    out["records"] = len(recs["single"])
    return out


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """``dryrun`` on n virtual shards of one device (None: the CUDA card;
    "cpu" for the CPU): the mesh path on a machine with one card."""
    dev = _device(device)
    return dryrun(n_devices, devices=[dev] * n_devices)

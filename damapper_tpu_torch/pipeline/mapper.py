"""End-to-end mapper: the damapper CLI equivalent (reference damapper.c).

Orchestrates: open reads block -> k-mer index -> for each reference block
(forward and complemented): k-mer index + seed match + chain sweep ->
reporter over the full reference, whose wave alignments run on the batched
wave engine (ops.wave_engine, the CUDA kernel on the card) -> sorted .las
output (+ -C dual output, -p repeat profile track).

The index and the seed match run on the device (ops.device_index: one
upload of the reads serves both orientations, the reads' revcomp index is
built once, one forward index per reference block, cached across calls,
and one join matches both orientations) or on the host (ops.kmers,
ops.seeds): ``index_backend``, else DAMAPPER_INDEX, else the device when
the run is on the card and the host when the caller asked for the CPU.
The chain sweep runs on the host (native C++) or on the device
(ops.chain_device): ``chain_backend``, else DAMAPPER_CHAIN, else the host.

On a (dp, ref) device mesh (parallel.mesh; ``mesh``, by default every card
of the process when there is more than one) the device index is sharded:
the reads' indexes over "dp", each reference block's over "ref", two
sharded matches a block (forward, then the reads' revcomp index in the
complement frame), no reference-index cache; the wave engine shards its
lanes over "dp".  A mesh across the ranks of a torch.distributed group
(DAMAPPER_COOP=1, set by ``launch --global-index``) shards the index over
the ranks; every rank runs the same host stages and the wave unsharded,
and rank 0 alone writes the output.

The external LAsort/LAcat/LAmerge post-pass of the reference (damapper.c:
882-911) is replaced by the in-process chain-preserving sort of io.las.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from ..io import db as dbio
from ..io import las as lasio
from ..io.tracks import merge_mask_tracks
from ..ops import device_index as dix
from ..ops.chain import ChainState
from ..ops.kmers import sort_kmers, sort_kmers_partitioned
from ..ops.seeds import match_seeds, match_seeds_multi
from ..ops.spec import new_align_spec
from ..ops.wave_engine import WaveEngine, resolve_device
from ..parallel import mesh as pmesh
from ..utils import spans
from .reporter import Reporter

WAVE_BACKENDS = ("device", "oracle")
BACKENDS = ("host", "device")


def _local_devices(device) -> list:
    """The devices of this process that a mesh may span: every CUDA card
    when the run is on the card, else the one device asked for."""
    import torch
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _auto_mesh(device):
    """The (dp, ref) mesh of a run on ``device`` (None: one device).

    Within a process it spans the process's devices (_local_devices), and
    one device gives none.  Under a torch.distributed group a rank's mesh is
    its own unless DAMAPPER_COOP=1 (set by ``launch --global-index``) asks
    for the cooperative mesh across the ranks (parallel.mesh.coop_mesh),
    whose "ref" axis shards the index over them: in the per-rank mode of
    parallel.launch the ranks map different blocks, and collectives across
    them would deadlock.  A mesh that cannot be built raises (the JAX
    package returns None there)."""
    if os.environ.get("DAMAPPER_COOP") == "1":
        return pmesh.coop_mesh(device)
    devs = _local_devices(device)
    if len(devs) > 1:
        return pmesh.make_mesh(len(devs), devices=devs)
    return None


def _physical_memory() -> int:
    try:
        return os.sysconf("SC_PHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError):
        return 16 << 30


def read_block(path: str, masks: list[str], kmer: int) -> dbio.DazzDB:
    """Open+trim+load a DB/DAM block with mask tracks (read_DB
    damapper.c:345-415)."""
    db = dbio.DazzDB.open(path)
    for m in masks:
        dbio.open_mask_track(db, m)
    db.trim()
    if len(db.tracks) > 1:
        merge_mask_tracks(db)
    if db.cutoff < kmer:
        if (db.reads["rlen"] < kmer).any():
            raise ValueError(
                f"Block {path} contains reads < {kmer}bp long!  Run DBsplit "
                f"-x{kmer}")
    db.load_bases()
    return db


class DamapperConfig:
    """Options of one mapping run.

    device: where the wave engine runs; None means the CUDA card, and with
    no card that is an error unless the caller passes device="cpu".
    wave_backend: "device" (the batched wave engine on ``device``) or
    "oracle" (the host Local_Alignment, one seed at a time).  host_min:
    wave rounds with fewer lanes run on the host oracle.  persistent,
    packops, lanepack (and host_min): the wave engine's mode (None: the
    environment's DAMAPPER_WAVE_PERSISTENT, DAMAPPER_WAVE_PACKOPS,
    DAMAPPER_WAVE_LANEPACK, DAMAPPER_WAVE_HOSTMIN, then the measured mode
    file on its card; see ops.wave_engine.resolve_wave_mode).
    index_backend: "device" (ops.device_index on ``device``) or "host";
    None: DAMAPPER_INDEX, else "device" on the card and "host" on the
    CPU.  chain_backend: "host" or "device"
    (ops.chain_device on ``device``); None: DAMAPPER_CHAIN, else "host".
    mesh: a parallel.mesh.Mesh, None (one device) or "auto" (_auto_mesh,
    resolved by run_damapper)."""

    def __init__(self, kmer=20, suppress=0, mem_limit=None, ave_error=.85,
                 spacing=100, best_tie=1.0, masks=(), verbose=False,
                 profile=False, do_a=True, do_b=False, map_order=True,
                 wave_backend="device", device=None, host_min=None,
                 persistent=None, packops=None, lanepack=None,
                 index_backend=None, chain_backend=None, mesh="auto"):
        self.kmer = kmer
        self.suppress = suppress
        self.mem_limit = _physical_memory() if mem_limit is None else mem_limit
        self.ave_error = ave_error
        self.spacing = spacing
        self.best_tie = best_tie
        self.masks = list(masks)
        self.verbose = verbose
        self.profile = profile
        self.do_a = do_a
        self.do_b = do_b
        self.map_order = map_order
        if wave_backend not in WAVE_BACKENDS:
            raise ValueError(f"wave_backend must be one of {WAVE_BACKENDS}, "
                             f"got {wave_backend!r}")
        self.wave_backend = wave_backend
        self.device = resolve_device(device)
        self.host_min = host_min
        self.wave_mode = dict(persistent=persistent, packops=packops,
                              lanepack=lanepack)
        self.index_backend = _backend(
            "index_backend", index_backend, "DAMAPPER_INDEX",
            "device" if self.device.type == "cuda" else "host")
        self.chain_backend = _backend("chain_backend", chain_backend,
                                      "DAMAPPER_CHAIN", "host")
        if self.index_backend == "device":
            dix._join_mode()    # an unknown DAMAPPER_JOIN raises here
        self.mesh = mesh


def _backend(name, arg, env, default) -> str:
    """A backend choice: the argument, else the environment, else the
    default; "host" or "device"."""
    val = arg or os.environ.get(env) or default
    if val not in BACKENDS:
        raise ValueError(f"{name} must be one of {BACKENDS}, got {val!r}")
    return val


# Device-resident reference-index cache across run_damapper calls: mapping
# many read blocks against one reference (the reference's per-block HPC job
# layout) rebuilds the SAME ref-block index each call.  Keyed on the block
# (stub path, block number), the mtime AND size of every file the index
# depends on (stub, .bps, each mask track's files), k, -t, the masks and
# the device.  Bounded by payload bytes: DAMAPPER_REFCACHE_MB (default
# 2600), DAMAPPER_REFCACHE=0 turns it off.
_ref_index_cache: dict = {}
_ref_index_cache_bytes = [0]


def _refcache_on() -> bool:
    return os.environ.get("DAMAPPER_REFCACHE", "1") != "0"


def _ref_cache_get(key):
    if not _refcache_on():
        return None
    ent = _ref_index_cache.get(key)
    if ent is not None:
        _ref_index_cache[key] = _ref_index_cache.pop(key)  # LRU touch
        return ent[0]
    return None


def _ref_cache_put(key, aindex):
    if not _refcache_on():
        return
    nbytes = sum(t.numel() * t.element_size() for t in
                 (aindex.key, aindex.pos, aindex.boffs, aindex.rlens))
    budget = int(os.environ.get("DAMAPPER_REFCACHE_MB", "2600")) << 20
    if nbytes > budget:
        return
    while _ref_index_cache and _ref_index_cache_bytes[0] + nbytes > budget:
        oldest = next(iter(_ref_index_cache))     # LRU: insertion-ordered
        _, old_bytes = _ref_index_cache.pop(oldest)
        _ref_index_cache_bytes[0] -= old_bytes
    _ref_index_cache[key] = (aindex, nbytes)
    _ref_index_cache_bytes[0] += nbytes


def _file_id(path):
    """(mtime, size) of a file, (-1.0, -1) when it is missing."""
    try:
        st = os.stat(path)
    except FileNotFoundError:
        return (-1.0, -1)
    return (st.st_mtime, st.st_size)


def _ref_cache_key(pwd, aroot_stub, stubp, k, cfg):
    """The cache key of reference block k: block paths are virtual (the
    stub and .idx encode the blocks), so the stub's identity and the block
    number, plus every file the index reads."""
    deps = [_file_id(stubp),
            _file_id(os.path.join(pwd, "." + aroot_stub + ".bps"))]
    for m in cfg.masks:
        deps += [_file_id(p) for p in dbio.track_paths(
            os.path.join(pwd, "." + aroot_stub), k, m)]
    return (os.path.abspath(stubp), tuple(deps), k, cfg.kmer, cfg.suppress,
            tuple(cfg.masks), str(cfg.device))


#: the stage seconds of LAST_STATS["times"], each the sum of its spans
STAGE_SPANS = {"load": ("load.reads", "load.ref", "load.full"),
               "index": ("index",), "match": ("match",), "chain": ("chain",),
               "align": ("reporter",)}


def _stage_seconds(seconds) -> dict:
    return {k: sum(seconds(n) for n in names)
            for k, names in STAGE_SPANS.items()}


def run_damapper(ref_path: str, reads_path: str, cfg: DamapperConfig,
                 out_dir: str = "."):
    """Map one reads DB/block against a reference DAM.  Returns
    (a_las_path, b_las_path or None).

    The call is the span "block" and its stages are spans inside it
    (utils.spans): LAST_STATS holds their totals ("spans": {name: {"s",
    "self_s", "n"}}), the call's counters ("counts") and the stage seconds
    ("times", sums of STAGE_SPANS), beside the run's telemetry."""
    global LAST_STATS
    spans.begin_call()
    with spans.span("block"):
        paths, stats = _map_block(ref_path, reads_path, cfg, out_dir)
    tot = spans.end_call()
    LAST_STATS = dict(times=_stage_seconds(
        lambda n: tot["spans"].get(n, {"s": 0.})["s"]), **stats, **tot)
    return paths


def _map_block(ref_path, reads_path, cfg, out_dir):
    """run_damapper's body: (paths, the run's telemetry)."""
    pwd, aroot, isdam = dbio._split_db_path(ref_path)
    aroot_stub, _ = dbio._strip_part(aroot)
    stubp = os.path.join(pwd, aroot_stub + (".dam" if isdam else ".db"))
    if not os.path.exists(stubp):
        other = os.path.join(pwd, aroot_stub + (".db" if isdam else ".dam"))
        if os.path.exists(other):
            stubp = other
        else:
            raise FileNotFoundError(f"Could not open database {ref_path}")
    stub = dbio.read_stub(stubp)
    nblocks = stub.nblocks
    if nblocks == 0:
        raise ValueError(f"DB {aroot_stub} has not been partitioned")

    # base frequencies come from the reference .idx header (damapper.c:788-796)
    with open(os.path.join(pwd, "." + aroot_stub + ".idx"), "rb") as fp:
        hdr = np.frombuffer(fp.read(dbio.HEADER_DTYPE.itemsize),
                            dbio.HEADER_DTYPE)[0]
    spec = new_align_spec(cfg.ave_error, cfg.spacing, np.array(hdr["freq"]),
                          reach=True)

    _, broot, _ = dbio._split_db_path(reads_path)

    mesh = _auto_mesh(cfg.device) if cfg.mesh == "auto" else cfg.mesh
    # a mesh across ranks is the cooperative mode: every rank runs the same
    # host stages, the reference index is sharded over the ranks, and only
    # rank 0 writes the output files
    multiproc = mesh is not None and dix._mesh_is_multiprocess(mesh)
    use_device_index = cfg.index_backend == "device"
    # the index's device work is asynchronous: its span ends in a
    # synchronize on the card, so the match is not charged for it
    on_card = cfg.device.type == "cuda"
    # dp x ref sharded matching: the reads' indexes sharded over "dp", each
    # reference block's index over "ref"
    sharded_ix = (use_device_index and mesh is not None
                  and "ref" in mesh.axis_names)
    with spans.span("load.reads"):
        reads_db = read_block(reads_path, cfg.masks, cfg.kmer)
    with spans.span("index", sync=on_card):
        if use_device_index:
            # one upload serves both orientations; the reads' revcomp
            # index, built once, lets both orientations match against a
            # single forward reference index per block (hits stay
            # identical by emission-time frame mirroring)
            reads_seq_dev = dix.device_upload_seq(reads_db, cfg.device)
            bindex = dix.device_sort_kmers(reads_db, cfg.kmer, cfg.suppress,
                                           seq_dev=reads_seq_dev)
            bindex_rc = dix.device_sort_kmers(reads_db, cfg.kmer,
                                              cfg.suppress, comp=True,
                                              seq_dev=reads_seq_dev)
            del reads_seq_dev
            if sharded_ix:
                bindex = dix.shard_index(bindex, mesh, "dp")
                bindex_rc = dix.shard_index(bindex_rc, mesh, "dp")
        else:
            bindex = sort_kmers(reads_db, cfg.kmer, cfg.suppress)
    if cfg.verbose:
        # stage counters mirroring the reference -v (map.c:692-697,792-799)
        print(f"\n   Kmer count = {len(bindex):,}\n"
              f"   Index occupies {len(bindex) / 67108864:.2f}Gb "
              f"({broot})", file=sys.stderr)

    state = ChainState(reads_db.nreads, cfg.kmer, profile=cfg.profile,
                       rlens=reads_db.reads["rlen"], spacing=cfg.spacing,
                       device=cfg.device)

    # ref-index builds recycle their buffers: each aindex is dead once its
    # hits are chained, so the next build reuses the warm pages
    kscratch: dict = {}
    cache_hits = cache_builds = 0
    rkey = cached = None
    for k in range(1, nblocks + 1):
        blk_path = os.path.join(pwd, f"{aroot_stub}.{k}"
                                + (".dam" if isdam else ".db"))
        with spans.span("load.ref"):
            ref_blk = read_block(blk_path, cfg.masks, cfg.kmer)
        bstart = ref_blk.tfirst

        # sub-partition large blocks so each index sort stays cache-resident
        # (bit-exact: merged per-code counts keep block-level -M/MAXGRAM
        # semantics; disabled under -t, whose culling is per-block index)
        sub_bases = int(os.environ.get("DAMAPPER_SUBBLOCK", 24_000_000))
        use_sub = (sub_bases > 0 and cfg.suppress == 0
                   and ref_blk.totlen > 2 * sub_bases)

        if use_device_index and not sharded_ix:
            # the sharded index is bound to its mesh: no cache there
            rkey = _ref_cache_key(pwd, aroot_stub, stubp, k, cfg)
            cached = _ref_cache_get(rkey)
        for comp in (0, 1):
            if comp and not use_device_index:
                ref_blk.complement_inplace()
            db_bytes = reads_db.sizeof() + ref_blk.sizeof()
            with spans.span("index", sync=on_card):
                if not use_device_index:
                    if use_sub:
                        subs = sort_kmers_partitioned(ref_blk, cfg.kmer,
                                                      sub_bases, kscratch)
                        aindex = None
                    else:
                        aindex = sort_kmers(ref_blk, cfg.kmer, cfg.suppress,
                                            scratch=kscratch)
                elif comp == 0:
                    # one forward index per block serves both orientations:
                    # the reads' revcomp index provides the complement pass
                    # (damapper.c:851-861 without the second Sort_Kmers)
                    if cached is not None:
                        cache_hits += 1
                        aindex = cached
                    else:
                        cache_builds += 1
                        aindex = dix.device_sort_kmers(
                            ref_blk, cfg.kmer, cfg.suppress,
                            device=cfg.device)
                        if sharded_ix:
                            aindex = dix.shard_index(aindex, mesh, "ref")
                        else:
                            _ref_cache_put(rkey, aindex)
            with spans.span("match"):
                if sharded_ix:
                    # two sharded matches a block: the reads' forward
                    # index, then their revcomp index in the complement
                    # frame against the same forward reference index
                    hits = dix.device_match_seeds_sharded(
                        bindex_rc if comp else bindex, aindex, mesh,
                        cfg.mem_limit, db_bytes, comp_frame=bool(comp))
                elif use_device_index and comp == 0:
                    # one combined join serves both orientations; the comp
                    # hits wait for the comp pass of the loop
                    hits, pending_cmp = dix.device_match_seeds_pair(
                        bindex, bindex_rc, aindex, cfg.mem_limit, db_bytes)
                elif use_device_index:
                    hits = pending_cmp
                elif use_sub:
                    hits = match_seeds_multi(bindex, subs, cfg.mem_limit,
                                             db_bytes)
                else:
                    hits = match_seeds(bindex, aindex, cfg.mem_limit,
                                       db_bytes)
            if cfg.verbose:
                nidx = (sum(len(i) for i, _ in subs) if aindex is None
                        else len(aindex))
                print(f"   Block {k} comp={comp}: index = {nidx:,} "
                      f"kmers, hit count = {len(hits):,}", file=sys.stderr)
            before = state.ncands() if cfg.verbose else 0
            with spans.span("chain"):
                state.process_hits(hits, bstart, comp,
                                   device=cfg.chain_backend == "device")
            if cfg.verbose:
                # candidate counters (map.c:3184-3208 epilogue)
                tfilt = state.ncands()
                atot = max(1, reads_db.totlen)
                btot = max(1, ref_blk.totlen)
                print(f"     {len(hits):,} {cfg.kmer}-mers "
                      f"({len(hits) / atot / btot:e} of matrix)\n"
                      f"     {tfilt - before:,} candidates added\n"
                      f"     {tfilt:,} candidates "
                      f"({tfilt / atot / btot:e} of matrix)",
                      file=sys.stderr)
        # the block's buffers die here, before the next block's build (a
        # cached index stays resident for the next call)
        aindex = cached = hits = pending_cmp = None
    # the reads' indexes are dead before the align stage's uploads
    bindex = bindex_rc = None
    with spans.span("chain"):
        state.finish()

    if nblocks == 1:
        # block 1 IS the full DB: un-complement it (the host orientation
        # loop left it reversed; the device comp index never touches the
        # host copy) instead of re-decoding the .bps
        if not use_device_index:
            ref_blk.complement_inplace()
        ref_full = ref_blk
    else:
        with spans.span("load.full"):
            ref_full = read_block(os.path.join(
                pwd, aroot_stub + (".dam" if isdam else ".db")), [],
                cfg.kmer)

    engine = None
    if cfg.wave_backend == "device":
        # on a mesh across ranks the wave stays on each rank's device: the
        # host stages are replicated, so every rank holds the same lanes
        # and needs all their results
        engine = WaveEngine(spec, device=cfg.device, host_min=cfg.host_min,
                            mesh=None if multiproc else mesh,
                            **cfg.wave_mode)
    rep = Reporter(spec, cfg.kmer, cfg.spacing, cfg.best_tie,
                   do_a=cfg.do_a, do_b=cfg.do_b, engine=engine)
    profile_out = [] if cfg.profile else None
    with spans.span("reporter"):
        a_recs, b_recs = rep.run(reads_db, ref_full, state,
                                 astart=reads_db.tfirst,
                                 profile_out=profile_out)
    if engine is not None:
        spans.count("engine.launches", sum(engine.launches.values()))
    if cfg.verbose:
        print(f"      {len(a_recs):,} mapped segments", file=sys.stderr)
        print("      stage seconds: " + "  ".join(
            f"{k}={v:.2f}" for k, v in _stage_seconds(spans.seconds).items()),
            file=sys.stderr)
        print(f"      index {cfg.index_backend} (DAMAPPER_INDEX), chain "
              f"{cfg.chain_backend} (DAMAPPER_CHAIN), join "
              f"{dix._join_mode()} (DAMAPPER_JOIN), upload "
              f"{'packed' if dix.packed_upload_on() else 'plain'} "
              f"(DAMAPPER_PACK_UPLOAD), mesh {mesh}", file=sys.stderr)
        if engine is not None:
            # wave-engine telemetry: a silent drift to the host-oracle
            # fallback would destroy device perf while keeping output
            # identical
            ndev = engine.n_total - engine.n_fallback - engine.n_hostmin
            print(f"      wave mode {engine.mode} from {engine.mode_source} "
                  f"(W={engine.W}); lanes: "
                  f"{engine.n_total:,} total, {ndev:,} device, "
                  f"{engine.n_winmiss:,} retried on the classic kernel, "
                  f"{engine.n_fallback:,} overflow-fallback, "
                  f"{engine.n_hostmin:,} tiny-round host", file=sys.stderr)

    # cooperative mode: every rank computed the same records; rank 0's copy
    # is the output, the other ranks skip the (racy) file writes
    rank0 = not multiproc or mesh.rank == 0
    a_path = b_path = None
    with spans.span("write"):
        if cfg.do_a:
            a_recs = lasio.sort_las(a_recs, cfg.map_order)
            a_path = os.path.join(out_dir, f"{broot}.{aroot}.las")
            if rank0:
                lasio.write_las(a_path, a_recs, cfg.spacing)
        if cfg.do_b:
            b_recs = lasio.sort_las(b_recs, cfg.map_order)
            b_path = os.path.join(out_dir, f"{aroot}.{broot}.las")
            if rank0:
                lasio.write_las(b_path, b_recs, cfg.spacing)

        if cfg.profile and rank0:
            anno = np.zeros(reads_db.nreads + 1, np.int64)
            data = bytearray()
            for i, logv in enumerate(profile_out):
                anno[i] = len(data)
                data += logv.tobytes()
            anno[reads_db.nreads] = len(data)
            dbio.write_track(os.path.join(out_dir, "." + broot), "prof",
                             anno, bytes(data), size=8)

    # run telemetry for benchmarks: the keys are the JAX package's (its
    # cell_updates is total_waves x band_cap), plus the tiny-round host
    # lanes and the summed kernel time (CUDA events; 0 off the card), the
    # wave mode and the launches of each kernel
    stats = dict(index_backend=cfg.index_backend,
                 chain_backend=cfg.chain_backend,
                 mesh=None if mesh is None else mesh.shape,
                 ref_index_cache_hits=cache_hits,
                 ref_index_builds=cache_builds,
                 total_waves=getattr(engine, "total_waves", 0),
                 band_cap=getattr(engine, "W", 0),
                 n_fallback=getattr(engine, "n_fallback", 0),
                 n_winmiss=getattr(engine, "n_winmiss", 0),
                 wave_mode=getattr(engine, "mode", "oracle"),
                 # where the mode came from: arg, env, file, default
                 wave_mode_source=getattr(engine, "mode_source", None),
                 kernel_launches=dict(getattr(engine, "launches", {})),
                 n_lanes=getattr(engine, "n_total", 0),
                 n_hostmin=getattr(engine, "n_hostmin", 0),
                 kernel_ms=getattr(engine, "kernel_ms", 0.),
                 # align-stage split: device kernel+pull wall vs the host
                 # side (trace extraction, refinement, fallback)
                 align_device_s=getattr(engine, "t_run", 0.),
                 align_host_s=max(0., getattr(engine, "t_batch", 0.)
                                  - getattr(engine, "t_run", 0.)),
                 # the engine's host seconds by step (HOST_STEPS)
                 align_host_split=dict(getattr(engine, "host_s", {})))
    return (a_path, b_path), stats


LAST_STATS: dict = {}


def expand_db_block_arg(arg: str) -> list[str]:
    """'@' block-range expansion of a DB/DAM argument (Parse_Block_DB_Arg
    DB.c:2822-2923): 'root.@' covers every block, 'root.@f' blocks f..n,
    'root.@f-l' the explicit range; a plain name passes through."""
    import re

    m = re.search(r"@(\d+)?(?:-(\d+))?$", arg)
    if not m:
        return [arg]
    if arg.count("@") > 1:
        raise ValueError(f"Two or more occurrences of @-sign in source "
                         f"name '{arg}'")
    base = arg[:m.start()].rstrip(".")
    first = int(m.group(1)) if m.group(1) else 1
    last = int(m.group(2)) if m.group(2) else None
    if first < 1:
        raise ValueError(f"Integer following @-sign is less than 1 in "
                         f"source name '{arg}'")
    if last is not None and last < first:
        raise ValueError(f"2nd integer is less than 1st integer in source "
                         f"name '{arg}'")
    if last is None:
        pwd, root, isdam = dbio._split_db_path(base)
        stubp = os.path.join(pwd, root + (".dam" if isdam else ".db"))
        if not os.path.exists(stubp):
            other = os.path.join(pwd, root + (".db" if isdam else ".dam"))
            if os.path.exists(other):
                stubp = other
            else:
                raise FileNotFoundError(
                    f"Cannot open database {root}[db|dam]")
        last = max(1, dbio.read_stub(stubp).nblocks)
    return [f"{base}.{k}" for k in range(first, last + 1)]


def main_damapper(argv: list[str]) -> int:
    """CLI with the reference's flag surface (damapper.c:53-56).  The run
    is on the CUDA card; DAMAPPER_DEVICE=cpu runs it on the CPU.  The
    DAMAPPER_WAVE_{PERSISTENT,PACKOPS,LANEPACK} switches pick the wave mode
    (ops.wave_engine), DAMAPPER_INDEX and DAMAPPER_CHAIN the index and
    chain backends (DamapperConfig), DAMAPPER_JOIN the device join and
    DAMAPPER_PACK_UPLOAD=1 the 2-bit packed sequence upload
    (ops.device_index)."""
    kw = dict()
    args = []
    flags = set()
    masks = []
    ignored = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a.startswith("-") and len(a) > 1 and not a[1].isdigit():
            c = a[1]
            if c in "vpzCN":
                # combined flag group: every character must be a legal flag
                # (ARG_FLAGS DB.h:88-99 errors on the first bad one)
                for ch in a[1:]:
                    if ch not in "vpzCN":
                        print(f"damapper: -{ch} is an illegal option",
                              file=sys.stderr)
                        return 1
                    flags.add(ch)
            elif c == "k":
                kw["kmer"] = int(a[2:])
            elif c == "t":
                kw["suppress"] = int(a[2:])
            elif c == "M":
                kw["mem_limit"] = int(a[2:]) << 30
            elif c == "e":
                kw["ave_error"] = float(a[2:])
            elif c == "s":
                kw["spacing"] = int(a[2:])
            elif c == "n":
                kw["best_tie"] = float(a[2:])
            elif c == "m":
                masks.append(a[2:])
            elif c in ("T", "P"):
                ignored.append(a)   # thread count / tmp dir
            else:
                print(f"damapper: -{c} is an illegal option", file=sys.stderr)
                return 1
        else:
            args.append(a)
        i += 1

    if len(args) < 2:
        print("Usage: damapper [-vpzCN] [-k<int>] [-t<int>] [-M<int>] "
              "[-e<double>] [-s<int>] [-n<double>] [-m<track>]+ "
              "<reference:dam> <reads:db> ...", file=sys.stderr)
        return 1

    cover = "C" in flags
    nomap = "N" in flags
    if nomap and not cover:
        print("damapper: Cannot specify N flag without C also",
              file=sys.stderr)
        return 1
    if nomap and "p" in flags:
        print("damapper: Cannot specify both N and p flags together",
              file=sys.stderr)
        return 1
    if ignored and "v" in flags:
        print(f"damapper: {' '.join(ignored)} accepted and ignored (this "
              f"engine has no thread count and writes no temporary files)",
              file=sys.stderr)

    cfg = DamapperConfig(masks=masks, verbose="v" in flags,
                         profile="p" in flags, do_a=not nomap, do_b=cover,
                         map_order="z" not in flags,
                         device=os.environ.get("DAMAPPER_DEVICE") or None,
                         **kw)
    if not (.7 <= cfg.ave_error < 1.):
        print("damapper: Average correlation must be in [.7,1.)",
              file=sys.stderr)
        return 1
    if cfg.kmer > 32:
        print("damapper: K-mer length must be 32 or less", file=sys.stderr)
        return 1
    if not (.7 <= cfg.best_tie <= 1.):
        print("damapper: Near optimal threshold must be in [.7,1.]",
              file=sys.stderr)
        return 1

    for arg in args[1:]:
        for reads in expand_db_block_arg(arg):
            run_damapper(args[0], reads, cfg)
    return 0

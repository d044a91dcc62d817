"""Benchmark: reads mapped a second by damapper_tpu_torch on the CUDA card.

    python -m damapper_tpu_torch.bench

The counterpart, without jax, of the repository's bench.py: the same
simulated PacBio dataset (byte for byte, from the same knobs), the same
timed runs (best of BENCH_REPEATS, every repeat with cold reference-index
and reference-upload caches, LAST_STATS summed over the read blocks) and
the same variants (-n.95 -C and -p, one repeat each).  It prints ONE JSON
line, the last of its output:

  {"metric": ..., "value": reads/s, "unit": "reads/s", "vs_baseline": null,
   "seconds_samples": [...], "stage_seconds": {...}, "wave_lanes": ...,
   "cell_updates_per_sec": ..., "kernel_launches": {...}, "gate": ...,
   "las_identical": bool, "variants": {"n95_C": {...}, "profile": {...}},
   "device": nvidia-smi's name and power limit, "wave_mode_source": ...,
   "align_host_split": {...}, "wave_mode_file": ...,
   "wave_build_status": {...}, ...}

wave_mode_file is the measured mode file in force on this card (None where
none applies) and wave_build_status each wave mode's build-gate status
(tools/wave_build_status.json, written by tools/wave_build_gate.py), so a
record says which mode ran, where the mode came from, and which modes the
gate found broken.

No C reference is run (neither machine of this project has it), so
vs_baseline is null and the identity gate compares the port with itself,
at one of two levels (BENCH_GATE), in an untimed run after the timed ones:

  oracle  (default) the records equal those of a run with the host index
          and the host oracle wave (index_backend="host",
          wave_backend="oracle"): every lane re-aligned on the host;
  sample  the records equal those of a run with the host index and the
          device wave, and in that run a --seed-drawn 1 lane in 50 of every
          device round is re-aligned by the host oracle and must match path
          and trace (for sizes where the oracle of every lane would take
          hours).

-C gates both .las files, -p also the .prof.anno and .prof.data bytes.

Env knobs, as bench.py's: BENCH_GLEN (genome bp, default 140_000_000),
BENCH_NREADS (1000), BENCH_SEED (42), BENCH_BSIZE (reference block size,
260_000_000), BENCH_RBSIZE (reads block size; 0: one block), BENCH_REPEATS
(2), BENCH_VARIANTS ("1" all, "0" none, or a comma list of n95_C,
profile); and BENCH_GATE (oracle | sample), BENCH_DATA (the datasets'
directory, default build/bench/ beside the package).  The run is on the
CUDA card; DAMAPPER_DEVICE=cpu runs it on the CPU (plain PyTorch wave),
and with neither the line carries "error" and the exit code is 1, as it is
when a run raises or a gate fails.
"""

from __future__ import annotations

import os

# before numpy loads: its MADV_HUGEPAGE hint makes cold big-buffer faults
# much slower under synchronous-compaction THP defrag (bench.py does the
# same)
os.environ.setdefault("NUMPY_MADVISE_HUGEPAGE", "0")

import copy  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
import traceback  # noqa: E402

import numpy as np  # noqa: E402

PKG = pathlib.Path(__file__).resolve().parent
GATES = ("oracle", "sample")
# the share of each device round's lanes the sample gate re-aligns
SAMPLE_EVERY = 50
VARIANT_KW = {"n95_C": dict(best_tie=.95, do_b=True),
              "profile": dict(profile=True)}


@dataclasses.dataclass(frozen=True)
class Knobs:
    glen: int = 140_000_000
    nreads: int = 1000
    seed: int = 42
    bsize: int = 260_000_000
    rbsize: int = 0
    repeats: int = 2
    variants: tuple = ("n95_C", "profile")
    gate: str = "oracle"
    data: pathlib.Path = PKG.parent / "build" / "bench"

    @classmethod
    def from_env(cls, env=None) -> "Knobs":
        env = os.environ if env is None else env
        v = env.get("BENCH_VARIANTS", "1")
        variants = (() if v == "0" else tuple(VARIANT_KW) if v == "1"
                    else tuple(n for n in VARIANT_KW
                               if n in {x.strip() for x in v.split(",")}))
        gate = env.get("BENCH_GATE", "oracle")
        if gate not in GATES:
            raise ValueError(f"BENCH_GATE must be one of {GATES}, "
                             f"got {gate!r}")
        d = cls()
        return cls(glen=int(env.get("BENCH_GLEN", d.glen)),
                   nreads=int(env.get("BENCH_NREADS", d.nreads)),
                   seed=int(env.get("BENCH_SEED", d.seed)),
                   bsize=int(env.get("BENCH_BSIZE", d.bsize)),
                   rbsize=int(env.get("BENCH_RBSIZE", d.rbsize)),
                   repeats=int(env.get("BENCH_REPEATS", d.repeats)),
                   variants=variants, gate=gate,
                   data=pathlib.Path(env.get("BENCH_DATA", d.data)))

    def work(self) -> pathlib.Path:
        """The dataset's directory, named as bench.py names its own."""
        return self.data / (
            f"ds_{self.seed}_{self.glen}_{self.nreads}"
            + (f"_b{self.bsize}" if self.bsize != 260_000_000 else "")
            + (f"_r{self.rbsize}" if self.rbsize else ""))


def build_dataset(work: pathlib.Path, k: Knobs):
    """bench.py's dataset, drawn by utils.sim from the same generator: the
    same .dam/.db files and hidden .idx/.bps files, byte for byte."""
    from .io import db as dbio
    from .io import fasta
    from .utils.sim import sim_genome, sim_read

    work.mkdir(parents=True, exist_ok=True)
    marker = work / f"ds_{k.seed}_{k.glen}_{k.nreads}_{k.bsize}_{k.rbsize}.ok"
    if marker.exists():
        return
    rng = np.random.default_rng(k.seed)
    genome = sim_genome(rng, k.glen)
    ncontigs = max(2, k.glen // 500_000)
    clen = k.glen // ncontigs
    entries = [fasta.FastaEntry(f"ctg{i}", genome[i * clen:(i + 1) * clen])
               for i in range(ncontigs)]
    reads = []
    for _ in range(k.nreads):
        ci = int(rng.integers(0, ncontigs))
        r, *_ = sim_read(rng, entries[ci].seq, min_len=3000, max_len=9000)
        reads.append(r)
    dbio.create_dam(str(work / "ref.dam"), entries, bsize=k.bsize)
    dbio.create_db(str(work / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)],
                   **({"bsize": k.rbsize} if k.rbsize else {}))
    marker.write_text("ok")


def _reads_blocks(work, k: Knobs):
    """Reads-DB block names: ["reads"] single-block, else reads.1..N."""
    from .io import db as dbio
    stub = dbio.read_stub(str(work / "reads.db"))
    if not k.rbsize or stub.nblocks <= 1:
        return ["reads"]
    return [f"reads.{i}" for i in range(1, stub.nblocks + 1)]


def _sync(dev):
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()


def _cold_caches():
    """Empty the reference-index cache and the reference-upload cache: each
    repeat pays for its index builds and uploads, as the C reference
    re-sorts its k-mers per invocation."""
    from .pipeline import mapper, reporter
    mapper._ref_index_cache.clear()
    mapper._ref_index_cache_bytes[0] = 0
    reporter._ref_seq_cache.clear()


SUMMED = ("n_lanes", "total_waves", "n_fallback",
          "n_winmiss", "n_hostmin", "ref_index_cache_hits",
          "ref_index_builds", "kernel_ms", "align_device_s", "align_host_s")


def _map_blocks(work, blocks, cfg, out):
    """Map every read block; returns ([(a_path, b_path)], LAST_STATS summed
    over the blocks)."""
    from .pipeline import mapper
    outs, tot = [], None
    for b in blocks:
        outs.append(mapper.run_damapper(str(work / "ref.dam"),
                                        str(work / b), cfg,
                                        out_dir=str(out)))
        st = mapper.LAST_STATS
        if tot is None:
            tot = dict(times=dict(st["times"]), wave_mode=st["wave_mode"],
                       band_cap=st["band_cap"],
                       wave_mode_source=st["wave_mode_source"],
                       kernel_launches=dict(st["kernel_launches"]),
                       align_host_split=dict(st["align_host_split"]),
                       **{f: st[f] for f in SUMMED})
            continue
        for f, v in st["times"].items():
            tot["times"][f] += v
        for f, v in st["align_host_split"].items():
            tot["align_host_split"][f] += v
        for f, v in st["kernel_launches"].items():
            tot["kernel_launches"][f] = tot["kernel_launches"].get(f, 0) + v
        for f in SUMMED:
            tot[f] += st[f]
    return outs, tot


def time_ours(work, k: Knobs, dev, cfg_kw=None, repeats=None,
              subdir="torch_ours"):
    """Best of ``repeats`` timed runs over every read block, each with cold
    caches and ending in a synchronize.  Returns (best seconds, the best
    repeat's [(a_path, b_path)], its summed stats with "samples" and
    "builds_samples", the seconds and reference-index builds of every
    repeat)."""
    from .pipeline import mapper
    cfg = mapper.DamapperConfig(device=dev, **(cfg_kw or {}))
    out = work / subdir
    out.mkdir(exist_ok=True)
    blocks = _reads_blocks(work, k)
    best = stats = outs = None
    samples, builds = [], []
    for _ in range(max(1, k.repeats if repeats is None else repeats)):
        _cold_caches()
        _sync(dev)
        t0 = time.perf_counter()
        got, st = _map_blocks(work, blocks, cfg, out)
        _sync(dev)
        dt = time.perf_counter() - t0
        samples.append(round(dt, 3))
        builds.append(st["ref_index_builds"])
        if best is None or dt < best:
            best, stats, outs = dt, st, got
    stats["samples"] = samples
    stats["builds_samples"] = builds
    return best, outs, stats


def las_identical(want, got) -> bool:
    """Both runs' [(a_path, b_path)] hold the same records, block by block
    and file by file (the B file where -C wrote one)."""
    from .io import las as lasio
    if len(want) != len(got):
        return False
    for w, g in zip(want, got):
        for wp, gp in zip(w, g):
            if (wp is None) != (gp is None):
                return False
            if wp is None:
                continue
            (wr, wt), (gr, gt) = (lasio.read_las(str(x)) for x in (wp, gp))
            if wt != gt or not lasio.las_equal(wr, gr):
                return False
    return True


def profile_identical(want_dir, got_dir, blocks) -> bool:
    """The -p track's bytes of every block equal in both directories."""
    return all((want_dir / f".{b}{ext}").read_bytes()
               == (got_dir / f".{b}{ext}").read_bytes()
               for b in blocks for ext in (".prof.anno", ".prof.data"))


def _sample_lanes(seed):
    """A recorder of WaveEngine rounds: for every device round (at least
    host_min lanes) a seed-drawn ceil(n / SAMPLE_EVERY) of its lanes are
    kept, seed and result copied (the reporter fuses paths in place).
    Returns (WaveEngine._batch_inner, the recording one that stands in for
    it, the kept lanes)."""
    from .ops import wave_engine
    orig = wave_engine.WaveEngine._batch_inner
    rng = np.random.default_rng(seed)
    kept = []

    def recording(self, Adev, Bdev, Anp, Bnp, seeds):
        res = orig(self, Adev, Bdev, Anp, Bnp, seeds)
        n = len(seeds)
        if n >= self.host_min:
            for i in rng.choice(n, size=math.ceil(n / SAMPLE_EVERY),
                                replace=False):
                kept.append((self.spec, Anp, Bnp, dict(seeds[int(i)]),
                             copy.deepcopy(res[int(i)])))
        return res

    return orig, recording, kept


def gate_run(work, k: Knobs, dev, cfg_kw, subdir):
    """The untimed run the timed one is held to (BENCH_GATE).  Returns
    ([(a_path, b_path)], its directory, the sample gate's (lanes, lanes
    that differ from the oracle) or None)."""
    from .ops import wave as host_wave
    from .ops import wave_engine
    from .pipeline import mapper
    from .tools.wave_replay import first_difference
    kw = dict(index_backend="host", **(cfg_kw or {}))
    if k.gate == "oracle":
        kw["wave_backend"] = "oracle"
    out = work / subdir
    out.mkdir(exist_ok=True)
    _cold_caches()
    cfg = mapper.DamapperConfig(device=dev, **kw)
    if k.gate == "oracle":
        outs, _ = _map_blocks(work, _reads_blocks(work, k), cfg, out)
        return outs, out, None
    orig, recording, kept = _sample_lanes(k.seed)
    wave_engine.WaveEngine._batch_inner = recording
    try:
        outs, _ = _map_blocks(work, _reads_blocks(work, k), cfg, out)
    finally:
        wave_engine.WaveEngine._batch_inner = orig
    differ = 0
    for spec, A, B, s, got in kept:
        want = host_wave.local_alignment(
            A[s["abase"]:s["abase"] + s["alen"]],
            B[s["bbase"]:s["bbase"] + s["blen"]], spec, int(s["diag"]),
            int(s["diag"]), int(s["anti"]), -1, -1, int(s["flags"]))
        fld = first_difference(want, got)
        if fld is not None:
            differ += 1
            print(f"sample gate: lane differs from the oracle in {fld}: "
                  f"seed {s}", file=sys.stderr)
    return outs, out, (len(kept), differ)


def _gate(work, k, dev, cfg_kw, subdir, outs, rec):
    """Run the gate for one timed run's outputs and write its verdict into
    ``rec``; returns whether it passed."""
    t0 = time.perf_counter()
    want, want_dir, sample = gate_run(work, k, dev, cfg_kw, subdir + "_gate")
    rec["las_identical"] = las_identical(want, outs)
    ok = rec["las_identical"]
    if (cfg_kw or {}).get("profile"):
        rec["profile_track_identical"] = profile_identical(
            want_dir, work / subdir, _reads_blocks(work, k))
        ok = ok and rec["profile_track_identical"]
    if sample is not None:
        rec["oracle_sample"] = {"lanes": sample[0], "differ": sample[1]}
        ok = ok and sample[0] > 0 and sample[1] == 0
    rec["gate_seconds"] = round(time.perf_counter() - t0, 3)
    return ok


def build_libraries(dev) -> float:
    """Build and load, before any timed run, every library a run may call:
    the wave kernels (nvcc) on the card, the native host libraries (g++)
    everywhere.  Returns the seconds it took."""
    from . import native
    t0 = time.perf_counter()
    native.chain_lib()
    native.kmer_lib()
    native.radix_lib()
    native.trace_lib()
    if dev.type == "cuda":
        import torch
        from .ops import wave_cuda, wave_persistent
        from .ops.wave_engine import mode_file_for, resolve_wave_mode
        torch.zeros(1, device=dev)
        wave_cuda._load()
        knobs, _ = resolve_wave_mode("cuda", {}, os.environ,
                                     mode_file_for(dev))
        if knobs["persistent"]:
            wave_persistent._load()
    return time.perf_counter() - t0


def card_line() -> str:
    """nvidia-smi's name and power limit of the first card."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def _gate_status(path):
    """Each mode's status in the build gate's file, or None without it."""
    try:
        return {m: v.get("status", "?")
                for m, v in json.loads(path.read_text()).items()}
    except (OSError, ValueError, AttributeError):
        return None


def run(k: Knobs, result: dict) -> bool:
    """Every timed run and gate, written into ``result``; returns whether
    every gate passed.  Raises when a run fails."""
    import torch
    from .ops.wave_engine import mode_file_for, resolve_device
    from .tools.wave_build_gate import STATUS_FILE
    dev = resolve_device(os.environ.get("DAMAPPER_DEVICE") or None)
    result["platform"] = "gpu" if dev.type == "cuda" else "cpu"
    result["device"] = card_line() if dev.type == "cuda" else "cpu"
    result["wave_mode_file"] = mode_file_for(dev) or None
    result["wave_build_status"] = _gate_status(STATUS_FILE)
    work = k.work()
    t0 = time.perf_counter()
    build_dataset(work, k)
    result["dataset_seconds"] = round(time.perf_counter() - t0, 3)
    result["build_seconds"] = round(build_libraries(dev), 3)
    result["host_cores"] = os.cpu_count()
    result["ref_index_cache"] = (
        "cold per repeat; within a repeat the device ref index is reused "
        "across the read-block list (hits/builds recorded)")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    dt, outs, st = time_ours(work, k, dev)
    result["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                      if dev.type == "cuda" else None)
    result["value"] = round(k.nreads / dt, 3)
    result["seconds_samples"] = st["samples"]
    result["stage_seconds"] = {f: round(v, 3)
                               for f, v in st["times"].items()}
    result["ref_index_cache_hits"] = st["ref_index_cache_hits"]
    result["ref_index_builds"] = st["ref_index_builds"]
    result["ref_index_builds_samples"] = st["builds_samples"]
    result["align_device_s"] = round(st["align_device_s"], 3)
    result["align_host_s"] = round(st["align_host_s"], 3)
    align = max(1e-9, st["times"].get("align", dt))
    result["cell_updates_per_sec"] = round(
        st["total_waves"] * st["band_cap"] / align, 0)
    result["wave_lanes"] = st["n_lanes"]
    result["total_waves"] = st["total_waves"]
    result["wave_mode"] = st["wave_mode"]
    result["wave_mode_source"] = st["wave_mode_source"]
    result["align_host_split"] = {f: round(v, 3) for f, v in
                                  st["align_host_split"].items()}
    result["kernel_launches"] = st["kernel_launches"]
    result["kernel_ms"] = round(st["kernel_ms"], 3)
    for f in ("n_fallback", "n_winmiss", "n_hostmin"):
        result[f] = st[f]
    result["gate"] = k.gate
    ok = _gate(work, k, dev, None, "torch_ours", outs, result)

    if k.variants:
        variants = result["variants"] = {}
        for name in k.variants:
            kw = VARIANT_KW[name]
            sub = "torch_ours_" + ("nC" if name == "n95_C" else "p")
            vdt, vouts, vst = time_ours(work, k, dev, kw, repeats=1,
                                        subdir=sub)
            rec = variants[name] = {
                "value": round(k.nreads / vdt, 3), "vs_baseline": None,
                "seconds": round(vdt, 3),
                "stage_seconds": {f: round(v, 3)
                                  for f, v in vst["times"].items()},
                "wave_lanes": vst["n_lanes"],
                "kernel_launches": vst["kernel_launches"]}
            ok = _gate(work, k, dev, kw, sub, vouts, rec) and ok
    return ok


def main() -> int:
    result = {"metric": "", "value": 0.0, "unit": "reads/s",
              "vs_baseline": None}
    ok = False
    try:
        k = Knobs.from_env()
        result["metric"] = (
            "reads mapped/sec, simulated PacBio 15% err, damapper_tpu_torch "
            f"(genome {k.glen}bp, {k.nreads} reads, -k20; no C reference "
            f"timed, gate: {k.gate})")
        ok = run(k, result)
    except Exception as e:  # the one boundary: always emit the JSON line
        traceback.print_exc()
        result["error"] = f"{type(e).__name__}: {e}"[:500]
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0 if ok and "error" not in result else 1


if __name__ == "__main__":
    sys.exit(main())

"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout on a machine with the cell's cards.  It draws
the cell's data from the seed (gen.py) into a directory under TMPDIR,
writes them as DAZZ files (dazz.py), maps one read block as a warm-up, then
maps the traffic's read blocks one after another, cycling through them,
through the port's entry (``damapper_tpu_torch.pipeline.mapper.run_damapper``
with the configuration's options and every other knob at its default) and
starts blocks until ``--seconds`` have passed; the window closes when the
last block ends, in a synchronize.  Before any of that it sets glibc's
malloc to keep what the process frees (steady_malloc), so that the timed
blocks reuse memory that is already mapped.  Then it checks the window's
outputs (check.py, against the plain reference in ref/) and prints, as the last
line of its standard output, one JSON object:

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"],
     "check"}

with the cell's end-to-end metrics untraced and its per-layer metrics with
``--trace 1`` (the window under torch.profiler).  Each number the check
compares is printed beside its limit on the last lines of standard error
and under "check", the line's last key.

Without a CUDA card (or with fewer than the cell asks for), without the
port's package, or when jax, jaxlib, flax or the JAX package was loaded, it
prints no result and exits non-zero.  ``--device cpu`` (with
``--benchmark`` and ``--traffic-dir``) is for the harness's own tests: the
port's plain PyTorch path on the CPU, and no device metric.
"""

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from . import cells, check, dazz, devtrace, gen  # noqa: E402
from .heap import steady_malloc  # noqa: E402
from .ref.mapper import GOVERNOR  # noqa: E402

CHECKOUT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "damapper_tpu")
STAT_SUMS = ("kernel_ms", "align_device_s", "align_host_s",
             "ref_index_builds", "ref_index_cache_hits", "n_lanes")


class NoCard(RuntimeError):
    pass


@dataclass
class Window:
    """What the metric readers read (metrics/*.py)."""
    platform: str
    reads: int
    wall_s: float
    setup_s: float
    stats: dict
    las: list
    peak_bytes: int
    host_rate: float
    trace: devtrace.DeviceTrace | None = None

    def per_kread(self, seconds: float) -> float:
        """Seconds over the window's reads, in ms a 1,000 reads."""
        return seconds * 1e6 / self.reads


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX
    package, compared whole (damapper_tpu_torch is not damapper_tpu)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def host_rate(seconds: float = 0.25) -> float:
    """A pure-Python loop's rate on this host, in millions of iterations a
    second, over ``seconds`` of the host clock."""
    n = 0
    t0 = time.perf_counter()
    while True:
        for _ in range(10_000):
            n += 1
        t = time.perf_counter() - t0
        if t >= seconds:
            return n / t / 1e6


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths;
    the port builds its own libraries under build/ there too."""
    build = CHECKOUT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton_cache"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(build / sub)


def power_limit() -> str:
    """The first card's power limit, from nvidia-smi ("" without it)."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return (smi.stdout.strip().splitlines() or [""])[0].strip()


def add_stats(tot: dict, st: dict) -> dict:
    if not tot:
        return dict(times=dict(st["times"]),
                    align_host_split=dict(st["align_host_split"]),
                    **{f: st[f] for f in STAT_SUMS})
    for f, v in st["times"].items():
        tot["times"][f] += v
    for f, v in st["align_host_split"].items():
        tot["align_host_split"][f] += v
    for f in STAT_SUMS:
        tot[f] += st[f]
    return tot


def run(args) -> dict:
    """One run of a cell; returns the result line's object.  Raises NoCard
    without the cards the cell asks for, and on any failure outside the
    window."""
    cat = cells.Catalog(args.benchmark or cells.BENCHMARK,
                        args.traffic_dir or cells.HERE / "traffic")
    wl = cat.workload(args.workload)
    cfg = cat.config(wl["config"])
    traffic = cat.traffic(wl["traffic"])
    import torch
    if args.device == "cpu":
        device, platform = torch.device("cpu"), "cpu"
    else:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device is available")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise NoCard(f"the cell asks for {wl['chips']} cards, "
                         f"{torch.cuda.device_count()} are here")
        device, platform = torch.device("cuda", 0), "gpu"
        torch.zeros(1, device=device)
    cache_dirs()
    from damapper_tpu_torch.pipeline import mapper

    def sync():
        if platform == "gpu":
            torch.cuda.synchronize()

    opts = cfg["options"]
    work = pathlib.Path(tempfile.mkdtemp(prefix="benchmark-",
                                         dir=os.environ.get("TMPDIR")))
    try:
        t_data = time.perf_counter()
        genome, blocks = gen.draw_cell(args.seed, cfg, traffic)
        t_files = time.perf_counter()
        ref_cut = dazz.write_dam(str(work / "ref"), genome,
                                 int(cfg["ref_block_bases"]))
        read_cut = dazz.write_reads(str(work / "reads"), blocks,
                                    int(traffic["block_bases"]))
        dcfg = mapper.DamapperConfig(
            device=device, kmer=int(opts["kmer"]),
            ave_error=float(opts["ave_error"]),
            spacing=int(opts["spacing"]), profile=bool(opts["profile"]),
            best_tie=float(opts.get("best_tie", 1.0)),
            mem_limit=int(opts["mem_limit_gb"]) << 30)

        def map_block(b: int, out: pathlib.Path):
            out.mkdir(parents=True)
            a_path, _ = mapper.run_damapper(str(work / "ref.dam"),
                                            str(work / f"reads.{b + 1}"),
                                            dcfg, out_dir=str(out))
            return a_path, dict(mapper.LAST_STATS)

        t_warm = time.perf_counter()
        _, st = map_block(0, work / "out" / "warm")
        sync()
        t_end = time.perf_counter()
        print(f"benchmark: {args.workload} seed {args.seed}: wave mode "
              f"{st['wave_mode']} from {st['wave_mode_source']}, index "
              f"{st['index_backend']}, chain {st['chain_backend']}, "
              f"reference index builds {st['ref_index_builds']} and cache "
              f"hits {st['ref_index_cache_hits']} in the warm-up; set-up: "
              f"start {t_data - _T0:.3f} s, data {t_files - t_data:.3f} s, "
              f"files {t_warm - t_files:.3f} s, warm-up "
              f"{t_end - t_warm:.3f} s", file=sys.stderr)
        rate0 = host_rate()
        if platform == "gpu":
            torch.cuda.reset_peak_memory_stats()
        prof = None
        if args.trace and platform == "gpu":
            from torch.profiler import ProfilerActivity, profile
            prof = profile(activities=[ProfilerActivity.CUDA])
        mapped, stats, reads, failed, walls = [], {}, 0, 0, []
        with prof if prof is not None else nullcontext():
            sync()
            setup_s = time.perf_counter() - _T0
            t0 = time.perf_counter()
            j = 0
            while time.perf_counter() - t0 < args.seconds:
                b = j % len(blocks)
                out = work / "out" / f"w{j}"
                reads += blocks[b].nreads
                tb = time.perf_counter()
                try:
                    a_path, st = map_block(b, out)
                    walls.append(time.perf_counter() - tb)
                except Exception:
                    traceback.print_exc()
                    failed += blocks[b].nreads
                    break
                stats = add_stats(stats, st)
                mapped.append((b, out, a_path))
                j += 1
            sync()
            wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if platform == "gpu" else 0
        rate1 = host_rate()
        print(f"benchmark: window {wall:.3f} s, {len(mapped)} blocks, "
              f"{reads} reads, {reads / wall:.3f} reads/s, reference index "
              f"builds {stats.get('ref_index_builds')}, cache hits "
              f"{stats.get('ref_index_cache_hits')}, lanes "
              f"{stats.get('n_lanes')}; stage seconds "
              f"{' '.join(f'{k} {v:.3f}' for k, v in stats.get('times', {}).items())}"
              f"; block walls "
              f"{' '.join(f'{w:.3f}' for w in walls)} s; host loop rate "
              f"{rate0:.3f} before and {rate1:.3f} after, Mloop/s",
              file=sys.stderr)
        trace = None
        if prof is not None:
            trace = devtrace.reduce(prof.profiler.kineto_results.events(),
                                    wall)
            prof = None
        result = {"correct": False, "attempted": reads, "failed": failed}
        # the reference runs after the peak was read, in what the program
        # has released
        gc.collect()
        if platform == "gpu":
            torch.cuda.empty_cache()
        las = [dazz.LasFile(a) for _, _, a in mapped]
        numbers = verify(args.seed, cfg, traffic, genome, blocks, ref_cut,
                         read_cut, mapped, las, work, device) \
            if not failed and mapped else None
        win = Window(platform=platform, reads=reads, wall_s=wall,
                     setup_s=setup_s, stats=stats, las=las, peak_bytes=peak,
                     host_rate=(rate0 + rate1) / 2, trace=trace)
        metrics = {}
        for m in cat.metrics(args.workload, bool(args.trace)):
            v = cells.reader(m["name"])(win) if stats else None
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
        if platform == "gpu":
            result["device"] = {"platform": "gpu",
                                "kind": torch.cuda.get_device_name(0),
                                "count": int(wl["chips"]),
                                "memory_peak_bytes": int(peak),
                                "power_limit": power_limit()}
        else:
            result["device"] = {"platform": "cpu", "kind": "cpu",
                                "count": 1, "memory_peak_bytes": 0}
        if args.trace and trace is not None:
            result["device"]["busy_s"] = trace.busy_s
            result["device"]["window_s"] = trace.window_s
            result["breakdown"] = {"device_ops": trace.ops,
                                   "idle_gaps": trace.gaps}
        result["correct"] = numbers is not None and all(
            numbers[k] <= check.LIMITS[k] for k in check.LIMITS)
        result["check"] = {k: {"value": numbers[k] if numbers else None,
                               "limit": lim}
                           for k, lim in check.LIMITS.items()}
        return result
    finally:
        shutil.rmtree(work, ignore_errors=True)


def verify(seed, cfg, traffic, genome, blocks, ref_cut, read_cut, mapped,
           las, work, device) -> dict:
    """check.py's numbers for the window's outputs."""
    opts = cfg["options"]
    spacing = int(opts["spacing"])
    out = {k: 0 for k in check.LIMITS}
    firsts, files = {}, {}
    for (b, d, a_path), f in zip(mapped, las):
        tfirst = read_cut[b]
        out["records_malformed"] += check.malformed(
            f, blocks[b].lens, tfirst, genome.lens, spacing)
        names = {"las": a_path}
        if opts["profile"]:
            root = str(d / f".reads.{b + 1}")
            names.update(anno=root + ".prof.anno", data=root + ".prof.data")
        if b in firsts:
            out["repeats_differ"] += not check.same_output(files[b], names)
        else:
            firsts[b] = {"las": f, "tfirst": tfirst,
                         "prof": str(d / f".reads.{b + 1}")}
            files[b] = names
    sample = check.draw_sample(seed, traffic, blocks, firsts)
    t0 = time.perf_counter()
    expect = check.reference_answers(sample, genome, blocks, ref_cut,
                                     read_cut, opts, work, device)
    out["reads_differ"], out["profiles_differ"] = check.compare(
        check.program_answers(sample, firsts, bool(opts["profile"])),
        expect)
    print(f"benchmark: the reference's {len(sample)} reads of "
          f"{len(firsts)} blocks hold "
          f"{sum(len(v[0]) for v in expect.values())} records; it took "
          f"{time.perf_counter() - t0:.3f} s; the -M governor's (largest "
          f"count product, limit) a reference block and orientation: "
          f"{GOVERNOR}", file=sys.stderr)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cpu: the harness's own tests only")
    ap.add_argument("--benchmark", help="another BENCHMARK.json (tests)")
    ap.add_argument("--traffic-dir", help="another traffic folder (tests)")
    args = ap.parse_args(argv)
    try:
        steady_malloc()
        result = run(args)
    except NoCard as e:
        print(f"benchmark: {e}; no result", file=sys.stderr)
        return 2
    except Exception:
        traceback.print_exc()
        print("benchmark: the run failed; no result", file=sys.stderr)
        return 1
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for k, v in result["check"].items():
        print(f"check {k} {v['value']} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

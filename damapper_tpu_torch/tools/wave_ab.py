"""A/B timing of builds of the classic wave kernel on one card.

    python3 -m damapper_tpu_torch.tools.wave_ab DIR [DIR ...]
        [--rounds 7] [--reps 10] [--seed 42] [--out FILE]

Each DIR holds a ``wave.cu`` (and the headers it includes) that exports
``wave_lanes_launch`` with the C signature of ``csrc/wave.cu``, and may
hold a file ``nvcc_flags`` of extra nvcc arguments; DIR may be
``damapper_tpu_torch/csrc`` itself.  Every source is built with nvcc for
sm_90a into its own library under ``build/ab/`` (all builds started
together), and ptxas's register report and the SASS instruction count of
each kernel are printed (the SASS of each W=128 kernel goes to ``--out``'s
directory when ``--out`` is given).  Then the same lanes go through every
build at W=128 and W=64, both directions, in interleaved rounds: chip
smoke's phase-3 lanes, 128 lanes of 3-9 kb reads at ~15% error from
``--seed``.  Each round times ``--reps`` launches per build and case with
CUDA events; the median over rounds is printed per build and case, with the
card's name and power limit.  All builds must give identical outputs.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]


def _nvcc():
    cuda = pathlib.Path("/usr/local/cuda/bin")
    return (str(cuda / "nvcc") if (cuda / "nvcc").exists() else "nvcc",
            str(cuda / "cuobjdump") if (cuda / "cuobjdump").exists()
            else "cuobjdump")


def build(src_dir: pathlib.Path, name: str):
    """nvcc src_dir/wave.cu -> build/ab/<name>/libwave.so; returns (path,
    ptxas report)."""
    from ..ops.wave_cuda import NVCC_FLAGS
    out = REPO / "build" / "ab" / name
    out.mkdir(parents=True, exist_ok=True)
    so = out / "libwave.so"
    extra = src_dir / "nvcc_flags"
    extra = extra.read_text().split() if extra.exists() else []
    r = subprocess.run([_nvcc()[0], *NVCC_FLAGS, *extra, "-Xptxas", "-v",
                        "-o", str(so), str(src_dir / "wave.cu")],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src_dir}:\n{r.stderr}")
    return so, r.stderr


def sass_counts(so: pathlib.Path):
    """{kernel symbol: (instructions, sass text)} from cuobjdump."""
    r = subprocess.run([_nvcc()[1], "-sass", str(so)], capture_output=True,
                       text=True)
    if r.returncode != 0:
        return {}
    out, cur, lines = {}, None, []
    for ln in r.stdout.splitlines():
        m = re.match(r"\s*Function : (\S+)", ln)
        if m:
            if cur:
                out[cur] = lines
            cur, lines = m.group(1), []
        elif cur:
            lines.append(ln)
    if cur:
        out[cur] = lines
    return {k: (sum(1 for x in v if re.match(r"\s+/\*[0-9a-f]{4,}\*/", x)),
                "\n".join(v)) for k, v in out.items()}


def regs(report: str):
    """{kernel symbol: registers} from a ptxas -v report."""
    out, cur = {}, None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = m.group(1)
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out[cur] = int(m.group(1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--rounds", type=int, default=7)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("wave_ab: no CUDA device is available", file=sys.stderr)
        return 2
    from ..convert import lanes_from_numpy
    from ..ops.spec import new_align_spec
    from ..ops.wave_cuda import IN_FIELDS, OUT_FIELDS
    from ..utils.sim import make_lane_cases

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dirs = [pathlib.Path(d).resolve() for d in args.dirs]
    names = [f"{i}_{d.name}" for i, d in enumerate(dirs)]
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as ex:
        built = list(ex.map(build, dirs, names))
    outdir = pathlib.Path(args.out).parent if args.out else None
    libs = {}
    for nm, (so, rep) in zip(names, built):
        rg = regs(rep)
        for sym, (cnt, text) in sorted(sass_counts(so).items()):
            # the plain layout's kernels (a packed twin shares the body)
            if "wave_lanes_kernel" not in sym or "PackedIO" in sym:
                continue
            print(f"{nm}: {sym[-40:]}: {rg.get(sym)} registers, {cnt} SASS "
                  f"instructions")
            if outdir and "ILi128E" in sym:
                kind = "rev" if "Lb1E" in sym else "fwd"
                (outdir / f"sass_{nm}_w128_{kind}.txt").write_text(text)
        lib = ctypes.CDLL(str(so))
        P_, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.wave_lanes_launch.restype = I
        lib.wave_lanes_launch.argtypes = ([P_] * 6 + [P_, LL, P_, LL]
                                          + [I] * 9 + [P_, P_, P_])
        libs[nm] = lib

    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    consts = (spec.trace_space, spec.ave_path, spec.mscore, spec.dscore)
    dev = torch.device("cuda")
    seqmem, insts = make_lane_cases(args.seed, 128, glen=200_000, rlen=9000,
                                    rmin=3000, mix=True, err=0.15)
    lanes = lanes_from_numpy(insts, seqmem, dev)
    n, P = len(insts), 512
    A = lanes["A"]
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, W, rev, bufs=None):
        out, pool = bufs or (
            torch.empty((len(OUT_FIELDS), n), dtype=torch.int32, device=dev),
            torch.zeros((n, P, 4), dtype=torch.int32, device=dev))
        rc = lib.wave_lanes_launch(
            *[lanes[f].data_ptr() for f in IN_FIELDS], A.data_ptr(),
            A.shape[0], A.data_ptr(), A.shape[0], n, W, P, int(rev),
            *consts, 1 << 20, out.data_ptr(), pool.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return out, pool

    cases = [(128, False), (128, True), (64, False), (64, True)]
    ref = {}
    for nm, lib in libs.items():       # warm-up and the identity check
        for W, rev in cases:
            out, pool = launch(lib, W, rev)
            torch.cuda.synchronize()
            if (W, rev) not in ref:
                ref[(W, rev)] = (out, pool)
            else:
                ro, rp = ref[(W, rev)]
                av = ro[OUT_FIELDS.index("avail")]
                below = (torch.arange(P, device=dev)[None, :]
                         < av[:, None])[:, :, None]
                if not (torch.equal(out, ro)
                        and torch.equal(pool * below, rp * below)):
                    raise RuntimeError(f"{nm} differs at W={W} rev={rev}")
    times = {(nm, c): [] for nm in libs for c in cases}
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    bufs = launch(next(iter(libs.values())), 128, False)
    for _ in range(args.rounds):
        for nm, lib in libs.items():
            for W, rev in cases:
                torch.cuda.synchronize()
                ev0.record()
                for _ in range(args.reps):
                    launch(lib, W, rev, bufs)
                ev1.record()
                torch.cuda.synchronize()
                times[(nm, (W, rev))].append(ev0.elapsed_time(ev1)
                                             / args.reps)
    print(card)
    res = {}
    for nm in libs:
        row = {}
        for W, rev in cases:
            ts = times[(nm, (W, rev))]
            row[f"W{W}_{'rev' if rev else 'fwd'}"] = dict(
                median_ms=float(np.median(ts)), min_ms=float(np.min(ts)),
                max_ms=float(np.max(ts)))
        res[nm] = row
        print(nm + ": " + "  ".join(
            f"{k} {v['median_ms']:.4f} ms ({v['min_ms']:.4f}-"
            f"{v['max_ms']:.4f})" for k, v in row.items()))
    line = json.dumps({"card": card, "lanes": n, "rounds": args.rounds,
                       "reps": args.reps, "builds": res})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

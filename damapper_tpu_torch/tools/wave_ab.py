"""A/B timing of builds of the classic wave kernel on one card.

    python3 -m damapper_tpu_torch.tools.wave_ab DIR [DIR ...]
        [--nlanes 128 [1024 ...]] [--rounds 7] [--reps 10] [--seed 42]
        [--out FILE]

Each DIR holds a ``wave.cu`` (and the headers it includes) that exports
``wave_lanes_launch`` and ``wave_lanes_packed_launch`` with the C
signatures of ``csrc/wave.cu``, and may hold a file ``nvcc_flags`` of extra
nvcc arguments; DIR may be ``damapper_tpu_torch/csrc`` itself, or a
parent's copy of it under the gitignored ``build/`` (``git show``).  Every
source is built with nvcc for sm_90a into its own library under
``build/ab/`` (all builds started together); for each kernel of the plain
and packed layouts (and the dense W=128 kernel of each, which the launcher
picks for more lanes than the card holds at once) ptxas's registers and
spill bytes are printed, with its SASS instruction count and, in its wave
loop (the longest loop of the SASS), the instructions and the ``BAR``
instructions by kind.  The SASS of each W=128 plain kernel goes to
``--out``'s directory when ``--out`` is given.  Then the same lanes go
through every build, layout, W (128 and 64) and direction in interleaved
rounds: for each ``--nlanes`` N, N lanes of 3-9 kb reads at ~15% error
from ``--seed`` (128: chip smoke's phase-3 lanes; 1024: about a round of
BASELINE config 1's main path; 4096-16384: rounds of read blocks of tens
of thousands of reads).  Each round
times ``--reps`` launches per build and case with CUDA events; the median
over rounds is printed per build and case, with the card's name and power
limit.  All builds must give identical outputs.
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


def _sass_rows(text):
    return [(int(m.group(1), 16), m.group(2)) for m in
            (re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", ln)
             for ln in text.splitlines()) if m]


def loops(text):
    """The loops of a kernel's SASS: (first, last) addresses of each
    backward branch's target and the branch."""
    return [(int(m.group(1), 16), addr) for addr, op in _sass_rows(text)
            for m in [re.search(r"\bBRA\s+0x([0-9a-f]+)", op)]
            if m and int(m.group(1), 16) <= addr]


def loop_ops(text):
    """The instructions of a kernel's SASS that lie in a loop."""
    spans = loops(text)
    return [op for addr, op in _sass_rows(text)
            if any(a <= addr <= b for a, b in spans)]


def wave_loop_ops(text):
    """The instructions of the longest region of overlapping loops: a wave
    kernel's wave loop, with the snake, drop and clip loops inside it and
    the blocks ptxas placed after it that branch back into it."""
    regions = []
    for a, b in sorted(loops(text)):
        if regions and a <= regions[-1][1]:
            regions[-1][1] = max(regions[-1][1], b)
        else:
            regions.append([a, b])
    if not regions:
        return []
    a, b = max(regions, key=lambda s: s[1] - s[0])
    return [op for addr, op in _sass_rows(text) if a <= addr <= b]


def bar_counts(ops):
    """{BAR kind: count} over SASS instructions (BAR.SYNC, BAR.RED, ...)."""
    out = {}
    for op in ops:
        m = re.search(r"\bBAR\.(\w+)", op)
        if m:
            out[m.group(1)] = out.get(m.group(1), 0) + 1
    return out


def ptxas_report(report: str):
    """{kernel symbol: (registers, spill store bytes, spill load bytes)}
    from a ptxas -v report."""
    out, cur = {}, None
    spill = (0, 0)
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur, spill = m.group(1), (0, 0)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur:
            out[cur] = (int(m.group(1)),) + spill
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--nlanes", type=int, nargs="+", default=[128])
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
    from ..ops.wave_cuda import (IN_FIELDS, NREC_OUT, OUT_FIELDS, bind,
                                 pack_record)
    from ..utils.sim import make_lane_cases

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dirs = [pathlib.Path(d).resolve() for d in args.dirs]
    names = [f"{i}_{d.name}" for i, d in enumerate(dirs)]
    dev = torch.device("cuda")
    shapes = {}
    # the lanes are drawn on the host while nvcc builds
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as ex:
        pending = [ex.submit(build, d, nm) for d, nm in zip(dirs, names)]
        for n in args.nlanes:
            seqmem, insts = make_lane_cases(args.seed, n, glen=200_000,
                                            rlen=9000, rmin=3000, mix=True,
                                            err=0.15)
            lanes = lanes_from_numpy(insts, seqmem, dev)
            shapes[n] = (lanes, pack_record([lanes[f] for f in IN_FIELDS]))
        built = [f.result() for f in pending]
    outdir = pathlib.Path(args.out).parent if args.out else None
    libs, static = {}, {}
    for nm, (so, rep) in zip(names, built):
        pt = ptxas_report(rep)
        for sym, (cnt, text) in sorted(sass_counts(so).items()):
            # the classic kernels of the plain and packed layouts, and
            # their dense W=128 twins
            m = re.search(r"wave_lanes_(dense_)?kernelI(?:Li(\d+)E)?Lb(\d)E",
                          sym)
            if not m:
                continue
            lay = "packed" if "PackedIO" in sym else "plain"
            W = int(m.group(2) or 128)
            kind = ("dense " if m.group(1) else "") + (
                "rev" if m.group(3) == "1" else "fwd")
            r, st, ld = pt.get(sym, (None, None, None))
            wl = wave_loop_ops(text)
            bars = bar_counts(wl)
            static[f"{nm} {lay} W{W} {kind}"] = dict(
                registers=r, spill_stores=st, spill_loads=ld, sass=cnt,
                wave_loop=len(wl), wave_loop_bar=bars)
            print(f"{nm}: {lay} W={W} {kind}: {r} registers, spills "
                  f"{st}/{ld} bytes (stores/loads), {cnt} SASS instructions, "
                  f"wave loop {len(wl)} with BAR {bars}")
            if outdir and W == 128 and lay == "plain" and not m.group(1):
                (outdir / f"sass_{nm}_w128_{kind}.txt").write_text(text)
        libs[nm] = bind(ctypes.CDLL(str(so)))

    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    consts = (spec.trace_space, spec.ave_path, spec.mscore, spec.dscore)
    P = 512
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, n, lay, W, rev, bufs=None):
        lanes, rec = shapes[n]
        shape = (n, NREC_OUT) if lay == "packed" else (len(OUT_FIELDS), n)
        out, pool = bufs or (
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.zeros((n, P, 4), dtype=torch.int32, device=dev))
        A = lanes["A"]
        seq = (A.data_ptr(), A.shape[0], A.data_ptr(), A.shape[0])
        tail = (int(rev), *consts, 1 << 20, out.data_ptr(), pool.data_ptr(),
                stream)
        if lay == "packed":
            rc = lib.wave_lanes_packed_launch(rec.data_ptr(), *seq, n, W, P,
                                              *tail)
        else:
            rc = lib.wave_lanes_launch(*[lanes[f].data_ptr()
                                         for f in IN_FIELDS], *seq, n, W, P,
                                       *tail)
        if rc != 0:
            raise RuntimeError(f"launch failed: {rc}")
        return out, pool

    def avail(out, lay):
        i = OUT_FIELDS.index("avail")
        return out[:, i] if lay == "packed" else out[i]

    cases = [(n, lay, W, rev) for n in args.nlanes
             for lay in ("plain", "packed")
             for W in (128, 64) for rev in (False, True)]
    ref = {}
    for nm, lib in libs.items():       # warm-up and the identity check
        for case in cases:
            out, pool = launch(lib, *case)
            torch.cuda.synchronize()
            if case not in ref:
                ref[case] = (out, pool)
                continue
            ro, rp = ref[case]
            below = (torch.arange(P, device=dev)[None, :]
                     < avail(ro, case[1])[:, None])[:, :, None]
            if not (torch.equal(out, ro)
                    and torch.equal(pool * below, rp * below)):
                raise RuntimeError(f"{nm} differs on {case}")
    times = {(nm, c): [] for nm in libs for c in cases}
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    bufs = {c: launch(next(iter(libs.values())), *c) for c in cases}
    for _ in range(args.rounds):
        for nm, lib in libs.items():
            for c in cases:
                torch.cuda.synchronize()
                ev0.record()
                for _ in range(args.reps):
                    launch(lib, *c, bufs[c])
                ev1.record()
                torch.cuda.synchronize()
                times[(nm, c)].append(ev0.elapsed_time(ev1) / args.reps)
    print(card)
    res = {}
    for nm in libs:
        row = {}
        for n, lay, W, rev in cases:
            ts = times[(nm, (n, lay, W, rev))]
            row[f"n{n}_{lay}_W{W}_{'rev' if rev else 'fwd'}"] = dict(
                median_ms=float(np.median(ts)), min_ms=float(np.min(ts)),
                max_ms=float(np.max(ts)))
        res[nm] = row
        print(nm + ":\n  " + "\n  ".join(
            f"{k} {v['median_ms']:.4f} ms ({v['min_ms']:.4f}-"
            f"{v['max_ms']:.4f})" for k, v in row.items()))
    line = json.dumps({"card": card, "nlanes": args.nlanes,
                       "rounds": args.rounds, "reps": args.reps,
                       "static": static, "builds": res})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())

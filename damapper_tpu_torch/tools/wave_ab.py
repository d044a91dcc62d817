"""A/B timing of builds of the wave kernels on one card.

    python3 -m damapper_tpu_torch.tools.wave_ab DIR [DIR ...]
        [--nlanes 128 [1024 ...]] [--rounds 7] [--reps 10] [--seed 42]
        [--out FILE]

Each DIR holds a ``wave.cu`` (and the headers it includes) that exports
``wave_lanes_launch`` and ``wave_lanes_packed_launch`` with the C
signatures of ``csrc/wave.cu``, and may hold a ``wave_persistent.cu`` (the
persistent kernels; a DIR without one has no persistent rows) and a file
``nvcc_flags`` of extra nvcc arguments.  The lane-packed rows 3 and 6 are
the plain launchers at W=64, as the wrappers run them; a build that
exports a lane-packed launcher (``wave_lanes_lanepack_launch``,
``wave_persistent_lanepack_launch``: an older build's two lanes a
128-thread block) also has its rows 3 and 6 timed through it.  DIR may be
``damapper_tpu_torch/csrc`` itself, or a parent's copy of it under the
gitignored ``build/`` (``git show``).  Every source is built with nvcc for
sm_90a into its own library under ``build/ab/`` (all builds started
together).

For every wave kernel of every build it prints ptxas's registers and spill
bytes, its SASS instruction count, in its wave loop (the longest loop of
the SASS) the instructions and the ``BAR`` instructions by kind, and
whether its SASS instructions equal the first build's (``same SASS``: a
kernel whose source did not change must compile to the same code).  The
SASS of each W=128 plain kernel goes to ``--out``'s directory when
``--out`` is given.

Then the same lanes go through every build and case in interleaved rounds.
For each ``--nlanes`` N, N lanes of 3-9 kb reads at ~15% error from
``--seed`` (128: chip smoke's phase-3 lanes; 1024: about a round of
BASELINE config 1's main path; 4096-16384: rounds of read blocks of tens of
thousands of reads): the classic plain and packed kernels at W=128 and W=64
(rows 1-2; plain at W=64, one lane to a 64-thread block, is also row 3),
and, for a build with persistent kernels, the persistent kernels at W=64
with the reads' window (rows 4-6: plain on shared-memory and global
windows, which is also row 6, and packed on shared-memory windows), both
directions; and the persistent plain kernel on 8 lanes of 40-45 kb reads
(L=65536, pool 2048: long windows) by both routes.  A build's lane-packed
launchers add their cases beside these (row 3; row 6 by both routes, the
long lanes too), and a route that does not fit a build's blocks is left
out.  Each round times ``--reps`` launches per build and case with CUDA
events; the median over rounds is printed per build and case, with the
card's name and power limit.  All builds and launchers must give identical
outputs.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import json
import pathlib
import re
import subprocess
import sys

import numpy as np

REPO = pathlib.Path(__file__).resolve().parents[2]
# the wave kernels, by the name their symbols carry
KERNELS = ("wave_lanes_dense_kernel", "wave_lanes_lp_kernel",
           "wave_lanes_kernel", "persistent_lp_kernel", "persistent_kernel")
LONG_P = 2048       # the pool of the long lanes (utils/sim.py)


def _nvcc():
    cuda = pathlib.Path("/usr/local/cuda/bin")
    return (str(cuda / "nvcc") if (cuda / "nvcc").exists() else "nvcc",
            str(cuda / "cuobjdump") if (cuda / "cuobjdump").exists()
            else "cuobjdump")


def build(src_dir: pathlib.Path, name: str, src: str = "wave.cu"):
    """nvcc src_dir/<src> -> build/ab/<name>/lib<stem>.so; returns (path,
    ptxas report)."""
    from ..ops.wave_cuda import NVCC_FLAGS
    out = REPO / "build" / "ab" / name
    out.mkdir(parents=True, exist_ok=True)
    so = out / ("lib" + pathlib.Path(src).stem + ".so")
    extra = src_dir / "nvcc_flags"
    extra = extra.read_text().split() if extra.exists() else []
    r = subprocess.run([_nvcc()[0], *NVCC_FLAGS, *extra, "-Xptxas", "-v",
                        "-o", str(so), str(src_dir / src)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed for {src_dir / src}:\n{r.stderr}")
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


def sass_digest(text):
    """A digest of a kernel's SASS instructions (addresses, opcodes and
    operands; the symbol names the file's anonymous namespace differently
    in every build, so it is left out)."""
    rows = "\n".join(f"{a:x} {op}" for a, op in _sass_rows(text))
    return hashlib.sha256(rows.encode()).hexdigest()[:16]


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


def kernel_key(sym):
    """A wave kernel symbol without its file's anonymous namespace: the
    kernel's name and its template arguments and parameters, or None."""
    for name in KERNELS:
        i = sym.find(str(len(name)) + name)
        if i >= 0:
            return sym[i:]
    return None


def kernel_label(key):
    """Row, W, route and direction of a kernel key, for the report."""
    m = re.match(r"\d+(\w+?_kernel)I(.*)", key)
    name, args = m.group(1), m.group(2)
    bits = re.findall(r"Lb([01])E", args)
    w = re.search(r"Li(\d+)E", args)
    lay = "packed" if "PackedIO" in args else (
        "lanepack" if "_lp_" in name else "plain")
    W = int(w.group(1)) if w else (128 if "dense" in name else 64)
    rev = "rev" if bits and bits[0] == "1" else "fwd"
    mode = "persistent" if name.startswith("persistent") else "classic"
    extra = ""
    if mode == "persistent":
        extra = " smem" if bits[1] == "1" else " global"
    if "dense" in name:
        extra = " dense"
    return f"{mode} {lay} W{W} {rev}{extra}"


def cases(nlanes, lanepack, persistent, persistent_lanepack):
    """The cases (N, mode, layout, W, reverse, route) a build is timed in:
    rows 1-2 at W=128 and 64 for each N, the persistent rows 4-6 where the
    build has persistent kernels, and the long lanes; the lane-packed
    layout only where the build exports a lane-packed launcher (classic:
    lanepack, persistent: persistent_lanepack), since without one rows 3
    and 6 are the plain W=64 cases already in the list."""
    out = []
    for n in nlanes:
        for rev in (False, True):
            out += [(n, "classic", lay, W, rev, "")
                    for lay in ("plain", "packed") for W in (128, 64)]
            if lanepack:
                out.append((n, "classic", "lanepack", 64, rev, ""))
            if not persistent:
                continue
            out += [(n, "persistent", "plain", 64, rev, route)
                    for route in ("smem", "global")]
            out.append((n, "persistent", "packed", 64, rev, "smem"))
            if persistent_lanepack:
                out += [(n, "persistent", "lanepack", 64, rev, route)
                        for route in ("smem", "global")]
    if persistent:
        lays = ("plain", "lanepack") if persistent_lanepack else ("plain",)
        for rev in (False, True):
            out += [("long", "persistent", lay, 64, rev, route)
                    for lay in lays for route in ("smem", "global")]
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
    from ..ops import wave_cuda, wave_persistent
    from ..ops.spec import new_align_spec
    from ..ops.wave_cuda import IN_FIELDS, NREC_OUT, OUT_FIELDS, pack_record
    from ..utils.sim import make_lane_cases, make_long_lane_cases

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dirs = [pathlib.Path(d).resolve() for d in args.dirs]
    names = [f"{i}_{d.name}" for i, d in enumerate(dirs)]
    pers = [(d / "wave_persistent.cu").exists() for d in dirs]
    dev = torch.device("cuda")
    shapes = {}
    # the lanes are drawn on the host while nvcc builds
    with concurrent.futures.ThreadPoolExecutor(2 * len(dirs)) as ex:
        pending = [(ex.submit(build, d, nm),
                    ex.submit(build, d, nm, "wave_persistent.cu")
                    if p else None) for d, nm, p in zip(dirs, names, pers)]
        sets = {n: make_lane_cases(args.seed, n, glen=200_000, rlen=9000,
                                   rmin=3000, mix=True, err=0.15)
                for n in args.nlanes}
        if any(pers):
            long_ = make_long_lane_cases(args.seed + 2, 8)
            sets["long"] = (long_[0], long_[1])
        for n, (seqmem, insts) in sets.items():
            lanes = lanes_from_numpy(insts, seqmem, dev)
            L = (long_[2] if n == "long" else wave_persistent.window_length(
                max(s["blen"] for s in insts)))
            win = {rev: lanes_from_numpy(insts, seqmem, dev, L=L,
                                         reverse=rev)
                   for rev in (False, True)} if any(pers) else {}
            shapes[n] = dict(lanes=lanes, L=L, win=win, n=len(insts),
                             rec=pack_record([lanes[f] for f in IN_FIELDS]),
                             wrec={r: pack_record([w[f] for f in IN_FIELDS
                                                   + ("awst", "bwst")])
                                   for r, w in win.items()})
        built = [(f.result(), g.result() if g else None)
                 for f, g in pending]
    outdir = pathlib.Path(args.out).parent if args.out else None
    libs, static, first = {}, {}, {}
    for nm, (wb, pb) in zip(names, built):
        lib = _bind(wave_cuda, ctypes.CDLL(str(wb[0])),
                    "wave_lanes_lanepack_launch", 6, 8)
        plib = _bind(wave_persistent, ctypes.CDLL(str(pb[0])),
                     "wave_persistent_lanepack_launch", 8, 10) if pb else None
        libs[nm] = (lib, plib)
        for so, rep in (b for b in (wb, pb) if b):
            pt = ptxas_report(rep)
            for sym, (cnt, text) in sorted(sass_counts(so).items()):
                key = kernel_key(sym)
                if key is None:
                    continue
                label = kernel_label(key)
                r, st, ld = pt.get(sym, (None, None, None))
                wl = wave_loop_ops(text)
                bars = bar_counts(wl)
                dig = sass_digest(text)
                same = first.setdefault(key, dig) == dig
                static[f"{nm} {label}"] = dict(
                    registers=r, spill_stores=st, spill_loads=ld, sass=cnt,
                    wave_loop=len(wl), wave_loop_bar=bars, sass_digest=dig,
                    same_sass_as_first=same)
                print(f"{nm}: {label}: {r} registers, spills {st}/{ld} bytes "
                      f"(stores/loads), {cnt} SASS instructions, wave loop "
                      f"{len(wl)} with BAR {bars}"
                      + ("" if nm == names[0] else
                         f", {'same SASS as' if same else 'SASS differs from'}"
                         f" {names[0]}"))
                if outdir and label.startswith("classic plain W128") \
                        and "dense" not in label:
                    (outdir / f"sass_{nm}_{label.replace(' ', '_')}.txt") \
                        .write_text(text)

    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    consts = (spec.trace_space, spec.ave_path, spec.mscore, spec.dscore)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(nm, case, bufs=None):
        n, mode, lay, W, rev, route = case
        sh = shapes[n]
        P = LONG_P if n == "long" else 512
        lib, plib = libs[nm]
        nl = sh["n"]
        shape = (nl, NREC_OUT) if lay == "packed" else (len(OUT_FIELDS), nl)
        out, pool = bufs or (
            torch.empty(shape, dtype=torch.int32, device=dev),
            torch.zeros((nl, P, 4), dtype=torch.int32, device=dev))
        A = sh["lanes"]["A"]
        seq = (A.data_ptr(), A.shape[0], A.data_ptr(), A.shape[0])
        tail = (*consts, 1 << 20, out.data_ptr(), pool.data_ptr(), stream)
        if mode == "classic":
            ptrs = [sh["lanes"][f].data_ptr() for f in IN_FIELDS]
            if lay == "packed":
                rc = lib.wave_lanes_packed_launch(sh["rec"].data_ptr(), *seq,
                                                  nl, W, P, int(rev), *tail)
            elif lay == "plain":
                rc = lib.wave_lanes_launch(*ptrs, *seq, nl, W, P, int(rev),
                                           *tail)
            else:
                rc = lib.lanepack(*ptrs, *seq, nl, P, int(rev), *tail)
        else:
            w = sh["win"][rev]
            L, smem = sh["L"], int(route == "smem")
            ptrs = [w[f].data_ptr() for f in IN_FIELDS + ("awst", "bwst")]
            if lay == "packed":
                rc = plib.wave_persistent_packed_launch(
                    sh["wrec"][rev].data_ptr(), *seq, nl, W, P, L, int(rev),
                    smem, *tail)
            elif lay == "plain":
                rc = plib.wave_persistent_launch(*ptrs, *seq, nl, W, P, L,
                                                 int(rev), smem, *tail)
            else:
                rc = plib.lanepack(*ptrs, *seq, nl, P, L, int(rev), smem,
                                   *tail)
        if rc != 0:
            raise RuntimeError(f"{nm}: launch failed on {case}: {rc}")
        return out, pool

    def cases_of(nm):
        lib, plib = libs[nm]
        return cases(args.nlanes, lib.lanepack is not None,
                     plib is not None,
                     plib is not None and plib.lanepack is not None)

    def avail(out, lay):
        i = OUT_FIELDS.index("avail")
        return out[:, i] if lay == "packed" else out[i]

    def fn_of(case):
        """The function a case computes: the layout's output shape and the
        mode (a window miss flags overflow where the classic kernel goes
        on), not the route, the geometry or the build."""
        n, mode, lay, W, rev, _ = case
        return (n, mode, "packed" if lay == "packed" else "split", W, rev)

    ref, skip = {}, set()
    for nm in libs:                  # warm-up and the identity check
        for case in cases_of(nm):
            try:
                out, pool = launch(nm, case)
            except RuntimeError:
                if case[0] != "long" or case[5] != "smem":
                    raise
                # the long windows do not fit this build's blocks
                print(f"{nm}: {case} does not launch; left out")
                skip.add((nm, case))
                continue
            torch.cuda.synchronize()
            key = fn_of(case)
            if key not in ref:
                ref[key] = (out, pool, case)
                continue
            ro, rp, _ = ref[key]
            below = (torch.arange(rp.shape[1], device=dev)[None, :]
                     < avail(ro, case[2] if case[2] == "packed"
                             else "plain")[:, None])[:, :, None]
            if not (torch.equal(out, ro)
                    and torch.equal(pool * below, rp * below)):
                raise RuntimeError(f"{nm} differs on {case} from "
                                   f"{ref[key][2]}")
    runs = {nm: [c for c in cases_of(nm) if (nm, c) not in skip]
            for nm in libs}
    times = {(nm, c): [] for nm in libs for c in runs[nm]}
    ev0 = torch.cuda.Event(enable_timing=True)
    ev1 = torch.cuda.Event(enable_timing=True)
    bufs = {(nm, c): launch(nm, c) for nm in libs for c in runs[nm]}
    for _ in range(args.rounds):
        for nm in libs:
            for c in runs[nm]:
                torch.cuda.synchronize()
                ev0.record()
                for _ in range(args.reps):
                    launch(nm, c, bufs[(nm, c)])
                ev1.record()
                torch.cuda.synchronize()
                times[(nm, c)].append(ev0.elapsed_time(ev1) / args.reps)
    print(card)
    res = {}
    for nm in libs:
        row = {}
        for c in runs[nm]:
            n, mode, lay, W, rev, route = c
            ts = times[(nm, c)]
            key = (f"n{n}_{mode}_{lay}_W{W}_{'rev' if rev else 'fwd'}"
                   + (f"_{route}" if route else ""))
            row[key] = dict(median_ms=float(np.median(ts)),
                            min_ms=float(np.min(ts)),
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


def _bind(mod, lib, lanepack, nptr, nint):
    """mod.bind(lib) (ops.wave_cuda or ops.wave_persistent); lib.lanepack is
    the build's lane-packed launcher, with its argument types (nptr lane
    arrays, the sequences, nint ints, out, pool, stream), or None."""
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    mod.bind(lib)
    lib.lanepack = getattr(lib, lanepack, None)
    if lib.lanepack is not None:
        lib.lanepack.argtypes = [P] * nptr + [P, LL, P, LL] + [I] * nint \
            + [P, P, P]
        lib.lanepack.restype = ctypes.c_int
    return lib


if __name__ == "__main__":
    sys.exit(main())

"""A/B timing of builds of the wave kernels on one card.

    python3 -m damapper_tpu_torch.tools.wave_ab DIR [DIR ...]
        [--nlanes 128 [1024 ...]] [--long 8 [1024 ...]]
        [--rings 1024:8 [whole ...]] [--rounds 7] [--reps 10] [--seed 42]
        [--out FILE]

Each DIR holds a ``wave.cu`` (and the headers it includes) that exports
``wave_lanes_launch`` and ``wave_lanes_packed_launch`` with the C
signatures of ``csrc/wave.cu``, and may hold a ``wave_persistent.cu`` (the
persistent kernels; a DIR without one has no persistent rows) and a file
``nvcc_flags`` of extra nvcc arguments.  A ``wave_persistent.cu`` is of one
of two designs: the ring (it exports ``wave_persistent_occupancy`` and its
launchers take a ring geometry: ``csrc/``'s) or whole windows (an older
source, whose launchers take an ``smem`` flag: both windows staged whole
into shared memory, or read in place).  A whole-window source is built
through a probe file (``WHOLE_PROBE``) that includes it and adds its lanes
an SM and a clocked launch of its staging alone.  DIR may be
``damapper_tpu_torch/csrc`` itself, or a parent's copy of it under the
gitignored ``build/`` (``git show``).  Every source is built with nvcc for
sm_90a into its own library under ``build/ab/`` (all builds started
together).

For every wave kernel of every build it prints ptxas's registers and spill
bytes, its SASS instruction count, in its wave loop (the longest loop of
the SASS) the instructions and the ``BAR`` instructions by kind, and
whether its SASS instructions equal the first build's (``same SASS``: a
kernel whose source did not change must compile to the same code).  The
SASS of each W=128 plain kernel and of the forward persistent plain
kernels goes to ``--out``'s directory when ``--out`` is given.  For every build with persistent kernels it prints the
lanes an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) for each
layout, direction and route at L = 2,048 to 131,072, and for a
whole-window build the SM cycles its staging takes on each lane set (block
start to the barrier after the staging, the staging code of its kernel in
a launch of the same shape with no wave behind it; median and max over the
blocks).

Then the same lanes go through every build and case in interleaved rounds.
For each ``--nlanes`` N, N lanes of 3-9 kb reads at ~15% error from
``--seed`` (128: chip smoke's phase-3 lanes; 1024: about a round of
BASELINE config 1's main path; 4096-16384: rounds of read blocks of tens of
thousands of reads): the classic plain and packed kernels at W=128 and W=64
(rows 1-2; plain at W=64, one lane to a 64-thread block, is also row 3),
and, for a build with persistent kernels, the persistent kernels at W=64
with the reads' window (rows 4-6: plain, which is also row 6, and packed),
both directions, by each route of the build's design (whole windows:
``smem`` and ``global``; ring: one route for each ``--rings`` geometry,
``C:K`` for K chunks of C bytes a window, or ``whole`` for the whole
window as 32 chunks, at most 227 KB a block); and the persistent plain
kernel on each ``--long`` count of 40-45 kb reads (L=65536, pool 2048:
long windows) by the same routes.  A route that a build's launch refuses
(a window too large for its shared memory) is left out.  Each round times
``--reps`` launches per build and case with CUDA events; the median over
rounds is printed per build and case, with the card's name and power
limit.  All builds, routes and geometries must give identical outputs.
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
KERNELS = ("wave_lanes_dense_kernel", "wave_lanes_kernel",
           "persistent_kernel")
LONG_P = 2048       # the pool of the long lanes (utils/sim.py)
OCC_L = (2048, 16384, 32768, 65536, 131072)   # window lengths of the report

# Built in place of a whole-window wave_persistent.cu (it includes it): the
# lanes an SM holds by route, and the kernel's staging launched alone.
WHOLE_PROBE = r"""
#include "wave_persistent.cu"

namespace {
__global__ void __launch_bounds__(64)
ab_stage_kernel(const int* awst, const int* bwst, const uint8_t* A,
                long long LA, const uint8_t* B, long long LB, int L,
                long long* cycles) {
  extern __shared__ __align__(16) uint8_t ab_win[];
  const long long t0 = clock64();
  make_window<true>(ab_win, A, LA, B, LB, awst[blockIdx.x], bwst[blockIdx.x],
                    L, threadIdx.x, 64);
  __syncthreads();
  if (threadIdx.x == 0) cycles[blockIdx.x] = clock64() - t0;
}

template <class K>
cudaError_t ab_occ(K kern, size_t dyn, int* lanes) {
  *lanes = 0;
  if (dyn > 0 && cudaFuncSetAttribute(
                     kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                     (int)dyn) != cudaSuccess) {
    cudaGetLastError();
    return cudaSuccess;   // the route refuses this window: 0 lanes
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(lanes, kern, 64, dyn);
}

template <class IO>
cudaError_t ab_occ_io(int reverse, int smem, size_t dyn, int* lanes) {
  if (reverse)
    return smem ? ab_occ(persistent_kernel<64, true, true, IO>, dyn, lanes)
                : ab_occ(persistent_kernel<64, true, false, IO>, 0, lanes);
  return smem ? ab_occ(persistent_kernel<64, false, true, IO>, dyn, lanes)
              : ab_occ(persistent_kernel<64, false, false, IO>, 0, lanes);
}
}  // namespace

extern "C" int wave_ab_occupancy(int packed, int reverse, int smem, int L,
                                 int* lanes) {
  const size_t dyn = smem ? 2 * (size_t)L : 0;
  return (int)(packed ? ab_occ_io<PackedIO>(reverse, smem, dyn, lanes)
                      : ab_occ_io<SplitIO>(reverse, smem, dyn, lanes));
}

extern "C" int wave_ab_stage(const int* awst, const int* bwst,
                             const uint8_t* A, long long LA, const uint8_t* B,
                             long long LB, int n, int L, long long* cycles,
                             void* stream) {
  const size_t dyn = 2 * (size_t)L;
  cudaError_t e = cudaFuncSetAttribute(
      ab_stage_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dyn);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return (int)e;
  }
  ab_stage_kernel<<<n, 64, dyn, static_cast<cudaStream_t>(stream)>>>(
      awst, bwst, A, LA, B, LB, L, cycles);
  return (int)cudaGetLastError();
}
"""


def _nvcc():
    cuda = pathlib.Path("/usr/local/cuda/bin")
    return (str(cuda / "nvcc") if (cuda / "nvcc").exists() else "nvcc",
            str(cuda / "cuobjdump") if (cuda / "cuobjdump").exists()
            else "cuobjdump")


def is_ring(src_dir: pathlib.Path) -> bool:
    """Whether src_dir's wave_persistent.cu is of the ring design."""
    return "wave_persistent_occupancy" in \
        (src_dir / "wave_persistent.cu").read_text()


def build(src_dir: pathlib.Path, name: str, src: str = "wave.cu"):
    """nvcc src_dir/<src> -> build/ab/<name>/lib<stem>.so; returns (path,
    ptxas report).  A whole-window wave_persistent.cu is built through
    WHOLE_PROBE."""
    from ..ops.wave_cuda import NVCC_FLAGS
    out = REPO / "build" / "ab" / name
    out.mkdir(parents=True, exist_ok=True)
    so = out / ("lib" + pathlib.Path(src).stem + ".so")
    extra = src_dir / "nvcc_flags"
    extra = extra.read_text().split() if extra.exists() else []
    path = src_dir / src
    if src == "wave_persistent.cu" and not is_ring(src_dir):
        path = out / "whole_probe.cu"
        path.write_text(WHOLE_PROBE)
        extra = extra + ["-I", str(src_dir)]
    r = subprocess.run([_nvcc()[0], *NVCC_FLAGS, *extra, "-Xptxas", "-v",
                        "-o", str(so), str(path)],
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
    lay = "packed" if "PackedIO" in args else "plain"
    W = int(w.group(1)) if w else (128 if "dense" in name else 64)
    rev = "rev" if bits and bits[0] == "1" else "fwd"
    mode = "persistent" if name.startswith("persistent") else "classic"
    extra = ""
    if mode == "persistent" and len(bits) > 1:    # a whole-window build
        extra = " smem" if bits[1] == "1" else " global"
    if "dense" in name:
        extra = " dense"
    return f"{mode} {lay} W{W} {rev}{extra}"


def ring_geometry(route, L):
    """(chunk bytes, slots) of a ring route: "C:K", or "whole" (the window
    as 32 chunks, 128 bytes or more each)."""
    if route == "whole":
        chunk = max(128, L // 32)
        return chunk, L // chunk
    c, k = route.split(":")
    return int(c), int(k)


def cases(nlanes, routes, nlong=(8,)):
    """The cases (N, mode, layout, W, reverse, route) a build is timed in:
    rows 1-2 at W=128 and 64 for each N (plain W=64 is row 3), the
    persistent rows 4-6 (plain, also row 6, and packed) by each of the
    build's persistent routes (none: no persistent kernels), and the long
    lanes, "long<n>" for each count n of nlong, plain by each route."""
    out = []
    for n in nlanes:
        for rev in (False, True):
            out += [(n, "classic", lay, W, rev, "")
                    for lay in ("plain", "packed") for W in (128, 64)]
            out += [(n, "persistent", lay, 64, rev, route)
                    for lay in ("plain", "packed") for route in routes]
    for n in nlong if routes else ():
        for rev in (False, True):
            out += [(f"long{n}", "persistent", "plain", 64, rev, route)
                    for route in routes]
    return out


def _bind_whole(lib):
    """The C signatures of a whole-window build (launchers with an smem
    flag) and of WHOLE_PROBE's functions; returns lib."""
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    seqargs, tail = [P, LL, P, LL], [P, P, P]
    lib.wave_persistent_launch.argtypes = [P] * 8 + seqargs + [I] * 11 + tail
    lib.wave_persistent_packed_launch.argtypes = \
        [P] + seqargs + [I] * 11 + tail
    lib.wave_ab_occupancy.argtypes = [I] * 4 + [P]
    lib.wave_ab_stage.argtypes = [P, P] + seqargs + [I, I, P, P]
    for fn in (lib.wave_persistent_launch, lib.wave_persistent_packed_launch,
               lib.wave_ab_occupancy, lib.wave_ab_stage):
        fn.restype = ctypes.c_int
    return lib


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--nlanes", type=int, nargs="+", default=[128])
    ap.add_argument("--long", type=int, nargs="+", default=[8],
                    help="counts of 40-45 kb lanes (L=65536)")
    ap.add_argument("--rings", nargs="+", default=None,
                    help="ring geometries C:K or whole (default: the "
                    "wrapper's RING_CHUNK:RING_SLOTS)")
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

    rings = args.rings or [f"{wave_persistent.RING_CHUNK}:"
                           f"{wave_persistent.RING_SLOTS}"]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    dirs = [pathlib.Path(d).resolve() for d in args.dirs]
    names = [f"{i}_{d.name}" for i, d in enumerate(dirs)]
    pers = [(d / "wave_persistent.cu").exists() for d in dirs]
    ring = [p and is_ring(d) for d, p in zip(dirs, pers)]
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
        for n in args.long if any(pers) else ():
            sets[f"long{n}"] = make_long_lane_cases(args.seed + 2, n)[:2]
        for n, (seqmem, insts) in sets.items():
            lanes = lanes_from_numpy(insts, seqmem, dev)
            L = wave_persistent.window_length(max(s["blen"] for s in insts))
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
    libs, static, first, occupancy, stage = {}, {}, {}, {}, {}
    for nm, (wb, pb), rg in zip(names, built, ring):
        lib = wave_cuda.bind(ctypes.CDLL(str(wb[0])))
        plib = None
        if pb:
            plib = ctypes.CDLL(str(pb[0]))
            plib = wave_persistent.bind(plib) if rg else _bind_whole(plib)
        libs[nm] = (lib, plib, tuple(rings) if rg else
                    ("smem", "global") if pb else ())
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
                # None: the first build has no kernel of this name and
                # template arguments
                same = (None if key not in first and nm != names[0]
                        else first.setdefault(key, dig) == dig)
                static[f"{nm} {label}"] = dict(
                    registers=r, spill_stores=st, spill_loads=ld, sass=cnt,
                    wave_loop=len(wl), wave_loop_bar=bars, sass_digest=dig,
                    same_sass_as_first=same)
                print(f"{nm}: {label}: {r} registers, spills {st}/{ld} bytes "
                      f"(stores/loads), {cnt} SASS instructions, wave loop "
                      f"{len(wl)} with BAR {bars}"
                      + ("" if nm == names[0] else
                         f", not in {names[0]}" if same is None else
                         f", {'same SASS as' if same else 'SASS differs from'}"
                         f" {names[0]}"))
                if outdir and label.startswith(("classic plain W128",
                                                "persistent plain W64 fwd")) \
                        and "dense" not in label:
                    (outdir / f"sass_{nm}_{label.replace(' ', '_')}.txt") \
                        .write_text(text)
        if plib is not None:
            occupancy[nm] = _lanes_per_sm(plib, rg, libs[nm][2])
            for k, v in occupancy[nm].items():
                print(f"{nm}: lanes an SM, {k}: " + ", ".join(
                    f"L={L} {n}" for L, n in v.items()))

    spec = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
    consts = (spec.trace_space, spec.ave_path, spec.mscore, spec.dscore)
    stream = torch.cuda.current_stream(dev).cuda_stream

    for nm, (_, plib, _) in libs.items():     # a whole build's staging
        if plib is None or not hasattr(plib, "wave_ab_stage"):
            continue
        stage[nm] = {}
        for n, sh in shapes.items():
            A = sh["lanes"]["A"]
            for rev, w in sh["win"].items():
                cyc = torch.zeros(sh["n"], dtype=torch.int64, device=dev)
                rc = plib.wave_ab_stage(
                    w["awst"].data_ptr(), w["bwst"].data_ptr(), A.data_ptr(),
                    A.shape[0], A.data_ptr(), A.shape[0], sh["n"], sh["L"],
                    cyc.data_ptr(), stream)
                if rc != 0:
                    raise RuntimeError(f"{nm}: staging probe failed: {rc}")
                torch.cuda.synchronize()
                c = cyc.cpu().numpy()
                key = f"n{n}_{'rev' if rev else 'fwd'}_L{sh['L']}"
                stage[nm][key] = dict(median_cycles=float(np.median(c)),
                                      max_cycles=int(c.max()))
                print(f"{nm}: staging {key}: median {np.median(c):.0f}, "
                      f"max {int(c.max())} cycles")

    def launch(nm, case, bufs=None):
        n, mode, lay, W, rev, route = case
        sh = shapes[n]
        P = LONG_P if str(n).startswith("long") else 512
        lib, plib, _ = libs[nm]
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
            else:
                rc = lib.wave_lanes_launch(*ptrs, *seq, nl, W, P, int(rev),
                                           *tail)
        else:
            w = sh["win"][rev]
            L = sh["L"]
            geo = ((int(route == "smem"),) if route in ("smem", "global")
                   else ring_geometry(route, L))
            ptrs = [w[f].data_ptr() for f in IN_FIELDS + ("awst", "bwst")]
            if lay == "packed":
                rc = plib.wave_persistent_packed_launch(
                    sh["wrec"][rev].data_ptr(), *seq, nl, W, P, L, int(rev),
                    *geo, *tail)
            else:
                rc = plib.wave_persistent_launch(*ptrs, *seq, nl, W, P, L,
                                                 int(rev), *geo, *tail)
        if rc != 0:
            raise RuntimeError(f"{nm}: launch failed on {case}: {rc}")
        return out, pool

    def cases_of(nm):
        return cases(args.nlanes, libs[nm][2], args.long)

    def avail(out, lay):
        i = OUT_FIELDS.index("avail")
        return out[:, i] if lay == "packed" else out[i]

    def fn_of(case):
        """The function a case computes: the layout's output shape and the
        mode (a window miss flags overflow where the classic kernel goes
        on), not the route, the geometry or the build."""
        n, mode, lay, W, rev, _ = case
        return (n, mode, lay, W, rev)

    ref, skip = {}, set()
    for nm in libs:                  # warm-up and the identity check
        for case in cases_of(nm):
            try:
                out, pool = launch(nm, case)
            except RuntimeError:
                if case[1] != "persistent" or case[5] == "global":
                    raise
                # this route's shared memory does not hold the window
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
                     < avail(ro, case[2])[:, None])[:, :, None]
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
                       "long": args.long, "rings": rings,
                       "rounds": args.rounds, "reps": args.reps,
                       "static": static, "lanes_per_sm": occupancy,
                       "stage": stage, "builds": res})
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0


def _lanes_per_sm(plib, ring, routes):
    """{"<layout> <dir> <route>": {L: lanes an SM}} of one build's
    persistent kernels at the window lengths OCC_L."""
    out = {}
    for packed in (0, 1):
        for rev in (0, 1):
            for route in routes:
                row = {}
                for L in OCC_L:
                    lanes = ctypes.c_int(0)
                    if ring:
                        rc = plib.wave_persistent_occupancy(
                            packed, rev, L, *ring_geometry(route, L),
                            ctypes.byref(lanes))
                    else:
                        rc = plib.wave_ab_occupancy(
                            packed, rev, int(route == "smem"), L,
                            ctypes.byref(lanes))
                    if rc != 0:
                        raise RuntimeError(f"occupancy query failed: {rc}")
                    row[L] = lanes.value
                out[f"{'packed' if packed else 'plain'} "
                    f"{'rev' if rev else 'fwd'} {route}"] = row
    return out


if __name__ == "__main__":
    sys.exit(main())

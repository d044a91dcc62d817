"""A/B of builds of the op-cost probe kernels (rows 7-8) on one card.

    python3 -m damapper_tpu_torch.tools.probe_ab DIR [DIR ...]
        [--niter-floor 20000] [--niter-ops 3000] [--out FILE]

Each DIR holds a ``probes.cu`` with the C signatures of ``csrc/probes.cu``
and the ``wave_body.cuh`` it includes: ``damapper_tpu_torch/csrc`` itself,
or a copy under the gitignored ``build/`` (a parent's from ``git show``, or
a variant of this tree's made with ``sed``).  A DIR may hold a file
``nvcc_flags`` of extra nvcc arguments.  Every DIR is built with nvcc for
sm_90a into ``build/ab/<i>_<dir>/libprobes.so`` (all builds started
together).

For every probe kernel of every build it prints ptxas's registers and spill
bytes, its SASS instruction count, the instructions in its loops with their
``BAR``, ``SHFL``, ``REDUX``, ``VOTE``, ``LDS`` and ``STS`` counts, its SASS
digest, and whether that equals the first build's kernel of the same
pattern, W and barrier policy (``same SASS``: a kernel whose source did not
change must compile to the same code); with --out, each build's SASS goes
beside the records as ``<i>_<dir>.sass``.

Then it times, in turns, every build under every barrier policy its
launchers serve (a launch refused with cudaErrorInvalidValue is not served)
at every shape and pattern of the floor and ops tools
(``tools/floor_probe.py``, ``tools/ops_probe.py``): the slope of niter and
5·niter iterations with CUDA events after a warm-up, as the tools time.
Every build and policy must return the same outputs on the same seeded
int32 inputs.  Records (JSON lines, printed, and appended to --out when
given) carry the card's name and power limit, ms (the niter launch), µs
per iteration and ns per application (floor: per quad).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import pathlib
import re
import sys

from .floor_probe import SHAPES as FLOOR_SHAPES
from .ops_probe import SHAPES as OPS_SHAPES
from .probe_run import card, emit, open_card, out_file, slope
from .wave_ab import (bar_counts, build, loop_ops, ptxas_report, sass_counts,
                      sass_digest)

CUDA_ERROR_INVALID_VALUE = 1
LOOP_OPS = ("SHFL", "REDUX", "VOTE", "LDS", "STS")


def kernel_key(sym, names):
    """(kind, pattern, W, barrier) of a probe kernel's symbol, or None;
    names maps each kind to its patterns (``_probe_names`` order)."""
    m = re.search(r"(floor|ops|carry)(_warp)?_kernel", sym)
    if not m:
        return None
    bar = "warp" if m.group(2) else "block" if "BlockBar" in sym else None
    if bar is None:
        return None   # a policy this tree no longer has
    kind = m.group(1)
    lits = re.findall(r"L[ib](\d+)E", sym)
    return kind, names[kind][int(lits[-1])], int(lits[0]), bar


def sass_report(sass, report, names):
    """{kernel key: dict of registers, spills, counts, loop counts and
    digest} of a build, from its ``sass_counts`` and ptxas report."""
    regs = {}
    for sym, r in ptxas_report(report).items():
        key = kernel_key(sym, names)
        if key:
            regs[key] = r
    out = {}
    for sym, (cnt, text) in sass.items():
        key = kernel_key(sym, names)
        if key is None:
            continue
        ops = loop_ops(text)
        out[key] = dict(
            regs=regs.get(key, (None, None, None))[0],
            spills=regs.get(key, (None, 0, 0))[1:], instructions=cnt,
            loop=len(ops), loop_bar=bar_counts(ops),
            bar=bar_counts(text.splitlines()),
            **{op: sum(bool(re.search(r"\b" + op, ln)) for ln in ops)
               for op in LOOP_OPS},
            digest=sass_digest(text))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--niter-floor", type=int, default=20000)
    ap.add_argument("--niter-ops", type=int, default=3000)
    ap.add_argument("--nops", type=int, default=96)
    ap.add_argument("--reps", type=int, default=28)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--out", default=None, help="append the records here")
    args = ap.parse_args(argv)
    torch = open_card("probe_ab")
    if torch is None:
        return 2
    import numpy as np

    from ..ops import probes

    names = {"floor": probes.FLOOR_VARIANTS, "ops": probes.OPS_PATTERNS,
             "carry": probes.CARRY_BODIES}
    dirs = [pathlib.Path(d).resolve() for d in args.dirs]
    tags = [f"{i}_{d.name}" for i, d in enumerate(dirs)]
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as ex:
        built = list(ex.map(lambda a: build(a[0], a[1], "probes.cu"),
                            zip(dirs, tags)))
    info = card(torch)
    fh = out_file(args.out)
    libs, reports = {}, {}
    for tag, (so, report) in zip(tags, built):
        libs[tag] = probes.bind(ctypes.CDLL(str(so)))
        sass = sass_counts(so)
        reports[tag] = sass_report(sass, report, names)
        if fh is not None:   # the build's SASS beside the records
            pathlib.Path(args.out).with_name(f"{tag}.sass").write_text(
                "".join(f"Function : {sym}\n{text}\n"
                        for sym, (_, text) in sorted(sass.items())))
    first = reports[tags[0]]
    for tag in tags:
        for key, r in sorted(reports[tag].items()):
            same = "same SASS" if first.get(key, {}).get("digest") \
                == r["digest"] else ("-" if key not in first
                                     else "SASS differs")
            print(f"{tag} {' '.join(map(str, key))}: {r['regs']} regs, "
                  f"spills {r['spills']}, {r['instructions']} instructions,"
                  f" {r['loop']} in loops (BAR {r['loop_bar']}, "
                  + ", ".join(f"{op} {r[op]}" for op in LOOP_OPS)
                  + f"), BAR in the kernel {r['bar']}, digest "
                  f"{r['digest']}, {same}", flush=True)
            if fh is not None:
                fh.write(json.dumps(dict(build=tag, kernel=list(key), **r))
                         + "\n")

    dev = torch.device("cuda")
    rng = np.random.default_rng(args.seed)

    def ints(shape):
        return torch.from_numpy(rng.integers(-2**31, 2**31, shape,
                                             dtype=np.int64)
                                .astype(np.int32)).to(dev)

    def launcher(lib, kind, name, bid, x, s, xo, so):
        G, W = x.shape
        st = torch.cuda.current_stream(dev).cuda_stream
        if kind == "floor":
            return lambda n: lib.probe_floor_launch(
                x.data_ptr(), xo.data_ptr(), G, W, bid, int(name == "add"),
                n, args.nops // 4, st)
        return lambda n: lib.probe_ops_launch(
            x.data_ptr(), s.data_ptr(), xo.data_ptr(), so.data_ptr(), G, W,
            bid, probes.OPS_PATTERNS.index(name), n, args.reps, st)

    cases = [("floor", v, G, W, args.niter_floor)
             for v, shapes in FLOOR_SHAPES.items() for G, W in shapes]
    cases += [("ops", p, G, W, args.niter_ops)
              for G, W in OPS_SHAPES for p in probes.OPS_PATTERNS]
    try:
        for kind, name, G, W, niter in cases:
            x, s = ints((G, W)), ints((G, 1))
            want = None
            for tag in tags:
                for barrier, bid in probes.BARRIERS.items():
                    xo, so = torch.empty_like(x), torch.empty_like(s)
                    go = launcher(libs[tag], kind, name, bid, x, s, xo, so)
                    rc = go(niter)
                    if rc == CUDA_ERROR_INVALID_VALUE:
                        continue   # the build does not serve this policy
                    if rc != 0:
                        raise RuntimeError(f"probe_ab: {tag} {kind} {name} "
                                           f"{barrier} launch failed: {rc}")
                    torch.cuda.synchronize()
                    got = (xo.clone(), so.clone() if kind == "ops" else None)
                    if want is None:
                        want = got
                    elif not (torch.equal(got[0], want[0]) and (
                            kind == "floor" or torch.equal(got[1],
                                                           want[1]))):
                        raise RuntimeError(f"probe_ab: {tag} {kind} {name} "
                                           f"G={G} W={W} {barrier}: outputs "
                                           f"differ from the first build's")
                    ms, per_iter = slope(torch, go, niter)
                    apps = (probes.butterfly_apps(args.reps)
                            if name == "butterfly" else args.reps) \
                        if kind == "ops" else args.nops // 4
                    emit({"build": tag, "kind": kind, "name": name, "G": G,
                          "W": W, "barrier": barrier, "niter": niter,
                          "ms": ms, "us_per_iter": 1e6 * per_iter,
                          "ns_per_app": 1e9 * per_iter / apps, **info,
                          "bound_ms": probes.bound_ms(
                              kind, name, G, W, niter, args.nops,
                              args.reps)[0]}, fh)
    finally:
        if fh is not None:
            fh.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Floors of the seed match's sorts, scans and merge at the join's sizes.

    python -m damapper_tpu_torch.tools.sort_floor [nq_millions]
        [m_millions] [hits_millions] [--reps 3] [--out FILE] [--device cpu]

Times, at the sizes of one read block's join (nq: both orientations' query
k-mers, default 100 M; m: the reference's k-mers, default 140 M; hits: the
hits both orientations emit, default 2.4 M; tools/join_ab.py prints the
real ones of the 50k block), the passes the port's device index and join
actually run (ops/device_index.py), on seeded random 40-bit k-mer keys:

  sort_key_pos_2   _sort_key_pos: (key, pos) by two stable passes (pos,
                   then key), at the reference index's m rows;
  sort_key_pos_1   the same with pos already ascending (one stable pass);
  sort_nq_m        the combined stable key sort of the scan and sortg
                   joins, nq + m rows;
  sort_2nq_m       the combined stable key sort of the sort join (q, q+1
                   and b), 2 nq + m rows;
  lex_composite    _lex_order's hit sort with one composite int64 key
                   (aread, bread, apos: widths that fit 63 bits);
  lex_passes       _lex_order's stable passes (four 20-bit columns);
  cumsum, cummax   int32 scans at nq + m rows;
  bitonic_merge    _bitonic_merge of sorted q ++ pad ++ reversed sorted b,
                   the merge join, at the power of two above nq + m.

Every sort's output is checked sorted and equal to torch.sort's (and the
merge's and the lex orders' too), each scan against its own definition.
Each pass: the best of --reps synchronized calls after a warm-up, the
bytes it must move (each input read once, each output written once), its
floor at the card's 3.35 TB/s (peaks.py) and max_memory_allocated; the
tensors are freed between passes.  One JSON record a pass, printed and
appended to --out.  The floors summed over the passes an index program
runs bound that program.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import tuning


def _timed(dev, fn, reps):
    """(best seconds of reps synchronized calls after a warm-up, the last
    result)."""
    out = fn()
    best = None
    for _ in range(reps):
        del out
        tuning.sync(dev)
        t0 = time.perf_counter()
        out = fn()
        tuning.sync(dev)
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return best, out


def _sorted(x):
    import torch
    return bool(torch.all(x[1:] >= x[:-1]).item()) if len(x) > 1 else True


def passes(torch, dev, nq, m, nhits, gen):
    """[(name, rows, bytes, make, fn, check)] of every pass: make() draws
    its input, fn(input) runs it and check(input, output) holds the output
    to torch.sort's (or to the scan's definition)."""
    from ..ops import device_index as dix

    def keys(n):
        return torch.randint(0, 1 << 40, (n,), dtype=torch.int64,
                             device=dev, generator=gen)

    def perm(n):
        return torch.randperm(n, dtype=torch.int32, device=dev,
                              generator=gen)

    out = []

    def key_pos(pos_sorted):
        def make():
            k = keys(m)
            p = (torch.arange(m, dtype=torch.int32, device=dev)
                 if pos_sorted else perm(m))
            return k, p

        def check(args, res):
            k, p = args
            ks, ps = res
            # the keys sorted, the positions ascending within a key, and
            # every output pair an input pair (positions are 0..m-1)
            key_at = torch.empty_like(k)
            key_at[p.to(torch.int64)] = k
            tie = (ks[1:] == ks[:-1]) & (ps[1:] < ps[:-1])
            return (torch.equal(ks, torch.sort(k).values)
                    and not bool(tie.any())
                    and torch.equal(key_at[ps.to(torch.int64)], ks)
                    and torch.equal(torch.sort(ps).values, torch.arange(
                        m, dtype=ps.dtype, device=dev)))
        return make, (lambda a: dix._sort_key_pos(*a, pos_sorted)), check

    for nm, ps in (("sort_key_pos_2", False), ("sort_key_pos_1", True)):
        make, fn, check = key_pos(ps)
        out.append((nm, m, 2 * m * 12, make, fn, check))

    def combined(n):
        def check(k, res):
            vals, idx = res
            return (_sorted(vals) and torch.equal(vals, torch.sort(k).values)
                    and torch.equal(k[idx], vals))
        return (lambda: keys(n), lambda k: torch.sort(k, stable=True), check)

    for nm, n in (("sort_nq_m", nq + m), ("sort_2nq_m", 2 * nq + m)):
        make, fn, check = combined(n)
        out.append((nm, n, n * (8 + 8 + 8), make, fn, check))

    def lex(bits):
        def make():
            return [torch.randint(0, 1 << b, (nhits,), dtype=torch.int32,
                                  device=dev, generator=gen) for b in bits]

        def check(cols, o):
            comp = torch.zeros(nhits, dtype=torch.int64, device=dev)
            ok = True
            # lexicographic order, column by column from the major one
            eq = torch.ones(nhits - 1, dtype=torch.bool, device=dev)
            for c in cols:
                c = c[o]
                ok = ok and not bool((eq & (c[1:] < c[:-1])).any())
                eq = eq & (c[1:] == c[:-1])
            if sum(bits) <= 63:
                for c, b in zip(cols, bits):
                    comp = (comp << b) | c.to(torch.int64)
                ok = ok and torch.equal(comp[o], torch.sort(comp).values)
            return ok and torch.equal(torch.sort(o).values, torch.arange(
                nhits, device=dev))
        return make, (lambda cols: dix._lex_order(cols, bits)), check

    for nm, bits in (("lex_composite", [17, 12, 15]),
                     ("lex_passes", [20, 20, 20, 20])):
        make, fn, check = lex(bits)
        out.append((nm, nhits, nhits * (4 * len(bits) + 8), make, fn,
                    check))

    n2 = nq + m

    def scan_check(op):
        def check(x, res):
            vals = res if op == "cumsum" else res.values
            xs = x.cpu().numpy()
            ref = np.cumsum(xs) if op == "cumsum" else \
                np.maximum.accumulate(xs)
            return np.array_equal(vals.cpu().numpy(), ref)
        return check

    def small():
        return torch.randint(0, 4, (n2,), dtype=torch.int32, device=dev,
                             generator=gen)
    out.append(("cumsum", n2, n2 * 8, small,
                lambda x: torch.cumsum(x, 0, dtype=torch.int32),
                scan_check("cumsum")))
    out.append(("cummax", n2, n2 * (4 + 4 + 8),
                lambda: perm(n2), lambda x: torch.cummax(x, 0),
                scan_check("cummax")))

    npow = dix._pow2_above(n2)

    def merge_make():
        q = torch.sort(keys(nq)).values
        b = torch.sort(keys(m)).values
        k = torch.cat([q, torch.full((npow - n2,), dix.SENT,
                                     dtype=torch.int64, device=dev),
                       b.flip(0)])
        return k, torch.arange(npow, dtype=torch.int32, device=dev)

    def merge_check(args, res):
        k, _ = args
        ks, ps = res
        return (_sorted(ks) and torch.equal(ks, torch.sort(k).values)
                and torch.equal(k[ps.to(torch.int64)], ks))
    out.append(("bitonic_merge", npow, npow * 12 * 2, merge_make,
                lambda a: dix._bitonic_merge(*a), merge_check))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("nq", type=float, nargs="?", default=100)
    ap.add_argument("m", type=float, nargs="?", default=140)
    ap.add_argument("hits", type=float, nargs="?", default=2.4)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    import torch
    from ..peaks import HBM_BYTES_PER_S
    dev = tuning.open_device(args.device)
    info = tuning.card_info(dev)
    nq, m, nhits = (int(x * 1e6) for x in (args.nq, args.m, args.hits))
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    print(f"sort floors on {info}: nq {nq:,}, m {m:,}, hits {nhits:,}",
          flush=True)
    bad = []
    for name, rows, nbytes, make, fn, check in passes(torch, dev, nq, m,
                                                      nhits, gen):
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        inp = make()
        s, res = _timed(dev, lambda: fn(inp), args.reps)
        ok = bool(check(inp, res))
        rec = dict(pass_=name, rows=rows, seconds=s, bytes=nbytes,
                   bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
                   output_ok=ok,
                   max_memory_allocated=(torch.cuda.max_memory_allocated()
                                         if dev.type == "cuda" else None),
                   nq=nq, m=m, hits=nhits, **info, ts=time.time())
        rec["pass"] = rec.pop("pass_")
        print(f"{name}: {rows:,} rows, {1e3 * s:.3f} ms, floor "
              f"{rec['bound_ms']:.3f} ms ({nbytes:,} bytes), output "
              f"{'right' if ok else 'WRONG'}, "
              f"max_memory_allocated {rec['max_memory_allocated']}",
              flush=True)
        print(json.dumps(rec), flush=True)
        tuning.append_rows(args.out, [rec])
        if not ok:
            bad.append(name)
        del inp, res
    if bad:
        print(f"outputs differ: {bad}", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

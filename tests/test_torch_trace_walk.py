"""The wave engine's native trace walk (ops.trace_walk over
native/trace_walk.cpp) against the plain walk of ops.wave, element for
element: on every pass of the engine's cases, on a seeded fuzz of synthetic
pools that reaches each branch of the walk, and on malformed chains; and
the engine without the native library."""

import jax.numpy as jnp
import numpy as np
import pytest

from damapper_tpu.ops.wave_pallas import PallasWaveEngine
from damapper_tpu_torch import native
from damapper_tpu_torch.ops import trace_walk as tw
from damapper_tpu_torch.ops import wave as host
from damapper_tpu_torch.ops import wave_engine as twe
from damapper_tpu_torch.utils import spans
from damapper_tpu_torch.utils.sim import make_lane_cases
from tests.test_torch_engine import (SPEC, T_SPEC, _clip_cases, _oracle,
                                     _same_paths)

TS = 100


def _case(case):
    if case == "err15":
        return (*make_lane_cases(1005, 4, err=0.15), 64)
    if case == "err30":
        return (*make_lane_cases(1000, 4, err=0.30), 64)
    if case == "boundary":
        return (*make_lane_cases(2000, 4, glen=2600, rlen=2500), 64)
    if case == "flags":
        # plain, COMP and ACOMP lanes (the reporter sets one flag or
        # none): the trace lines' phase on the complemented side, and
        # finalize's flips and pair reversals
        seqmem, insts = make_lane_cases(1007, 9, err=0.15, mix=True)
        for i, s in enumerate(insts):
            s["flags"] = i % 3
        return seqmem, insts, 64
    return (*_clip_cases(), 128)


def _run(seqmem, insts, band):
    spans.begin_call()
    got, eng = twe.local_alignment_batch(T_SPEC, seqmem, seqmem, insts,
                                         device="cpu", host_min=0,
                                         band_cap=band)
    return got, eng, spans.end_call()["counts"]


def _same_arrays(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["err15", "err30", "boundary", "clip",
                                  "flags"])
def test_native_walk_is_the_plain_walk_on_the_engines_cases(case,
                                                            monkeypatch):
    """Every pass of the round (the redo rounds' too) walked both ways
    gives the same arrays; the engine's output equals the plain-walk
    engine's, and on the flags case the JAX engine's and the oracle's (the
    other cases' are held to them in test_torch_engine.py)."""
    seqmem, insts, band = _case(case)
    passes = []
    walk = twe.WaveEngine._walk

    def both(fn, lib, pool, lanes, *args):
        assert lib is not None
        got = walk(fn, lib, pool, lanes, *args)
        _same_arrays(got, fn(None, pool, lanes, *args))
        passes.append(fn.__name__)
        return got

    monkeypatch.setattr(twe.WaveEngine, "_walk", staticmethod(both))
    got, _, counts = _run(seqmem, insts, band)
    monkeypatch.undo()
    assert passes[:2] == ["forward", "reverse"]
    if case == "err30":
        assert passes == ["forward", "reverse", "forward", "reverse"]
    assert counts["engine.walk_native_lanes"] == counts[
        "engine.walk_lanes"] > 0

    monkeypatch.setattr(native, "trace_lib", _no_lib)
    plain, eng, _ = _run(seqmem, insts, band)
    assert eng._tlib is False
    for i in range(len(insts)):
        assert _same_paths(got[i], plain[i]), f"lane {i}"
        assert all(type(v) is int for p in got[i] for v in
                   (p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs, *p.trace))
    if case == "flags":
        jeng = PallasWaveEngine(SPEC, band_cap=band, pool_cap=2048,
                                use_pallas=False)
        jeng.host_min = 0
        dev = jnp.asarray(seqmem)
        jgot = jeng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
        for i, s in enumerate(insts):
            assert _same_paths(got[i], jgot[i]), f"lane {i} vs JAX engine"
            assert _same_paths(got[i], _oracle(seqmem, s)), f"lane {i}"


def _no_lib():
    raise OSError("no C++ toolchain")


def test_engine_falls_back_to_the_plain_walk(monkeypatch):
    """Without the native library the engine walks with ops.wave's plain
    walk: the same paths, and no lane counted as native."""
    seqmem, insts, band = _case("err30")
    got, eng, counts = _run(seqmem, insts, band)
    assert eng._tlib is not False
    monkeypatch.setattr(native, "trace_lib", _no_lib)
    plain, peng, pcounts = _run(seqmem, insts, band)
    assert peng._tlib is False
    assert pcounts["engine.walk_native_lanes"] == 0
    assert pcounts["engine.walk_lanes"] == counts["engine.walk_lanes"] > 0
    for i in range(len(insts)):
        assert _same_paths(got[i], plain[i]), f"lane {i}"


# ---- the walk on synthetic pools ----

def _link(pool, chain):
    pool[chain[0], 0] = -1
    for prev, h in zip(chain[:-1], chain[1:]):
        pool[h, 0] = prev


def _ends(cells, chain, sign, mida):
    """(b + s * k, b) where each walk's last pebble leaves them: the
    forward walk's and the reverse walk's (s = +1 for A, -1 for B)."""
    k0, kl = int(cells[chain[0], 1]), int(cells[chain[-1], 1])
    if len(chain) == 1:
        bf = (mida - sign * k0) // 2
        br = int(cells[chain[0], 3]) - sign * k0
    else:
        bf = br = int(cells[chain[-1], 3]) - sign * kl
    return [(bf + sign * kl, bf), (br + sign * kl, br)]


def _fuzz(seed, nlanes=600, top=48):
    """A pool of random pebbles with two chains a lane (one to eight
    pebbles, small or wide values), and trim points, trace-line phases and
    forward traces drawn to reach each branch of both walks: ends on and
    off the last pebble's antidiagonal and b, the junction on and off the
    trace line, empty and non-empty forward traces."""
    rng = np.random.default_rng(seed)
    pool = np.empty((nlanes, top, 4), np.int32)
    lanes = []
    for i in range(nlanes):
        span = 3000 if rng.random() < 0.5 else 200_000
        pool[i] = rng.integers(-span, span, (top, 4))
        pool[i, :, 0] = rng.integers(-1, top, top)
        perm = rng.permutation(top)
        la, lb = (int(rng.choice([1, 1, 2, 3, 8])) for _ in range(2))
        ca, cb = perm[:la], perm[la:la + lb]
        _link(pool[i], ca)
        _link(pool[i], cb)
        mida = int(rng.integers(-span, span))
        ea = _ends(pool[i], ca, +1, mida)
        eb = _ends(pool[i], cb, -1, mida)
        xs = [e[0] for e in ea] + [e[1] for e in eb]
        ys = [e[1] for e in ea] + [e[0] for e in eb]
        tx = int(rng.choice(xs + [int(rng.integers(-span, span))]))
        ty = int(rng.choice(ys + [int(rng.integers(-span, span))]))
        aoff = (int(pool[i, ca[0], 3]) % TS if rng.random() < 0.5
                else int(rng.integers(0, TS)))
        boff = (int(pool[i, cb[0], 3]) % TS if rng.random() < 0.5
                else int(rng.integers(0, TS)))
        fa, fb = ([int(v) for v in rng.integers(0, 65536, 2 * int(
            rng.choice([0, 0, 1, 3])))] for _ in range(2))
        lanes.append(dict(trim=(tx, ty, int(rng.integers(-span, span)),
                                int(ca[-1]), int(cb[-1])),
                          mida=mida, aoff=aoff, boff=boff, fa=fa, fb=fb,
                          la=la, ea=ea, eb=eb, a0=int(ca[0])))
    return pool, lanes


def _plain_fwd(pool, i, ln):
    x, y, d, ha, hb = ln["trim"]
    low, fwd, btr = host.extract_forward_traces(pool[i], ha, hb, x, y, d,
                                                ln["mida"])
    return fwd.trace, btr, low


def _plain_rev(pool, i, ln):
    x, y, d, ha, hb = ln["trim"]
    fa, fb = list(ln["fa"]), list(ln["fb"])
    a_pre, b_pre = host.extract_reverse_traces(
        pool[i], ha, hb, x, y, d, TS, ln["aoff"], ln["boff"], fa, fb)
    return a_pre + fa, b_pre + fb


def _native(which, pool, rows, lanes):
    trim = [np.array([ln["trim"][j] for ln in lanes]) for j in range(5)]
    if which == "fwd":
        return tw.forward(native.trace_lib(), pool, rows, trim,
                          np.array([ln["mida"] for ln in lanes]))
    fa, fb = ([v for ln in lanes for v in ln[s]] for s in ("fa", "fb"))
    ends = [np.cumsum([0] + [len(ln[s]) for ln in lanes])
            for s in ("fa", "fb")]
    return tw.reverse(native.trace_lib(), pool, rows, trim, TS,
                      np.array([ln["aoff"] for ln in lanes]),
                      np.array([ln["boff"] for ln in lanes]),
                      (np.array(fa, np.int32), ends[0][:-1], ends[0][1:],
                       np.array(fb, np.int32), ends[1][:-1], ends[1][1:]))


def _split(flat, off):
    return [flat[off[k]:off[k + 1]].tolist() for k in range(len(off) - 1)]


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("which", ["fwd", "rev"])
def test_native_walk_is_the_plain_walk_on_fuzzed_pools(which, seed):
    """Lane by lane the native walk gives the plain walk's traces, or
    raises IndexError where the plain walk does (an edit of a pair that
    does not exist); then all the good lanes in one call give the same
    traces again.  Each branch is reached, and the u16 wrap."""
    pool, lanes = _fuzz(seed)
    plain = _plain_fwd if which == "fwd" else _plain_rev
    good, want, hits = [], [], dict.fromkeys(
        ("A end edit", "B end edit", "A end off", "junction, empty forward",
         "junction, forward", "on the trace line", "single pebble",
         "raises", "wraps"), 0)
    for i, ln in enumerate(lanes):
        try:
            w = plain(pool, i, ln)
        except IndexError:
            with pytest.raises(IndexError):
                _native(which, pool, np.array([i]), [ln])
            hits["raises"] += 1
            continue
        g = _native(which, pool, np.array([i]), [ln])
        assert _split(*g[:2]) == [w[0]] and _split(*g[2:4]) == [w[1]], i
        if which == "fwd":
            assert g[4].tolist() == [w[2]]
        good.append(i)
        want.append(w)
        x, y = ln["trim"][:2]
        e = 0 if which == "fwd" else 1
        hits["A end edit"] += ln["ea"][e] == (x, ln["ea"][e][1]) and \
            ln["ea"][e][1] != y
        hits["B end edit"] += ln["eb"][e] == (y, ln["eb"][e][1]) and \
            ln["eb"][e][1] != x
        hits["A end off"] += ln["ea"][e][0] != x
        junction = int(pool[i, ln["a0"], 3]) % TS != ln["aoff"]
        hits["junction, empty forward"] += junction and not ln["fa"]
        hits["junction, forward"] += junction and bool(ln["fa"])
        hits["on the trace line"] += not junction
        hits["single pebble"] += ln["la"] == 1
        hits["wraps"] += any(abs(int(v)) > 65535 for v in pool[i].ravel())
    assert min(hits.values()) >= 5, hits
    g = _native(which, pool, np.array(good), [lanes[i] for i in good])
    assert _split(*g[:2]) == [w[0] for w in want]
    assert _split(*g[2:4]) == [w[1] for w in want]


def test_malformed_chains_raise():
    """A chain that starts or steps outside the pool raises in both walks;
    a chain that loops raises in the native walk (the plain one never
    ends)."""
    pool, lanes = _fuzz(3, nlanes=1)
    ln = lanes[0]
    x, y, d, ha, hb = ln["trim"]
    top = pool.shape[1]
    for bad in (dict(ha=-1), dict(hb=top), dict(step=top)):
        p = pool.copy()
        trim = [np.array([v]) for v in
                (x, y, d, bad.get("ha", ha), bad.get("hb", hb))]
        if "step" in bad:
            p[0, ha, 0] = bad["step"]
        for lib in (native.trace_lib(), None):
            with pytest.raises(IndexError):
                tw.forward(lib, p, np.array([0]), trim, np.array([0]))
            with pytest.raises(IndexError):
                tw.reverse(lib, p, np.array([0]), trim, TS, np.array([0]),
                           np.array([0]))
    p = pool.copy()
    p[0, ha, 0] = ha
    trim = [np.array([v]) for v in (x, y, d, ha, hb)]
    with pytest.raises(IndexError, match="pool row 0"):
        tw.forward(native.trace_lib(), p, np.array([0]), trim, np.array([0]))


def test_round_traces_reverse_pairs_as_finalize_does():
    """RoundTraces.lists: each lane's trace from the newest walk that put
    it (empty when cleared or never put), its (d, b) pairs reversed where
    asked, as finalize_paths's _reverse_pairs."""
    rng = np.random.default_rng(5)
    rt = tw.RoundTraces(7)
    traces = [rng.integers(0, 65536, 2 * m).astype(np.int32)
              for m in (0, 1, 2, 5, 3, 4, 2)]
    for lanes in ([4, 1, 0, 6], [2, 5, 3]):
        off = np.cumsum([0] + [len(traces[i]) for i in lanes])
        rt.put(np.array(lanes), np.concatenate([traces[i] for i in lanes]),
               off)
    rt.clear(np.array([6]))
    traces[6] = traces[6][:0]
    lanes = np.array([0, 1, 3, 4, 5, 6])
    rev = np.array([True, False, True, True, False, True])
    for k, got in enumerate(rt.lists(lanes, rev)):
        want = traces[lanes[k]].tolist()
        if rev[k]:
            host._reverse_pairs(want)
        assert got == want
        assert all(type(v) is int for v in got)

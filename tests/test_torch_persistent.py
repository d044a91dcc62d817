"""The port's persistent wave path against the JAX package's persistent
driver (make_persistent_wrapped), its engine and its mapper.

Inputs come from numpy seeds and go unchanged to both packages; every
comparison is exact (integer outputs, tolerance 0).  On the CPU the port's
``wave_lanes_persistent`` runs its plain PyTorch version, which serves all
three layouts; the CUDA kernels are held against it by
tests/test_torch_cuda.py (on the card) and by chip_smoke.py.

The port flags a lane only when it needs a base outside its windows; JAX
also flags a lane whose reload window (anchored by _anchor_math) leaves the
lane window or the sequence memory.  So the port's overflow set must be a
subset of JAX's, and every lane that neither flags must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damapper_tpu.io import las as jlas
from damapper_tpu.ops import wave
from damapper_tpu.ops.spec import new_align_spec
from damapper_tpu.pipeline.mapper import DamapperConfig as JaxConfig
from damapper_tpu.pipeline.mapper import run_damapper as jax_run
from damapper_tpu.ops.wave_pallas import (PallasWaveEngine,
                                          make_persistent_wrapped)
from damapper_tpu_torch.convert import lanes_from_numpy
from damapper_tpu_torch.io import las as tlas
from damapper_tpu_torch.ops import wave_engine as twe
from damapper_tpu_torch.ops.spec import new_align_spec as t_new_align_spec
from damapper_tpu_torch.ops.wave_persistent import (MARGIN,
                                                    persistent_windows,
                                                    wave_lanes_persistent,
                                                    window_length)
from damapper_tpu_torch.pipeline import mapper as tmapper
from damapper_tpu_torch.utils.sim import make_lane_cases
from tests.test_e2e_golden import make_dataset
from tests.test_torch_wave import _assert_lanes_equal
from tests.test_wave_jax import make_cases

# The plain versions run many tiny tensor ops: torch's intra-op threads gain
# nothing there, and under several test workers their spinning starves the
# other workers (the port's tests ran 5x slower with 2 workers).  Every
# worker imports this module when it collects, so this holds for the whole
# run.
torch.set_num_threads(1)

SPEC = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
T_SPEC = t_new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
CONSTS = (SPEC.trace_space, SPEC.ave_path, SPEC.mscore, SPEC.dscore)
W, P, BW, DBUF, G = 64, 512, 128, 512, 8

_DRIVERS = {}


def _jax_driver(L, reverse, lanepack=False, use_pallas=False,
                interpret=False):
    key = (L, reverse, lanepack, use_pallas, interpret)
    if key not in _DRIVERS:
        _DRIVERS[key] = jax.jit(make_persistent_wrapped(
            W, P, BW, DBUF, G, L, reverse, use_pallas=use_pallas,
            interpret=interpret, lanepack=lanepack))
    return _DRIVERS[key]


def _run_both(seqmem, insts, L, reverse, **jax_kw):
    lanes = lanes_from_numpy(insts, seqmem, "cpu")
    ins = [lanes[nm].numpy() for nm in
           ("abase", "bbase", "mida", "k0", "aoffp", "boffp")]
    j = _jax_driver(L, reverse, **jax_kw)(
        *(jnp.asarray(x) for x in ins), jnp.asarray(seqmem),
        jnp.asarray(seqmem), *(jnp.int32(c) for c in CONSTS))
    j = {k: np.asarray(v) for k, v in j.items()}
    r = wave_lanes_persistent(**lanes, ts=CONSTS[0], pave=CONSTS[1],
                              msc=CONSTS[2], dsc=CONSTS[3], W=W, P=P, L=L,
                              reverse=reverse)
    return j, {k: v.numpy() for k, v in r.items()}


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("seed,err,glen,rlen,lanepack", [
    (1002, 0.05, 6000, 2500, False),
    (1001, 0.15, 6000, 2500, False),
    (1003, 0.30, 6000, 2500, False),
    (2000, 0.15, 2600, 2500, False),
    (2000, 0.15, 2700, 2400, False),
    (1001, 0.15, 6000, 2500, True),
    (2000, 0.15, 2700, 2400, True)])
def test_persistent_ref_matches_jax_driver(seed, err, glen, rlen, lanepack,
                                           reverse):
    """The plain version equals JAX's persistent driver (its XLA twin,
    unpacked and lane-packed) at the engine's window length.  The short
    genomes clamp the windows to the sequence memory; at glen=2600 the JAX
    reverse reload runs past the genome start on every lane (only the
    subset rule is checkable there)."""
    seqmem, insts = make_cases(seed, ncases=4, err=err, glen=glen, rlen=rlen)
    L = window_length(insts[0]["alen"])
    j, r = _run_both(seqmem, insts, L, reverse, lanepack=lanepack)
    n = _assert_lanes_equal(j, r)
    if not (glen == 2600 and reverse):
        assert n > 0


def test_persistent_ref_matches_pallas_interpret():
    """The real persistent pallas_call (interpret mode on the CPU) on two
    lanes, both directions."""
    seqmem, insts = make_cases(2000, ncases=2, err=0.15)
    L = window_length(insts[0]["alen"])
    for reverse in (False, True):
        j, r = _run_both(seqmem, insts, L, reverse, use_pallas=True,
                         interpret=True)
        assert _assert_lanes_equal(j, r) > 0


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_persistent_small_window_flags_subset(reverse):
    """A window too small for the longer reads (L=2048 with reads of
    1.5-4 kb): both drivers flag lanes, the port's flags are a subset of
    JAX's, and every lane neither flags is equal."""
    seqmem, insts = make_cases(1002, ncases=4, err=0.15, glen=8000,
                               rlen=4000, mix=True)
    j, r = _run_both(seqmem, insts, 2048, reverse)
    assert r["overflow"].any() and j["overflow"].any()
    assert _assert_lanes_equal(j, r) > 0


def test_persistent_windows_follow_jax_placement():
    """Window starts: MARGIN before the seed (reverse: ending MARGIN after
    it), clipped to the 128-padded memory and aligned down to 128."""
    assert MARGIN == 512
    seqmem, insts = make_cases(2000, ncases=4, glen=2600, rlen=2500)
    L = window_length(insts[0]["alen"])
    LM = len(seqmem)
    LMp = -(-max(LM, L) // 128) * 128
    for reverse in (False, True):
        lanes = lanes_from_numpy(insts, seqmem, "cpu", L=L, reverse=reverse)
        for side, base, pos in (("awst", "abase", "x0"),
                                ("bwst", "bbase", "y0")):
            for i, s in enumerate(insts):
                x0 = (s["anti"] + s["diag"]) >> 1
                y0 = (s["anti"] - s["diag"]) >> 1
                p = s[base] + (x0 if pos == "x0" else y0)
                want = p - MARGIN if not reverse else p + MARGIN - L
                want = min(max(want, 0), LMp - L) // 128 * 128
                assert int(lanes[side][i]) == want, (side, reverse, i)
        aw, bw = persistent_windows(lanes["abase"], lanes["bbase"],
                                    lanes["mida"], lanes["k0"], LM, LM, L,
                                    reverse)
        assert torch.equal(aw, lanes["awst"]) and aw.dtype == torch.int32


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _oracle(seqmem, s):
    a_np = seqmem[s["abase"]:s["abase"] + s["alen"]]
    b_np = seqmem[s["bbase"]:s["bbase"] + s["blen"]]
    return wave.local_alignment(a_np, b_np, SPEC, s["diag"], s["diag"],
                                s["anti"], -1, -1, s["flags"])


def _same_paths(x, y):
    return all((p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs, list(p.trace))
               == (q.abpos, q.bbpos, q.aepos, q.bepos, q.diffs,
                   list(q.trace))
               for p, q in zip(x, y))


@pytest.mark.parametrize("case,layout", [("err15", "plain"),
                                         ("err30", "packed"),
                                         ("boundary", "lanepack")])
def test_persistent_engine_matches_jax_engine_and_oracle(case, layout):
    """The port's persistent engine against damapper_tpu's persistent
    PallasWaveEngine (XLA twin) and the oracle: paths and traces."""
    if case == "err15":
        seqmem, insts = make_lane_cases(1005, 4, err=0.15)
    elif case == "err30":
        seqmem, insts = make_lane_cases(1000, 4, err=0.30)
    else:
        seqmem, insts = make_lane_cases(2000, 4, glen=2600, rlen=2500)
    got, eng = twe.local_alignment_batch(
        T_SPEC, seqmem, seqmem, insts, device="cpu", host_min=0,
        persistent=True, packops=layout == "packed",
        lanepack=layout == "lanepack")
    assert eng.mode == {"plain": "persistent",
                        "packed": "persistent+packops",
                        "lanepack": "persistent+lanepack"}[layout]
    assert eng.W == 64 and eng.n_total == len(insts)
    assert eng._L == window_length(insts[0]["alen"])
    jeng = PallasWaveEngine(SPEC, band_cap=64, pool_cap=2048,
                            use_pallas=False, persistent=True,
                            lanepack=layout == "lanepack")
    jeng.host_min = 0
    dev = jnp.asarray(seqmem)
    jgot = jeng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    for i, s in enumerate(insts):
        assert _same_paths(got[i], jgot[i]), f"lane {i} vs JAX engine"
        assert _same_paths(got[i], _oracle(seqmem, s)), f"lane {i} vs oracle"


def test_persistent_winmiss_retries_on_classic_kernel(monkeypatch):
    """Port of test_persistent_winmiss_retries_on_classic_driver: every
    lane of the persistent kernel reports overflow; the classic retry tier
    reproduces the classic engine's paths, and only lanes the classic
    kernel itself overflows reach the oracle."""
    seqmem, insts = make_cases(4242, ncases=10, err=0.15)
    orig = twe.wave_lanes_persistent

    def forced(*a, **kw):
        res = orig(*a, **kw)
        res["overflow"][:] = True       # every lane "misses its window"
        return res

    monkeypatch.setattr(twe, "wave_lanes_persistent", forced)
    got_p, eng_p = twe.local_alignment_batch(
        T_SPEC, seqmem, seqmem, insts, device="cpu", host_min=0,
        persistent=True)
    got_c, eng_c = twe.local_alignment_batch(
        T_SPEC, seqmem, seqmem, insts, device="cpu", host_min=0,
        persistent=False)
    assert eng_p.n_winmiss >= len(insts)
    assert eng_p.n_fallback == eng_c.n_fallback
    assert eng_p.total_waves == eng_c.total_waves
    for i in range(len(insts)):
        assert _same_paths(got_p[i], got_c[i]), f"lane {i}"


def test_persistent_small_window_engine_retries(monkeypatch):
    """Genuine window misses (a forced small window) go through the
    classic retry tier, and the engine's output still equals the oracle."""
    seqmem, insts = make_cases(1002, ncases=4, err=0.15, glen=8000,
                               rlen=4000, mix=True)
    monkeypatch.setattr(twe, "window_length", lambda alen: 2048)
    got, eng = twe.local_alignment_batch(T_SPEC, seqmem, seqmem, insts,
                                         device="cpu", host_min=0,
                                         persistent=True)
    assert eng._L == 2048 and eng.n_winmiss > 0
    for i, s in enumerate(insts):
        assert _same_paths(got[i], _oracle(seqmem, s)), f"lane {i}"


def test_persistent_tiny_round_host_route(monkeypatch):
    """Persistent rounds smaller than host_min stay on the oracle."""
    def no_kernel(*a, **kw):
        raise AssertionError("a tiny round reached a wave kernel")

    monkeypatch.setattr(twe, "wave_lanes_persistent", no_kernel)
    monkeypatch.setattr(twe, "wave_lanes", no_kernel)
    seqmem, insts = make_lane_cases(3000, 4, err=0.15)
    got, eng = twe.local_alignment_batch(T_SPEC, seqmem, seqmem, insts,
                                         device="cpu", host_min=5,
                                         persistent=True)
    assert eng.n_hostmin == len(insts) and eng.total_waves == 0
    for i, s in enumerate(insts):
        assert _same_paths(got[i], _oracle(seqmem, s)), f"lane {i}"


@pytest.mark.parametrize("env,kw,mode", [
    ({}, {}, "classic"),
    ({"DAMAPPER_WAVE_PERSISTENT": "1"}, {}, "persistent"),
    ({"DAMAPPER_WAVE_PERSISTENT": "1", "DAMAPPER_WAVE_PACKOPS": "1"}, {},
     "persistent+packops"),
    ({"DAMAPPER_WAVE_PERSISTENT": "1", "DAMAPPER_WAVE_PACKOPS": "1",
      "DAMAPPER_WAVE_LANEPACK": "1"}, {}, "persistent+lanepack"),
    ({"DAMAPPER_WAVE_PERSISTENT": "1"}, {"persistent": False}, "classic"),
    ({"DAMAPPER_WAVE_PERSISTENT": "0"}, {"persistent": True, "packops": True},
     "persistent+packops"),
    ({"DAMAPPER_WAVE_PACKOPS": "1"}, {}, "classic+packops"),
    ({"DAMAPPER_WAVE_PACKOPS": "1"}, {"lanepack": True}, "classic+lanepack"),
])
def test_wave_mode_switches(env, kw, mode, monkeypatch):
    """The engine's mode: explicit argument first, then the environment
    (the JAX engine's precedence; lanepack before packops), in either
    mode."""
    for nm in ("DAMAPPER_WAVE_PERSISTENT", "DAMAPPER_WAVE_PACKOPS",
               "DAMAPPER_WAVE_LANEPACK"):
        monkeypatch.delenv(nm, raising=False)
    for nm, v in env.items():
        monkeypatch.setenv(nm, v)
    eng = twe.WaveEngine(T_SPEC, device="cpu", **kw)
    assert eng.mode == mode
    assert eng.W == 64


@pytest.mark.parametrize("layout", ["packed", "lanepack"])
def test_classic_layout_engine_matches_jax_engine_and_oracle(layout):
    """The classic engine in the packed and lane-packed layouts (the
    kernels of wave_pallas.py:1457 and :1413) against damapper_tpu's
    classic PallasWaveEngine of the same layout (XLA twin) and the
    oracle."""
    seqmem, insts = make_lane_cases(1005, 4, err=0.15)
    got, eng = twe.local_alignment_batch(
        T_SPEC, seqmem, seqmem, insts, device="cpu", host_min=0,
        persistent=False, packops=layout == "packed",
        lanepack=layout == "lanepack")
    assert eng.mode == "classic+" + {"packed": "packops",
                                     "lanepack": "lanepack"}[layout]
    assert eng.layout == layout and eng.W == 64
    jeng = PallasWaveEngine(SPEC, band_cap=64, pool_cap=2048,
                            use_pallas=False, persistent=False,
                            lanepack=layout == "lanepack")
    jeng.host_min = 0
    dev = jnp.asarray(seqmem)
    jgot = jeng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    for i, s in enumerate(insts):
        assert _same_paths(got[i], jgot[i]), f"lane {i} vs JAX engine"
        assert _same_paths(got[i], _oracle(seqmem, s)), f"lane {i} vs oracle"


@pytest.mark.parametrize("layout", ["plain", "packed", "lanepack"])
def test_persistent_retry_tier_keeps_the_layout(monkeypatch, layout):
    """The retry tier of each persistent layout runs the classic kernel of
    the same layout (the JAX classic twin keeps lanepack and packops), and
    a packed engine hands both kernels one ready-made record."""
    seqmem, insts = make_cases(4242, ncases=4, err=0.15)
    calls = []

    def spy(fn, forced):
        def run(*a, **kw):
            calls.append((fn, kw["layout"], "record" in kw))
            res = getattr(twe._wc if fn == "classic" else twe._wp,
                          "wave_lanes" if fn == "classic"
                          else "wave_lanes_persistent")(*a, **kw)
            if forced:
                res["overflow"][:] = True
            return res
        return run

    monkeypatch.setattr(twe, "wave_lanes_persistent", spy("persistent", True))
    monkeypatch.setattr(twe, "wave_lanes", spy("classic", False))
    _, eng = twe.local_alignment_batch(
        T_SPEC, seqmem, seqmem, insts, device="cpu", host_min=0,
        persistent=True, packops=layout == "packed",
        lanepack=layout == "lanepack")
    assert eng.n_winmiss >= len(insts)
    kinds = {fn for fn, _, _ in calls}
    assert kinds == {"persistent", "classic"}
    assert all(lay == layout and rec == (layout == "packed")
               for _, lay, rec in calls), calls


# ---------------------------------------------------------------------------
# the mapper
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_persistent_run(tmp_path_factory):
    """test_e2e_persistent_wave_backend's dataset (seed 23) mapped by
    damapper_tpu with DAMAPPER_WAVE_PERSISTENT=1 (every round on the
    persistent driver)."""
    tmp = tmp_path_factory.mktemp("torch_persistent")
    make_dataset(tmp, seed=23, glen=24_000, ncontigs=2, nreads=6,
                 bsize=14_000, max_len=3500)
    (tmp / "jax").mkdir()
    mp = pytest.MonkeyPatch()
    try:
        mp.setenv("DAMAPPER_WAVE_PERSISTENT", "1")
        mp.setenv("DAMAPPER_WAVE_HOSTMIN", "0")
        jout, _ = jax_run(str(tmp / "ref.dam"), str(tmp / "reads.db"),
                          JaxConfig(wave_backend="pallas",
                                    index_backend="host", mesh=None),
                          out_dir=str(tmp / "jax"))
    finally:
        mp.undo()
    recs, tspace = jlas.read_las(jout)
    return tmp, tspace, [r.key() for r in recs]


@pytest.mark.parametrize("layout", ["plain", "packed", "lanepack"])
def test_persistent_las_identical_to_jax(jax_persistent_run, layout):
    """run_damapper on the CPU in each persistent mode writes .las records
    identical to damapper_tpu's persistent run."""
    tmp, jt, jk = jax_persistent_run
    out = tmp / f"torch_{layout}"
    out.mkdir()
    cfg = tmapper.DamapperConfig(device="cpu", host_min=0, persistent=True,
                                 packops=layout == "packed",
                                 lanepack=layout == "lanepack")
    tp, _ = tmapper.run_damapper(str(tmp / "ref.dam"), str(tmp / "reads.db"),
                                 cfg, out_dir=str(out))
    stats = tmapper.LAST_STATS
    assert stats["wave_mode"].startswith("persistent")
    assert stats["n_lanes"] > 0 and stats["n_hostmin"] == 0
    recs, tt = tlas.read_las(tp)
    assert tt == jt and len(jk) > 0
    assert [r.key() for r in recs] == jk


@pytest.mark.parametrize("layout", ["packed", "lanepack"])
def test_classic_layouts_las_identical_to_jax(jax_persistent_run, layout):
    """run_damapper on the CPU in the classic packed and lane-packed modes
    writes the same .las records (the wave mode changes no result)."""
    tmp, jt, jk = jax_persistent_run
    out = tmp / f"torch_classic_{layout}"
    out.mkdir()
    cfg = tmapper.DamapperConfig(device="cpu", host_min=0, persistent=False,
                                 packops=layout == "packed",
                                 lanepack=layout == "lanepack")
    tp, _ = tmapper.run_damapper(str(tmp / "ref.dam"), str(tmp / "reads.db"),
                                 cfg, out_dir=str(out))
    assert tmapper.LAST_STATS["wave_mode"] == "classic+" + (
        "packops" if layout == "packed" else "lanepack")
    recs, tt = tlas.read_las(tp)
    assert tt == jt and [r.key() for r in recs] == jk

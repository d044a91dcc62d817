"""The port's wave engine (ops.wave_engine) against the JAX package's
PallasWaveEngine (its XLA path on the CPU) and the host oracle.

Inputs come from numpy seeds and go unchanged to both packages; paths and
traces must be equal.  On the CPU the engine's kernel calls run the plain
PyTorch version of the wave kernel.
"""

import jax.numpy as jnp
import pytest

from damapper_tpu.ops import wave
from damapper_tpu.ops.spec import new_align_spec
from damapper_tpu.ops.wave_pallas import PallasWaveEngine
from damapper_tpu_torch.ops import wave_engine as twe
from damapper_tpu_torch.ops.spec import new_align_spec as t_new_align_spec
from damapper_tpu_torch.utils.sim import make_clip_cases, make_lane_cases

SPEC = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
T_SPEC = t_new_align_spec(0.85, 100, [.25, .25, .25, .25], True)


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


def _clip_cases():
    # the port's copy of tools/clip_fuzz.py's cases (test_torch_tune.py
    # holds it to the JAX tool's byte for byte)
    seqmem, all_insts = make_clip_cases(7000, 117)
    return seqmem, [all_insts[i] for i in (0, 14, 46, 50, 55, 67, 116)]


@pytest.mark.parametrize("case", ["err15", "err30", "boundary", "clip"])
def test_engine_matches_jax_engine_and_oracle(case, monkeypatch):
    """(c) The port's engine against damapper_tpu's PallasWaveEngine (XLA
    path on the CPU) and the oracle: paths and traces.  err30 takes the
    fshort and rshort redo rounds; clip holds the boundary-clip coast seeds
    of test_wave_boundary_clip_coast at W=128."""
    band = 64
    if case == "err15":
        seqmem, insts = make_lane_cases(1005, 4, err=0.15)
    elif case == "err30":
        seqmem, insts = make_lane_cases(1000, 4, err=0.30)
    elif case == "boundary":
        seqmem, insts = make_lane_cases(2000, 4, glen=2600, rlen=2500)
    else:
        seqmem, insts = _clip_cases()
        band = 128
    rounds = []
    orig = twe.WaveEngine._run

    def spy(self, which, *a, **kw):
        rounds.append(which)
        return orig(self, which, *a, **kw)

    monkeypatch.setattr(twe.WaveEngine, "_run", spy)
    got, eng = twe.local_alignment_batch(T_SPEC, seqmem, seqmem, insts,
                                         device="cpu", host_min=0,
                                         band_cap=band)
    assert eng.n_total == len(insts) and eng.n_hostmin == 0
    if case == "err30":
        assert rounds == ["fwd", "rev", "fwd", "rev"], rounds
    jeng = PallasWaveEngine(SPEC, band_cap=band, pool_cap=2048,
                            use_pallas=False)
    jeng.host_min = 0
    dev = jnp.asarray(seqmem)
    jgot = jeng.local_alignment_batch(dev, dev, seqmem, seqmem, insts)
    for i, s in enumerate(insts):
        assert _same_paths(got[i], jgot[i]), f"lane {i} vs JAX engine"
        assert _same_paths(got[i], _oracle(seqmem, s)), f"lane {i} vs oracle"


def test_engine_overflow_lanes_go_to_oracle():
    """(c) Lanes whose pool fills (a deliberately small pool cap) are
    flagged by the kernel and re-aligned by the oracle: the result is the
    oracle's, and the telemetry counts them."""
    seqmem, insts = make_lane_cases(1005, 4, err=0.15)
    got, eng = twe.local_alignment_batch(T_SPEC, seqmem, seqmem, insts,
                                         device="cpu", host_min=0,
                                         pool_cap=80)
    assert eng.n_fallback > 0
    for i, s in enumerate(insts):
        assert _same_paths(got[i], _oracle(seqmem, s)), f"lane {i}"


def test_engine_tiny_round_host_route(monkeypatch):
    """Rounds smaller than host_min run on the oracle and never reach the
    kernel."""
    def no_kernel(*a, **kw):
        raise AssertionError("a tiny round reached the wave kernel")

    monkeypatch.setattr(twe, "wave_lanes", no_kernel)
    seqmem, insts = make_lane_cases(3000, 4, err=0.15)
    got, eng = twe.local_alignment_batch(T_SPEC, seqmem, seqmem, insts,
                                         device="cpu", host_min=5)
    assert eng.n_hostmin == len(insts) and eng.total_waves == 0
    for i, s in enumerate(insts):
        assert _same_paths(got[i], _oracle(seqmem, s)), f"lane {i}"

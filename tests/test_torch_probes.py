"""The op-cost probes of damapper_tpu_torch against the JAX package's
Mosaic microbenchmarks (tools/mosaic_floor.py, mosaic_ops.py,
mosaic_carry.py), on the CPU.

The same seeded int32 inputs go through the JAX computation and the port's
plain version (what ``floor_probe``/``ops_probe``/``carry_probe`` run on
CPU tensors); tolerance 0, the outputs are integers.  Once per tool the JAX
side is the tool's real ``pallas_call`` in interpret mode: ``pl.pallas_call``
is wrapped to record the kernel and run it interpreted, the tool's bench
builds it, and the recorded kernel then runs on the seeded inputs.  The
tools are loaded from their files; the port never imports them.
"""

import builtins
import importlib.util
import pathlib
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from damapper_tpu_torch.ops import probes
from damapper_tpu_torch.peaks import INT32_OPS_PER_S

torch.set_num_threads(1)

TOOLS = pathlib.Path(__file__).resolve().parent.parent / "tools"
G, N, REPS, NOPS = 8, 3, 9, 8


def _load(name):
    spec = importlib.util.spec_from_file_location(f"_tpu_{name}",
                                                  TOOLS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tpu_tools():
    return {nm: _load(nm) for nm in ("mosaic_floor", "mosaic_ops",
                                     "mosaic_carry")}


def _ints(seed, shape):
    rng = np.random.default_rng(seed)
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture
def interpret(monkeypatch):
    """Wraps pl.pallas_call: every call runs interpreted, and the last
    kernel and its arguments are kept; ``rerun(*inputs)`` runs that kernel
    (interpreted) on new inputs."""
    orig = pl.pallas_call
    seen = {}

    def recording(kernel, *a, **kw):
        seen["call"] = (kernel, a, dict(kw, interpret=True))
        return orig(kernel, *a, **dict(kw, interpret=True))

    monkeypatch.setattr(pl, "pallas_call", recording)

    def rerun(*inputs):
        kernel, a, kw = seen["call"]
        return orig(kernel, *a, **kw)(*inputs)

    return rerun


def _n_smem(n):
    return jnp.full((1, 1), n, jnp.int32)


# ---------------------------------------------------------------------------
# mosaic_floor: the JAX side is the tool's kernel, interpreted, in every case
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("variant", probes.FLOOR_VARIANTS)
def test_floor_plain_matches_pallas_interpret(tpu_tools, interpret,
                                              monkeypatch, tmp_path, W,
                                              variant):
    mod = tpu_tools["mosaic_floor"]
    # the tool's bench appends its record to tools/mosaic_floor.jsonl
    log = tmp_path / "floor.jsonl"
    monkeypatch.setattr(mod, "open", lambda _p, mode: builtins.open(log,
                                                                    mode),
                        raising=False)
    mod.bench(G, W, 2, NOPS, variant)
    assert log.read_text().count("\n") == 1
    x = _ints(W + len(variant), (G, W))
    want = interpret(jnp.asarray(x), _n_smem(N))
    got = probes.floor_probe(_t(x), N, NOPS, variant)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# mosaic_ops: mk_patterns looped in jnp; once, the interpreted kernel
# ---------------------------------------------------------------------------


def _ops_inputs(W, pattern, positive_s=None):
    x = _ints(W, (G, W))
    s = _ints(W + 1, (G, 1))
    if positive_s is False:
        s = -np.abs(s.astype(np.int64)).astype(np.int32)
    return x, s


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("pattern", probes.OPS_PATTERNS)
def test_ops_plain_matches_mk_patterns(tpu_tools, W, pattern):
    fn = tpu_tools["mosaic_ops"].mk_patterns(G, W, REPS)[pattern]
    x, s = _ops_inputs(W, pattern)
    jx, js = jnp.asarray(x), jnp.asarray(s)[:, 0]
    for _ in range(N):
        jx, js = fn(jx, js)
    gx, gs = probes.ops_probe(_t(x), _t(s), N, REPS, pattern)
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gs.numpy()[:, 0], np.asarray(js))


@pytest.mark.parametrize("W", [64, 128])
def test_ops_cond_false_branch(tpu_tools, W):
    """cond with no positive s takes the other branch."""
    fn = tpu_tools["mosaic_ops"].mk_patterns(G, W, REPS)["cond"]
    x, s = _ops_inputs(W, "cond", positive_s=False)
    jx, js = jnp.asarray(x), jnp.asarray(s)[:, 0]
    for _ in range(N):
        jx, js = fn(jx, js)
    gx, _ = probes.ops_probe(_t(x), _t(s), N, REPS, "cond")
    np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(gx.numpy(), x - N * REPS)


def test_ops_plain_matches_pallas_interpret(tpu_tools, interpret):
    mod = tpu_tools["mosaic_ops"]
    W = 128
    for pattern in ("onehot_grab", "butterfly"):
        mod.bench(G, W, 2, REPS, pattern,
                  mod.mk_patterns(G, W, REPS)[pattern])
        x, s = _ops_inputs(W, pattern)
        wx, ws = interpret(jnp.asarray(x), jnp.asarray(s), _n_smem(N))
        gx, gs = probes.ops_probe(_t(x), _t(s), N, REPS, pattern)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(wx))
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws))


# ---------------------------------------------------------------------------
# mosaic_carry: the bodies main() passes to bench, looped in jnp; once, the
# interpreted kernel
# ---------------------------------------------------------------------------


def _rebind(f, **vals):
    """f with the closure variables named in vals set anew (main() makes
    its bodies for W=128 only)."""
    cells = tuple(types.CellType(vals[nm]) if nm in vals else c
                  for nm, c in zip(f.__code__.co_freevars,
                                   f.__closure__ or ()))
    return types.FunctionType(f.__code__, f.__globals__, f.__name__,
                              f.__defaults__, cells or None)


@pytest.fixture(scope="module")
def carry_bodies(tpu_tools):
    """{name: (mk_init, body_fn)} as main() passes them to bench at G=8
    (closures over main's loop variables, which end at G=128: rebind)."""
    mod = tpu_tools["mosaic_carry"]
    seen = {}

    def record(name, g, w, niter, mk_init, body_fn):
        if g == G:
            seen[name] = (mk_init, body_fn)

    orig, argv = mod.bench, sys.argv
    mod.bench, sys.argv = record, ["mosaic_carry.py", "3"]
    try:
        mod.main()
    finally:
        mod.bench, sys.argv = orig, argv
    assert tuple(seen) == probes.CARRY_BODIES
    return seen


def _jax_carry(mk_init, body_fn, x0, n, W):
    """The JAX state after n iterations from mk_init()'s state with x0
    added to each of its (G, W) arrays."""
    st = tuple(a + x0 if a.shape == (G, W) else a for a in mk_init())
    for _ in range(n):
        st = body_fn(st)
    return st


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("body", probes.CARRY_BODIES)
def test_carry_plain_matches_main_bodies(carry_bodies, W, body):
    mk_init, body_fn = carry_bodies[body]
    mk_init = _rebind(mk_init, G=G, W=W)
    body_fn = _rebind(body_fn, W=W)
    for x0 in (np.zeros((G, W), np.int32), _ints(W, (G, W))):
        st = _jax_carry(mk_init, body_fn, jnp.asarray(x0), N, W)
        out, aux = probes.carry_probe(_t(x0), N, body)
        np.testing.assert_array_equal(out.numpy(), np.asarray(st[0]))
        want = (jnp.stack(st[1:]) if body in ("carry60", "dbuf_soa")
                else st[1])
        assert tuple(aux.shape) == probes.aux_shape(body, G, W)
        np.testing.assert_array_equal(aux.numpy(), np.asarray(want))


def test_carry_plain_matches_pallas_interpret(tpu_tools, carry_bodies,
                                              interpret):
    """The Pallas kernel makes its state inside: x0 = 0."""
    mod = tpu_tools["mosaic_carry"]
    W = 128
    for body in ("dbuf_write", "3d_minor4"):
        mk_init, body_fn = carry_bodies[body]
        mod.bench(body, G, W, 2, _rebind(mk_init, G=G, W=W), body_fn)
        want = interpret(_n_smem(N))
        out, _ = probes.carry_probe(torch.zeros((G, W), dtype=torch.int32),
                                    N, body)
        np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the bound
# ---------------------------------------------------------------------------


def test_bound_counts_the_pattern_definition():
    # floor "mix": 7 operations per element per quad, 24 quads
    assert probes.op_count("floor", "mix", 128, 128, 10) \
        == 10 * 24 * 7 * 128 * 128
    # butterfly at W=64: 6 masked-roll steps, 4 applications at reps 28
    assert probes.op_count("ops", "butterfly", 8, 64, 1) == 4 * 6 * 5 * 8 * 64
    ms, by = probes.bound_ms("floor", "mix", 128, 128, 20000)
    assert by == "operations" and ms > 0
    assert probes.bound_ms("carry", "carry60", 8, 128, 0)[1] == "bytes"
    # the integer rate: the H100's dispatch ceiling, 4 schedulers x 32 lanes
    # a clock on 132 SMs at 1.98 GHz (carry60 ran 79.9-88.3 adds a clock an
    # SM on the card, above the 64 of the guide's table)
    assert INT32_OPS_PER_S == 132 * 4 * 32 * 1.98e9
    # dbuf: the add and the row max per element, the slot's & 127 per row;
    # the masked where over the buffer is not work the result needs
    ops = probes.op_count("carry", "dbuf_write", 128, 128, 100)
    assert ops == 100 * (2 * 128 * 128 + 128)
    assert probes.op_count("carry", "dbuf_soa", 128, 128, 100) == ops
    # ... so its bound is the bytes: x in and out, the (128, 192, 4) aux
    ms, by = probes.bound_ms("carry", "dbuf_write", 128, 128, 100)
    nbytes = 4 * (2 * 128 * 128 + 128 * 192 * 4)
    # rel 1e-12: the same quotient, the float operations in another order
    assert by == "bytes" \
        and ms == pytest.approx(1e3 * nbytes / 3.35e12, rel=1e-12)
    assert ops / INT32_OPS_PER_S < nbytes / 3.35e12

"""The warp policy of ``probe_carry`` (csrc/probes.cu ``carry_warp_kernel``),
modelled on the CPU.

Under the warp policy one (G, W) row lives on one warp: lane l carries
columns [l·V, l·V + V) of every carried array in V = W/32 registers.  The
model below computes each iteration as the kernel does, on the row viewed
as (G, 32, V) (lane, register), with the warp's intrinsics as PyTorch
operations on the lane axis (tests/test_torch_probe_warp.py's helpers):
carry60, 3d_minor4 and concat2w add and select on the registers; the dbuf
bodies fold the V registers and take one warp max (every lane gets it),
broadcast column 0's slot ``at`` from lane 0's register 0 with one
shuffle, and lanes 0-3 store the max at their column of that slot in the
row's own 4 x 192 slice of shared memory (``4·at + lane`` for dbuf_write,
``lane·192 + at`` for dbuf_soa).  The copy-out writes the slice in the
kernel's aux layouts.

Every body is held at tolerance 0, at W = 64 and 128 on seeded numpy
inputs, against three references: the port's plain version
(``probes.carry_probe_ref``, what the wrapper runs on CPU tensors), the
bodies of tools/mosaic_carry.py's ``main`` looped in jnp, and, for the dbuf
bodies at x0 = 0, the tool's Pallas kernel in interpret mode.  The dbuf
cases cover every residue of ``& 127`` in column 0, a slot written twice
(the last write wins), the slots 128-191 that no iteration writes, and
values near INT32_MAX whose +1 wraps and flips the row max's sign.  The
kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damapper_tpu_torch.ops import probes
from tests.test_torch_probe_warp import (CSRC, LANES, _warp_source,
                                         from_regs, shfl, to_regs,
                                         warp_row_max)
from tests.test_torch_probes import (G, _ints, _jax_carry,  # noqa: F401
                                     _n_smem, _rebind, _t, carry_bodies,
                                     interpret, tpu_tools)

torch.set_num_threads(1)

N = 3
DBUF = probes.DBUF
DBUF_BODIES = ("dbuf_write", "dbuf_soa")
I32 = torch.int32


# ---------------------------------------------------------------------------
# the model of carry_warp_kernel
# ---------------------------------------------------------------------------


def dbuf_slot_stores(x, m, d, body):
    """One iteration's stores: lane 0's register 0 (column 0) broadcast by
    one shuffle gives the slot; lanes 0-3 store the row max m (G, 32) at
    their column of it in the slice d (G, 4·192)."""
    a = shfl(x[:, :, 0], torch.zeros(LANES, dtype=torch.long)) & 127
    lane = torch.arange(4)
    addr = 4 * a[:, :4] + lane if body == "dbuf_write" \
        else lane * DBUF + a[:, :4]
    d[torch.arange(d.shape[0])[:, None], addr] = m[:, :4]


def warp_carry(x0, n, body, trace=None):
    """carry_warp_kernel on x0 (G, W): (out, aux) in the wrapper's shapes.
    trace, a list, receives each iteration's stored (slot, row max) of the
    dbuf bodies."""
    G, W = x0.shape
    x = to_regs(x0.clone())
    if body == "carry60":
        st = [x + k for k in range(60)]
        for _ in range(n):
            st = [s + 1 for s in st]
        return from_regs(st[0]), torch.stack([from_regs(s) for s in st[1:]])
    if body == "3d_minor4":
        r = torch.zeros(*x.shape, 4, dtype=I32)
        for _ in range(n):
            x = x + 1
            r = torch.where(((x & 7) == 0)[..., None], r + 1, r)
        return from_regs(x), r.reshape(G, W, 4)
    if body == "concat2w":
        bb = x + 1
        for _ in range(n):
            x, bb = x + 1, bb + 1
        return from_regs(x), from_regs(bb)
    d = torch.zeros(G, 4 * DBUF, dtype=I32)     # the zeroed slice
    for _ in range(n):
        x = x + 1
        m = warp_row_max(x)
        dbuf_slot_stores(x, m, d, body)
        if trace is not None:
            trace.append((x[:, 0, 0] & 127, m[:, 0]))
    # copy-out: lane l reads words l, l + 32, ... of the slice after the
    # __syncwarp(); word i goes to aux[g, i // 4, i % 4] (dbuf_write) or
    # aux[i // 192, g, i % 192] (dbuf_soa)
    aux = d.reshape(G, DBUF, 4) if body == "dbuf_write" \
        else d.reshape(G, 4, DBUF).permute(1, 0, 2)
    return from_regs(x), aux.contiguous()


def _check_refs(x0, n, body):
    """The model against the plain version (and the wrapper's warp policy
    on the CPU, which takes it); returns the model's outputs."""
    out, aux = warp_carry(x0, n, body)
    ro, ra = probes.carry_probe_ref(x0, n, body)
    assert tuple(aux.shape) == probes.aux_shape(body, *x0.shape)
    assert torch.equal(out, ro) and torch.equal(aux, ra)
    wo, wa = probes.carry_probe(x0, n, body, "warp")
    assert torch.equal(out, wo) and torch.equal(aux, wa)
    return out, aux


# ---------------------------------------------------------------------------
# every body against the plain version, the JAX bodies and Pallas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("body", probes.CARRY_BODIES)
def test_warp_carry_matches_plain_and_main_bodies(carry_bodies, W, body):
    mk_init, body_fn = carry_bodies[body]
    mk_init = _rebind(mk_init, G=G, W=W)
    body_fn = _rebind(body_fn, W=W)
    for x0 in (np.zeros((G, W), np.int32), _ints(W + 31, (G, W))):
        out, aux = _check_refs(_t(x0), N, body)
        st = _jax_carry(mk_init, body_fn, jnp.asarray(x0), N, W)
        np.testing.assert_array_equal(out.numpy(), np.asarray(st[0]))
        want = (jnp.stack(st[1:]) if body in ("carry60", "dbuf_soa")
                else st[1])
        np.testing.assert_array_equal(aux.numpy(), np.asarray(want))


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("body", DBUF_BODIES)
def test_warp_dbuf_matches_pallas_interpret(tpu_tools, carry_bodies,
                                            interpret, W, body):
    """The Pallas kernel makes its state inside (x0 = 0) and returns
    st[0]."""
    mk_init, body_fn = carry_bodies[body]
    tpu_tools["mosaic_carry"].bench(body, G, W, 2, _rebind(mk_init, G=G,
                                                           W=W), body_fn)
    want = interpret(_n_smem(N))
    out, _ = _check_refs(torch.zeros((G, W), dtype=I32), N, body)
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# the slot: every residue, a slot written twice, the slots never written,
# the int32 wrap
# ---------------------------------------------------------------------------


def _every_residue(W, seed):
    """128 rows whose column 0 runs through every residue of & 127, with
    full-range high bits; the other columns seeded."""
    x0 = _ints(seed, (128, W))
    x0[:, 0] = (x0[:, 0] & ~127) | np.arange(128, dtype=np.int32)
    return _t(x0)


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("body", DBUF_BODIES)
def test_warp_dbuf_every_residue_of_the_slot(W, body):
    x0 = _every_residue(W, W + 37)
    trace = []
    warp_carry(x0, N, body, trace)
    assert {int(v) for a, _ in trace for v in a} == set(range(128))
    _check_refs(x0, N, body)


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("body", DBUF_BODIES)
def test_warp_dbuf_slot_written_twice_last_write_wins(W, body):
    """130 iterations: the slots of iterations 0-1 come again at 128-129,
    and hold the later row max; the slots 128-191 stay 0."""
    x0 = _every_residue(W, W + 41)
    n = 130
    trace = []
    out, aux = _check_refs(x0, n, body)
    warp_carry(x0, n, body, trace)
    slots = aux if body == "dbuf_write" else aux.permute(1, 2, 0)  # (G,192,4)
    rows = torch.arange(128)
    for it in (0, 1):
        a, first = trace[it]
        a2, last = trace[it + 128]
        assert torch.equal(a, a2)
        assert bool((first != last).all())
        assert torch.equal(slots[rows, a.long()],
                           last[:, None].expand(-1, 4))
    assert not bool(slots[:, 128:].any())
    assert bool(slots[:, :128].all())


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("body", probes.CARRY_BODIES)
def test_warp_carry_wraps_near_int32_max(W, body):
    """x0 within 3 of INT32_MAX: each +1 wraps to INT32_MIN on some
    iteration, and in the dbuf bodies the row max, once every column has
    wrapped, turns negative."""
    rng = np.random.default_rng(W + 43)
    x0 = _t((2**31 - 1 - rng.integers(0, 3, (4, W))).astype(np.int32))
    trace = []
    _check_refs(x0, 4, body)
    if body in DBUF_BODIES:
        warp_carry(x0, 4, body, trace)
        assert bool((trace[0][1] > 0).all()) and bool((trace[3][1] < 0).all())


# ---------------------------------------------------------------------------
# the source
# ---------------------------------------------------------------------------


def test_carry_warp_source_has_no_barrier_and_one_shared_slice():
    """carry_warp_kernel holds no block barrier, exchange, block reduction
    or shared slot index; its only shared memory is the dbuf slice, stored
    (never loaded) in the loop and read after one __syncwarp()."""
    body = _warp_source()["carry_warp_kernel"]
    for gone in ("__syncthreads", "bar.", "exchange(", "block_reduce",
                 "at_s"):
        assert gone not in body, gone
    assert body.count("__shared__") == 1
    assert re.search(r"__shared__ int db\[", body)
    db = body[body.index("// DBUF_WRITE, DBUF_SOA"):]
    loop = db[db.index("#pragma unroll 1"):db.index("__syncwarp();",
                                                    db.index("#pragma "
                                                             "unroll 1"))]
    assert "warp_row_max(x)" in loop and "__shfl_sync(FULL, x[0], 0)" in loop
    assert re.findall(r"\bd\[[^\]]*\]\s*=?", loop) == [
        "d[BODY == DBUF_WRITE ? 4 * a + l : l * DBUF + a] ="]
    after = db[db.index(loop) + len(loop):]
    assert after.count("__syncwarp();") == 1
    assert after.index("__syncwarp();") < after.index("= d[i]")
    src = (CSRC / "probes.cu").read_text()
    assert "carry_warp_kernel<W, P>" in src

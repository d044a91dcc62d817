"""The warp policy of the op-cost probes (csrc/probes.cu), modelled on the
CPU (``probe_carry``'s in tests/test_torch_carry_warp.py).

Under the warp policy ``probe_floor`` and ``probe_ops`` hold one (G, W) row
on one warp: lane l owns the V = W/32 consecutive columns [l·V, l·V + V) in
V registers.  The model below computes each step as the kernel does, on the
row viewed as (G, 32, V) (lane, register), with the warp's intrinsics as
PyTorch operations on the lane axis: a roll is a register shift plus one
``__shfl_sync`` from lane l-1; a row max folds the V registers, then one
warp reduction broadcast to every lane; the one-hot grab of column c is
register c mod V (a tree of selects on the bits of c) of lane c / V (one
shuffle); the butterfly's shifts below V move within the registers and
one ``__shfl_down_sync`` a crossing register, a shift of d·V takes every
register from d lanes down, each class with its end-of-row mask.

Every step is held at tolerance 0 against the port's plain versions (what
the wrappers run on CPU tensors) at W = 64, 128 (and 256 for the floor),
and the whole patterns against the JAX tools on the same seeded numpy
inputs: ``mk_patterns`` of tools/mosaic_ops.py looped in jnp, and
tools/mosaic_floor.py's kernel in interpret mode, as
tests/test_torch_probes.py runs them.  Inputs cover negative and
full-range int32 values, every residue of s & (W-1), and the int32 wrap of
s + grab.  The kernels themselves are held against the plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 3).
"""

import builtins
import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damapper_tpu_torch.ops import probes
from damapper_tpu_torch.tools import probe_ab
from tests.test_torch_probes import (_ints, _n_smem, _t,  # noqa: F401
                                     interpret, tpu_tools)

torch.set_num_threads(1)

LANES = 32
G, N, REPS, NOPS = 8, 3, 9, 8
CSRC = pathlib.Path(probes.__file__).resolve().parent.parent / "csrc"


# ---------------------------------------------------------------------------
# the warp model: a row as (G, 32, V), lane-axis intrinsics
# ---------------------------------------------------------------------------


def to_regs(x):
    """(G, W) -> (G, 32, V): lane l, register k holds column l·V + k."""
    return x.reshape(x.shape[0], LANES, -1)


def from_regs(r):
    return r.reshape(r.shape[0], -1)


LANE = torch.arange(LANES)


def shfl(v, src):
    """__shfl_sync: every lane l reads lane src[l]'s v; v (G, 32)."""
    return v[:, src]


def shfl_down(v, d):
    """__shfl_down_sync by d: lane l reads lane l + d, or its own value
    past lane 31."""
    return shfl(v, torch.where(LANE + d < LANES, LANE + d, LANE))


def warp_roll(r):
    """roll(x, 1) along the row: the registers move up by one, register 0
    takes register V-1 of lane l-1 (lane 0 that of lane 31)."""
    c = shfl(r[:, :, -1], (LANE + LANES - 1) % LANES)
    return torch.cat([c[:, :, None], r[:, :, :-1]], 2)


def warp_row_max(r):
    """Fold the V registers, then one warp max: the result in every lane,
    (G, 32)."""
    m = r.max(2).values
    return m.max(1, keepdim=True).values.expand(-1, LANES)


def warp_grab(r, c):
    """Column c (G,) of each row, in every lane: register c mod V by a tree
    of selects on the bits of c (log2 V deep), then one shuffle from lane
    c / V."""
    V = r.shape[2]
    t = [r[:, :, k] for k in range(V)]
    w = 1
    while w < V:
        for k in range(0, V, 2 * w):
            t[k] = torch.where((c & w)[:, None] != 0, t[k + w], t[k])
        w *= 2
    return t[0].gather(1, (c // V)[:, None].expand(-1, LANES))


def butterfly_step(r, sft):
    """One shift of the revcummax scan: o[j] = max(o[j], o[j + sft]) where
    j + sft < W, NEG_BIG past the row's end."""
    V = r.shape[2]
    out = r.clone()
    if sft < V:
        for k in range(V):
            src = r[:, :, (k + sft) % V]
            if k + sft < V:
                sh = src
            else:   # lane l+1's register; lane 31's is past the row's end
                sh = torch.where(LANE < LANES - 1, shfl_down(src, 1),
                                 probes.NEG_BIG)
            out[:, :, k] = torch.maximum(r[:, :, k], sh)
        return out
    d = sft // V
    for k in range(V):
        sh = torch.where(LANE + d < LANES, shfl_down(r[:, :, k], d),
                         probes.NEG_BIG)
        out[:, :, k] = torch.maximum(r[:, :, k], sh)
    return out


def warp_butterfly(r):
    W = LANES * r.shape[2]
    sft = 1
    while sft < W:
        r = butterfly_step(r, sft)
        sft *= 2
    return r


def warp_floor(x, n, nops, variant):
    r = to_regs(x.clone())
    for _ in range(n):
        for _ in range(nops // 4):
            if variant == "add":
                r = (((r + 1) ^ 3) + 7) ^ 5
            else:
                r = r + 1
                r = torch.where(r > 100000, r - 100000, r)
                r = warp_roll(r)
                r = torch.maximum(r, r ^ 2)
    return from_regs(r)


def warp_ops(x, s, n, reps, pattern):
    """x (G, W), s (G, 1) -> (x, s); s is held alike by every lane."""
    r = to_regs(x.clone())
    V = r.shape[2]
    W = LANES * V
    sl = s.expand(-1, LANES).clone()          # (G, 32)
    # cond: lane l ors (s > 0) over rows l, l + 32, ...; the vote ors lanes
    part = torch.zeros(LANES, dtype=torch.bool)
    for i in range(s.shape[0]):
        part[i % LANES] |= bool(s[i, 0] > 0)
    for _ in range(n):
        if pattern == "butterfly":
            for _ in range(probes.butterfly_apps(reps)):
                r = warp_butterfly(r)
            continue
        for _ in range(reps):
            if pattern == "elemwise":
                r = torch.maximum(r + 1, r ^ 3)
            elif pattern == "roll":
                r = warp_roll(r) + 1
            elif pattern == "reduce_row":
                r = r + warp_row_max(r)[:, :, None]
            elif pattern == "reduce_scal":
                sl = sl + warp_row_max(r)
                r = r + sl[:, :, None]
            elif pattern == "onehot_grab":
                sl = sl + warp_grab(r, sl[:, 0] & (W - 1))
            elif pattern == "scal_arith":
                sl = torch.maximum(sl + 1, sl ^ 3)
            else:   # cond
                r = r + (1 if bool(part.any()) else -1)
    assert bool((sl == sl[:, :1]).all()), "the lanes' s differ"
    return from_regs(r), sl[:, :1].clone()


def _inputs(seed, W, g=G, neg_s=False):
    x = torch.from_numpy(_ints(seed, (g, W)))
    s = torch.from_numpy(_ints(seed + 1, (g, 1)))
    return x, (-s.abs() if neg_s else s)


# ---------------------------------------------------------------------------
# each step against the plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [64, 128, 256])
def test_roll_is_register_shift_and_lane_shuffle(W):
    x, _ = _inputs(W, W)
    assert torch.equal(from_regs(warp_roll(to_regs(x))), torch.roll(x, 1, 1))


@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("cls", ["below_V", "V", "above_V"])
def test_butterfly_shift_classes_with_row_end_mask(W, cls):
    """Each shift class of the revcummax scan equals the plain version's
    masked roll step (values below NEG_BIG included, which the mask
    raises)."""
    V = W // LANES
    x, _ = _inputs(W + 7, W)
    idx = torch.arange(W)[None, :]
    sfts = {"below_V": [s for s in (1, 2, 4) if s < V], "V": [V],
            "above_V": [V * d for d in (2, 4, 8, 16)]}[cls]
    assert sfts
    for sft in sfts:
        want = torch.maximum(x, torch.where(idx + sft < W,
                                            torch.roll(x, -sft, 1),
                                            probes.NEG_BIG))
        assert torch.equal(from_regs(butterfly_step(to_regs(x), sft)),
                           want), sft
    assert bool((x < probes.NEG_BIG).any())


@pytest.mark.parametrize("W", [64, 128])
def test_onehot_grab_every_residue(W):
    """The (lane, register) pick equals the one-hot sum for every column,
    in every lane."""
    x, _ = _inputs(W + 3, W, g=W)
    c = torch.arange(W)      # row g grabs column g: every residue
    got = warp_grab(to_regs(x), c)
    onehot = torch.where(torch.arange(W)[None, :] == c[:, None], x,
                         0).sum(1, dtype=torch.int32)
    assert torch.equal(got, onehot[:, None].expand(-1, LANES))


@pytest.mark.parametrize("W", [64, 128])
def test_fold_then_warp_reduction_is_row_max(W):
    x, _ = _inputs(W + 5, W)
    assert torch.equal(warp_row_max(to_regs(x)),
                       x.max(1, keepdim=True).values.expand(-1, LANES))


@pytest.mark.parametrize("W", [64, 128])
def test_grab_wraps_as_int32(W):
    """s + grab wraps mod 2^32 as JAX's int32 sum does: s and the grabbed
    value near the int32 ends."""
    x = torch.full((4, W), 2**31 - 5, dtype=torch.int32)
    x[2:] = -2**31 + 3
    s = torch.tensor([[2**31 - 1], [2**31 - 2 - W], [-2**31], [-2**31 + W]],
                     dtype=torch.int32)
    gx, gs = warp_ops(x, s, 1, 1, "onehot_grab")
    want = (s.numpy().astype(np.int64) + x.numpy()[:, :1]) \
        .astype(np.uint32).astype(np.int32)     # one grab, any column
    assert np.array_equal(gs.numpy(), want)
    px, ps = probes.ops_probe(x, s, 1, 1, "onehot_grab")
    assert torch.equal(gs, ps) and torch.equal(gx, px)


# ---------------------------------------------------------------------------
# whole patterns against the plain version and the JAX tools
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("W", [64, 128, 256])
@pytest.mark.parametrize("variant", probes.FLOOR_VARIANTS)
def test_warp_floor_matches_plain_and_pallas_interpret(
        tpu_tools, interpret, monkeypatch, tmp_path, W, variant):
    mod = tpu_tools["mosaic_floor"]
    log = tmp_path / "floor.jsonl"
    monkeypatch.setattr(mod, "open", lambda _p, mode: builtins.open(log,
                                                                    mode),
                        raising=False)
    mod.bench(G, W, 2, NOPS, variant)
    x = _ints(W + 11, (G, W))
    want = np.asarray(interpret(jnp.asarray(x), _n_smem(N)))
    got = warp_floor(_t(x), N, NOPS, variant)
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, probes.floor_probe(_t(x), N, NOPS, variant,
                                               "warp"))


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("pattern", probes.OPS_PATTERNS)
def test_warp_ops_matches_plain_and_mk_patterns(tpu_tools, W, pattern):
    fn = tpu_tools["mosaic_ops"].mk_patterns(G, W, REPS)[pattern]
    for neg in (False, True) if pattern == "cond" else (False,):
        x, s = _inputs(W + 13, W, neg_s=neg)
        jx, js = jnp.asarray(x.numpy()), jnp.asarray(s.numpy())[:, 0]
        for _ in range(N):
            jx, js = fn(jx, js)
        gx, gs = warp_ops(x, s, N, REPS, pattern)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(jx))
        np.testing.assert_array_equal(gs.numpy()[:, 0], np.asarray(js))
        px, ps = probes.ops_probe(x, s, N, REPS, pattern, "warp")
        assert torch.equal(gx, px) and torch.equal(gs, ps)


@pytest.mark.parametrize("W", [64, 128])
def test_warp_grab_pattern_every_residue(W):
    """onehot_grab over rows whose s runs through every residue of
    s & (W-1), full-range high bits."""
    x, s = _inputs(W + 17, W, g=W)
    s = (s & ~(W - 1)) | torch.arange(W, dtype=torch.int32)[:, None]
    gx, gs = warp_ops(x, s, N, REPS, "onehot_grab")
    px, ps = probes.ops_probe(x, s, N, REPS, "onehot_grab")
    assert torch.equal(gx, px) and torch.equal(gs, ps)


# ---------------------------------------------------------------------------
# the policies the wrappers serve, and the source
# ---------------------------------------------------------------------------


CALLS = {
    "floor_probe": lambda x, b: probes.floor_probe(x, 1, 8, "mix", b),
    "ops_probe": lambda x, b: probes.ops_probe(x, x[:, :1].contiguous(), 1,
                                               2, "roll", b),
    "carry_probe": lambda x, b: probes.carry_probe(x, 1, "concat2w", b),
}


@pytest.mark.parametrize("fn", sorted(CALLS))
@pytest.mark.parametrize("barrier", ["block", "half", "warp", "grid"])
def test_wrapper_serves_two_policies(fn, barrier):
    """Each wrapper serves two policies, block and warp, and raises on any
    other (the retired half-block policy too), whatever the device; CPU
    tensors take the plain version."""
    x = torch.from_numpy(_ints(3, (2, 64)))
    if barrier in probes.SERVED[fn]:
        got = CALLS[fn](x, barrier)
        want = CALLS[fn](x, "block")
        got, want = (got, want) if isinstance(got, tuple) else \
            ((got,), (want,))
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    else:
        with pytest.raises(ValueError, match="barrier must be one of"):
            CALLS[fn](x, barrier)
    assert probes.SERVED[fn] == ("block", "warp")


def _warp_source():
    """The warp policy's helpers and kernels in csrc/probes.cu."""
    src = (CSRC / "probes.cu").read_text()
    parts = re.findall(r"\n((?:template <[^\n]*>\n)?__(?:device|global)__"
                       r"[^{]*\b(warp_\w+|\w+_warp_kernel)\b[^{]*\{.*?\n\})",
                       src, re.S)
    return {name: body for body, name in parts}


def test_warp_source_has_no_barrier_or_shared_memory():
    """The warp policy's code holds no barrier, vote on a barrier, or
    shared memory: one row lives on one warp.  carry_warp_kernel's one
    shared array is its dbuf slice, which nothing reads in the loop
    (tests/test_torch_carry_warp.py pins how it is used)."""
    parts = _warp_source()
    assert set(parts) == {"warp_roll", "warp_row_max", "warp_grab",
                          "warp_butterfly", "floor_warp_kernel",
                          "ops_warp_kernel", "carry_warp_kernel"}
    for name, body in parts.items():
        if name == "carry_warp_kernel":
            body = body.replace("__shared__ int db[", "", 1)
        for gone in ("__syncthreads", "bar.", "__shared__", "exchange(",
                     "block_reduce"):
            assert gone not in body, (name, gone)
    assert "__any_sync" in parts["ops_warp_kernel"]
    assert "__reduce_max_sync" in parts["warp_row_max"]


def test_probe_ab_names_each_kernel_and_needs_a_card(monkeypatch, tmp_path,
                                                      capsys):
    """The A/B tool keys a kernel's SASS by kind, pattern, W and policy
    (the symbols as nvcc mangles the templates), and exits non-zero
    without a card."""
    names = {"floor": probes.FLOOR_VARIANTS, "ops": probes.OPS_PATTERNS,
             "carry": probes.CARRY_BODIES}
    ns = "_ZN45_INTERNAL_6d1c8b54_9_probes_cu_5a7e4f2b_12345"
    cases = {
        ns + "10ops_kernelILi64ENS_8BlockBarELi3EEEvPKiS3_PiS4_iii":
            ("ops", "reduce_scal", 64, "block"),
        ns + "15ops_warp_kernelILi128ELi7EEEvPKiS2_PiS3_iii":
            ("ops", "butterfly", 128, "warp"),
        ns + "17floor_warp_kernelILi256ELb1EEEvPKiPiiii":
            ("floor", "add", 256, "warp"),
        ns + "12floor_kernelILi128ENS_8BlockBarELb0EEEvPKiPiiii":
            ("floor", "mix", 128, "block"),
        ns + "17carry_warp_kernelILi64ELi4EEEvPKiPiS2_ii":
            ("carry", "dbuf_soa", 64, "warp"),
        ns + "12carry_kernelILi128ENS_8BlockBarELi0EEEvPKiPiS4_ii":
            ("carry", "carry60", 128, "block"),
        ns + "20persistent_kernelILi64ELb0EEEvv": None,
    }
    for sym, key in cases.items():
        assert probe_ab.kernel_key(sym, names) == key, sym
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "ab.jsonl"
    assert probe_ab.main([str(CSRC), "--out", str(out)]) != 0
    assert "no CUDA device" in capsys.readouterr().err
    assert not out.exists()

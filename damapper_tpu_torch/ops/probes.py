"""Op-cost probes: the loops of the JAX package's three Mosaic
microbenchmarks (``tools/mosaic_floor.py``, ``mosaic_ops.py``,
``mosaic_carry.py``) as kernels for Hopper.

Each probe runs ``n`` iterations of one pattern of the wave body's inner
loop on a (G, W) int32 array.  Three kernels in ``csrc/probes.cu``, built
with nvcc at first use into ``build/torch_kernels/libprobes.so`` and bound
through ctypes, each serving two row layouts (``barrier``; see the note at
the top of ``csrc/probes.cu``):

  * ``floor_probe``  — mosaic_floor.py:32 (``pallas_call`` at :62);
    ``block`` or ``warp``;
  * ``ops_probe``    — mosaic_ops.py:102 (:123) over ``mk_patterns``;
    ``block`` or ``warp``;
  * ``carry_probe``  — mosaic_carry.py:27 (:44) over the five bodies of
    its ``main``; ``block`` or ``warp``.

``block``: one row per block of W threads, every step across columns
through shared memory and block barriers, as the wave body's rounds run.
``warp``: one row per warp, lane l holding columns [l·W/32, (l+1)·W/32) in
registers; rolls, grabs and the butterfly's shifts are shuffles, row
reductions one ``redux.sync``, the vote one ``__any_sync``, and no barrier
(the carry bodies' dbuf slots are stored to shared memory that nothing
reads before the loop ends).  So the probes price a wave's block rounds
against the warp-wide steps that would replace them.  A wrapper raises on
a policy its kernel does not serve, on any device.

Beside each, ``*_ref`` is the plain PyTorch version of the same function
(torch's int32 add wraps in two's complement, as JAX's does and as the
kernels do through unsigned adds).  A wrapper runs the plain version only
for tensors on the CPU; for CUDA tensors it launches the kernel or raises,
and counts the launch in ``<wrapper>.launches``.

The kernels compute what the Pallas kernels return, plus the state those
leave dead (see ``carry_probe``), so that nvcc cannot delete the work being
timed.  ``op_count`` and ``bound_ms`` give the least time the card could
take for a launch, from the pattern's definition.
"""

from __future__ import annotations

import ctypes

import torch

from ..peaks import HBM_BYTES_PER_S, INT32_OPS_PER_S
from .wave_cuda import CSRC_DIR, lane_device_kinds, nvcc_build, ptxas_build

FLOOR_VARIANTS = ("mix", "add")
OPS_PATTERNS = ("elemwise", "roll", "reduce_row", "reduce_scal",
                "onehot_grab", "scal_arith", "cond", "butterfly")
CARRY_BODIES = ("carry60", "3d_minor4", "concat2w", "dbuf_write", "dbuf_soa")
# the launchers' barrier ids (id 1 was a retired half-block policy; the ids
# stay so that a build of an older probes.cu keeps its policies' ids)
BARRIERS = {"block": 0, "warp": 2}
SERVED = {"floor_probe": ("block", "warp"), "ops_probe": ("block", "warp"),
          "carry_probe": ("block", "warp")}
DBUF = 192                     # the dbuf bodies' slots per row
NEG_BIG = -(1 << 30)           # butterfly's fill


def butterfly_apps(reps: int) -> int:
    """Applications of butterfly per iteration (mosaic_ops.py:85)."""
    return max(1, reps // 7)


# ---------------------------------------------------------------------------
# the plain PyTorch versions
# ---------------------------------------------------------------------------


def floor_probe_ref(x, n, nops=96, variant="mix"):
    """Plain version of ``floor_probe``: n iterations of nops//4 quads."""
    x = x.clone()
    for _ in range(n):
        for _ in range(nops // 4):
            if variant == "add":
                x = ((x + 1) ^ 3) + 7
                x = x ^ 5
            else:
                x = x + 1
                x = torch.where(x > 100000, x - 100000, x)
                x = torch.roll(x, 1, 1)
                x = torch.maximum(x, x ^ 2)
    return x


def _ops_apply(x, s, reps, pattern):
    """One iteration of mosaic_ops.py's pattern; s is (G,)."""
    G, W = x.shape
    if pattern == "butterfly":
        idx = torch.arange(W, device=x.device)[None, :]
        for _ in range(butterfly_apps(reps)):
            out = x
            sft = 1
            while sft < W:
                sh = torch.roll(out, -sft, 1)
                out = torch.maximum(out, torch.where(idx + sft < W, sh,
                                                     NEG_BIG))
                sft *= 2
            x = out
        return x, s
    slots = torch.arange(W, device=x.device)[None, :]
    for _ in range(reps):
        if pattern == "elemwise":
            x = torch.maximum(x + 1, x ^ 3)
        elif pattern == "roll":
            x = torch.roll(x, 1, 1) + 1
        elif pattern == "reduce_row":
            x = x + x.max(1, keepdim=True).values
        elif pattern == "reduce_scal":
            s = s + x.max(1).values
            x = x + s[:, None]
        elif pattern == "onehot_grab":
            s = s + torch.where(slots == (s[:, None] & (W - 1)), x,
                                0).sum(1, dtype=torch.int32)
        elif pattern == "scal_arith":
            s = torch.maximum(s + 1, s ^ 3)
        elif pattern == "cond":
            x = x + 1 if bool((s > 0).any()) else x - 1
        else:
            raise ValueError(f"ops_probe: unknown pattern {pattern!r}")
    return x, s


def ops_probe_ref(x, s, n, reps=28, pattern="elemwise"):
    """Plain version of ``ops_probe``: x (G, W), s (G, 1) -> (x, s)."""
    s = s[:, 0]
    for _ in range(n):
        x, s = _ops_apply(x, s, reps, pattern)
    return x.clone(), s[:, None].clone()


def carry_init(x0, body):
    """The carried state of a carry body, made from x0 (G, W): the Pallas
    kernel's own state (mosaic_carry.py main) when x0 is 0."""
    G = x0.shape[0]

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=x0.device)

    if body == "carry60":
        return tuple(x0 + k for k in range(60))
    if body == "3d_minor4":
        return (x0, zeros(*x0.shape, 4))
    if body == "concat2w":
        return (x0, x0 + 1)
    if body == "dbuf_write":
        return (x0, zeros(G, DBUF, 4))
    if body == "dbuf_soa":
        return (x0,) + tuple(zeros(G, DBUF) for _ in range(4))
    raise ValueError(f"carry_probe: unknown body {body!r}")


def _carry_step(st, body):
    if body == "carry60":
        return tuple(v + 1 for v in st)
    if body == "3d_minor4":
        x = st[0] + 1
        return (x, torch.where(((x & 7) == 0)[:, :, None], st[1] + 1, st[1]))
    if body == "concat2w":
        return (st[0] + 1, st[1] + 1)
    x = st[0] + 1
    mask = torch.arange(DBUF, device=x.device)[None, :] == (x[:, :1] & 127)
    row = x.max(1, keepdim=True).values
    if body == "dbuf_write":
        return (x, torch.where(mask[:, :, None], row[:, :, None], st[1]))
    return (x,) + tuple(torch.where(mask, row, d) for d in st[1:])


def carry_aux(st, body):
    """The state the Pallas kernel leaves dead, as the kernel's aux
    output: carry60 (59, G, W); 3d_minor4 (G, W, 4); concat2w (G, W);
    dbuf_write (G, 192, 4); dbuf_soa (4, G, 192)."""
    if body in ("carry60", "dbuf_soa"):
        return torch.stack(st[1:])
    return st[1]


def aux_shape(body, G, W):
    return {"carry60": (59, G, W), "3d_minor4": (G, W, 4),
            "concat2w": (G, W), "dbuf_write": (G, DBUF, 4),
            "dbuf_soa": (4, G, DBUF)}[body]


def carry_probe_ref(x0, n, body):
    """Plain version of ``carry_probe``: (st[0], the rest as aux)."""
    st = carry_init(x0, body)
    for _ in range(n):
        st = _carry_step(st, body)
    return st[0].clone(), carry_aux(st, body).clone()


# ---------------------------------------------------------------------------
# operations and bytes of a launch, from the patterns' definitions
# ---------------------------------------------------------------------------

# per iteration: (operations per element of (G, W), per row, per launch)
# counting each jnp operation of the pattern once per element it produces
# (a roll, a compare, a select and a reduction step each count one); the
# dbuf bodies count what their result needs, the add, the row max and the
# slot's & 127, not the masked where over the whole buffer, whose one
# changed slot is 4 stores
_FLOOR_QUAD = {"mix": 7, "add": 4}


def op_count(kind, name, G, W, n, nops=96, reps=28):
    """Integer operations of one launch of n iterations."""
    if kind == "floor":
        return n * (nops // 4) * _FLOOR_QUAD[name] * G * W
    if kind == "ops":
        lw = W.bit_length() - 1
        per = {"elemwise": (3, 0, 0), "roll": (2, 0, 0),
               "reduce_row": (2, 0, 0), "reduce_scal": (2, 1, 0),
               "onehot_grab": (3, 2, 0), "scal_arith": (0, 3, 0),
               "cond": (1, 0, 2 * G)}
        if name == "butterfly":
            return n * butterfly_apps(reps) * lw * 5 * G * W
        e, r, c = per[name]
        return n * reps * (e * G * W + r * G + c)
    per = {"carry60": (60, 0), "3d_minor4": (11, 0), "concat2w": (2, 0),
           "dbuf_write": (2, 1), "dbuf_soa": (2, 1)}
    e, r = per[name]
    return n * (e * G * W + r * G)


def byte_count(kind, name, G, W):
    """Bytes one launch must move: each input read once, each output
    written once."""
    if kind == "floor":
        return 2 * 4 * G * W
    if kind == "ops":
        return 2 * 4 * (G * W + G)
    aux = 1
    for d in aux_shape(name, G, W):
        aux *= d
    return 4 * (2 * G * W + aux)


def bound_ms(kind, name, G, W, n, nops=96, reps=28):
    """(least ms for one launch, "bytes" or "operations")."""
    tb = byte_count(kind, name, G, W) / HBM_BYTES_PER_S
    to = op_count(kind, name, G, W, n, nops, reps) / INT32_OPS_PER_S
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


# ---------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

_lib = None


def build(verbose: bool = False):
    """Build csrc/probes.cu into build/torch_kernels/libprobes.so."""
    return nvcc_build(CSRC_DIR / "probes.cu", "libprobes.so", verbose)


def build_report():
    """``build`` under ptxas -v, always compiling; returns (the library's
    path, ptxas's report)."""
    return ptxas_build(CSRC_DIR / "probes.cu", "libprobes.so")


def bind(lib):
    """Sets the C signatures of a build of csrc/probes.cu; returns lib."""
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.probe_floor_launch.argtypes = [P, P] + [I] * 6 + [P]
    lib.probe_ops_launch.argtypes = [P] * 4 + [I] * 6 + [P]
    lib.probe_carry_launch.argtypes = [P] * 3 + [I] * 5 + [P]
    for fn in (lib.probe_floor_launch, lib.probe_ops_launch,
               lib.probe_carry_launch):
        fn.restype = I
    lib.probe_error_string.restype = ctypes.c_char_p
    lib.probe_error_string.argtypes = [I]
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def _check(fn, name, t, shape, dev):
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous() or t.device != dev:
        raise ValueError(f"{fn}: {name} must be a contiguous int32 "
                         f"{list(shape)} tensor on {dev}")


def _served(fn, barrier):
    """Raises unless the wrapper's kernel serves the barrier policy."""
    if barrier not in SERVED[fn]:
        raise ValueError(f"{fn}: barrier must be one of {SERVED[fn]}, not "
                         f"{barrier!r}")


def _cuda_args(fn, x, W_ok, barrier, n):
    """Checks common to the three wrappers; returns (G, W, barrier id)."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{fn}: CUDA tensors given but no CUDA device "
                           f"is available")
    if x.dim() != 2:
        raise ValueError(f"{fn}: x must be (G, W)")
    G, W = (int(d) for d in x.shape)
    _check(fn, "x", x, (G, W), x.device)
    if W not in W_ok:
        raise ValueError(f"{fn}: W={W} is not served (W in {W_ok})")
    if n < 0:
        raise ValueError(f"{fn}: n must be >= 0")
    return G, W, BARRIERS[barrier]


def _raise_on(fn, rc):
    if rc != 0:
        raise RuntimeError(f"{fn}: kernel launch failed: "
                           + _load().probe_error_string(rc).decode())


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def floor_probe(x, n, nops=96, variant="mix", barrier="block"):
    """mosaic_floor's kernel: n iterations of nops//4 quads of ``variant``
    on x, int32 (G, W) with W in 64, 128, 256, under ``barrier`` "block"
    or "warp".  Returns x (G, W)."""
    fn = "floor_probe"
    if variant not in FLOOR_VARIANTS:
        raise ValueError(f"{fn}: variant must be one of {FLOOR_VARIANTS}")
    _served(fn, barrier)
    if lane_device_kinds(fn, (x,)) == "cpu":
        return floor_probe_ref(x, n, nops, variant)
    G, W, bid = _cuda_args(fn, x, (64, 128, 256), barrier, n)
    out = torch.empty_like(x)
    rc = _load().probe_floor_launch(
        x.data_ptr(), out.data_ptr(), G, W, bid, int(variant == "add"),
        int(n), nops // 4, _stream(x.device))
    _raise_on(fn, rc)
    floor_probe.launches += 1
    return out


def ops_probe(x, s, n, reps=28, pattern="elemwise", barrier="block"):
    """mosaic_ops's kernel over one pattern of ``mk_patterns``: x int32
    (G, W) with W in 64, 128, s int32 (G, 1), under ``barrier`` "block"
    or "warp".  Returns (x, s)."""
    fn = "ops_probe"
    if pattern not in OPS_PATTERNS:
        raise ValueError(f"{fn}: pattern must be one of {OPS_PATTERNS}")
    _served(fn, barrier)
    if lane_device_kinds(fn, (x, s)) == "cpu":
        return ops_probe_ref(x, s, n, reps, pattern)
    G, W, bid = _cuda_args(fn, x, (64, 128), barrier, n)
    _check(fn, "s", s, (G, 1), x.device)
    xo, so = torch.empty_like(x), torch.empty_like(s)
    rc = _load().probe_ops_launch(
        x.data_ptr(), s.data_ptr(), xo.data_ptr(), so.data_ptr(), G, W, bid,
        OPS_PATTERNS.index(pattern), int(n), int(reps), _stream(x.device))
    _raise_on(fn, rc)
    ops_probe.launches += 1
    return xo, so


def carry_probe(x0, n, body, barrier="block"):
    """mosaic_carry's kernel over one body: the state made from x0 int32
    (G, W) with W in 64, 128 (``carry_init``), n iterations, under
    ``barrier`` "block" or "warp".  Returns (st[0] (G, W) — the
    Pallas kernel's output when x0 is 0 —, the rest of the state as
    ``aux``, shaped by ``aux_shape``)."""
    fn = "carry_probe"
    if body not in CARRY_BODIES:
        raise ValueError(f"{fn}: body must be one of {CARRY_BODIES}")
    _served(fn, barrier)
    if lane_device_kinds(fn, (x0,)) == "cpu":
        return carry_probe_ref(x0, n, body)
    G, W, bid = _cuda_args(fn, x0, (64, 128), barrier, n)
    out = torch.empty_like(x0)
    aux = torch.empty(aux_shape(body, G, W), dtype=torch.int32,
                      device=x0.device)
    rc = _load().probe_carry_launch(
        x0.data_ptr(), out.data_ptr(), aux.data_ptr(), G, W, bid,
        CARRY_BODIES.index(body), int(n), _stream(x0.device))
    _raise_on(fn, rc)
    carry_probe.launches += 1
    return out, aux


floor_probe.launches = 0
ops_probe.launches = 0
carry_probe.launches = 0

"""Persistent wave lanes: each lane runs against its own sequence windows.

``wave_lanes_persistent`` is the counterpart of the JAX package's persistent
wave driver (``make_persistent_driver`` wrapped by ``make_persistent_wrapped``,
damapper_tpu/ops/wave_pallas.py): the same one wave direction for N lanes as
``ops.wave_cuda.wave_lanes``, but each lane reads its A and B bases only from
a window of L bases per side placed around its seed (``persistent_windows``,
the JAX placement).  A lane that needs a base outside its windows is flagged
as overflowed; the engine re-runs such lanes on the classic kernel.  On
every lane that it does not flag, the result equals ``wave_lanes``'.

Three layouts with one contract over the hand-written kernels of
``csrc/wave_persistent.cu`` (see the note at the top of that file), built
with nvcc at first use into ``build/torch_kernels/libwave_persistent.so``:

  * layout "plain"    — one thread block of W=64 threads per lane
    (TPU kernel: wave_pallas.py:2104);
  * layout "packed"   — the same, with one (N, 8) int32 input record and
    one (N, 16) output record per lane (wave_pallas.py:2031);
  * layout "lanepack" — the plain kernel, one block of W=64 threads per
    lane (wave_pallas.py:1981, where two lanes share a row).

Each kernel caches a lane's two windows in a ring of RING_SLOTS chunks of
RING_CHUNK bytes a window in shared memory, filled by TMA bulk copies as the
band's front moves, and reads what the ring does not hold in place: the
shared memory a lane takes (``ring_bytes``) is the same for every L.

``wave_lanes_persistent_ref`` is the plain PyTorch version of all three:
``wave_lanes_ref`` with window readers.  The wrapper takes it only for
tensors on the CPU; for CUDA tensors it launches the layout's kernel or
raises.
"""

from __future__ import annotations

import ctypes

import torch

from .wave_cuda import (CSRC_DIR, IN_FIELDS, LAYOUTS, MAX_WAVES, check_lanes,
                        check_seq, count_launch, lane_device_kinds,
                        nvcc_build, out_buffers, pack_record, wave_lanes_ref)

MARGIN = 512            # window slack on each side of the seed
KERNEL_NAMES = {"plain": "wave_persistent",
                "packed": "wave_persistent_packed",
                "lanepack": "wave_persistent_lanepack"}
# each window's ring: RING_SLOTS chunks of RING_CHUNK bytes (powers of two,
# a chunk 128 bytes or more, at most 32 slots), 16 KB a lane; of the
# geometries timed on the H100 the fastest or within 1% of it (PERF.md §6)
RING_CHUNK = 2048
RING_SLOTS = 4


def pow2ceil(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def window_length(max_alen: int) -> int:
    """The window L a round of lanes gets: every extension of its longest
    a-read fits (the JAX engine's bucket, wave_pallas.py:2360-2367)."""
    return max(2048, pow2ceil(int(max_alen) + 2 * MARGIN))


def ring_bytes(ring=None) -> int:
    """Dynamic shared memory a block (one lane) asks for: its A and B
    rings, each ``slots`` chunks of ``chunk`` bytes; ring = (chunk, slots),
    None for (RING_CHUNK, RING_SLOTS).  The same for every window length."""
    chunk, slots = ring or (RING_CHUNK, RING_SLOTS)
    return 2 * int(chunk) * int(slots)


def persistent_windows(abase, bbase, mida, k0, LA, LB, L, reverse):
    """Window starts (awst, bwst), int32 tensors on the inputs' device, as
    make_persistent_wrapped places them (wave_pallas.py:2226-2243): L bases
    from MARGIN before the seed (reverse: ending MARGIN after it), clipped
    to the 128-padded sequence memory, aligned down to 128."""
    i64 = torch.int64
    ab, bb, mida, k0 = (t.to(i64) for t in (abase, bbase, mida, k0))
    x0 = (mida + k0) >> 1
    y0 = (mida - k0) >> 1
    L = int(L)
    LAp = -(-max(int(LA), L) // 128) * 128
    LBp = -(-max(int(LB), L) // 128) * 128
    if not reverse:
        awst = (ab + x0 - MARGIN).clamp(0, LAp - L)
        bwst = (bb + y0 - MARGIN).clamp(0, LBp - L)
    else:
        awst = (ab + x0 + MARGIN - L).clamp(0, LAp - L)
        bwst = (bb + y0 + MARGIN - L).clamp(0, LBp - L)
    return ((awst // 128) * 128).to(torch.int32), \
        ((bwst // 128) * 128).to(torch.int32)


def window_reader(mem, wst, L):
    """The window access of the plain version: ``read(idx) -> (bytes,
    miss)`` over the lanes' windows [wst, wst + L) of ``mem``; window bytes
    past the end of the memory read 4, indices outside the window read 4
    and are marked in ``miss``."""
    LM = int(mem.shape[0])
    wst = wst.to(mem.device, torch.int64)

    def read(idx):
        r = idx - wst.view((-1,) + (1,) * (idx.dim() - 1))
        inw = (r >= 0) & (r < L)
        return torch.where(inw & (idx < LM), mem[idx.clamp(0, LM - 1)],
                           4), ~inw

    return read


def wave_lanes_persistent_ref(abase, bbase, mida, k0, aoffp, boffp, A, B,
                              ts, pave, msc, dsc, *, W, P, L, reverse,
                              max_waves=MAX_WAVES, awst=None, bwst=None):
    """Plain PyTorch version of ``wave_lanes_persistent``, all layouts."""
    if awst is None:
        awst, bwst = persistent_windows(abase, bbase, mida, k0, A.shape[0],
                                        B.shape[0], L, reverse)
    seq = (window_reader(A, awst, int(L)), window_reader(B, bwst, int(L)))
    return wave_lanes_ref(abase, bbase, mida, k0, aoffp, boffp, A, B, ts,
                          pave, msc, dsc, W=W, P=P, reverse=reverse,
                          max_waves=max_waves, seq=seq)


# ---------------------------------------------------------------------------
# the CUDA kernels: build, bind, launch
# ---------------------------------------------------------------------------

_lib = None


def build(verbose: bool = False):
    """Build csrc/wave_persistent.cu into
    build/torch_kernels/libwave_persistent.so."""
    return nvcc_build(CSRC_DIR / "wave_persistent.cu",
                      "libwave_persistent.so", verbose)


def bind(lib):
    """Sets the C signatures of a build of csrc/wave_persistent.cu;
    returns lib."""
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    seqargs = [P, LL, P, LL]
    tail = [P, P, P]                  # out, pool, stream
    lib.wave_persistent_launch.argtypes = \
        [P] * 8 + seqargs + [I] * 12 + tail
    lib.wave_persistent_packed_launch.argtypes = \
        [P] + seqargs + [I] * 12 + tail
    lib.wave_persistent_occupancy.argtypes = [I] * 5 + [P]
    for fn in (lib.wave_persistent_launch,
               lib.wave_persistent_packed_launch,
               lib.wave_persistent_occupancy):
        fn.restype = ctypes.c_int
    lib.wave_persistent_error_string.restype = ctypes.c_char_p
    lib.wave_persistent_error_string.argtypes = [I]
    return lib


def _load():
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(str(build())))
    return _lib


def _launch(ins, A, B, consts, W, P, L, reverse, layout, ring, max_waves,
            record):
    fn = "wave_lanes_persistent"
    if not torch.cuda.is_available():
        raise RuntimeError(f"{fn}: CUDA tensors given but no CUDA device is "
                           f"available")
    if W != 64:
        raise ValueError(f"{fn}: W={W}; the persistent kernels run W=64")
    if P < W + 2:
        raise ValueError(f"{fn}: P={P} must exceed W+2")
    if L <= 0 or L % 128:
        raise ValueError(f"{fn}: L={L} must be a positive multiple of 128")
    dev = check_seq(fn, A, B)
    n = check_lanes(fn, IN_FIELDS + ("awst", "bwst"), ins, record, dev)
    if layout == "packed" and record is None:
        record = pack_record(ins)
    out, res = out_buffers(n, layout, dev)
    pool = torch.zeros((n, P, 4), dtype=torch.int32, device=dev)
    if n:
        lib = _load()
        stream = torch.cuda.current_stream(dev).cuda_stream
        seqargs = (A.data_ptr(), A.shape[0], B.data_ptr(), B.shape[0])
        scal = [int(reverse), *map(int, ring or (RING_CHUNK, RING_SLOTS))] \
            + [int(c) for c in consts] + [int(max_waves)]
        tail = (out.data_ptr(), pool.data_ptr(), stream)
        if layout == "packed":
            rc = lib.wave_persistent_packed_launch(
                record.data_ptr(), *seqargs, n, W, P, L, *scal, *tail)
        else:   # plain, and lanepack: the plain kernel
            rc = lib.wave_persistent_launch(
                *[t.data_ptr() for t in ins], *seqargs, n, W, P, L, *scal,
                *tail)
        if rc != 0:
            raise RuntimeError(
                f"{fn}: {layout} kernel launch failed: "
                + lib.wave_persistent_error_string(rc).decode())
        count_launch(wave_lanes_persistent, layout)
    res["overflow"] = res["overflow"] != 0
    res["pool"] = pool
    return res


def wave_lanes_persistent(abase, bbase, mida, k0, aoffp, boffp, A, B, ts,
                          pave, msc, dsc, *, W, P, L, reverse,
                          layout="plain", ring=None, max_waves=MAX_WAVES,
                          awst=None, bwst=None, record=None):
    """Run one wave direction for N lanes against their windows of L bases.

    Arguments and result as ``wave_lanes`` (int32 [N] lane inputs, uint8
    sequence memories A and B, the AlignSpec constants; a dict of int32 [N]
    fields, bool ``overflow`` and the [N, P, 4] ``pool``; the packed layout
    also returns its raw (N, 16) output ``record``), plus: W, which must be
    64 on the card; L, the window length (a multiple of 128); layout, one of
    LAYOUTS; ring, the (chunk bytes, slots) of each window's ring (None:
    RING_CHUNK, RING_SLOTS; the result does not depend on it); awst/bwst,
    the window starts (None: ``persistent_windows``);
    record, for the packed layout, the lanes' ready-made (N, 8) int32 input
    record with the window starts in its last two words (``pack_record``),
    read by the kernel in place of the lane tensors.

    CPU tensors run the plain PyTorch version; CUDA tensors launch the
    layout's kernel and count the launch in ``launches_<layout>``."""
    fn = "wave_lanes_persistent"
    if layout not in LAYOUTS:
        raise ValueError(f"{fn}: layout must be one of {LAYOUTS}, got "
                         f"{layout!r}")
    if record is not None and layout != "packed":
        raise ValueError(f"{fn}: a record is the packed layout's input")
    ins = (abase, bbase, mida, k0, aoffp, boffp)
    if record is not None and awst is None:
        awst, bwst = record[:, 6], record[:, 7]
    extra = tuple(t for t in (awst, bwst, record) if t is not None)
    if lane_device_kinds(fn, ins + extra + (A, B)) == "cpu":
        return wave_lanes_persistent_ref(
            *ins, A, B, ts, pave, msc, dsc, W=W, P=P, L=L, reverse=reverse,
            max_waves=max_waves, awst=awst, bwst=bwst)
    if awst is None:
        awst, bwst = persistent_windows(abase, bbase, mida, k0, A.shape[0],
                                        B.shape[0], L, reverse)
    win = () if record is not None else (awst, bwst)
    return _launch(ins + win, A, B, (ts, pave, msc, dsc), W, P, int(L),
                   reverse, layout, ring, max_waves, record)


def lanes_per_sm(L, layout="plain", reverse=False, ring=None) -> int:
    """Lanes (64-thread blocks) of the layout's kernel one SM holds at once
    on the current card in a launch at window length L with the ring
    geometry (None: the default), from
    cudaOccupancyMaxActiveBlocksPerMultiprocessor; 0 where the launch would
    refuse it."""
    chunk, slots = ring or (RING_CHUNK, RING_SLOTS)
    out = ctypes.c_int(0)
    rc = _load().wave_persistent_occupancy(
        int(layout == "packed"), int(reverse), int(L), int(chunk),
        int(slots), ctypes.byref(out))
    if rc != 0:
        raise RuntimeError("wave_persistent_occupancy failed: "
                           + _load().wave_persistent_error_string(rc)
                           .decode())
    return out.value


wave_lanes_persistent.launches_plain = 0
wave_lanes_persistent.launches_packed = 0
wave_lanes_persistent.launches_lanepack = 0

"""The word-wide snake and the fused barrier rounds of csrc/wave_body.cuh.

The kernel runs only on the card, so its new arithmetic is modelled here in
plain PyTorch, step for step as the source writes it, and held against the
forms it replaces (tolerance 0: integer results):

  (a) the word walk's stop finder (aligned 8-byte words joined by a funnel
      shift, the exact per-byte stop test, the first flagged byte in walk
      order) against the byte-at-a-time walk, at every address residue of
      the sequence memory mod 16, in both directions, with the window rule;
  (b) round A's slot-order segmented scan and per-warp best (c, rel) and
      round B's packed prune key against the rel-order scan and the three
      reductions;
  (c) the adversarial lane set of ``utils/sim.py`` through the port's plain
      version and the JAX classic driver.

The kernels themselves are held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from damapper_tpu_torch.utils.sim import make_adversarial_lane_cases
from tests.test_torch_wave import _assert_lanes_equal, _run_both

BODY = (pathlib.Path(__file__).resolve().parent.parent / "damapper_tpu_torch"
        / "csrc" / "wave_body.cuh").read_text()

M64 = (1 << 64) - 1
L7 = 0x7F7F7F7F7F7F7F7F
H = 0x8080808080808080 - (1 << 64)      # as int64
S4 = 0x0404040404040404
NEG_BIG, I32MAX = -(1 << 30), 0x7FFFFFFF


# ---------------------------------------------------------------------------
# (a) the word walk
# ---------------------------------------------------------------------------


def stop_bytes(a, b):
    """wave_body.cuh stop_bytes on int64 tensors (two's complement wrap)."""
    d, e = a ^ b, b ^ S4
    dne = ((d & L7) + L7) | d
    ene = ((e & L7) + L7) | e
    return (dne | ~ene) & H


class AuditedMemory:
    """A sequence buffer at an address of residue `res` mod 16 that records
    every index read, so a test can hold the walk to [0, len)."""

    def __init__(self, codes, res):
        self.codes = torch.as_tensor(codes, dtype=torch.int64)
        self.res = res
        self.lo, self.hi = 1 << 62, -(1 << 62)

    def read(self, idx):
        idx = torch.as_tensor(idx, dtype=torch.int64)
        if idx.numel():
            self.lo = min(self.lo, int(idx.min()))
            self.hi = max(self.hi, int(idx.max()))
        return self.codes[idx]


def _load(mem, n, q):
    """WordWalk.load: the word at q (mem's address + q is 8-aligned), whole
    when it lies in [0, n), else byte by byte with 4 outside."""
    j = torch.arange(8)
    if 0 <= q <= n - 8:
        b = mem.read(q + j)
    else:
        inside = [int(i) for i in q + j if 0 <= int(i) < n]
        got = dict(zip(inside, mem.read(inside).tolist())) if inside else {}
        b = torch.tensor([got.get(int(i), 4) for i in q + j])
    return int((b << (8 * j)).sum())


def word_walk(mem, n, p, reverse):
    """A WordWalk from p: yields (the step's bases as int64, the index of
    its byte 0)."""
    lo = p - 7 if reverse else p
    r = (mem.res + lo) % 8
    q, s8 = lo - r, 8 * r
    w0, w1 = _load(mem, n, q), _load(mem, n, q + 8)
    while True:
        x = ((w0 & M64) >> s8 | ((w1 << 1) << (63 - s8))) & M64
        yield x - (1 << 64) if x >> 63 else x, q + r
        if reverse:
            q -= 8
            w1, w0 = w0, _load(mem, n, q)
        else:
            q += 8
            w0, w1 = w1, _load(mem, n, q + 8)


def word_snake(amem, an, bmem, bn, pa, pb, reverse, amiss, bmiss):
    """The kernel's snake: (run, sa, sb, smiss)."""
    run = 0
    for (xa, _), (xb, _) in zip(word_walk(amem, an, pa, reverse),
                                word_walk(bmem, bn, pb, reverse)):
        stop = int(stop_bytes(torch.tensor(xa), torch.tensor(xb)))
        if stop:
            flags = [(stop >> (8 * j + 7)) & 1 for j in range(8)]
            j = 7 - flags[::-1].index(1) if reverse else flags.index(1)
            run += 7 - j if reverse else j
            b, a = (xb >> 8 * j) & 0xFF, (xa >> 8 * j) & 0xFF
            sgn = -1 if reverse else 1
            if b == 4:
                return run, False, True, bmiss(pb + sgn * run)
            return run, a == 4, False, amiss(pa + sgn * run)
        run += 8


def byte_snake(aget, bget, pa, pb, reverse):
    """The byte walk the word walk replaces; get(i) -> (byte, miss)."""
    sgn, run = (-1 if reverse else 1), 0
    while True:
        b, mb = bget(pb + sgn * run)
        a, ma = aget(pa + sgn * run)
        if b == 4:
            return run, False, True, mb
        if a != b:
            return run, a == 4, False, ma
        run += 1


def _getter(codes, wst=None, L=None):
    """The byte access: classic (4 outside the memory) or a window
    [wst, wst + L) (4 and a miss outside it; 4 past the memory's end)."""
    n = len(codes)

    def get(i):
        if wst is not None:
            r = i - wst
            if not 0 <= r < L:
                return 4, True
        return (int(codes[i]), False) if 0 <= i < n else (4, False)
    return get


def _memories(rng, n=700):
    """A and B over the same n codes, sentinels at index 0 and n - 1."""
    b = rng.integers(0, 4, n).astype(np.int64)
    b[0] = b[-1] = 4
    return b.copy(), b


def _mismatch(a, i, to4=False):
    a[i] = 4 if to4 else (a[i] + 1) % 4


def _walk_cases(rng, reverse):
    """(a, b, pa, pb): runs of 0, 60, 61, 64 and >200 bases to a mismatch,
    to an A sentinel, and to the sentinels at index 0 and n - 1."""
    n = 700
    out = []
    for run in (0, 1, 7, 8, 60, 61, 64, 250):
        for p in (300, 301, 305, 307):
            a, b = _memories(rng, n)
            _mismatch(a, p - run if reverse else p + run, to4=run == 61)
            out.append((a, b, p, p))
    for p in (1, 2, 6, 9, 15, n - 2, n - 3, n - 9, n - 16):
        a, b = _memories(rng, n)
        out.append((a, b, p, p))       # runs into a sentinel or the end
    a, b = _memories(rng, n)
    out.append((a, b, 0, 0))          # starts on a sentinel
    out.append((a, b, -5, -5))        # starts outside the memory
    out.append((a, b, n + 3, n + 3))
    return out


@pytest.mark.parametrize("res", range(16))
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_word_walk_matches_byte_walk(res, reverse):
    """(a) classic access: same run, sa, sb as the byte walk, and no read
    leaves [0, n)."""
    rng = np.random.default_rng(100 + res)
    for a, b, pa, pb in _walk_cases(rng, reverse):
        n = len(a)
        am, bm = AuditedMemory(a, res), AuditedMemory(b, (res + 5) % 16)
        got = word_snake(am, n, bm, n, pa, pb, reverse, lambda i: False,
                         lambda i: False)
        want = byte_snake(_getter(a), _getter(b), pa, pb, reverse)
        assert got == want, (pa, reverse, res)
        for m in (am, bm):
            assert m.lo >= 0 and m.hi < n, (m.lo, m.hi, pa)


@pytest.mark.parametrize("res", range(0, 16, 3))
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_word_walk_window_miss_rule(res, reverse):
    """(a) window access: a mismatch one byte inside, on and outside the
    window's edge; a window that runs past the memory's end (those bytes
    read 4 and are no miss).  The walks read the window's bytes that lie in
    the memory, relative to the window start, as WindowSeq does."""
    rng = np.random.default_rng(200 + res)
    n, L = 700, 256
    for wst, edge_off in ((200, -1), (200, 0), (200, 1), (200, 9),
                          (n - 100, 0), (n - 100, 40)):
        a, b = _memories(rng, n)
        a[1:-1] = b[1:-1]              # one run from the seed to the edge
        edge = wst - 1 if reverse else wst + L
        e = edge + (-edge_off if reverse else edge_off)
        if 0 < e < n - 1:
            _mismatch(a, e)
        p = wst + min(L, n - wst) // 2
        valid = min(n - wst, L)
        am = AuditedMemory(a[wst:wst + valid], res)
        bm = AuditedMemory(b[wst:wst + valid], res)

        def miss(i):
            return not 0 <= i - wst < L
        got = word_snake(am, valid, bm, valid, p - wst, p - wst, reverse,
                         lambda r: miss(r + wst), lambda r: miss(r + wst))
        want = byte_snake(_getter(a, wst, L), _getter(b, wst, L), p, p,
                          reverse)
        assert got == want, (wst, edge_off, reverse, res)
        assert bm.lo >= 0 and bm.hi < valid


def test_stop_bytes_is_exact_per_byte():
    """The highest flagged byte is right too: no borrow or carry crosses a
    byte (the has-zero-byte trick without the exact form flags a 0x01 byte
    above a zero byte)."""
    rng = np.random.default_rng(5)
    for _ in range(200):
        a = rng.integers(0, 6, 8)
        b = rng.integers(0, 6, 8)
        pack = (lambda v: int(sum(int(x) << (8 * j) for j, x in
                                  enumerate(v))))
        got = int(stop_bytes(torch.tensor(pack(a)), torch.tensor(pack(b))))
        want = sum(0x80 << (8 * j) for j in range(8)
                   if a[j] != b[j] or b[j] == 4)
        assert got & M64 == want


# ---------------------------------------------------------------------------
# (b) the fused rounds
# ---------------------------------------------------------------------------


def round_a(cm, low, W, reverse):
    """Round A as the kernel computes it: per warp a segmented scan in slot
    order (segments [sl, W) and [0, sl)), the warp totals per segment and
    the warp's best (c, rel); after the round the exclusive value per slot,
    bandc and the rel that holds it.  Returns (excl per slot, bandc,
    rel)."""
    fill = I32MAX if reverse else NEG_BIG
    op = torch.minimum if reverse else torch.maximum
    sl = low & (W - 1)
    t = torch.arange(W)
    segA = t >= sl
    v = cm.clone()
    wl = t & 31
    o = 1
    while o < 32:
        if reverse:
            src = t - o
            ok = (wl >= o) & (~segA | (src >= sl))
        else:
            src = t + o
            ok = (wl + o < 32) & (segA | (src < sl))
        u = v[src.clamp(0, W - 1)]
        v = torch.where(ok, op(u, v), v)
        o <<= 1
    if reverse:
        ex = torch.where((wl == 0) | (t == sl), fill, v[(t - 1).clamp(0)])
    else:
        ex = torch.where((wl == 31) | (t + 1 == sl), fill,
                         v[(t + 1).clamp(max=W - 1)])
    NW = W // 32
    # per warp: the max (reverse: min) of c over segment A, over segment
    # B, over both, and the largest (smallest) rel that holds the last
    red = (lambda x: int(x.min())) if reverse else (lambda x: int(x.max()))
    wA, wB, cw, rw = [], [], [], []
    for i in range(NW):
        w = slice(32 * i, 32 * i + 32)
        wA.append(red(torch.where(segA[w], cm[w], fill)))
        wB.append(red(torch.where(segA[w], fill, cm[w])))
        cw.append(red(cm[w]))
        rw.append(red(torch.where(cm[w] == cw[-1],
                                  torch.remainder(t[w] - low, W),
                                  W if reverse else -1)))
    excl = ex.clone()
    for s in range(W):
        wi = s // 32
        for i in range(NW):
            if not reverse:
                u = (max(wA[i], wB[i]) if i > wi else wB[i]) if s >= sl \
                    else (wB[i] if i > wi else fill)
                excl[s] = max(int(excl[s]), u)
            else:
                u = (wA[i] if i < wi else fill) if s >= sl \
                    else (min(wB[i], wA[i]) if i < wi else wA[i])
                excl[s] = min(int(excl[s]), u)
    bandc = min(cw) if reverse else max(cw)
    held = [r for c, r in zip(cw, rw) if c == bandc]
    return excl, bandc, min(held) if reverse else max(held)


def three_reductions(cm, low, hgh, W, besta, reverse):
    """The parent's form: the rel-order exclusive scan (wave_lanes_ref),
    bandc, and kstar as the sum of k over the triggering slots with
    c == bandc.  Returns (excl per slot, bandc, kstar, any0)."""
    fill = I32MAX if reverse else NEG_BIG
    t = torch.arange(W)
    rel = torch.remainder(t - low, W)
    k = low + rel
    inb = k <= hgh
    ring = (low + t) & (W - 1)          # slot of rel r
    crel = cm[ring]
    if reverse:
        pre = crel.cummin(0).values
        exr = torch.cat([torch.tensor([fill]), pre[:-1]])
        runbase = torch.minimum(torch.tensor(besta), exr[rel])
        trigger = inb & (cm < runbase)
        bandc = int(cm.min())
        any0 = bandc < besta
    else:
        suf = crel.flip(0).cummax(0).values.flip(0)
        exr = torch.cat([suf[1:], torch.tensor([fill])])
        runbase = torch.maximum(torch.tensor(besta), exr[rel])
        trigger = inb & (cm > runbase)
        bandc = int(cm.max())
        any0 = bandc > besta
    kstar = int(torch.where(trigger & (cm == bandc), k, 0).sum())
    return exr[rel], bandc, kstar, any0


def _band(rng, W, reverse, span, low, ties):
    fill = I32MAX if reverse else NEG_BIG
    t = torch.arange(W)
    rel = torch.remainder(t - low, W)
    inb = rel <= span
    hi = 4 if ties else 1000
    c = torch.as_tensor(rng.integers(-hi, hi + 1, W)) + 5000
    if ties == "fill":            # in-band slots that hold the fill value
        c = torch.where(torch.as_tensor(rng.random(W) < 0.3), fill, c)
    return torch.where(inb, c, fill), low + span


@pytest.mark.parametrize("W", [64, 128])
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_round_a_scan_and_best_match_three_reductions(W, reverse):
    """(b) Ties in c, fill values in the band, an empty band, bands that
    wrap the ring or not, negative diagonals."""
    rng = np.random.default_rng(7 + W + reverse)
    n = 0
    for trial in range(300):
        span = int(rng.integers(-1, W - 4))      # -1: an empty band
        low = int(rng.integers(-3 * W, 3 * W))
        ties = (False, True, "fill")[trial % 3]
        cm, hgh = _band(rng, W, reverse, span, low, ties)
        besta = 5000 + int(rng.integers(-6, 7)) * (1 if ties else 150)
        excl, bandc, krel = round_a(cm, low, W, reverse)
        wexcl, wbandc, wkstar, any0 = three_reductions(cm, low, hgh, W,
                                                      besta, reverse)
        assert torch.equal(excl, wexcl), (trial, low, span)
        assert bandc == wbandc
        if any0:
            assert low + krel == wkstar, (trial, low, span)
            n += 1
    assert n > 50


def _vmaxu2(a, b):
    return torch.maximum(a >> 16, b >> 16) << 16 | torch.maximum(
        a & 0xFFFF, b & 0xFFFF)


@pytest.mark.parametrize("W", [64, 128])
def test_round_b_packed_prune_key(W):
    """(b) The prune's hi_rel and lo_rel: per warp max(rel + 1) and
    max(W - rel) over the ok slots packed into one word, the warps' words
    combined by a per-halfword max, against a max and a min."""
    rng = np.random.default_rng(W)
    rel = torch.arange(W)
    for trial in range(400):
        ok = torch.as_tensor(rng.random(W) < (0.0, 0.03, 0.5)[trial % 3])
        hi = torch.where(ok, rel + 1, 0).view(W // 32, 32).max(1).values
        lo = torch.where(ok, W - rel, 0).view(W // 32, 32).max(1).values
        per = hi << 16 | lo
        tot = per[0]
        for i in range(1, W // 32):
            tot = _vmaxu2(tot, per[i])
        hi_rel = int(torch.where(ok, rel, -1).max())
        lo_rel = int(torch.where(ok, rel, W).min())
        assert int(tot >> 16) - 1 == hi_rel
        if hi_rel >= 0:
            assert W - int(tot & 0xFFFF) == lo_rel


def test_source_note_names_the_round_barriers():
    """The source note names each round by its line; those lines hold the
    barrier (round 0) or a Rounds::meet, which meets at the block barrier.
    Every wave kernel, the lane-packed rows' too, meets there: the named
    half-block barrier (HalfBar, bar.sync id, 64) and the lane-packed
    kernels that ran on it are gone, from the probes too, which price the
    block barrier beside one row a warp."""
    lines = BODY.splitlines()
    note = dict(re.findall(r"round (0|A|B) \(:(\d+)\)", BODY))
    assert set(note) == {"0", "A", "B"}
    assert "__syncthreads()" in lines[int(note["0"]) - 1]
    for r in "AB":
        assert "rd.meet(" in lines[int(note[r]) - 1], r
    meet = BODY[BODY.index("const int4* meet(int4 r0, int4 r1)"):]
    assert "__syncthreads();" in meet[:meet.index("\n  }")]
    csrc = pathlib.Path(__file__).resolve().parent.parent \
        / "damapper_tpu_torch" / "csrc"
    for f in ("wave.cu", "wave_persistent.cu", "wave_body.cuh", "probes.cu"):
        text = (csrc / f).read_text()
        for gone in ("HalfBar", "bar.sync %0, 64", "_lp_kernel"):
            assert gone not in text, (f, gone)
    probes = (csrc / "probes.cu").read_text()
    assert "struct BlockBar" in probes and "struct WarpBar" in probes


# ---------------------------------------------------------------------------
# (c) the adversarial lanes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_adversarial_lanes_match_jax_driver(reverse):
    """(c) Exact repeats, exact runs of 60-600 bases, seeds on the first and
    last bases of the genome and of the memory: the plain version equals the
    JAX classic driver field for field and pool cell for pool cell."""
    seqmem, insts = make_adversarial_lane_cases(7)
    j, r = _run_both(seqmem, insts, reverse)
    assert _assert_lanes_equal(j, r) >= len(insts) - 1
    assert int(r["waves"].max()) > 100

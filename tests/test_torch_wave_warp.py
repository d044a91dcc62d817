"""The lane-packed rows on one 64-thread block a lane, on the CPU.

The lane-packed rows (the ``lanepack`` layouts of ops/wave_cuda.py and
ops/wave_persistent.py) ran two W=64 lanes in a 128-thread block, each half
on a named barrier.  Their redesign was measured on the card in two forms:
one W=64 lane on one warp (a warp team of shuffles, votes and redux.sync,
no barrier) and one lane to a 64-thread block on the block barrier (the
plain kernel at W=64).  The warp lane lost at every launch size (PERF.md
§6), so its source is not kept, and the lane-packed rows run the plain
W=64 kernels.  What ships is held here:

  (a) the lane-packed rows' geometry: one lane to a 64-thread block, the
      plain kernels' launch in both directions, and zero lanes; and the
      persistent rows' windows (rows 4-6): every layout's launch asks for
      the same ring of shared-memory chunks whatever the window length L,
      and passes its direction and L through;
  (b) the A/B tool's cases (tools/wave_ab.py): rows 3 and 6 are the plain
      W=64 cases, timed once, and the persistent rows are timed by each of
      a build's routes, the long lanes at each count.

The kernels themselves are held against the plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py, and the source's round notes by
tests/test_torch_wave_words.py.
"""

import pytest
import torch

from damapper_tpu_torch.ops import wave_cuda, wave_persistent
from damapper_tpu_torch.tools import wave_ab


# ---------------------------------------------------------------------------
# (a) the lane-packed rows' geometry
# ---------------------------------------------------------------------------


class FakeLib:
    """Stands in for a kernel library: records each launcher call."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.endswith("_launch"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


def _fake_card(monkeypatch, mod):
    lib = FakeLib()
    monkeypatch.setattr(mod, "_load", lambda: lib)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    return lib


def _inputs(n, windows=False):
    g = torch.Generator().manual_seed(n)
    k = 8 if windows else 6
    ins = [torch.randint(0, 1000, (n,), generator=g, dtype=torch.int32)
           for _ in range(k)]
    return ins, torch.full((4000,), 2, dtype=torch.uint8)


@pytest.mark.parametrize("n", [0, 1, 7, 33])
def test_lanepack_rows_launch_the_plain_kernels_at_w64(monkeypatch, n):
    """The lane-packed layouts launch the plain layouts' kernels at W=64
    (one 64-thread block a lane, so any lane count fills its blocks), count
    the launch as the lane-packed row's, and launch nothing for zero
    lanes; a long window (L = 65,536) takes the ring of the short ones."""
    lib = _fake_card(monkeypatch, wave_cuda)
    ins, seq = _inputs(n)
    before = wave_cuda.wave_lanes.launches_lanepack
    res = wave_cuda._launch(ins, seq, seq, 100, 10, 1, 1, 64, 256, False,
                            1 << 20, "lanepack", None)
    assert res["pool"].shape == (n, 256, 4)
    if n == 0:
        assert lib.calls == []
        assert wave_cuda.wave_lanes.launches_lanepack == before
    else:
        (name, args), = lib.calls
        assert name == "wave_lanes_launch"
        assert args[10:13] == (n, 64, 256)
        assert wave_cuda.wave_lanes.launches_lanepack == before + 1
    lib = _fake_card(monkeypatch, wave_persistent)
    ins, seq = _inputs(n, windows=True)
    before = wave_persistent.wave_lanes_persistent.launches_lanepack
    wave_persistent._launch(ins, seq, seq, (100, 10, 1, 1), 64, 256, 65536,
                            True, "lanepack", None, 1 << 20, None)
    if n:
        (name, args), = lib.calls
        assert name == "wave_persistent_launch"
        assert args[12:17] == (n, 64, 256, 65536, 1)
        assert args[17:19] == (wave_persistent.RING_CHUNK,
                               wave_persistent.RING_SLOTS)
        assert wave_persistent.wave_lanes_persistent.launches_lanepack \
            == before + 1
    else:
        assert lib.calls == []


@pytest.mark.parametrize("L", [2048, 4096, 8192, 16384, 32768, 65536])
def test_windows_of_a_lane_fit_shared_memory(monkeypatch, L):
    """A lane's windows take the same shared memory at every window
    length: each launch, plain and packed, asks for the ring geometry
    (RING_CHUNK, RING_SLOTS), whose two rings (one a window) take 16 KB a
    lane or less, whatever L is; an explicit ring is passed through."""
    wp = wave_persistent
    assert wp.ring_bytes() == 2 * wp.RING_CHUNK * wp.RING_SLOTS <= 16 * 1024
    assert wp.ring_bytes((2048, 16)) == 65536
    ins, seq = _inputs(3, windows=True)
    for layout, ring in (("plain", None), ("packed", None),
                         ("plain", (128, 1))):
        lib = _fake_card(monkeypatch, wp)
        wp._launch(ins, seq, seq, (100, 10, 1, 1), 64, 256, L, False,
                   layout, ring, 1 << 20, None)
        (name, args), = lib.calls
        geo = args[10:12] if layout == "packed" else args[17:19]
        assert geo == (ring or (wp.RING_CHUNK, wp.RING_SLOTS))


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("L", [2048, 65536, 131072])
def test_lanepack_rows_pass_direction_and_route(monkeypatch, reverse, L):
    """Both lane-packed rows hand the plain launcher their direction, and
    row 6 its window length and the one route every L takes now: the ring
    (no global route above some L)."""
    lib = _fake_card(monkeypatch, wave_cuda)
    ins, seq = _inputs(5)
    wave_cuda._launch(ins, seq, seq, 100, 10, 1, 1, 64, 256, reverse,
                      1 << 20, "lanepack", None)
    (name, args), = lib.calls
    assert name == "wave_lanes_launch" and args[13] == int(reverse)
    lib = _fake_card(monkeypatch, wave_persistent)
    ins, seq = _inputs(5, windows=True)
    wave_persistent._launch(ins, seq, seq, (100, 10, 1, 1), 64, 256, L,
                            reverse, "lanepack", None, 1 << 20, None)
    (name, args), = lib.calls
    assert name == "wave_persistent_launch"
    assert args[15:19] == (L, int(reverse), wave_persistent.RING_CHUNK,
                           wave_persistent.RING_SLOTS)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("L", [2048, 131072])
def test_packed_row_passes_its_record_direction_and_l(monkeypatch, reverse,
                                                      L):
    """Row 5 hands the packed launcher one (N, 8) record (built from the
    lane tensors and window starts, or the caller's own), its direction,
    L and the ring; the launch counts as the packed row's."""
    wp = wave_persistent
    ins, seq = _inputs(5, windows=True)
    rec = wave_cuda.pack_record(ins)
    for record in (None, rec):
        lib = _fake_card(monkeypatch, wp)
        before = wp.wave_lanes_persistent.launches_packed
        wp._launch(ins, seq, seq, (100, 10, 1, 1), 64, 256, L, reverse,
                   "packed", None, 1 << 20, record)
        (name, args), = lib.calls
        assert name == "wave_persistent_packed_launch"
        assert args[5:12] == (5, 64, 256, L, int(reverse), wp.RING_CHUNK,
                              wp.RING_SLOTS)
        assert wp.wave_lanes_persistent.launches_packed == before + 1
        if record is not None:
            assert args[0] == rec.data_ptr()


# ---------------------------------------------------------------------------
# (b) the A/B tool's cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("routes", [(), ("1024:8",), ("1024:8", "whole"),
                                    ("smem", "global")],
                         ids=["classic", "shipped", "rings", "parent"])
def test_wave_ab_times_each_kernel_once(routes):
    """Rows 3 and 6 are the plain W=64 cases, so no kernel is timed twice
    under two names; the persistent rows 4-6 are timed by each of a
    build's routes (a ring geometry each, or an older whole-window build's
    smem and global), and so are the long lanes at each count, 8 and
    1,024; a build without persistent kernels has no persistent case."""
    cases = wave_ab.cases([128, 1024], routes, (8, 1024))
    assert len(set(cases)) == len(cases)
    assert {c[2] for c in cases} == {"plain", "packed"}
    assert any(c[1] == "persistent" for c in cases) == bool(routes)
    for n in (128, 1024):
        for rev in (False, True):
            assert (n, "classic", "plain", 64, rev, "") in cases
            for route in routes:
                for lay in ("plain", "packed"):
                    assert (n, "persistent", lay, 64, rev, route) in cases
                for nl in ("long8", "long1024"):
                    assert (nl, "persistent", "plain", 64, rev,
                            route) in cases
    assert wave_ab.ring_geometry("1024:8", 65536) == (1024, 8)
    for L in (2048, 16384, 65536):
        c, k = wave_ab.ring_geometry("whole", L)
        assert c * k == L and c >= 128 and k <= 32

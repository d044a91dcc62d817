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
      plain kernels' launch in both directions, 2L bytes of windows a
      block (in shared memory up to L = 65,536, the global route above),
      and zero lanes;
  (b) the A/B tool's cases (tools/wave_ab.py): rows 3 and 6 of a build
      without lane-packed launchers are its plain W=64 cases, timed once.

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
    lanes; a long window (L = 65,536, 2L bytes a block) takes the
    shared-memory route."""
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
    smem = wave_persistent.window_fits_smem(65536)
    wave_persistent._launch(ins, seq, seq, (100, 10, 1, 1), 64, 256, 65536,
                            True, "lanepack", smem, 1 << 20, None)
    if n:
        (name, args), = lib.calls
        assert name == "wave_persistent_launch"
        assert args[12:17] == (n, 64, 256, 65536, 1)
        assert args[17] == 1       # the shared-memory route
        assert wave_persistent.wave_lanes_persistent.launches_lanepack \
            == before + 1
    else:
        assert lib.calls == []


@pytest.mark.parametrize("L", [2048, 4096, 8192, 16384, 32768, 65536])
def test_windows_of_a_lane_fit_shared_memory(L):
    """One lane's A and B windows (2L bytes) and the body's static state fit
    the 227 KB a block may use at every window length up to 65,536, in
    every layout: the long reads' 65,536-base windows, which two lanes a
    block pushed to the global route, now stay in shared memory."""
    wp = wave_persistent
    assert wp.window_bytes(L) == 2 * L
    assert wp.window_fits_smem(L)
    assert not wp.window_fits_smem(2 * 65536)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("L", [2048, 65536, 131072])
def test_lanepack_rows_pass_direction_and_route(monkeypatch, reverse, L):
    """Both lane-packed rows hand the plain launcher their direction, and
    row 6 takes the shared-memory route exactly where one lane's windows
    fit (every L up to 65,536) and the global route above."""
    lib = _fake_card(monkeypatch, wave_cuda)
    ins, seq = _inputs(5)
    wave_cuda._launch(ins, seq, seq, 100, 10, 1, 1, 64, 256, reverse,
                      1 << 20, "lanepack", None)
    (name, args), = lib.calls
    assert name == "wave_lanes_launch" and args[13] == int(reverse)
    lib = _fake_card(monkeypatch, wave_persistent)
    ins, seq = _inputs(5, windows=True)
    smem = wave_persistent.window_fits_smem(L)
    assert smem == (L <= 65536)
    wave_persistent._launch(ins, seq, seq, (100, 10, 1, 1), 64, 256, L,
                            reverse, "lanepack", smem, 1 << 20, None)
    (name, args), = lib.calls
    assert name == "wave_persistent_launch"
    assert args[15:18] == (L, int(reverse), int(smem))


# ---------------------------------------------------------------------------
# (b) the A/B tool's cases
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lanepack,persistent,persistent_lanepack",
                         [(False, False, False), (False, True, False),
                          (True, False, False), (True, True, True)],
                         ids=["classic", "shipped", "parent_classic",
                              "parent"])
def test_wave_ab_times_each_kernel_once(lanepack, persistent,
                                        persistent_lanepack):
    """A build without lane-packed launchers (this tree's) is timed in its
    plain W=64 cases only, which are rows 3 and 6, so no kernel is timed
    twice under two names; a build with them (an older one) adds row 3 and
    row 6 by both routes, the long lanes too; a build without persistent
    kernels has no persistent case."""
    cases = wave_ab.cases([128, 1024], lanepack, persistent,
                          persistent_lanepack)
    assert len(set(cases)) == len(cases)
    lays = {(c[1], c[2]) for c in cases}
    assert (("classic", "lanepack") in lays) == lanepack
    assert (("persistent", "lanepack") in lays) == persistent_lanepack
    assert any(c[1] == "persistent" for c in cases) == persistent
    for n in (128, 1024):
        for rev in (False, True):
            assert (n, "classic", "plain", 64, rev, "") in cases
            for route in ("smem", "global"):
                assert ((n, "persistent", "plain", 64, rev, route)
                        in cases) == persistent
                assert (("long", "persistent", "plain", 64, rev, route)
                        in cases) == persistent
                assert (("long", "persistent", "lanepack", 64, rev, route)
                        in cases) == persistent_lanepack

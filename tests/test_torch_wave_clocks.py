"""The section clocks of the wave body (tools/wave_clocks.py), on the CPU:
the tool's section names against the wave body's, and its per-wave account
on made-up cycles.  The clocked kernels themselves run only on the card
(``python3 -m damapper_tpu_torch.tools.wave_clocks``)."""

import pathlib
import re

import numpy as np
import pytest

from damapper_tpu_torch.tools import wave_clocks

BODY = (pathlib.Path(wave_clocks.__file__).resolve().parent.parent / "csrc"
        / "wave_body.cuh").read_text()


def test_sections_are_the_wave_body_sections_in_order():
    enum = re.search(r"enum \{\s*(SEC_.*?)NSEC", BODY, re.S).group(1)
    names = tuple(n.lower() for n in re.findall(r"SEC_(\w+),", enum))
    assert names == wave_clocks.SECTIONS
    # the wave body closes each section at exactly one point
    used = re.findall(r"WCLK\(SEC_(\w+)\);", BODY)
    assert sorted(u.lower() for u in used) == sorted(names)


def test_section_clocks_compile_to_nothing_by_default():
    """Without WAVE_SECTION_CLOCKS the three macros are empty, so the
    kernels of the mapping path are built from the same code as before."""
    off = BODY.split("#ifdef WAVE_SECTION_CLOCKS", 1)[1] \
        .split("#else", 1)[1].split("#endif", 1)[0]
    assert [ln.strip() for ln in off.strip().splitlines()] \
        == ["#define WCLK_BEGIN", "#define WCLK(sec)", "#define WCLK_END"]


@pytest.mark.parametrize("hz", [1.5e9, 1.98e9])
def test_summarize_takes_the_lane_with_the_most_waves(hz):
    rng = np.random.default_rng(3)
    ns = len(wave_clocks.SECTIONS)
    clocks = rng.integers(0, 10**6, (5, ns))
    waves = np.array([10, 40, 7, 0, 39])
    acc = wave_clocks.summarize(clocks, waves, hz)
    assert acc["lane"] == 1 and acc["waves"] == 40
    assert acc["prologue_ns"] == pytest.approx(clocks[1, 0] * 1e9 / hz)
    want = {s: clocks[1, k] * 1e9 / hz / 40
            for k, s in enumerate(wave_clocks.SECTIONS) if k}
    assert acc["ns_per_wave"] == pytest.approx(want)
    assert acc["sum_ns"] == pytest.approx(sum(want.values()))
    assert acc["all_lanes_ns"]["snake"] == pytest.approx(
        clocks[:, 3].sum() * 1e9 / hz / waves.sum())

"""The reduction of the profiler's device events: the busy union, the
gaps named by what ended them, and annotations left out."""

import pytest

from benchmark import devtrace


class Ev:
    def __init__(self, name, start, dur, dev="DeviceType.CUDA",
                 annotation=False):
        self._v = (name, start, dur, dev, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


def test_busy_is_the_union_and_gaps_are_named_by_what_ended_them():
    ms = 1_000_000
    events = [
        Ev("void k1<int>(int*)", 0, 10 * ms),
        Ev("void (anonymous namespace)::k2<true>(int*, long)", 5 * ms,
           10 * ms),                                   # overlaps k1
        Ev("Memcpy HtoD (Pageable -> Device)", 40 * ms, 5 * ms),
        Ev("void k1<int>(int*)", 100 * ms, 1 * ms),
        Ev("benchmark block", 0, 200 * ms, annotation=True),
        Ev("aten::copy_", 0, 300 * ms, dev="DeviceType.CPU"),
    ]
    t = devtrace.reduce(events, window_s=0.2)
    assert t.busy_s == pytest.approx(0.021)
    assert t.idle_pct == pytest.approx(100 * (1 - 0.021 / 0.2))
    assert t.gaps == [("host work, then k1<int>", pytest.approx(0.055)),
                      ("host work, then Memcpy HtoD (Pageable -> Device)",
                       pytest.approx(0.025))]
    assert dict(t.ops) == {"k1<int>": pytest.approx(0.011),
                           "(anonymous namespace)::k2<true>":
                               pytest.approx(0.010),
                           "Memcpy HtoD (Pageable -> Device)":
                               pytest.approx(0.005)}


def test_no_device_event_gives_no_trace():
    assert devtrace.reduce([Ev("aten::add", 0, 5, dev="DeviceType.CPU")],
                           1.0) is None

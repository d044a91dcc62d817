"""The span recorder (damapper_tpu_torch.utils.spans) and the spans of one
``run_damapper`` call, on the CPU; one test on the card (marker ``cuda``).

Nothing here imports JAX, so the file also runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -q tests/test_torch_spans.py
"""

import numpy as np
import pytest
import torch

from damapper_tpu_torch.io import db as dbio
from damapper_tpu_torch.io import fasta
from damapper_tpu_torch.pipeline import mapper
from damapper_tpu_torch.utils import spans
from tests import helpers

MS = 1_000_000


@pytest.fixture
def recorder():
    """A clean recorder, recording off again afterwards."""
    spans.disable()
    spans.drain()
    spans.begin_call()
    yield spans
    spans.disable()
    spans.drain()


@pytest.fixture
def clock(monkeypatch):
    """A hand-driven ns clock for the recorder: ``clock.t = ...``."""
    class Clock:
        t = 0
    c = Clock()
    monkeypatch.setattr(spans, "now", lambda: c.t)
    return c


def _ns(ev, name):
    f = getattr(ev, name + "_ns", None)
    return int(f()) if f is not None else int(getattr(ev, name + "_us")()
                                              * 1000)


@pytest.mark.parametrize("record", [True, False], ids=["on", "off"])
def test_nesting_and_self_time(recorder, clock, record):
    """A hand-built tree: a(0-100) holds b(10-40, holding c 20-30) and
    the interval d(50-90); each span's seconds, self seconds and count, and
    with recording on one record a span with its parent; off, none."""
    if record:
        spans.enable()
    with spans.span("a"):
        clock.t = 10
        with spans.span("b"):
            clock.t = 20
            with spans.span("c"):
                clock.t = 30
            clock.t = 40
        spans.interval("d", 50, 90)
        spans.count("k", 3)
        spans.count("k")
        clock.t = 100
    tot = spans.end_call()
    assert tot["spans"] == {
        "a": {"s": 100e-9, "self_s": 30e-9, "n": 1},
        "b": {"s": 30e-9, "self_s": 20e-9, "n": 1},
        "c": {"s": 10e-9, "self_s": 10e-9, "n": 1},
        "d": {"s": 40e-9, "self_s": 40e-9, "n": 1}}
    assert tot["counts"] == {"k": 4}
    assert spans.recent(1) == [tot]
    recs, dropped = spans.drain()
    assert dropped == 0
    if not record:
        assert recs == []
        return
    call = recs[0][1]
    assert recs == [("a", call, -1, 0, 100), ("b", call, 0, 10, 40),
                    ("c", call, 1, 20, 30), ("d", call, 0, 50, 90)]


def test_cap_drain_and_calls(recorder, clock, monkeypatch):
    """Records past the cap are counted as dropped; a span open at a drain
    is left out and its children lose their parent; each call has its own
    id and totals."""
    monkeypatch.setattr(spans, "CAP", 2)
    spans.enable()
    with spans.span("x"):
        with spans.span("y"):
            pass
        with spans.span("z"):
            pass
    assert spans.drain() == ([("x", spans._rec["call"], -1, 0, 0),
                              ("y", spans._rec["call"], 0, 0, 0)], 1)
    spans.begin_call()
    first = spans._rec["call"]
    with spans.span("open"):
        with spans.span("inner"):
            pass
        recs, _ = spans.drain()
        assert recs == [("inner", first, -1, 0, 0)]
    assert spans.drain() == ([], 0)
    assert spans.end_call()["spans"]["open"]["n"] == 1
    spans.begin_call()
    with spans.span("w"):
        pass
    assert spans._rec["call"] == first + 1
    assert set(spans.end_call()["spans"]) == {"w"}


@pytest.mark.parametrize("record", [True, False], ids=["on", "off"])
def test_a_sync_span_synchronizes_recorded_or_not(recorder, monkeypatch,
                                                  record):
    """sync=True ends the span in one torch.cuda.synchronize whether or not
    the spans are recorded, inside the span; a span without it calls none."""
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda: calls.append(len(spans._stack)))
    if record:
        spans.enable()
    with spans.span("plain"):
        pass
    assert calls == []
    with spans.span("synced", sync=True):
        pass
    assert calls == [1]
    assert spans.end_call()["spans"]["synced"]["n"] == 1


def _write_dataset(tmp, seed=11, glen=60_000, ncontigs=2, nreads=12):
    rng = np.random.default_rng(seed)
    genome = helpers.sim_genome(rng, glen)
    clen = glen // ncontigs
    entries = [fasta.FastaEntry(f"ctg{i}", genome[i * clen:(i + 1) * clen])
               for i in range(ncontigs)]
    reads = [helpers.sim_read(rng, entries[int(rng.integers(0, ncontigs))]
                              .seq, min_len=2000, max_len=6000)[0]
             for _ in range(nreads)]
    # the reference in two blocks, so that the full reference is decoded
    dbio.create_dam(str(tmp / "refmb.dam"), entries, bsize=25_000)
    dbio.create_db(str(tmp / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r)
                    for i, r in enumerate(reads)])


# each span of one call with the spans it may lie in
PARENTS = {"block": None, "load.reads": "block", "index": "block",
           "load.ref": "block", "match": "block", "chain": "block",
           "chain.sweep": "chain", "chain.push": "chain",
           "chain.export": "chain", "load.full": "block", "reporter": "block",
           "reporter.upload": "reporter", "reporter.tasks": "reporter",
           "reporter.round": "reporter", "engine.batch": "reporter.round",
           "engine.upload": "engine.batch", "engine.pull": "engine.batch",
           "engine.trace": "engine.batch", "engine.refine": "engine.batch",
           "engine.oracle": "engine.batch", "reporter.select": "reporter",
           "reporter.profile": "reporter", "write": "block"}


def test_one_call_has_the_span_tree_and_its_stage_seconds(tmp_path,
                                                         recorder):
    """One run_damapper call with -p on a two-block reference: the span
    tree's names and parents, one call id, LAST_STATS["times"] equal to
    the span sums key for key, the engine's steps equal to its host split,
    and the counters."""
    _write_dataset(tmp_path)
    spans.enable()
    mapper.run_damapper(str(tmp_path / "refmb.dam"),
                        str(tmp_path / "reads.db"),
                        mapper.DamapperConfig(device="cpu", host_min=0,
                                              profile=True),
                        out_dir=str(tmp_path))
    recs, dropped = spans.drain()
    st = mapper.LAST_STATS
    assert dropped == 0
    assert {r[1] for r in recs} == {recs[0][1]}
    names = {r[0] for r in recs}
    assert names == set(PARENTS)
    for name, _, parent, t0, t1 in recs:
        assert (recs[parent][0] if parent >= 0 else None) == PARENTS[name]
        if parent >= 0:
            assert recs[parent][3] <= t0 <= t1 <= recs[parent][4]
    s = st["spans"]
    assert set(s) == names
    for name in names:
        mine = [r for r in recs if r[0] == name]
        assert s[name]["n"] == len(mine)
        assert s[name]["s"] == pytest.approx(
            sum(r[4] - r[3] for r in mine) / 1e9, abs=1e-9)
    assert set(st["times"]) == {"load", "index", "match", "chain", "align"}
    assert st["times"] == pytest.approx({
        "load": s["load.reads"]["s"] + s["load.ref"]["s"]
        + s["load.full"]["s"],
        "index": s["index"]["s"], "match": s["match"]["s"],
        "chain": s["chain"]["s"], "align": s["reporter"]["s"]}, rel=1e-12)
    steps = sum(v["s"] for k, v in s.items() if k.startswith("engine.")
                and k != "engine.batch")
    assert steps == pytest.approx(sum(st["align_host_split"].values()),
                                  rel=1e-6)
    assert s["block"]["self_s"] == pytest.approx(
        s["block"]["s"] - sum(v["s"] for k, v in s.items()
                              if PARENTS.get(k) == "block"), abs=1e-9)
    c = st["counts"]
    assert set(c) == {"engine.launches", "engine.launch_lanes",
                      "engine.walk_lanes", "engine.walk_native_lanes",
                      "chain.cands", "chain.cands_native",
                      "chain.cands_kept"}
    # every candidate of every pass pushed by the native push
    assert c["chain.cands_native"] == c["chain.cands"] >= \
        c["chain.cands_kept"] > 0
    assert c["engine.launch_lanes"] >= st["n_lanes"] > 0
    # every lane of every pass walked, each by the native walk
    assert c["engine.walk_native_lanes"] == c["engine.walk_lanes"] > 0
    assert c["engine.launches"] == sum(st["kernel_launches"].values())
    for gone in ("mesh_ranks", "cell_updates"):
        assert gone not in st
    assert spans.recent(1)[0] == {"spans": s, "counts": c}


def test_spans_share_the_profilers_clock(recorder):
    """A profiler range opened inside a span (CPU activity) starts and ends
    inside the span's [t0, t1], within 0.5 ms."""
    from torch.profiler import ProfilerActivity, profile, record_function
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("outer"):
            with record_function("inside the span"):
                torch.ones(1000).sum()
    (_, _, _, t0, t1), = spans.drain()[0]
    ev, = [e for e in prof.profiler.kineto_results.events()
           if e.name() == "inside the span"]
    a = _ns(ev, "start")
    b = a + _ns(ev, "duration")
    assert t0 - MS // 2 <= a <= b <= t1 + MS // 2, (t0, a, b, t1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_sync_span_holds_its_kernel_on_the_card(cuda_device, recorder):
    """A kernel enqueued inside a sync=True span lies inside the span in the
    profiler's device events, within 0.5 ms."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    spans.enable()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with spans.span("sleep", sync=True):
            torch.cuda._sleep(20_000_000)
    (_, _, _, t0, t1), = spans.drain()[0]
    # the kernel is torch's spin_kernel; runtime calls are not device work
    dev = [e for e in prof.profiler.kineto_results.events()
           if "cuda" in str(e.device_type()).lower()
           and "spin_kernel" in e.name()]
    assert len(dev) == 1, [(e.name(), str(e.device_type()))
                           for e in prof.profiler.kineto_results.events()]
    a = _ns(dev[0], "start")
    b = a + _ns(dev[0], "duration")
    print(f"span [{t0}, {t1}] ns, kernel [{a}, {b}] ns: starts "
          f"{(a - t0) / 1e6:.3f} ms after the span, ends "
          f"{(t1 - b) / 1e6:.3f} ms before its end")
    assert b - a > 1 * MS
    assert t0 - MS // 2 <= a <= b <= t1 + MS // 2, (t0, a, b, t1)

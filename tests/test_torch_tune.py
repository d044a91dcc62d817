"""The port's measure-then-pick loop and its tuning tools
(damapper_tpu_torch/tools/: clip_fuzz, wave_build_gate, wave_modes,
pick_wave_mode, wave_sweep, wave_kit, join_ab, index_profile, sort_floor;
ops.wave_engine's mode resolution and kit) against the JAX package's tools
and engine, on the CPU.

The clip cases come from numpy seeds and go unchanged to both packages;
records must be equal (tolerance 0).  On the CPU the engine runs the plain
versions of the wave kernels; the tools that need a card raise without one
unless they are given --device cpu.
"""

import importlib.util
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damapper_tpu.ops.spec import new_align_spec
from damapper_tpu.ops.wave_jax import WaveEngine as JaxWaveEngine
from damapper_tpu.ops.wave_pallas import PallasWaveEngine
from damapper_tpu_torch.ops import device_index as dix
from damapper_tpu_torch.ops import wave_engine as twe
from damapper_tpu_torch.ops.spec import new_align_spec as t_new_align_spec
from damapper_tpu_torch.tools import (clip_fuzz, index_profile, join_ab,
                                      pick_wave_mode, sort_floor, tuning,
                                      wave_build_gate, wave_kit, wave_modes,
                                      wave_sweep)
from damapper_tpu_torch.utils.sim import make_clip_cases, make_lane_cases
from tests import helpers

SPEC = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
T_SPEC = t_new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
CARD = "NVIDIA H100 80GB HBM3"
KNOBS = ("DAMAPPER_WAVE_PERSISTENT", "DAMAPPER_WAVE_PACKOPS",
         "DAMAPPER_WAVE_LANEPACK", "DAMAPPER_WAVE_BANDCAP",
         "DAMAPPER_WAVE_HOSTMIN", "DAMAPPER_WAVE_KIT",
         "DAMAPPER_WAVE_KIT_CAP")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for k in KNOBS:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", helpers.REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_clip_fuzz():
    sys.path.insert(0, str(helpers.REPO / "tools"))
    import clip_fuzz as mod
    return mod


# ---- make_clip_cases ------------------------------------------------------

@pytest.mark.parametrize("seed", [7000, 7001, 7002])
def test_make_clip_cases_is_the_jax_tools(seed, jax_clip_fuzz):
    """The same bytes and the same lanes as tools/clip_fuzz.py's."""
    jm, ji = jax_clip_fuzz.make_clip_cases(seed, 48)
    tm, ti = make_clip_cases(seed, 48)
    assert tm.dtype == jm.dtype and tm.tobytes() == jm.tobytes()
    assert ti == ji


# ---- clip fuzz --------------------------------------------------------------

@pytest.fixture(scope="module")
def clip_run():
    """clip_fuzz.run of seed 7000's 32 cases in every mode, plain versions
    on the CPU."""
    return clip_fuzz.run(7000, 32, list(tuning.MODES), 128,
                         torch.device("cpu"))


def _key(p):
    a, b = p
    return (a.abpos, a.bbpos, a.aepos, a.bepos, a.diffs,
            tuple(int(x) for x in a.trace), tuple(int(x) for x in b.trace))


@pytest.fixture(scope="module")
def jax_clip_records():
    """damapper_tpu's WaveEngine (the JAX clip fuzz's default engine) on
    the same cases at W=128 and W=64."""
    seqmem, insts = make_clip_cases(7000, 32)
    dev = jnp.asarray(seqmem)
    out = {}
    for W in (128, 64):
        eng = JaxWaveEngine(SPEC, band_cap=W, pool_cap=2048)
        eng.host_min = 0
        out[W] = [_key(r) for r in eng.local_alignment_batch(
            dev, dev, seqmem, seqmem, insts)]
    return out


@pytest.mark.parametrize("mode", list(tuning.MODES))
def test_clip_fuzz_plain_kernels_match_oracle_and_jax(mode, clip_run,
                                                      jax_clip_records):
    bad, fb, launches, got = clip_run[mode]
    assert bad == 0
    assert sum(launches.values()) == 0       # the plain versions ran
    W = 128 if mode in ("classic", "classic_packops") else 64
    assert [_key(r) for r in got] == jax_clip_records[W]


def test_clip_fuzz_main_exits_zero_on_the_cpu(monkeypatch, capsys):
    monkeypatch.setenv("FUZZ_CASES", "8")
    assert clip_fuzz.main(["1", "--mode", "classic,plp", "--device",
                           "cpu"]) == 0
    assert "TOTAL: 0 mismatches over 2 modes" in capsys.readouterr().out


# ---- mode resolution --------------------------------------------------------

FILE = {"persistent": True, "packops": False, "lanepack": True,
        "platform": "cuda", "card": CARD}


@pytest.mark.parametrize("dev,args,env,file,want,src", [
    # nothing set: the built-in defaults
    ("cuda", {}, {}, {}, (False, False, False, 128, 16), "default"),
    ("cpu", {}, {}, {}, (False, False, False, 64, 16), "default"),
    # the file on the card
    ("cuda", {}, {}, FILE, (True, False, True, 64, 16), "file"),
    # the environment beats the file, one knob at a time
    ("cuda", {}, {"DAMAPPER_WAVE_PERSISTENT": "0"}, FILE,
     (False, False, True, 64, 16), "file"),
    ("cuda", {}, {"DAMAPPER_WAVE_PERSISTENT": "0",
                  "DAMAPPER_WAVE_PACKOPS": "0",
                  "DAMAPPER_WAVE_LANEPACK": "0"}, FILE,
     (False, False, False, 128, 16), "env"),
    # the argument beats the environment and the file
    ("cuda", dict(persistent=False, packops=False, lanepack=False),
     {"DAMAPPER_WAVE_PERSISTENT": "1"}, FILE,
     (False, False, False, 128, 16), "arg"),
    ("cuda", dict(persistent=True), {}, {},
     (True, False, False, 64, 16), "arg"),
    # band and host_min: argument, environment, file, default
    ("cuda", {}, {"DAMAPPER_WAVE_BANDCAP": "64",
                  "DAMAPPER_WAVE_HOSTMIN": "0"}, {},
     (False, False, False, 64, 0), "default"),
    ("cuda", dict(band_cap=128, host_min=5),
     {"DAMAPPER_WAVE_BANDCAP": "64", "DAMAPPER_WAVE_HOSTMIN": "0"}, {},
     (False, False, False, 128, 5), "default"),
    ("cuda", {}, {}, dict(FILE, band_cap=128, host_min=0),
     (True, False, True, 128, 0), "file"),
    # the CPU never reads a file, whatever it holds
    ("cpu", {}, {}, dict(FILE, host_min=0),
     (False, False, False, 64, 16), "default"),
])
def test_resolve_wave_mode_order(dev, args, env, file, want, src):
    vals, srcs = twe.resolve_wave_mode(dev, args, env, file)
    assert tuple(vals[k] for k in ("persistent", "packops", "lanepack",
                                   "band_cap", "host_min")) == want
    assert srcs["mode"] == src


@pytest.mark.parametrize("body,card,applies", [
    (FILE, CARD, True),
    (FILE, "NVIDIA H200", False),              # another card
    (dict(FILE, platform="tpu"), CARD, False),  # another platform
    (None, CARD, False),                       # no file
])
def test_mode_file_applies_only_on_its_card(body, card, applies, tmp_path,
                                            monkeypatch):
    path = tmp_path / "wave_mode.json"
    if body is not None:
        path.write_text(json.dumps(body))
    monkeypatch.setattr(twe, "MODE_FILE", path)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: card)
    got = twe.mode_file_for(torch.device("cuda"))
    assert got == (body if applies else {})
    # the CPU ignores the file even where it names this card
    assert twe.mode_file_for(torch.device("cpu")) == {}
    eng = twe.WaveEngine(T_SPEC, device="cpu")
    assert (eng.mode, eng.mode_source) == ("classic", "default")


@pytest.mark.parametrize("env", [
    {}, {"DAMAPPER_WAVE_BANDCAP": "128"}, {"DAMAPPER_WAVE_BANDCAP": "64"},
    {"DAMAPPER_WAVE_PERSISTENT": "1"},
    {"DAMAPPER_WAVE_LANEPACK": "1", "DAMAPPER_WAVE_BANDCAP": "64"},
    {"DAMAPPER_WAVE_HOSTMIN": "0"}, {"DAMAPPER_WAVE_HOSTMIN": "40"},
], ids=lambda e: ",".join(f"{k[14:]}={v}" for k, v in e.items()) or "none")
def test_bandcap_and_hostmin_resolve_as_jax_engine(env, monkeypatch):
    """DAMAPPER_WAVE_BANDCAP as PallasWaveEngine resolves it (on its
    accelerator path and on the CPU's), DAMAPPER_WAVE_HOSTMIN as the JAX
    WaveEngine does."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for use_pallas, dev in ((True, "cuda"), (False, "cpu")):
        jeng = PallasWaveEngine(SPEC, use_pallas=use_pallas)
        vals, _ = twe.resolve_wave_mode(dev, {}, os.environ, {})
        assert vals["band_cap"] == jeng.W
        assert vals["host_min"] == jeng.host_min
    teng = twe.WaveEngine(T_SPEC, device="cpu")
    assert (teng.W, teng.host_min) == (
        PallasWaveEngine(SPEC, use_pallas=False).W,
        JaxWaveEngine(SPEC).host_min)


def test_engine_and_mapper_say_where_the_mode_came_from(monkeypatch,
                                                        tmp_path):
    from damapper_tpu_torch.io import db as dbio
    from damapper_tpu_torch.io import fasta
    from damapper_tpu_torch.pipeline import mapper
    from damapper_tpu_torch.utils.sim import sim_genome, sim_read
    assert twe.WaveEngine(T_SPEC, device="cpu").mode_source == "default"
    assert twe.WaveEngine(T_SPEC, device="cpu",
                          persistent=False).mode_source == "arg"
    monkeypatch.setenv("DAMAPPER_WAVE_PACKOPS", "1")
    eng = twe.WaveEngine(T_SPEC, device="cpu")
    assert (eng.mode, eng.mode_source) == ("classic+packops", "env")
    rng = np.random.default_rng(5)
    genome = sim_genome(rng, 12_000)
    reads = [sim_read(rng, genome, min_len=1500, max_len=2500)[0]
             for _ in range(3)]
    dbio.create_dam(str(tmp_path / "ref.dam"),
                    [fasta.FastaEntry("g", genome)])
    dbio.create_db(str(tmp_path / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", r) for i, r in
                    enumerate(reads)])
    mapper.run_damapper(str(tmp_path / "ref.dam"), str(tmp_path / "reads.db"),
                        mapper.DamapperConfig(device="cpu", host_min=0),
                        out_dir=str(tmp_path))
    st = mapper.LAST_STATS
    assert (st["wave_mode"], st["wave_mode_source"]) == ("classic+packops",
                                                         "env")
    assert set(st["align_host_split"]) == set(twe.HOST_STEPS)
    assert st["n_lanes"] > 0 and sum(st["align_host_split"].values()) > 0


# ---- the kit ----------------------------------------------------------------

@pytest.mark.parametrize("mode", ["classic", "persistent"])
def test_kit_changes_no_record_and_its_waves_sum(mode, monkeypatch):
    """err30 lanes take the fshort/rshort redo rounds; a 3-lane round stays
    on the host (host_min=4)."""
    seqmem, insts = make_lane_cases(1000, 6, err=0.30)
    pers = mode == "persistent"

    def run():
        eng = twe.WaveEngine(T_SPEC, device="cpu", host_min=4,
                             persistent=pers)
        mem = eng.upload(seqmem)
        got = eng.local_alignment_batch(mem, mem, seqmem, seqmem, insts)
        got += eng.local_alignment_batch(mem, mem, seqmem, seqmem,
                                         insts[:3])
        return eng, [_key(r) for r in got]

    plain, want = run()
    assert plain.kit_log is None
    monkeypatch.setenv("DAMAPPER_WAVE_KIT", "1")
    eng, got = run()
    assert got == want
    log = list(eng.kit_log)
    assert sum(int(e["waves"].sum()) for e in log) == eng.total_waves \
        == plain.total_waves
    dirs = [e["dir"] for e in log]
    assert dirs[:2] == ["fwd", "rev"] and dirs[-1] == "host"
    assert len(dirs) > 3                     # the redo rounds launched
    assert all(e["lanes"] == len(e["waves"]) for e in log
               if e["dir"] != "host")
    for s in twe.HOST_STEPS:
        assert sum(e["host_s"][s] for e in log) == pytest.approx(
            eng.host_s[s])
    assert eng.host_s["oracle"] > 0 and eng.host_s["trace"] > 0
    assert sum(eng.host_s.values()) <= eng.t_batch
    rec = wave_kit.summarize(log, 1.0)
    assert rec["total_waves"] == eng.total_waves
    assert rec["longest_lane_waves"] == max(int(e["waves"].max(initial=0))
                                            for e in log)
    monkeypatch.setenv("DAMAPPER_WAVE_KIT_CAP", "2")
    capped, _ = run()
    assert len(capped.kit_log) == 2 and capped.kit_log[-1]["dir"] == "host"


def test_wave_kit_main_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "kit.jsonl"
    assert wave_kit.main(["4", "1500", "1000", "--reps", "1", "--device",
                          "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert rec["platform"] == "cpu" and rec["total_waves"] > 0
    assert [x["dir"] for x in rec["launches"]][:2] == ["fwd", "rev"]


# ---- picker -----------------------------------------------------------------

def _relabel(rows, card=CARD):
    return [dict(r, platform="cuda", card=card) for r in rows]


PICK_ROWS = [
    {"platform": "cpu", "ncases": 64, "ms_per_lane": 0.1,
     "persistent": True, "packops": False, "lanepack": False},
    {"platform": "tpu", "ncases": 8, "ms_per_lane": 0.2,
     "persistent": True, "packops": False, "lanepack": False},
    {"platform": "tpu", "ncases": 64, "ms_per_lane": 3.2,
     "persistent": False, "packops": False, "lanepack": False},
    {"platform": "tpu", "ncases": 64, "ms_per_lane": 2.9,
     "persistent": False, "packops": False, "lanepack": False},
    {"platform": "tpu", "ncases": 64, "ms_per_lane": 1.1,
     "persistent": True, "packops": True, "lanepack": False},
    {"platform": "tpu", "ncases": 256, "ms_per_lane": 1.4,
     "persistent": False, "packops": False, "lanepack": True}]


@pytest.mark.parametrize("source", ["wave_ab_results", "test_rows"])
def test_pick_equals_jax_pick(source):
    """The same winner and group as tools/pick_wave_mode.py's pick() on
    the same rows, relabelled to the card."""
    jax_pick = _jax_tool("pick_wave_mode").pick
    if source == "wave_ab_results":
        rows = tuning.read_rows(helpers.REPO / "tools"
                                / "wave_ab_results.jsonl")
    else:
        rows = [r for r in PICK_ROWS if r["ncases"] >= 32
                and r["platform"] != "cpu"]
    rows = _relabel(rows)
    want = jax_pick(rows)
    got = pick_wave_mode.pick(rows, CARD)
    assert got is not None and got == want
    # rows of another card or platform never compete
    other = _relabel(rows, "NVIDIA A100") + [dict(r, platform="tpu")
                                             for r in rows]
    assert pick_wave_mode.pick(other, CARD) is None
    assert pick_wave_mode.pick(other + rows, CARD) == want


def _mode_rows(modes, ms):
    return [dict(mode=m, **tuning.triple(m), ncases=64, rlen=6000,
                 platform="cuda", card=CARD, ms_per_lane=v, ts=1.0)
            for m, v in zip(modes, ms)]


def test_picker_refuses_a_building_mode_left_unmeasured(tmp_path, capsys):
    res, status, mf = (tmp_path / n for n in ("r.jsonl", "s.json",
                                              "wave_mode.json"))
    tuning.append_rows(res, _mode_rows(list(tuning.MODES)[:5],
                                       [3, 2, 4, 5, 6]))
    gate = {m: {"status": "ok"} for m in tuning.MODES}
    status.write_text(json.dumps(gate))
    argv = [str(res), "--status", str(status), "--mode-file", str(mf),
            "--card", CARD]
    assert pick_wave_mode.main(argv) == 1
    assert "plp" in capsys.readouterr().out and not mf.exists()
    # a mode the gate marks failed need not be measured
    gate["plp"] = {"status": "fail", "reason": "nvcc failed"}
    status.write_text(json.dumps(gate))
    assert pick_wave_mode.main(argv + ["--dry-run"]) == 0
    assert "pick: classic_packops" in capsys.readouterr().out
    assert not mf.exists()
    assert pick_wave_mode.main(argv) == 0
    got = json.loads(mf.read_text())
    assert (got["persistent"], got["packops"], got["lanepack"],
            got["platform"], got["card"]) == (False, True, False, "cuda",
                                              CARD)
    assert got["source"] == "r.jsonl"
    # the written file steers an engine on that card only
    assert twe.resolve_wave_mode("cuda", {}, {}, got)[0]["packops"]
    assert not twe.resolve_wave_mode("cpu", {}, {}, got)[0]["packops"]
    assert pick_wave_mode.main(argv + ["--dry-run"]) == 0
    assert "says the same" in capsys.readouterr().out


# ---- build gate -------------------------------------------------------------

def test_build_gate_on_the_cpu_and_a_failing_mode(tmp_path):
    status = tmp_path / "st" / "status.json"
    assert wave_build_gate.main(["--device", "cpu", "--modes",
                                 "classic,plp", "--status",
                                 str(status)]) == 0
    got = json.loads(status.read_text())
    assert sorted(got) == ["classic", "plp"]
    assert all(v["status"] == "ok" and v["card"] == "cpu" for v in
               got.values())
    # a probe that cannot finish is a failure with its reason, never ok
    rec = wave_build_gate.gate("classic", 0.01, "cpu")
    assert rec["status"] == "fail" and "timeout" in rec["reason"]


def test_gate_probe_fails_when_a_lane_differs(monkeypatch):
    from damapper_tpu_torch.ops import wave as host
    real = host.local_alignment

    def off_by_one(*a, **kw):
        ap, bp = real(*a, **kw)
        ap.diffs += 1
        return ap, bp

    monkeypatch.setattr(host, "local_alignment", off_by_one)
    with pytest.raises(RuntimeError, match="differ from the oracle"):
        wave_build_gate.probe("classic", "cpu")


# ---- mode A/B and sweep -----------------------------------------------------

def test_wave_modes_rows_on_the_cpu(tmp_path):
    log = tmp_path / "rows.jsonl"
    assert wave_modes.main(["4", "1200", "--reps", "1", "--device", "cpu",
                            "--log", str(log)]) == 0
    rows = tuning.read_rows(log)
    assert [r["mode"] for r in rows] == list(tuning.MODES)
    for r in rows:
        assert {"persistent", "packops", "lanepack", "group", "ncases",
                "rlen", "mix", "platform", "total_s", "ms_per_lane",
                "fallback", "ts", "card", "power_limit_w",
                "kernel_ms"} <= set(r)
        assert (r["platform"], r["card"], r["ncases"]) == ("cpu", "cpu", 4)
        assert tuple(r[k] for k in ("persistent", "packops", "lanepack")) \
            == tuning.MODES[r["mode"]]
    # CPU rows never compete for the card's default
    assert pick_wave_mode.pick(rows, CARD) is None


def test_wave_modes_pins_every_knob(monkeypatch, tmp_path):
    """Neither the environment nor a mode file relabels a row."""
    monkeypatch.setenv("DAMAPPER_WAVE_PERSISTENT", "1")
    monkeypatch.setenv("DAMAPPER_WAVE_BANDCAP", "128")
    monkeypatch.setenv("DAMAPPER_WAVE_HOSTMIN", "99")
    for mode in tuning.MODES:
        eng = tuning.engine(torch.device("cpu"), mode)
        assert (eng.persistent, eng.layout != "plain") == (
            tuning.MODES[mode][0], any(tuning.MODES[mode][1:]))
        assert (eng.W, eng.host_min, eng.mode_source) == (64, 0, "arg")


def test_doubling_rounds():
    assert wave_sweep.doubling_rounds(256) == [1, 2, 4, 8, 16, 32, 64, 128,
                                               1]
    assert wave_sweep.doubling_rounds(5) == [1, 2, 2]
    assert sum(wave_sweep.doubling_rounds(1000)) == 1000


def test_wave_sweep_shapes_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(wave_sweep, "SHAPES",
                        [(64, 2048, 16), (128, 2048, 0), (64, 1024, 64)])
    log = tmp_path / "sweep.jsonl"
    assert wave_sweep.main(["6", "1200", "--reps", "1", "--device", "cpu",
                            "--log", str(log)]) == 0
    rows = tuning.read_rows(log)
    assert [(r["band_cap"], r["pool_cap"], r["host_min"]) for r in rows] \
        == [(64, 2048, 16), (128, 2048, 0), (64, 1024, 64)]
    assert all(r["sweep"] and r["mismatches"] == 0 for r in rows)
    assert "card only" in capsys.readouterr().out


# ---- join A/B, index profile, sort floors -----------------------------------

@pytest.fixture(scope="module")
def small_dataset(tmp_path_factory):
    from damapper_tpu_torch.bench import Knobs, build_dataset
    k = Knobs(glen=300_000, nreads=20,
              data=tmp_path_factory.mktemp("bench"))
    build_dataset(k.work(), k)
    return k.work()


def test_join_ab_modes_give_equal_hits_on_the_cpu(small_dataset, tmp_path):
    out = tmp_path / "join.jsonl"
    assert join_ab.main([str(small_dataset), "reads", "--reps", "1",
                         "--device", "cpu", "--out", str(out)]) == 0
    rows = tuning.read_rows(out)
    assert [r["mode"] for r in rows] == list(dix.JOIN_MODES)
    assert all(r["status"] == "ok" and r["identical_across_modes"]
               for r in rows)
    assert len({(r["nhits_f"], r["nhits_c"], r["nq"], r["nref"])
                for r in rows}) == 1 and rows[0]["nhits_f"] > 0


def test_join_ab_records_a_runaway_mode(small_dataset, tmp_path):
    out = tmp_path / "join.jsonl"
    assert join_ab.main([str(small_dataset), "reads", "--modes", "sortg",
                         "--timeout", "0.01", "--device", "cpu", "--out",
                         str(out)]) == 1
    (row,) = tuning.read_rows(out)
    assert row["status"].startswith("timeout")


def test_index_profile_on_the_cpu(small_dataset, tmp_path):
    out = tmp_path / "prof.jsonl"
    assert index_profile.main([str(small_dataset), "reads", "--reps", "1",
                               "--device", "cpu", "--out", str(out)]) == 0
    rec = json.loads(out.read_text())
    assert set(rec["seconds"]) == {
        "upload_ref", "upload_reads", "sort_kmers_reads_fwd",
        "sort_kmers_reads_rc", "sort_kmers_ref_fwd", "sort_kmers_ref_comp",
        "match_pair"}
    assert rec["hits_f"] + rec["hits_c"] > 0


def test_sort_floor_passes_equal_torch_sort(tmp_path):
    out = tmp_path / "floor.jsonl"
    assert sort_floor.main(["0.02", "0.03", "0.005", "--reps", "1",
                            "--device", "cpu", "--out", str(out)]) == 0
    recs = tuning.read_rows(out)
    assert [r["pass"] for r in recs] == [
        "sort_key_pos_2", "sort_key_pos_1", "sort_nq_m", "sort_2nq_m",
        "lex_composite", "lex_passes", "cumsum", "cummax", "bitonic_merge"]
    assert all(r["output_ok"] and r["bound_ms"] > 0 for r in recs)


@pytest.mark.parametrize("nq,m", [(300, 700), (1000, 24)])
def test_bitonic_merge_equals_torch_sort(nq, m):
    """The merge join's _bitonic_merge of sorted q ++ pad ++ reversed
    sorted b equals torch.sort's keys (and carries each key's payload)."""
    rng = np.random.default_rng(nq + m)
    q = np.sort(rng.integers(0, 50, nq))
    b = np.sort(rng.integers(0, 50, m))
    npow = dix._pow2_above(nq + m)
    key = torch.from_numpy(np.concatenate(
        [q, np.full(npow - nq - m, dix.SENT), b[::-1]]).astype(np.int64))
    pay = torch.arange(npow, dtype=torch.int32)
    ks, ps = dix._bitonic_merge(key, pay)
    assert torch.equal(ks, torch.sort(key).values)
    assert torch.equal(key[ps.to(torch.int64)], ks)


def test_sort_floor_checks_catch_a_wrong_sort():
    """A pass whose output is wrong is reported, not passed."""
    dev = torch.device("cpu")
    gen = torch.Generator().manual_seed(1)
    checks = {p[0]: p for p in sort_floor.passes(torch, dev, 500, 700, 300,
                                                 gen)}
    name, _, _, make, fn, check = checks["sort_nq_m"]
    inp = make()
    vals, idx = fn(inp)
    assert check(inp, (vals, idx))
    assert not check(inp, (vals.flip(0), idx))

"""BENCHMARK.json keeps the contract, and the harness finds every cell's
parts by name: a new traffic file is picked up with no edit."""

import json
import re

import pytest

from benchmark import cells
from conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT_KEYS = ("why", "layer", "source")


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert 1 <= len(BENCH["command"]) <= 32
    cells_n = len(BENCH["workloads"])
    # the whole check must fit with 24 cells
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells_n <= 24


def test_entries_names_units_and_texts():
    groups = {"configs": {"name", "source", "file", "reduced", "why"},
              "workloads": {"name", "config", "traffic", "chips", "why"},
              "end_to_end": {"name", "unit", "better", "bound", "source"},
              "per_layer": {"name", "unit", "better", "source", "layer",
                            "moves"}}
    names = set()
    for group, keys in groups.items():
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == keys, e
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            for k in TEXT_KEYS:
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}


def test_every_cell_finds_its_config_traffic_and_metrics():
    cat = cells.Catalog()
    for w in BENCH["workloads"]:
        cfg = cat.config(w["config"])
        traffic = cat.traffic(w["traffic"])
        assert cfg["name"] == w["config"] and traffic["name"] == w["traffic"]
        assert w["chips"] == 1
        for trace in (False, True):
            metrics = cat.metrics(w["name"], trace)
            assert metrics
            for m in metrics:
                assert callable(cells.reader(m["name"]))
        assert "setup_s" in {m["name"] for m in cat.metrics(w["name"],
                                                            False)}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_files_state_their_cuts(config):
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    cfg = json.loads((REPO / entry["file"]).read_text())
    assert cfg["reduced"] == entry["reduced"]
    for key in cfg["reduced"]:
        assert key in cfg.get("published", {})
    assert cfg["assumed"]


def test_a_new_traffic_file_is_found_with_no_edit(tmp_path):
    (tmp_path / "traffic").mkdir()
    for f in (cells.HERE / "traffic").iterdir():
        (tmp_path / "traffic" / f.name).write_text(f.read_text())
    new = dict(json.loads((cells.HERE / "traffic" / "clr_rb200M.json")
                          .read_text()), name="clr_rb25M",
               block_bases=25_000_000)
    (tmp_path / "traffic" / "clr_rb25M.json").write_text(json.dumps(new))
    bench = dict(BENCH)
    bench["configs"] = [dict(c, file=str(REPO / c["file"]))
                        for c in BENCH["configs"]]
    bench["workloads"] = BENCH["workloads"] + [
        {"name": "dmel140.rb25M", "config": "dmel_140M",
         "traffic": "clr_rb25M", "chips": 1, "why": "test"}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cat = cells.Catalog(tmp_path / "BENCHMARK.json", tmp_path / "traffic")
    wl = cat.workload("dmel140.rb25M")
    assert cat.traffic(wl["traffic"])["block_bases"] == 25_000_000
    assert cat.config(wl["config"])["name"] == "dmel_140M"
    # a metric without a workloads list is reported by every cell
    assert cat.metrics("dmel140.rb25M", False)


def test_unknown_names_raise():
    cat = cells.Catalog()
    with pytest.raises(KeyError):
        cat.workload("no.such.cell")
    with pytest.raises(KeyError):
        cat.config("no_such_config")
    with pytest.raises(FileNotFoundError):
        cat.traffic("no_such_mix")

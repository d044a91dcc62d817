"""The set-up timing tool on the tiny cell, on the CPU."""

import json

from benchmark import cells, setup_time
from conftest import TINY_CONFIG, TINY_TRAFFIC


def test_it_times_data_files_and_the_check(tmp_path, monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    out = setup_time.measure(TINY_CONFIG, TINY_TRAFFIC, 3000000201, "cpu")
    for k in ("start_s", "data_s", "write_dam_s", "write_reads_s",
              "files_s", "peak_rss_gb", "check_s", "peak_rss_gb_with_check"):
        assert out[k] > 0, k
    assert out["files_s"] == out["write_dam_s"] + out["write_reads_s"]
    assert out["genome_bases"] == sum(n for _, n in TINY_CONFIG["contigs"])
    assert out["ref_blocks"] == 2
    assert out["block_bases"] >= TINY_TRAFFIC["block_bases"]
    # the sample and the longest read of block 0
    assert TINY_TRAFFIC["check_reads"] <= out["check_reads"] \
        <= TINY_TRAFFIC["check_reads"] + 1
    assert out["check_records"] > 0
    assert out["check_device"] == "cpu"
    # its directory under TMPDIR is gone
    assert list(tmp_path.iterdir()) == []


def test_the_command_line_prints_one_json_line(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(cells.Catalog, "traffic",
                        lambda self, name: dict(TINY_TRAFFIC, name=name))
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_CONFIG))
    assert setup_time.main(["--config", str(cfg), "--traffic", "tiny_rb",
                            "--seed", "7"]) == 0
    cap = capsys.readouterr()
    out = json.loads(cap.out.strip().splitlines()[-1])
    assert out["data_s"] > 0 and "check_s" not in out
    assert "setup_time: tiny x tiny_rb seed 7" in cap.err


def test_each_worker_count_checks_the_same_answers(tmp_path, monkeypatch,
                                                   capsys):
    monkeypatch.setenv("TMPDIR", str(tmp_path))
    monkeypatch.setattr(cells.Catalog, "traffic",
                        lambda self, name: dict(TINY_TRAFFIC, name=name))
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_CONFIG))
    assert setup_time.main(["--config", str(cfg), "--traffic", "tiny_rb",
                            "--seed", "7", "--check-on", "cpu",
                            "--check-workers", "2", "1"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [c["workers"] for c in out["checks"]] == [2, 1]
    assert out["checks"][0]["answers_sha256"] == \
        out["checks"][1]["answers_sha256"]
    assert out["check_s"] == out["checks"][0]["check_s"] > 0
    assert out["cpus"] >= 1

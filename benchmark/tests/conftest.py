"""Shared pieces of the harness's own tests: a tiny cell on the CPU.

Run from the repository's root: ``python -m pytest benchmark/tests -q``.
Tests that need a CUDA card carry the ``cuda`` marker and skip inside their
fixture without one.
"""

import json
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())

TINY_CONFIG = {
    "name": "tiny",
    "contigs": [["a", 120_000], ["b", 80_000], ["c", 130_000],
                ["d", 70_000]],
    "repeats": [{"name": "rep", "genome_share": 0.05, "families": 3,
                 "consensus_len": [1000, 3000], "copy_len_min": 500,
                 "divergence": [0.0, 0.02]}],
    "ref_block_bases": 200_000,
    "options": {"kmer": 20, "ave_error": 0.85, "spacing": 100,
                "best_tie": 1.0, "profile": True, "mem_limit_gb": 16},
    "reduced": [], "assumed": []}
TINY_TRAFFIC = {
    "name": "tiny_rb",
    "read_len": {"mean": 2000, "sd": 500, "min": 1000},
    "error_rate": 0.15, "ins_share": 0.55, "del_share": 0.25,
    "block_bases": 16_000, "distinct_blocks": 2, "check_reads": 8}


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "cuda: needs a CUDA card; skips without one")


@pytest.fixture(scope="session")
def tiny(tmp_path_factory):
    """A BENCHMARK.json of one tiny cell (4 contigs with repeats in 2
    reference blocks,
    2 read blocks of ~8 reads) with every metric of the real one, and its
    traffic folder: (bench path, traffic dir)."""
    root = tmp_path_factory.mktemp("tiny")
    (root / "bm" / "configs").mkdir(parents=True)
    (root / "bm" / "traffic").mkdir()
    (root / "bm" / "configs" / "tiny.json").write_text(
        json.dumps(TINY_CONFIG))
    (root / "bm" / "traffic" / "tiny_rb.json").write_text(
        json.dumps(TINY_TRAFFIC))
    bench = dict(BENCH)
    bench["paths"] = ["bm"]
    bench["configs"] = [{"name": "tiny", "source": "test",
                         "file": "bm/configs/tiny.json", "reduced": [],
                         "why": "test"}]
    bench["workloads"] = [{"name": "tiny.rb", "config": "tiny",
                           "traffic": "tiny_rb", "chips": 1, "why": "test"}]
    bench["per_layer"] = [dict(m, workloads=["tiny.rb"])
                          for m in BENCH["per_layer"]]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root / "BENCHMARK.json", root / "bm" / "traffic"

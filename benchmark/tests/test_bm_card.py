"""The harness on the card at the tiny cell's size (marker ``cuda``):
skips without a CUDA card."""

import json

import pytest

from bm_helpers import run_harness, tiny_args


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_tiny_cell_on_the_card(card, tiny):
    rc, out, err = run_harness(tiny_args(tiny, 11, trace=1, device="cuda"))
    assert rc == 0, err[-3000:]
    r = json.loads(out.strip().splitlines()[-1])
    assert r["correct"] is True
    assert r["device"]["platform"] == "gpu"
    assert r["device"]["busy_s"] > 0
    # the tiny cell's rounds are smaller than the engine's host_min, so its
    # lanes run on the host oracle and no wave kernel is timed
    assert "device_idle_pct" in r["metrics"]

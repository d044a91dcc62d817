"""The CUDA wave kernel against its plain PyTorch version, on the card.

These tests need a CUDA card and skip without one.  They import nothing of
JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import pytest
import torch

from damapper_tpu_torch.convert import lanes_from_numpy
from damapper_tpu_torch.ops.spec import new_align_spec
from damapper_tpu_torch.ops.wave_cuda import (OUT_FIELDS, wave_lanes,
                                              wave_lanes_ref)
from damapper_tpu_torch.utils.sim import make_lane_cases

SPEC = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
CONSTS = (SPEC.trace_space, SPEC.ave_path, SPEC.mscore, SPEC.dscore)
P = 512


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_wave_kernel_matches_plain_version_on_card(cuda_device, reverse):
    """The CUDA kernel equals the plain version on the same CUDA tensors,
    at W=128 (the card's band) and W=64."""
    seqmem, insts = make_lane_cases(1000, 8, err=0.15)
    lanes = lanes_from_numpy(insts, seqmem, cuda_device)
    for w in (64, 128):
        args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2],
                    dsc=CONSTS[3], W=w, P=P, reverse=reverse)
        launches = wave_lanes.launches
        k = wave_lanes(**lanes, **args)
        torch.cuda.synchronize()
        assert wave_lanes.launches == launches + 1
        r = wave_lanes_ref(**lanes, **args)
        for f in OUT_FIELDS:
            assert torch.equal(k[f], r[f]), f
        for i in range(len(insts)):
            av = int(r["avail"][i])
            assert torch.equal(k["pool"][i, :av], r["pool"][i, :av]), i

"""chip_smoke.py names its failure: whichever phase raises, the run
prints the traceback to stderr, ends stdout with {"ok": false, "phase":
<that phase>, "error": <the exception, cut to 500 characters>} and
returns 1; with no card it ends the same way in phase "0 setup" and
returns 2.  The phases are replaced by stand-ins, so no card is needed."""

import json

import pytest
import torch

import chip_smoke


def _last_line(out):
    return json.loads(out.rstrip("\n").splitlines()[-1])


def _device(torch_):
    chip_smoke.phase("1 device")
    return "card", 1, "card, 700.00 W"


def _build_fails():
    chip_smoke.phase("2 build")
    raise RuntimeError("nvcc exited 1: " + "x" * 900)


def _kernel_disagrees(torch_, seed):
    chip_smoke.phase("3 kernel vs plain version: classic")
    chip_smoke.check(False, "wave_lanes differs from its plain version")


@pytest.mark.parametrize("case", ["device", "build", "kernel"])
def test_failing_phase_is_the_last_line(monkeypatch, capsys, case):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    if case == "device":
        def device(torch_):
            chip_smoke.phase("1 device")
            chip_smoke.check(False, "nvidia-smi failed")
        monkeypatch.setattr(chip_smoke, "phase_device", device)
    else:
        monkeypatch.setattr(chip_smoke, "phase_device", _device)
    if case == "build":
        monkeypatch.setattr(chip_smoke, "phase_build", _build_fails)
    else:
        monkeypatch.setattr(chip_smoke, "phase_build", lambda: None)
    monkeypatch.setattr(chip_smoke, "phase_kernel", _kernel_disagrees)

    assert chip_smoke.main([]) == 1
    out, err = capsys.readouterr()
    last = _last_line(out)
    assert last["ok"] is False
    want = {"device": ("1 device", "SmokeFailure: nvidia-smi failed"),
            "build": ("2 build", "RuntimeError: nvcc exited 1: "),
            "kernel": ("3 kernel vs plain version: classic",
                       "SmokeFailure: wave_lanes differs from its plain "
                       "version")}[case]
    assert last["phase"] == want[0]
    assert last["error"].startswith(want[1])
    assert len(last["error"]) <= 500
    assert "Traceback" in err
    assert '"ok": true' not in out and '"kernels"' not in out


def test_no_card_ends_in_setup(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    chip_smoke.PHASE["name"] = "5 las"     # a previous run's phase
    assert chip_smoke.main([]) == 2
    out, err = capsys.readouterr()
    assert _last_line(out) == {"ok": False, "phase": "0 setup",
                               "error": "SmokeFailure: no CUDA device is "
                                        "available"}
    assert "no CUDA device" in err

"""What the tuning tools share: the six wave modes by name, the device a
tool runs on and the card it names in its records, the lanes they time,
and how they run and compare the engine.

The mode names and triples are the JAX package's (its compile gate's MODES
and triple()), so a status file, a results row and the mode file speak of
the same modes in both packages.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import time


TOOLS = pathlib.Path(__file__).resolve().parent
#: the build gate's status file (tools/wave_build_gate.py)
STATUS_FILE = TOOLS / "wave_build_status.json"
#: the engine-level mode A/B's and the sweep's rows (tools/wave_modes.py,
#: tools/wave_sweep.py), which tools/pick_wave_mode.py reads
RESULTS_FILE = TOOLS / "wave_mode_results.jsonl"

# mode name -> (persistent, packops, lanepack)
MODES = {
    "classic": (False, False, False),
    "classic_packops": (False, True, False),
    "lanepack": (False, False, True),
    "persistent": (True, False, False),
    "persistent_packops": (True, True, False),
    "plp": (True, False, True),
}
# the kernel each mode launches (its retry tier aside)
MODE_KERNEL = {"classic": "wave_lanes", "classic_packops": "wave_lanes_packed",
               "lanepack": "wave_lanes_lanepack",
               "persistent": "wave_persistent",
               "persistent_packops": "wave_persistent_packed",
               "plp": "wave_persistent_lanepack"}


def triple(name):
    """{"persistent", "packops", "lanepack"} of a mode name."""
    return dict(zip(("persistent", "packops", "lanepack"), MODES[name]))


def mode_names(arg: str):
    """A comma list of mode names, or "all"; raises on an unknown name."""
    names = list(MODES) if arg == "all" else [m for m in arg.split(",") if m]
    bad = [m for m in names if m not in MODES]
    if bad or not names:
        raise ValueError(f"unknown wave modes {bad or arg!r}; "
                         f"one of {list(MODES)} or all")
    return names


def open_device(device):
    """The device a tool runs on: the card unless ``device`` names the CPU;
    no card is an error (ops.wave_engine.resolve_device)."""
    from ..ops.wave_engine import resolve_device
    return resolve_device(device)


def card_info(dev) -> dict:
    """{"platform", "card", "power_limit_w"} of the device a record was
    taken on: "cuda", torch's name of the card and nvidia-smi's power limit
    in watts, or "cpu", "cpu" and None."""
    import torch
    if dev.type != "cuda":
        return {"platform": "cpu", "card": "cpu", "power_limit_w": None}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    lines = smi.stdout.split()
    return {"platform": "cuda", "card": torch.cuda.get_device_name(dev),
            "power_limit_w": float(lines[0]) if smi.returncode == 0
            and lines else None}


def sync(dev):
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize(dev)


def lane_cases(ncases, rlen, mix=True, rmin=1500):
    """The tools' lanes: make_lane_cases(777, ...) on a genome four reads
    long at 15% error, as the JAX package's wave_ab draws them."""
    from ..utils.sim import make_lane_cases
    return make_lane_cases(777, ncases, glen=4 * rlen, rlen=rlen, err=0.15,
                           mix=mix, rmin=rmin)


def spec():
    from ..ops.spec import new_align_spec
    return new_align_spec(0.85, 100, [.25, .25, .25, .25], True)


def key(rec):
    """A lane's record: both paths' ends, diffs and traces."""
    a, b = rec
    return (a.abpos, a.bbpos, a.aepos, a.bepos, a.diffs,
            tuple(a.trace), tuple(b.trace))


def oracle_key(seqmem, s, sp):
    """The host oracle's record of one seed."""
    from ..ops import wave as host
    a = seqmem[s["abase"]:s["abase"] + s["alen"]]
    b = seqmem[s["bbase"]:s["bbase"] + s["blen"]]
    return key(host.local_alignment(a, b, sp, int(s["diag"]),
                                    int(s["diag"]), int(s["anti"]), -1, -1,
                                    int(s["flags"])))


def timed_batch(eng, dev, seqmem, insts, rounds=None):
    """One timed run of the engine over the lanes (as one round, or as
    rounds of the given sizes): (seconds, records, kernel ms, fallbacks,
    launches by kernel) of this run alone."""
    mem = eng.upload(seqmem)
    rounds = rounds or [len(insts)]
    k0, f0 = eng.kernel_ms, eng.n_fallback
    l0 = dict(eng.launches)
    sync(dev)
    t0 = time.perf_counter()
    got, at = [], 0
    for n in rounds:
        got += eng.local_alignment_batch(mem, mem, seqmem, seqmem,
                                         insts[at:at + n])
        at += n
    sync(dev)
    dt = time.perf_counter() - t0
    return (dt, got, eng.kernel_ms - k0, eng.n_fallback - f0,
            {k: v - l0[k] for k, v in eng.launches.items()})


def best_of(eng, dev, seqmem, insts, reps, rounds=None):
    """A warm-up run, then the best of ``reps`` timed runs (the records of
    every run must be equal): timed_batch's tuple of the best run."""
    first = timed_batch(eng, dev, seqmem, insts, rounds)
    best = None
    for _ in range(reps):
        run = timed_batch(eng, dev, seqmem, insts, rounds)
        if [key(r) for r in run[1]] != [key(r) for r in first[1]]:
            raise RuntimeError("two runs of one engine gave other records")
        if best is None or run[0] < best[0]:
            best = run
    return best


def append_rows(path, rows):
    """Append JSON rows to ``path`` (its directory made); None: nowhere."""
    if path is None:
        return
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("a") as fh:
        for r in rows:
            fh.write(json.dumps(r) + "\n")


def read_rows(path):
    """The JSON rows of a results file (lines that do not parse skipped)."""
    rows = []
    for line in pathlib.Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                pass
    return rows


def engine(dev, mode, band=None, host_min=0, pool_cap=2048):
    """A WaveEngine in the named mode with every knob pinned: the mode's
    triple, its built-in band unless ``band`` is given, ``host_min``, so no
    environment variable or mode file can relabel what runs."""
    from ..ops.wave_engine import WaveEngine, default_band
    t = triple(mode)
    if band is None:
        band = default_band(dev.type, t["persistent"], t["lanepack"])
    return WaveEngine(spec(), band_cap=band, pool_cap=pool_cap, device=dev,
                      host_min=host_min, **t)

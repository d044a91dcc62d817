"""Pick the fastest measured wave mode on this card and write it as the
engine's default.

    python -m damapper_tpu_torch.tools.pick_wave_mode [results.jsonl]
        [--dry-run] [--status FILE] [--mode-file FILE] [--card NAME]

Reads the rows of tools/wave_modes.py and tools/wave_sweep.py (default
tools/wave_mode_results.jsonl), keeps those of platform "cuda" on this card
(--card, default torch's name of the card) with ncases >= 32, and within
ONE (ncases, rlen) group, the JAX package's rule, takes the lowest warm ms a
lane of each (persistent, packops, lanepack) triple; the winner goes to
damapper_tpu_torch/wave_mode.json (--mode-file) with the platform, the card
and the results file it came from.  The engine reads that file on that
card only (ops.wave_engine.resolve_wave_mode).

Coverage guard, as the JAX package's: the picker refuses (exit 1) while a
mode that the build gate's status file (tools/wave_build_status.json,
--status) marks "ok" has no row in the chosen group: a winner is never
declared against modes that were not measured.  --dry-run prints the pick
and whether it differs from the mode file in force, and writes nothing.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

from . import tuning

MODE_FILE = tuning.TOOLS.parent / "wave_mode.json"


def _cfg(r):
    return (bool(r.get("persistent")), bool(r.get("packops")),
            bool(r.get("lanepack")))


def pick(rows, card):
    """(fastest row, its group) of the rows of platform "cuda" on ``card``
    at ncases >= 32, or None.  Rows are compared only within one (ncases,
    rlen) group, since the cost a lane amortizes with the batch: the group
    that measured the most distinct triples (ties to the larger batch)."""
    rows = [r for r in rows
            if r.get("platform") == "cuda" and r.get("card") == card
            and r.get("ncases", 0) >= 32]
    if not rows:
        return None
    groups = {}
    for r in rows:
        groups.setdefault((r.get("ncases"), r.get("rlen")), []).append(r)
    chosen = max(groups.values(),
                 key=lambda g: (len({_cfg(r) for r in g}),
                                g[0].get("ncases", 0)))
    best = {}
    for r in chosen:
        k = _cfg(r)
        if k not in best or r["ms_per_lane"] < best[k]["ms_per_lane"]:
            best[k] = r
    return min(best.values(), key=lambda r: r["ms_per_lane"]), chosen


def unmeasured(gate: dict, chosen) -> list:
    """The modes the gate marks "ok" that have no row in ``chosen``."""
    measured = {_cfg(r) for r in chosen}
    return [name for name, rec in gate.items()
            if rec.get("status") == "ok" and name in tuning.MODES
            and tuple(tuning.MODES[name]) not in measured]


def mode_record(win, card, src) -> dict:
    """The mode file's contents for a winning row."""
    return {"persistent": bool(win.get("persistent")),
            "packops": bool(win.get("packops")),
            "lanepack": bool(win.get("lanepack")),
            "ms_per_lane": win["ms_per_lane"], "platform": "cuda",
            "card": card, "source": src, "ts": win.get("ts")}


def _source_name(src: pathlib.Path) -> str:
    """The results file named from the repository root where it lies
    inside it."""
    try:
        return str(src.resolve().relative_to(tuning.TOOLS.parent.parent))
    except ValueError:
        return src.name


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("results", nargs="?", default=str(tuning.RESULTS_FILE))
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--status", default=str(tuning.STATUS_FILE))
    ap.add_argument("--mode-file", default=str(MODE_FILE))
    ap.add_argument("--card", default=None)
    args = ap.parse_args(argv)
    card = args.card
    if card is None:
        import torch
        dev = tuning.open_device(None)
        card = torch.cuda.get_device_name(dev)
    src = pathlib.Path(args.results)
    if not src.exists():
        print(f"no results at {src}; the engine keeps its defaults")
        return 0
    picked = pick(tuning.read_rows(src), card)
    if picked is None:
        print(f"no rows of {card} at >= 32 lanes; the engine keeps its "
              f"defaults")
        return 0
    win, chosen = picked
    status = pathlib.Path(args.status)
    if status.exists():
        try:
            gate = json.loads(status.read_text())
        except ValueError:
            gate = {}
        missing = unmeasured(gate, chosen)
        if missing:
            print(f"refusing to pick: modes that build were never measured "
                  f"in the chosen group (ncases {chosen[0].get('ncases')}, "
                  f"rlen {chosen[0].get('rlen')}): {missing}")
            return 1
    out = mode_record(win, card, _source_name(src))
    mf = pathlib.Path(args.mode_file)
    try:
        cur = json.loads(mf.read_text())
    except (OSError, ValueError):
        cur = None
    same = cur is not None and all(cur.get(k) == out[k] for k in (
        "persistent", "packops", "lanepack", "platform", "card"))
    name = next(m for m, t in tuning.MODES.items() if t == _cfg(out))
    print(f"pick: {name} ({out['ms_per_lane']:.4f} ms/lane in the group of "
          f"{chosen[0].get('ncases')} lanes of <= {chosen[0].get('rlen')} "
          f"bp, {len({_cfg(r) for r in chosen})} modes); the mode file in "
          f"force {'says the same' if same else 'differs: ' + str(cur)}")
    if args.dry_run:
        return 0
    mf.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wave mode -> {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

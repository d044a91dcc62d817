"""Differential fuzz of the wave engine against the host oracle on lanes
whose reverse wave clips at the start of A.

    python -m damapper_tpu_torch.tools.clip_fuzz [nseeds] [--mode all]
        [--device cpu]

The cases (utils.sim.make_clip_cases, seeds 7000, 7001, ...) are the lane
class of the JAX package's 50k-read parity edge: the band clips at the A
boundary and re-clips under REACH over many waves.  Each seed's FUZZ_CASES
lanes (default 256) run as one round (host_min=0) on an engine in each
requested wave mode (--mode: one of tools.tuning.MODES, a comma list or
"all"; default classic), at band FUZZ_W (default 128) where the mode serves
it and 64 where it does not, every other knob pinned; every lane is
re-aligned by the host oracle (ops.wave.local_alignment) and must match
path and trace.  On the card the engine runs the CUDA kernels; with
--device cpu their plain versions.  Prints each mismatch and a total a mode;
exits 1 on any mismatch.

The JAX tool's --oracle (the host oracle against the C reference's
Local_Alignment driver) is left out: no machine of this project has the C
reference.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import tuning


def run(seed, ncases, modes, W, dev):
    """One seed's clip cases through an engine in each of ``modes`` at band
    W (64 where the mode serves no other), every lane held to the oracle
    (re-aligned once for all modes).  Returns {mode: (mismatches,
    fallbacks, the engine's launches by kernel, its records)}."""
    from ..ops.wave_engine import default_band
    from ..utils.sim import make_clip_cases
    seqmem, insts = make_clip_cases(seed, ncases)
    sp = tuning.spec()
    want = [tuning.oracle_key(seqmem, s, sp) for s in insts]
    out = {}
    for mode in modes:
        t = tuning.triple(mode)
        eng = tuning.engine(dev, mode, band=min(W, default_band(
            "cuda", t["persistent"], t["lanepack"])))
        _, got, _, fb, launches = tuning.timed_batch(eng, dev, seqmem,
                                                     insts)
        bad = 0
        for i, (w, g) in enumerate(zip(want, got)):
            have = tuning.key(g)
            if w != have:
                bad += 1
                print(f"{mode} seed={seed} case={i}: oracle {w[:5]} engine "
                      f"{have[:5]} tracediff={w[5:] != have[5:]}",
                      flush=True)
        out[mode] = (bad, fb, launches, got)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("nseeds", type=int, nargs="?", default=8)
    ap.add_argument("--mode", default="classic")
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)
    modes = tuning.mode_names(args.mode)
    dev = tuning.open_device(args.device)
    W = int(os.environ.get("FUZZ_W", 128))
    ncases = int(os.environ.get("FUZZ_CASES", 256))
    print(f"clip fuzz on {tuning.card_info(dev)}: {args.nseeds} seeds x "
          f"{ncases} cases, FUZZ_W={W}", flush=True)
    tot = {m: [0, 0, 0] for m in modes}   # mismatches, fallbacks, launches
    for seed in range(7000, 7000 + args.nseeds):
        for mode, (bad, fb, launches, _) in run(seed, ncases, modes, W,
                                                dev).items():
            tot[mode][0] += bad
            tot[mode][1] += fb
            tot[mode][2] += launches[tuning.MODE_KERNEL[mode]]
            print(f"{mode} seed {seed}: {bad} mismatches ({fb} fallbacks)",
                  flush=True)
    total = 0
    for mode, (bad, fb, kernel) in tot.items():
        print(f"{mode}: {bad} mismatches, {fb} fallbacks, {kernel} "
              f"launches of {tuning.MODE_KERNEL[mode]}", flush=True)
        if dev.type == "cuda" and kernel == 0:
            print(f"{mode}: its kernel never launched", flush=True)
            bad += 1
        total += bad
    print(f"TOTAL: {total} mismatches over {len(modes)} modes", flush=True)
    return 1 if total else 0


if __name__ == "__main__":
    sys.exit(main())

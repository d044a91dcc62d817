"""Command-line entry points.

    python -m damapper_tpu_torch.cli damapper  [...]   — the mapper (reference damapper.c CLI)
    python -m damapper_tpu_torch.cli lasort    [...]   — sort .las shards (LAsort equivalent)
    python -m damapper_tpu_torch.cli lacat     [...]   — concatenate .las (LAcat equivalent)
    python -m damapper_tpu_torch.cli lamerge   [...]   — merge sorted .las (LAmerge equivalent)
    python -m damapper_tpu_torch.cli lacheck   [...]   — validate .las (LAcheck equivalent)
    python -m damapper_tpu_torch.cli lashow    [...]   — view .las records/alignments (LAshow equivalent)
    python -m damapper_tpu_torch.cli fasta2dam [...]   — import a fasta as a .dam
    python -m damapper_tpu_torch.cli fasta2db  [...]   — import a fasta as a .db
    python -m damapper_tpu_torch.cli dbsplit   [...]   — re-partition a DB/DAM (DBsplit equivalent)
    python -m damapper_tpu_torch.cli dbshow    [...]   — print reads as fasta (DBshow equivalent)
    python -m damapper_tpu_torch.cli plan      [...]   — emit an execution plan (HPC.damapper equivalent)

Only damapper touches a device.  Its run is on the CUDA card; set
DAMAPPER_DEVICE=cpu to run it on the CPU (plain PyTorch path).
DAMAPPER_WAVE_PERSISTENT=1 runs the persistent wave kernels (each lane
against its sequence windows in shared memory) in place of the classic ones;
DAMAPPER_WAVE_PACKOPS=1 or DAMAPPER_WAVE_LANEPACK=1 picks the packed or
lane-packed layout of either.  DAMAPPER_INDEX=host|device picks where the
k-mer index and seed match run (default: device on the card, host on the
CPU), DAMAPPER_CHAIN=host|device where the chain sweep runs (default host),
DAMAPPER_JOIN=bsearch|merge|scan|sortg|sort the device join (default
bsearch), and DAMAPPER_PACK_UPLOAD=1 uploads sequences 2-bit packed instead
of as plain bytes.  -v prints the wave mode and these four choices.  A plan
(-fjson) runs over ranks with `python -m damapper_tpu_torch.parallel.launch`.
"""

from __future__ import annotations

import os
import sys


def _expand_block_arg(arg: str) -> list[str]:
    """Expand a '@' block pattern to numbered files (Next_Block_Arg
    DB.c:2695-2817): '@' scans from 1 while files exist, '@f' starts at f,
    '@f-l' covers the explicit range.  Appends .las if missing."""
    import re as _re
    if not arg.endswith(".las"):
        arg = arg + ".las"
    m = _re.search(r"@(\d+)?(?:-(\d+))?", arg)
    if not m:
        return [arg]
    first = int(m.group(1)) if m.group(1) else 1
    last = int(m.group(2)) if m.group(2) else None
    out = []
    i = first
    while last is None or i <= last:
        p = arg[:m.start()] + str(i) + arg[m.end():]
        if not os.path.exists(p):
            if last is None:
                break
            # explicit '@f-l' ranges are validated eagerly, matching
            # Next_Block_Arg's guarded fopen (DB.c:2735-2752)
            print(f"Cannot find file {p}", file=sys.stderr)
            raise SystemExit(1)
        out.append(p)
        i += 1
    return out


def _main_lasort(argv: list[str]) -> int:
    from .io import las as lasio
    map_order = False
    files: list[str] = []
    for a in argv:
        if a == "-a":
            map_order = True
        elif a == "-v":
            pass
        else:
            files.extend(_expand_block_arg(a))
    for f in files:
        recs, tspace = lasio.read_las(f)
        recs = lasio.sort_las(recs, map_order)
        out = f[:-4] + ".S.las"
        lasio.write_las(out, recs, tspace)
    return 0


def _main_lacat(argv: list[str]) -> int:
    from .io import las as lasio
    files: list[str] = []
    for a in argv:
        if a == "-v":
            continue
        files.extend(_expand_block_arg(a))
    all_recs = []
    tspace = 0
    for f in files:
        recs, tspace = lasio.read_las(f)
        all_recs.extend(recs)
    import struct
    out = sys.stdout.buffer
    out.write(struct.pack("<qi", len(all_recs), tspace))
    tb = lasio.tbytes_for(tspace)
    import numpy as np
    for o in all_recs:
        out.write(lasio._REC.pack(o.tlen, o.diffs, o.abpos, o.bbpos,
                                  o.aepos, o.bepos, o.flags, o.aread, o.bread))
        out.write(o.trace.astype(np.uint8 if tb == 1 else "<u2").tobytes())
    out.flush()
    return 0


def _main_lamerge(argv: list[str]) -> int:
    from .io import las as lasio
    map_order = False
    args: list[str] = []
    for a in argv:
        if a == "-a":
            map_order = True
        elif a == "-v":
            pass
        else:
            args.append(a)
    out = args[0]
    if not out.endswith(".las"):
        out += ".las"
    files: list[str] = []
    for a in args[1:]:
        files.extend(_expand_block_arg(a))
    lasio.merge_las(files, out, map_order)
    return 0


def _main_lacheck(argv: list[str]) -> int:
    from .io import las as lasio
    rc = 0
    for a in argv:
        if a.startswith("-"):
            continue
        for f in _expand_block_arg(a):
            errs = lasio.check_las(f)
            for e in errs:
                print(f"{f}: {e}", file=sys.stderr)
            if errs:
                rc = 1
    return rc


def _main_dbsplit(argv: list[str]) -> int:
    from .io import db as dbio
    bsize = cutoff = None
    allw = None
    args = []
    for a in argv:
        if a.startswith("-s"):
            bsize = int(float(a[2:]) * 1_000_000)
        elif a.startswith("-x"):
            cutoff = int(a[2:])
        elif a == "-a":
            allw = True
        elif a.startswith("-"):
            print(f"dbsplit: {a} is an illegal option", file=sys.stderr)
            return 1
        else:
            args.append(a)
    if len(args) != 1:
        print("Usage: dbsplit [-a] [-x<int>] [-s<double:Mbp>] <path:db|dam>",
              file=sys.stderr)
        return 1
    n = dbio.dbsplit(args[0], bsize, cutoff, allw)
    print(f"{args[0]}: {n} blocks", file=sys.stderr)
    return 0


def _main_dbshow(argv: list[str]) -> int:
    from .io import db as dbio
    width, upper = 80, False
    args = []
    for a in argv:
        if a.startswith("-w"):
            width = int(a[2:])
        elif a == "-U":
            upper = True
        elif a.startswith("-") and not a[1:].isdigit():
            print(f"dbshow: {a} is an illegal option", file=sys.stderr)
            return 1
        else:
            args.append(a)
    if not args:
        print("Usage: dbshow [-U] [-w<int>] <path:db|dam> [reads...]",
              file=sys.stderr)
        return 1
    sel = [int(x) for x in args[1:]] or None
    dbio.dbshow(args[0], sel, width, upper)
    return 0


def _main_fasta2dam(argv: list[str]) -> int:
    from .io import db as dbio
    from .io import fasta
    dam, fa = argv[0], argv[1]
    dbio.create_dam(dam, fasta.read_fasta(fa))
    return 0


def _main_fasta2db(argv: list[str]) -> int:
    from .io import db as dbio
    from .io import fasta
    db, fa = argv[0], argv[1]
    dbio.create_db(db, fasta.read_fasta(fa))
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cmd, rest = argv[0], argv[1:]
    if cmd == "damapper":
        from .pipeline.mapper import main_damapper
        return main_damapper(rest)
    if cmd == "plan":
        from .parallel.plan import main_plan
        return main_plan(rest)
    if cmd == "lashow":
        from .io.display import main_lashow
        return main_lashow(rest)
    table = {
        "lasort": _main_lasort,
        "lacat": _main_lacat,
        "lamerge": _main_lamerge,
        "lacheck": _main_lacheck,
        "fasta2dam": _main_fasta2dam,
        "fasta2db": _main_fasta2db,
        "dbsplit": _main_dbsplit,
        "dbshow": _main_dbshow,
    }
    if cmd not in table:
        print(f"unknown command {cmd}", file=sys.stderr)
        return 1
    return table[cmd](rest)


if __name__ == "__main__":
    raise SystemExit(main())

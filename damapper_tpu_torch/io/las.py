"""Binary .las (local-alignment) file codec + sort/cat/merge/check tools.

Record layout (reference align.c:3098-3122): each file is
    int64 novl;  int32 tspace;
followed by `novl` records of 40 bytes (the Overlap struct minus its trace
pointer: tlen, diffs, abpos, bbpos, aepos, bepos, flags, aread, bread, 4 pad
bytes) each followed by the trace array of `tlen` values, 1 byte per value if
tspace <= TRACE_XOVR(=125) else 2 bytes (align.h:21-22).

The sort/cat/merge utilities replace the external LAsort/LAcat/LAmerge
processes the reference shells out to (damapper.c:893-911).  damapper output
is *chained*: records carry START/NEXT/BEST flags (align.h:127-143) and chains
must be kept intact as units when sorting.  Map order (-a) sorts chains by
(aread, abpos of first LA, ...); pile order (-z) by (aread, bread, comp, ...).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

TRACE_XOVR = 125

COMP_FLAG = 0x1
ACOMP_FLAG = 0x2
START_FLAG = 0x4
NEXT_FLAG = 0x8
BEST_FLAG = 0x10
ELIM_FLAG = 0x20

_REC = struct.Struct("<iiiiiiIii4x")   # 40 bytes


@dataclass
class LA:
    """One local alignment record (Overlap, align.h:336-341)."""
    aread: int
    bread: int
    flags: int
    abpos: int
    aepos: int
    bbpos: int
    bepos: int
    diffs: int
    trace: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int32))
    # trace = interleaved (d_i, b_i) pairs, length tlen

    @property
    def tlen(self):
        return len(self.trace)

    def key(self):
        return (self.aread, self.bread, self.flags & COMP_FLAG,
                self.abpos, self.aepos, self.bbpos, self.bepos, self.diffs,
                tuple(int(x) for x in self.trace))


def tbytes_for(tspace: int) -> int:
    return 1 if tspace <= TRACE_XOVR else 2


def read_las(path: str) -> tuple[list[LA], int]:
    with open(path, "rb") as fp:
        buf = fp.read()
    # guarded reads (FFREAD discipline, DB.h:136-224): a truncated file
    # must fail fast with a corruption message, not yield partial records
    if len(buf) < 12:
        raise IOError(f"{path}: The file is corrupted (truncated header)")
    novl, tspace = struct.unpack_from("<qi", buf, 0)
    tb = tbytes_for(tspace)
    las: list[LA] = []
    off = 12
    for _ in range(novl):
        if off + 40 > len(buf):
            raise IOError(f"{path}: The file is corrupted "
                          f"(truncated at record {len(las)})")
        tlen, diffs, abpos, bbpos, aepos, bepos, flags, aread, bread = \
            _REC.unpack_from(buf, off)
        off += 40
        if tlen < 0 or off + tb * tlen > len(buf):
            raise IOError(f"{path}: The file is corrupted "
                          f"(truncated trace at record {len(las)})")
        if tb == 1:
            trace = np.frombuffer(buf, np.uint8, tlen, off).astype(np.int32)
        else:
            trace = np.frombuffer(buf, "<u2", tlen, off).astype(np.int32)
        off += tb * tlen
        las.append(LA(aread, bread, flags, abpos, aepos, bbpos, bepos, diffs,
                      trace))
    return las, tspace


def write_las(path: str, las: list[LA], tspace: int) -> None:
    tb = tbytes_for(tspace)
    with open(path, "wb") as fp:
        fp.write(struct.pack("<qi", len(las), tspace))
        for o in las:
            fp.write(_REC.pack(o.tlen, o.diffs, o.abpos, o.bbpos,
                               o.aepos, o.bepos, o.flags, o.aread, o.bread))
            if tb == 1:
                fp.write(o.trace.astype(np.uint8).tobytes())
            else:
                fp.write(o.trace.astype("<u2").tobytes())


# --- chains -------------------------------------------------------------------

def group_chains(las: list[LA]) -> list[list[LA]]:
    """Split a record list into chains using START/NEXT flags.  If the file has
    no chain flags (first record unflagged), every record is its own chain."""
    if not las:
        return []
    chains: list[list[LA]] = []
    if not (las[0].flags & (START_FLAG | NEXT_FLAG)):
        return [[o] for o in las]
    for o in las:
        if o.flags & NEXT_FLAG:
            chains[-1].append(o)
        else:
            chains.append([o])
    return chains


def sort_las(las: list[LA], map_order: bool = True) -> list[LA]:
    """Chain-preserving sort.

    map_order=True  (LAsort -a): chains keyed by (aread, abpos, bread, comp,
                                 bbpos) of their first LA.
    map_order=False (LAsort, pile order): keyed by (aread, bread, comp, abpos,
                                 bbpos) of their first LA.
    Stable w.r.t. input order for equal keys.
    """
    chains = group_chains(las)
    if map_order:
        def k(ch):
            o = ch[0]
            return (o.aread, o.abpos, o.bread, o.flags & COMP_FLAG, o.bbpos)
    else:
        def k(ch):
            o = ch[0]
            return (o.aread, o.bread, o.flags & COMP_FLAG, o.abpos, o.bbpos)
    chains.sort(key=k)
    return [o for ch in chains for o in ch]


def cat_las(paths: list[str], out: str) -> None:
    """LAcat equivalent: concatenate .las files (same tspace) in order."""
    all_las: list[LA] = []
    tspace = None
    for p in paths:
        las, ts = read_las(p)
        if tspace is None:
            tspace = ts
        elif ts != tspace:
            raise ValueError("LAcat: trace spacing mismatch")
        all_las.extend(las)
    write_las(out, all_las, tspace or 0)


def merge_las(paths: list[str], out: str, map_order: bool = True) -> None:
    """LAmerge equivalent: merge sorted .las files into one sorted file."""
    all_las: list[LA] = []
    tspace = None
    for p in paths:
        las, ts = read_las(p)
        if tspace is None:
            tspace = ts
        elif ts != tspace:
            raise ValueError("LAmerge: trace spacing mismatch")
        all_las.extend(las)
    write_las(out, sort_las(all_las, map_order), tspace or 0)


# --- validation (Check_Trace_Points, align.c:3194-3236) ------------------------

def check_la(o: LA, tspace: int) -> list[str]:
    errs = []
    if tspace != 0:
        if ((o.aepos - 1) // tspace - o.abpos // tspace) * 2 != o.tlen - 2:
            errs.append("wrong number of trace points")
        if o.tlen and int(o.trace[1::2].sum()) + o.bbpos != o.bepos:
            errs.append("trace point sum != aligned interval")
        if o.tlen == 0 and o.bbpos != o.bepos:
            errs.append("empty trace but nonempty b interval")
    return errs


def check_las(path: str) -> list[str]:
    """LAcheck equivalent (structural invariants of a damapper .las)."""
    las, tspace = read_las(path)
    errs = []
    for i, o in enumerate(las):
        for e in check_la(o, tspace):
            errs.append(f"record {i}: {e}")
        if o.abpos >= o.aepos or o.abpos < 0:
            errs.append(f"record {i}: bad a-interval [{o.abpos},{o.aepos})")
        if o.bbpos > o.bepos or o.bbpos < 0:
            errs.append(f"record {i}: bad b-interval [{o.bbpos},{o.bepos})")
    # chain flag discipline: every record has START or NEXT, or none do
    if las:
        chained = bool(las[0].flags & (START_FLAG | NEXT_FLAG))
        for i, o in enumerate(las):
            has = bool(o.flags & (START_FLAG | NEXT_FLAG))
            if has != chained:
                errs.append(f"record {i}: inconsistent chain flags")
        if chained and (las[0].flags & NEXT_FLAG):
            errs.append("record 0: chain starts with NEXT")
    return errs


def las_equal(a: list[LA], b: list[LA]) -> bool:
    return len(a) == len(b) and all(x.key() == y.key() for x, y in zip(a, b))

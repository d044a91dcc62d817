"""ASCII alignment display: flip, cartoon and column printers + `lashow`.

Semantics-parity reimplementation of the reference's alignment printing
(align.c:3239-3952): ``flip_alignment`` (Flip_Alignment align.c:3239),
``alignment_cartoon`` (Alignment_Cartoon align.c:3858) and
``print_alignment`` (Print_Alignment align.c:3336, including the
border/bracket/percent-per-row layout).  ``main_lashow`` is the LAshow-style
viewer over this framework's .las + DB/DAM files: per-record summary lines
plus optional -c cartoons and -a full alignments (traces recomputed with
ops.trace.compute_trace_pts, the consumer call stack of
SURVEY.md 3.5).
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

import numpy as np

from ..ops.wave import COMP_FLAG, PathRec

_TO_L = "acgt.[]-"
_TO_U = "ACGT.[]-"


@dataclass
class Alignment:
    """Alignment record (align.h:103-116): numeric sequences WITHOUT
    sentinels; path coordinates are absolute within them."""
    aseq: np.ndarray
    bseq: np.ndarray
    alen: int
    blen: int
    path: PathRec
    flags: int = 0


def flip_alignment(aln: Alignment, full: bool) -> None:
    """Swap the roles of A and B in place (Flip_Alignment align.c:3239).
    With ``full`` the exact trace is remapped too."""
    path = aln.path
    tr = path.trace
    if aln.flags & COMP_FLAG:
        p = path.abpos
        path.abpos = aln.blen - path.bepos
        path.bepos = aln.alen - p
        p = path.aepos
        path.aepos = aln.blen - path.bbpos
        path.bbpos = aln.alen - p
        if full:
            al, bl = aln.alen + 2, aln.blen + 2
            tr[:] = [al + p if p < 0 else p - bl for p in tr]
            tr.reverse()
    else:
        path.abpos, path.bbpos = path.bbpos, path.abpos
        path.aepos, path.bepos = path.bepos, path.aepos
        if full:
            tr[:] = [-p for p in tr]
    aln.aseq, aln.bseq = aln.bseq, aln.aseq
    aln.alen, aln.blen = aln.blen, aln.alen


def _ndigits(x: int) -> int:
    return len(str(int(x)))


def alignment_cartoon(file, aln: Alignment, indent: int, coord: int) -> None:
    """ASCII overlap cartoon (Alignment_Cartoon align.c:3858)."""
    alen, blen, path = aln.alen, aln.blen, aln.path
    comp = aln.flags & COMP_FLAG
    out = file.write

    def rep(ch, n):
        if n > 0:
            out(ch * n)

    out(" " * indent)
    if path.abpos > 0:
        out("    %*d " % (coord, path.abpos))
    else:
        out(" " * (coord + 5))
    if path.aepos < alen:
        out("%*s%d" % (coord + 8, "", alen - path.aepos))
    out("\n")

    out(" " * indent)
    if path.abpos > 0:
        out("A ")
        w = _ndigits(path.abpos)
        rep(" ", coord - w)
        rep("=", w + 3)
        out("+")
        rep("-", coord + 5)
    else:
        out("A %*s" % (coord + 4, ""))
        rep("-", coord + 5)
    if path.aepos < alen:
        out("+")
        w = _ndigits(alen - path.aepos)
        rep("=", w + 2)
        out(">")
        rep(" ", w)
    else:
        out(">")
        rep(" ", coord + 3)

    asub = path.aepos - path.abpos
    bsub = path.bepos - path.bbpos
    out("   dif/(len1+len2) = %d/(%d+%d) = %5.2f%%\n"
        % (path.diffs, asub, bsub, (200. * path.diffs) / max(1, asub + bsub)))

    if comp:
        sym1p, sym2p, sym1e, sym2e = "<", "-", "<", "="
    else:
        sym1p, sym2p, sym1e, sym2e = "-", ">", "=", ">"
    out(" " * indent)
    if path.bbpos > 0:
        out("B ")
        w = _ndigits(path.bbpos)
        rep(" ", coord - w)
        out(sym1e)
        rep("=", w + 2)
        out("+")
        rep("-", coord + 5)
    else:
        out("B ")
        rep(" ", coord + 3)
        out(sym1p)
        rep("-", coord + 5)
    if path.bepos < blen:
        out("+")
        w = _ndigits(blen - path.bepos)
        rep("=", w + 2)
        out(sym2e + "\n")
    else:
        out(sym2p + "\n")

    out(" " * indent)
    if path.bbpos > 0:
        out("    %*d " % (coord, path.bbpos))
    else:
        out(" " * (coord + 5))
    if path.bepos < blen:
        out("%*s%d" % (coord + 8, "", blen - path.bepos))
    out("\n")


def print_alignment(file, aln: Alignment, indent=4, width=100, border=10,
                    upper=False, coord=0) -> None:
    """Column-by-column ASCII alignment (Print_Alignment align.c:3336).
    The path's trace must be an exact indel script."""
    trace = aln.path.trace
    n2a = _TO_U if upper else _TO_L
    aend, bend = aln.path.aepos, aln.path.bepos
    comp = aln.flags & COMP_FLAG
    blen = aln.blen

    # 1-based sequences with sentinel borders (the loaded-DB layout)
    a = np.full(aln.alen + 2, 4, np.int16)
    a[1:aln.alen + 1] = aln.aseq
    b = np.full(aln.blen + 2, 4, np.int16)
    b[1:aln.blen + 1] = aln.bseq

    st = dict(o=0, sa=0, sb=0, match=0, diff=0, mtag=":", dtag=":")
    Abuf, Bbuf, Dbuf = [], [], []

    def flush(final=False):
        o = st["o"]
        file.write("\n")
        file.write(" " * indent)
        if coord > 0:
            if st["sa"] < aend:
                file.write(" %*d" % (coord, st["sa"]))
            else:
                file.write(" %*s" % (coord, ""))
            file.write(" %s\n" % "".join(Abuf[:o]))
            file.write("%*s %*s %s\n" % (indent, "", coord, "",
                                         "".join(Dbuf[:o])))
            file.write(" " * indent)
            if st["sb"] < bend:
                file.write(" %*d" % (coord, blen - st["sb"] if comp
                                     else st["sb"]))
            else:
                file.write(" %*s" % (coord, ""))
            file.write(" %s" % "".join(Bbuf[:o]))
        else:
            file.write(" %s\n" % "".join(Abuf[:o]))
            file.write("%*s %s\n" % (indent, "", "".join(Dbuf[:o])))
            file.write("%*s %s" % (indent, "", "".join(Bbuf[:o])))
        md = st["diff"] + st["match"]
        if not final:
            file.write(" %5.1f%%\n" % ((100. * st["diff"]) / md))
        elif md > 0:
            file.write(" %5.1f%%\n" % ((100. * st["diff"]) / md))
        else:
            file.write("\n")

    def column(u, v):
        if st["o"] >= width:
            flush()
            st["o"] = 0
            st["sa"] = ii[0] - 1
            st["sb"] = jj[0] - 1
            st["match"] = st["diff"] = 0
            del Abuf[:], Bbuf[:], Dbuf[:]
        if u == 4 or v == 4:
            Dbuf.append(" ")
        elif u == v:
            Dbuf.append(st["mtag"])
        else:
            Dbuf.append(st["dtag"])
        Abuf.append(n2a[u])
        Bbuf.append(n2a[v])
        st["o"] += 1

    ii = [aln.path.abpos]
    jj = [aln.path.bbpos]

    prefa = 0
    while prefa < border and a[ii[0]] != 4:
        prefa += 1
        ii[0] -= 1
    ii[0] += 1
    prefb = 0
    while prefb < border and b[jj[0]] != 4:
        prefb += 1
        jj[0] -= 1
    jj[0] += 1

    st["sa"] = ii[0] - 1
    st["sb"] = jj[0] - 1
    st["mtag"] = st["dtag"] = ":"

    while prefa > prefb:
        column(a[ii[0]], 4)
        ii[0] += 1
        prefa -= 1
    while prefb > prefa:
        column(4, b[jj[0]])
        jj[0] += 1
        prefb -= 1
    while prefa > 0:
        column(a[ii[0]], b[jj[0]])
        ii[0] += 1
        jj[0] += 1
        prefa -= 1

    st["mtag"] = "["
    if prefb > 0:
        column(5, 5)

    st["mtag"], st["dtag"] = "|", "*"
    st["match"] = st["diff"] = 0

    for p in trace:
        if p < 0:
            p = -p
            while ii[0] != p:
                column(a[ii[0]], b[jj[0]])
                if a[ii[0]] == b[jj[0]]:
                    st["match"] += 1
                else:
                    st["diff"] += 1
                ii[0] += 1
                jj[0] += 1
            column(7, b[jj[0]])
            jj[0] += 1
            st["diff"] += 1
        else:
            while jj[0] != p:
                column(a[ii[0]], b[jj[0]])
                if a[ii[0]] == b[jj[0]]:
                    st["match"] += 1
                else:
                    st["diff"] += 1
                ii[0] += 1
                jj[0] += 1
            column(a[ii[0]], 7)
            ii[0] += 1
            st["diff"] += 1
    p = aln.path.aepos
    while ii[0] <= p:
        column(a[ii[0]], b[jj[0]])
        if a[ii[0]] == b[jj[0]]:
            st["match"] += 1
        else:
            st["diff"] += 1
        ii[0] += 1
        jj[0] += 1

    st["mtag"] = "]"
    if a[ii[0]] != 4 and b[jj[0]] != 4 and border > 0:
        column(6, 6)
    st["mtag"] = st["dtag"] = ":"
    c = 0
    while c < border and (a[ii[0]] != 4 or b[jj[0]] != 4):
        if a[ii[0]] != 4:
            if b[jj[0]] != 4:
                column(a[ii[0]], b[jj[0]])
                ii[0] += 1
                jj[0] += 1
            else:
                column(a[ii[0]], 4)
                ii[0] += 1
        else:
            column(4, b[jj[0]])
            jj[0] += 1
        c += 1

    flush(final=True)


def print_reference(file, aln: Alignment, indent=4, block=100, border=10,
                    upper=False, coord=0) -> None:
    """Reference-frame ASCII alignment (Print_Reference align.c:3587-3855):
    identical column layout to print_alignment, but rows break at A-sequence
    coordinates that are multiples of `block` (i % block == 1) instead of at
    a fixed column width, so every row starts at a round reference position.
    The path's trace must be an exact indel script."""
    trace = aln.path.trace
    n2a = _TO_U if upper else _TO_L
    aend, bend = aln.path.aepos, aln.path.bepos
    comp = aln.flags & COMP_FLAG
    blen = aln.blen

    a = np.full(aln.alen + 2, 4, np.int16)
    a[1:aln.alen + 1] = aln.aseq
    b = np.full(aln.blen + 2, 4, np.int16)
    b[1:aln.blen + 1] = aln.bseq

    st = dict(o=0, sa=0, sb=0, match=0, diff=0, mtag=":", dtag=":")
    Abuf, Bbuf, Dbuf = [], [], []

    def flush(final=False):
        o = st["o"]
        file.write("\n")
        file.write(" " * indent)
        if coord > 0:
            if st["sa"] < aend:
                file.write(" %*d" % (coord, st["sa"]))
            else:
                file.write(" %*s" % (coord, ""))
            file.write(" %s\n" % "".join(Abuf[:o]))
            file.write("%*s %*s %s\n" % (indent, "", coord, "",
                                         "".join(Dbuf[:o])))
            file.write(" " * indent)
            if st["sb"] < bend:
                file.write(" %*d" % (coord, blen - st["sb"] if comp
                                     else st["sb"]))
            else:
                file.write(" %*s" % (coord, ""))
            file.write(" %s" % "".join(Bbuf[:o]))
        else:
            file.write(" %s\n" % "".join(Abuf[:o]))
            file.write("%*s %s\n" % (indent, "", "".join(Dbuf[:o])))
            file.write("%*s %s" % (indent, "", "".join(Bbuf[:o])))
        md = st["diff"] + st["match"]
        if not final:
            file.write(" %5.1f%%\n" % ((100. * st["diff"]) / md))
        elif md > 0:
            file.write(" %5.1f%%\n" % ((100. * st["diff"]) / md))
        else:
            file.write("\n")

    ii = [aln.path.abpos]
    jj = [aln.path.bbpos]
    s0 = [0]

    def column(u, v):
        # break BEFORE a real A base at a block boundary (BLOCK macro,
        # align.c:3638-3667)
        if (ii[0] % block == 1 and ii[0] != s0[0] and u < 4
                and st["o"] > 0):
            flush()
            st["o"] = 0
            st["sa"] = ii[0] - 1
            st["sb"] = jj[0] - 1
            st["match"] = st["diff"] = 0
            del Abuf[:], Bbuf[:], Dbuf[:]
        if u == 4 or v == 4:
            Dbuf.append(" ")
        elif u == v:
            Dbuf.append(st["mtag"])
        else:
            Dbuf.append(st["dtag"])
        Abuf.append(n2a[u])
        Bbuf.append(n2a[v])
        st["o"] += 1

    prefa = 0
    while prefa < border and a[ii[0]] != 4:
        prefa += 1
        ii[0] -= 1
    ii[0] += 1
    prefb = 0
    while prefb < border and b[jj[0]] != 4:
        prefb += 1
        jj[0] -= 1
    jj[0] += 1

    s0[0] = ii[0]
    st["sa"] = ii[0] - 1
    st["sb"] = jj[0] - 1
    st["mtag"] = st["dtag"] = ":"

    while prefa > prefb:
        column(a[ii[0]], 4)
        ii[0] += 1
        prefa -= 1
    while prefb > prefa:
        column(4, b[jj[0]])
        jj[0] += 1
        prefb -= 1
    while prefa > 0:
        column(a[ii[0]], b[jj[0]])
        ii[0] += 1
        jj[0] += 1
        prefa -= 1

    st["mtag"] = "["
    if prefb > 0:
        column(5, 5)

    st["mtag"], st["dtag"] = "|", "*"
    st["match"] = st["diff"] = 0

    for p in trace:
        if p < 0:
            p = -p
            while ii[0] != p:
                column(a[ii[0]], b[jj[0]])
                if a[ii[0]] == b[jj[0]]:
                    st["match"] += 1
                else:
                    st["diff"] += 1
                ii[0] += 1
                jj[0] += 1
            column(7, b[jj[0]])
            jj[0] += 1
            st["diff"] += 1
        else:
            while jj[0] != p:
                column(a[ii[0]], b[jj[0]])
                if a[ii[0]] == b[jj[0]]:
                    st["match"] += 1
                else:
                    st["diff"] += 1
                ii[0] += 1
                jj[0] += 1
            column(a[ii[0]], 7)
            ii[0] += 1
            st["diff"] += 1
    p = aln.path.aepos
    while ii[0] <= p:
        column(a[ii[0]], b[jj[0]])
        if a[ii[0]] == b[jj[0]]:
            st["match"] += 1
        else:
            st["diff"] += 1
        ii[0] += 1
        jj[0] += 1

    st["mtag"] = "]"
    if a[ii[0]] != 4 and b[jj[0]] != 4 and border > 0:
        column(6, 6)
    st["mtag"] = st["dtag"] = ":"
    c = 0
    while c < border and (a[ii[0]] != 4 or b[jj[0]] != 4):
        if a[ii[0]] != 4:
            if b[jj[0]] != 4:
                column(a[ii[0]], b[jj[0]])
                ii[0] += 1
                jj[0] += 1
            else:
                column(a[ii[0]], 4)
                ii[0] += 1
        else:
            column(4, b[jj[0]])
            jj[0] += 1
        c += 1

    flush(final=True)


def main_lashow(argv: list[str]) -> int:
    """LAshow-equivalent viewer:
    lashow [-caUFG] [-i<int>] [-w<int>] [-b<int>] <ref:dam> <reads:db> <las>
    -c cartoon, -a alignment, -U uppercase, -F flip (B on top),
    -G consolidate gaps (Gap_Improver) before display."""
    from . import db as dbio
    from . import las as lasio
    from ..ops import trace as T

    flags = set()
    indent, width, border = 4, 100, 10
    args = []
    for aarg in argv:
        if aarg.startswith("-") and len(aarg) > 1 and not aarg[1].isdigit():
            c = aarg[1]
            if c in "caUFG" and len(aarg) == 2:
                flags.add(c)
            elif all(ch in "caUFG" for ch in aarg[1:]):
                flags.update(aarg[1:])
            elif c == "i":
                indent = int(aarg[2:])
            elif c == "w":
                width = int(aarg[2:])
            elif c == "b":
                border = int(aarg[2:])
            else:
                print(f"lashow: -{c} is an illegal option", file=sys.stderr)
                return 1
        else:
            args.append(aarg)
    if len(args) != 3:
        print("Usage: lashow [-caUFG] [-i<int>] [-w<int>] [-b<int>] "
              "<ref:dam> <reads:db> <las>", file=sys.stderr)
        return 1

    ref_db = dbio.DazzDB.open(args[0])
    ref_db.trim()
    ref_db.load_bases()
    reads_db = dbio.DazzDB.open(args[1])
    reads_db.trim()
    reads_db.load_bases()
    recs, tspace = lasio.read_las(args[2])

    out = sys.stdout
    out.write(f"\n{args[2]}: {len(recs):,} records\n")
    for o in recs:
        aseq = reads_db.read_seq(o.aread)
        bseq = ref_db.read_seq(o.bread)
        if o.flags & COMP_FLAG:
            bseq = dbio.complement_numeric(bseq)
        ch = "c" if o.flags & COMP_FLAG else "n"
        chain = ("+" if lasio.START_FLAG & o.flags else
                 "-" if lasio.NEXT_FLAG & o.flags else " ")
        best = "*" if o.flags & lasio.BEST_FLAG else " "
        out.write("%*s%6d %6d %c %s%s [%9d..%9d] x [%9d..%9d] : %5d diffs\n"
                  % (indent, "", o.aread + 1, o.bread + 1, ch, chain, best,
                     o.abpos, o.aepos, o.bbpos, o.bepos, o.diffs))
        path = PathRec(abpos=o.abpos, bbpos=o.bbpos,
                       aepos=o.aepos, bepos=o.bepos,
                       trace=[int(v) for v in o.trace])
        path.diffs = o.diffs
        aln = Alignment(aseq, bseq, len(aseq), len(bseq), path, o.flags)
        if "c" in flags:
            alignment_cartoon(out, aln, indent, max(5, _ndigits(
                max(aln.alen, aln.blen))))
        if "a" in flags:
            T.compute_trace_pts(path, aseq, bseq, tspace, T.GREEDIEST)
            if "G" in flags:
                from ..ops.gap import gap_improver
                gap_improver(aseq, bseq, path)
            if "F" in flags:
                flip_alignment(aln, True)
                if o.flags & COMP_FLAG:
                    # flipped comp coordinates live on the complement of
                    # both strands; the caller supplies complemented seqs
                    # (align.h:112-116)
                    aln.aseq = dbio.complement_numeric(aln.aseq)
                    aln.bseq = dbio.complement_numeric(aln.bseq)
            print_alignment(out, aln, indent, width, border,
                            upper="U" in flags,
                            coord=_ndigits(max(aln.alen, aln.blen)))
    return 0

"""The DAZZ files the benchmark hands the mapper, and the ones it reads back.

Writers: a DAM of named contigs split into blocks of ``bsize`` bases, and a
reads DB whose blocks are the traffic's read blocks, in the formats of the
DAZZ_DB library (DB.h, DB.c): the ASCII stub, the hidden ``.idx`` (a
112-byte header and one 40-byte record a read), the hidden ``.bps`` (each
read 2-bit packed, 4 bases a byte, first base in the top bits, padded to a
byte) and, for the DAM, the ``.hdr`` of contig names.  Readers: the
``.las`` records and the ``-p`` track (``.prof.anno``, ``.prof.data``).
"""

from __future__ import annotations

import os
import struct

import numpy as np

DB_BEST = 0x0800
COMP_FLAG, START_FLAG, NEXT_FLAG, BEST_FLAG = 0x1, 0x4, 0x8, 0x10
TRACE_XOVR = 125

READ_DTYPE = np.dtype([
    ("origin", "<i4"), ("rlen", "<i4"), ("fpulse", "<i4"), ("_pad1", "<i4"),
    ("boff", "<i8"), ("coff", "<i8"), ("flags", "<i4"), ("_pad2", "<i4")])
HEADER_DTYPE = np.dtype([
    ("ureads", "<i4"), ("treads", "<i4"), ("cutoff", "<i4"),
    ("allarr", "<i4"), ("freq", "<f4", (4,)), ("maxlen", "<i4"),
    ("_pad1", "<i4"), ("totlen", "<i8"), ("nreads", "<i4"),
    ("trimmed", "<i4"), ("part", "<i4"), ("ufirst", "<i4"),
    ("tfirst", "<i4"), ("_pad2", "<i4"), ("_path", "<i8"), ("loaded", "<i4"),
    ("_pad3", "<i4"), ("_bases", "<i8"), ("_reads", "<i8"),
    ("_tracks", "<i8")])
_REC = struct.Struct("<iiiiiiIii4x")


#: bases counted or packed in one step, which bounds the temporaries
PACK_STEP = 1 << 22


def base_freq(seq: np.ndarray) -> np.ndarray:
    """The header's base frequencies (fasta2DAM's counts over the total)."""
    counts = np.zeros(4, np.int64)
    for a in range(0, len(seq), PACK_STEP):
        step = seq[a:a + PACK_STEP]
        for b in range(4):
            counts[b] += np.count_nonzero(step == b)
    return (counts / max(int(counts.sum()), 1)).astype(np.float32)


def _pack(seq: np.ndarray, offs: np.ndarray):
    """(.bps bytes as a uint8 array, byte offset of each read): every read
    padded to a whole byte."""
    rlens = np.diff(offs)
    poffs = np.concatenate([[0], np.cumsum((rlens + 3) // 4 * 4)])
    out = np.empty(int(poffs[-1]) // 4, np.uint8)
    if (rlens % 4 == 0).all():
        _pack_whole(seq, out)
        return out, poffs[:-1] // 4
    # runs of reads of about PACK_STEP padded bases (a longer read alone),
    # each read copied into a zeroed buffer at its padded offset
    i = 0
    while i < len(rlens):
        j = max(int(np.searchsorted(poffs, poffs[i] + PACK_STEP,
                                    "right")) - 1, i + 1)
        p0, p1 = int(poffs[i]), int(poffs[j])
        buf = np.zeros(p1 - p0, np.uint8)
        copy_runs(buf, poffs[i:j] - p0, seq, offs[i:j], rlens[i:j])
        _pack_whole(buf, out[p0 // 4:p1 // 4])
        i = j
    return out, poffs[:-1] // 4


def _pack_whole(seq: np.ndarray, out: np.ndarray) -> None:
    """out[k] = the bases seq[4k:4k+4], 2 bits each, the first in the top
    bits: a 4-base group read as a little-endian 32-bit word w holds its
    bases at bits 0, 8, 16 and 24, and w * 0x40100401 gathers them, with
    nothing carried in, into bits 30, 28, 26 and 24."""
    for a in range(0, len(out), PACK_STEP // 4):
        w = seq[4 * a:4 * a + PACK_STEP].view("<u4") * np.uint32(0x40100401)
        w >>= 24
        out[a:a + len(w)] = w


def copy_runs(dst: np.ndarray, at, src: np.ndarray, start, lens) -> None:
    """dst[at[i]:at[i] + lens[i]] = src[start[i]:start[i] + lens[i]] for
    every i in order: one slice copy a run, no per-base index."""
    d, s = memoryview(dst), memoryview(src)
    for a, b, n in zip(at.tolist(), start.tolist(), lens.tolist()):
        d[a:a + n] = s[b:b + n]


def _blocks(rlens: np.ndarray, bsize: int) -> list[int]:
    """DBsplit's block boundaries: a block closes on the read whose bases
    reach bsize; a last partial block keeps the rest."""
    cut = [0]
    acc = 0
    for i, ln in enumerate(rlens.tolist()):
        acc += ln
        if acc >= bsize:
            cut.append(i + 1)
            acc = 0
    if cut[-1] != len(rlens):
        cut.append(len(rlens))
    return cut


def _write(root: str, ext: str, seq, offs, recs, bsize, freq):
    pwd, name = os.path.split(root)
    pwd = pwd or "."
    os.makedirs(pwd, exist_ok=True)
    n = len(recs)
    cut = _blocks(recs["rlen"], bsize)
    with open(os.path.join(pwd, name + ext), "wt") as fp:
        fp.write("files = %9d\n" % 1)
        fp.write("  %9d %s %s\n" % (n, name, name))
        fp.write("blocks = %9d\n" % (len(cut) - 1))
        fp.write("size = %11d cutoff = %9d all = %1d\n" % (bsize, 0, 1))
        for c in cut:
            fp.write(" %9d %9d\n" % (c, c))
    bps, boffs = _pack(seq, offs)
    recs["boff"] = boffs
    hdr = np.zeros(1, HEADER_DTYPE)
    hdr["ureads"] = hdr["treads"] = hdr["nreads"] = n
    hdr["cutoff"] = -1
    hdr["freq"] = freq
    hdr["maxlen"] = int(recs["rlen"].max(initial=0))
    hdr["totlen"] = int(recs["rlen"].sum())
    with open(os.path.join(pwd, "." + name + ".idx"), "wb") as fp:
        fp.write(hdr.tobytes())
        fp.write(recs.tobytes())
    with open(os.path.join(pwd, "." + name + ".bps"), "wb") as fp:
        fp.write(bps)
    return cut


def write_dam(root: str, genome, bsize: int) -> list[int]:
    """<root>.dam: one contig a read, under its name.  Returns the block
    boundaries in contigs."""
    n = genome.ncontigs
    lines = [b"%s\n" % name.encode() for name in genome.names]
    names = b"".join(lines)
    coff = np.concatenate([[0], np.cumsum([len(x) for x in lines])])[:-1]
    recs = np.zeros(n, READ_DTYPE)
    recs["rlen"] = genome.lens
    recs["coff"] = coff
    cut = _write(root, ".dam", genome.seq, genome.offs, recs, bsize,
                 base_freq(genome.seq))
    pwd, name = os.path.split(root)
    with open(os.path.join(pwd or ".", "." + name + ".hdr"), "wb") as fp:
        fp.write(names)
    return cut


def write_reads(root: str, blocks, block_bases: int) -> list[int]:
    """<root>.db holding the read blocks in order, one DB block each
    (the blocks were drawn to close where DBsplit closes them).  Returns
    the blocks' first reads."""
    seq = np.concatenate([b.seq for b in blocks])
    lens = np.concatenate([b.lens for b in blocks])
    offs = np.concatenate([[0], np.cumsum(lens)])
    recs = np.zeros(len(lens), READ_DTYPE)
    recs["origin"] = np.arange(len(lens))
    recs["rlen"] = lens
    recs["flags"] = DB_BEST
    cut = _write(root, ".db", seq, offs, recs, block_bases, base_freq(seq))
    want = np.concatenate([[0], np.cumsum([b.nreads for b in blocks])])
    if cut != want.tolist():
        raise ValueError(f"read blocks {want.tolist()} do not close where "
                         f"DBsplit closes them ({cut})")
    return cut


# --- reading the mapper's output ---------------------------------------------

class LasFile:
    """The records of one .las file as columns: ``head`` (n, 9) int64 of
    tlen, diffs, abpos, bbpos, aepos, bepos, flags, aread, bread; the
    traces back to back in ``trace`` with record i's at
    trace[toff[i]:toff[i+1]]."""

    COLS = ("tlen", "diffs", "abpos", "bbpos", "aepos", "bepos", "flags",
            "aread", "bread")

    def __init__(self, path: str):
        with open(path, "rb") as fp:
            buf = fp.read()
        if len(buf) < 12:
            raise IOError(f"{path}: truncated header")
        novl, self.tspace = struct.unpack_from("<qi", buf, 0)
        tb = 1 if self.tspace <= TRACE_XOVR else 2
        head = np.zeros((novl, 9), np.int64)
        spans = []
        off = 12
        for i in range(novl):
            if off + 40 > len(buf):
                raise IOError(f"{path}: truncated at record {i}")
            row = _REC.unpack_from(buf, off)
            head[i] = row
            off += 40
            n = row[0] * tb
            if row[0] < 0 or off + n > len(buf):
                raise IOError(f"{path}: truncated trace at record {i}")
            spans.append((off, row[0]))
            off += n
        if off != len(buf):
            raise IOError(f"{path}: {len(buf) - off} bytes after the records")
        dt = np.uint8 if tb == 1 else np.dtype("<u2")
        self.trace = (np.concatenate([np.frombuffer(buf, dt, c, o)
                                      for o, c in spans]).astype(np.int64)
                      if spans else np.zeros(0, np.int64))
        self.head = head
        self.toff = np.concatenate([[0], np.cumsum(head[:, 0])])

    def __len__(self):
        return len(self.head)

    def col(self, name: str) -> np.ndarray:
        return self.head[:, self.COLS.index(name)]

    def record(self, i: int) -> tuple:
        """Every field of record i, its trace included, as one tuple."""
        return (tuple(int(x) for x in self.head[i])
                + tuple(int(x) for x in
                        self.trace[self.toff[i]:self.toff[i + 1]]))

    def records_of(self, aread: int) -> list[tuple]:
        rows = np.flatnonzero(self.col("aread") == aread)
        return [self.record(int(i)) for i in rows]


def read_profile(root: str) -> tuple[np.ndarray, bytes]:
    """The -p track written beside a block's .las: (offsets int64[n+1],
    data bytes); read i's values are data[offs[i]:offs[i+1]]."""
    with open(root + ".prof.anno", "rb") as fp:
        buf = fp.read()
    n, size = struct.unpack_from("<ii", buf, 0)
    if size != 8 or len(buf) != 8 + 8 * (n + 1):
        raise IOError(f"{root}.prof.anno: bad header or length")
    offs = np.frombuffer(buf, "<i8", n + 1, 8).astype(np.int64)
    with open(root + ".prof.data", "rb") as fp:
        data = fp.read()
    return offs, data

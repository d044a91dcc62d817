"""DAZZ database (.db / .dam) codec — read, write, trim, block logic.

Round-trips the reference on-disk formats exactly so that golden tests can run
the reference `damapper` binary on databases we create, and so that our mapper
consumes the same inputs bit-for-bit.

On-disk format (reference citations):
  * ASCII stub  <root>.db|.dam          — DB.h:431-435 formats, DB.c:478-588 parser
  * .<root>.idx — 112-byte DAZZ_DB header struct + ureads x 40-byte DAZZ_READ
                  records (DB.h:285-295, DB.h:390-420, DB.c:754-834)
  * .<root>.bps — per-read 2-bit packed bases, 4 bases/byte, MSB first
                  (DB.c:319-338 Compress_Read)
  * .<root>.hdr — (DAM only) scaffold fasta headers; read.coff = byte offset
                  (DB.h:472-478)

Trimming semantics mirror Trim_DB (DB.c:908-1039): keep reads with
(flags & DB_BEST) >= allflag and rlen >= cutoff, where allflag = 0 if the DB
was split with -a (all wells) else DB_BEST.

In-memory, sequences are loaded as numeric strings over {0,1,2,3} with a `4`
sentinel separating/terminating reads, matching Load_All_Reads (DB.c:1389-1441)
so alignment code can walk off either end of a read and hit a sentinel.
"""

from __future__ import annotations

import os
import re
from dataclasses import dataclass, field

import numpy as np

# --- flag constants (DB.h:276-281) ---
DB_QV = 0x03FF
DB_CCS = 0x0400
DB_BEST = 0x0800
DB_ARROW = 0x2
DB_ALL = 0x1

MAX_NAME = 10000

# DAZZ_READ: int origin, rlen, fpulse; int64 boff, coff; int flags  (40 bytes w/ padding)
READ_DTYPE = np.dtype([
    ("origin", "<i4"), ("rlen", "<i4"), ("fpulse", "<i4"), ("_pad1", "<i4"),
    ("boff", "<i8"), ("coff", "<i8"), ("flags", "<i4"), ("_pad2", "<i4"),
])
assert READ_DTYPE.itemsize == 40

# DAZZ_DB header as stored at the head of .idx (112 bytes incl. pointer fields)
HEADER_DTYPE = np.dtype([
    ("ureads", "<i4"), ("treads", "<i4"), ("cutoff", "<i4"), ("allarr", "<i4"),
    ("freq", "<f4", (4,)),
    ("maxlen", "<i4"), ("_pad1", "<i4"), ("totlen", "<i8"),
    ("nreads", "<i4"), ("trimmed", "<i4"), ("part", "<i4"),
    ("ufirst", "<i4"), ("tfirst", "<i4"), ("_pad2", "<i4"),
    ("_path", "<i8"), ("loaded", "<i4"), ("_pad3", "<i4"),
    ("_bases", "<i8"), ("_reads", "<i8"), ("_tracks", "<i8"),
])
assert HEADER_DTYPE.itemsize == 112

# --- 2-bit codec ------------------------------------------------------------

_ACGT = np.frombuffer(b"acgt", dtype=np.uint8)
_BASE_NUM = np.zeros(256, dtype=np.uint8)
for _i, _cs in enumerate("ACGT"):
    _BASE_NUM[ord(_cs)] = _i
    _BASE_NUM[ord(_cs.lower())] = _i


def seq_to_numeric(seq: str | bytes) -> np.ndarray:
    """ASCII acgt/ACGT -> uint8 array over {0..3} (N and others -> 0, as in
    Number_Read DB.c:393-416)."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BASE_NUM[np.frombuffer(seq, dtype=np.uint8)].copy()


def numeric_to_seq(arr: np.ndarray, upper: bool = False) -> str:
    letters = _ACGT[arr]
    s = letters.tobytes().decode()
    return s.upper() if upper else s


def compress_bases(num: np.ndarray) -> bytes:
    """Pack numeric bases 4/byte, first base in top 2 bits (Compress_Read DB.c:319)."""
    n = len(num)
    pad = (-n) % 4
    if pad:
        num = np.concatenate([num, np.zeros(pad, dtype=np.uint8)])
    q = num.reshape(-1, 4).astype(np.uint8)
    packed = (q[:, 0] << 6) | (q[:, 1] << 4) | (q[:, 2] << 2) | q[:, 3]
    return packed.tobytes()


def _fread(fp, n: int, what: str) -> bytes:
    """Guarded batch read (FFREAD discipline, reference DB.h:136-224):
    short reads raise a corruption error instead of silently yielding
    partial arrays."""
    b = fp.read(n)
    if len(b) != n:
        raise IOError(f"{what}: The file is corrupted (short read: "
                      f"wanted {n} bytes, got {len(b)})")
    return b



def uncompress_bases(buf: bytes | np.ndarray, length: int) -> np.ndarray:
    """Inverse of compress_bases (Uncompress_Read DB.c:342)."""
    b = np.frombuffer(buf, dtype=np.uint8) if not isinstance(buf, np.ndarray) else buf
    out = np.empty(len(b) * 4, dtype=np.uint8)
    out[0::4] = (b >> 6) & 3
    out[1::4] = (b >> 4) & 3
    out[2::4] = (b >> 2) & 3
    out[3::4] = b & 3
    return out[:length]


def complement_numeric(num: np.ndarray) -> np.ndarray:
    """Reverse complement of a numeric sequence (Complement_Seq align.c:3314)."""
    return (3 - num)[::-1].copy()


# --- stub -------------------------------------------------------------------

@dataclass
class DBStub:
    """Parsed ASCII stub (DAZZ_STUB, DB.h:373-384)."""
    nfiles: int = 0
    nreads: list[int] = field(default_factory=list)     # cumulative last-read+1 per file
    fname: list[str] = field(default_factory=list)
    prolog: list[str] = field(default_factory=list)
    all: int = 1
    cutoff: int = 0
    bsize: int = 200_000_000
    nblocks: int = 0
    ublocks: list[int] = field(default_factory=list)    # [0..nblocks] untrimmed first-read idx
    tblocks: list[int] = field(default_factory=list)    # [0..nblocks] trimmed first-read idx


_RE_NFILE = re.compile(r"files =\s*(\d+)")
_RE_FDATA = re.compile(r"\s*(\d+)\s+(\S+)\s+(\S+)")
_RE_NBLOCK = re.compile(r"blocks =\s*(\d+)")
_RE_PARAMS = re.compile(r"size =\s*(\d+) cutoff =\s*(-?\d+) all =\s*(\d+)")
_RE_BDATA = re.compile(r"\s*(\d+)\s+(\d+)")


def read_stub(path: str) -> DBStub:
    stub = DBStub()
    with open(path, "rt") as fp:
        lines = fp.read().splitlines()
    it = iter(lines)
    m = _RE_NFILE.match(next(it))
    if not m:
        raise ValueError(f"Stub file {path} is junk")
    stub.nfiles = int(m.group(1))
    for _ in range(stub.nfiles):
        m = _RE_FDATA.match(next(it))
        if not m:
            raise ValueError(f"Stub file {path} is junk")
        stub.nreads.append(int(m.group(1)))
        stub.fname.append(m.group(2))
        stub.prolog.append(m.group(3))
    rest = list(it)
    if rest:
        m = _RE_NBLOCK.match(rest[0])
        if m:
            stub.nblocks = int(m.group(1))
            m = _RE_PARAMS.match(rest[1])
            if not m:
                raise ValueError(f"Stub file {path} is junk")
            stub.bsize, stub.cutoff, stub.all = int(m.group(1)), int(m.group(2)), int(m.group(3))
            for i in range(stub.nblocks + 1):
                m = _RE_BDATA.match(rest[2 + i])
                if not m:
                    raise ValueError(f"Stub file {path} is junk")
                stub.ublocks.append(int(m.group(1)))
                stub.tblocks.append(int(m.group(2)))
    return stub


def write_stub(path: str, stub: DBStub) -> None:
    with open(path, "wt") as fp:
        fp.write("files = %9d\n" % stub.nfiles)
        for n, f, p in zip(stub.nreads, stub.fname, stub.prolog):
            fp.write("  %9d %s %s\n" % (n, f, p))
        if stub.nblocks > 0:
            fp.write("blocks = %9d\n" % stub.nblocks)
            fp.write("size = %11d cutoff = %9d all = %1d\n"
                     % (stub.bsize, stub.cutoff, stub.all))
            for u, t in zip(stub.ublocks, stub.tblocks):
                fp.write(" %9d %9d\n" % (u, t))


# --- path algebra (PathTo/Root, DB.c:112-251) --------------------------------

def _split_db_path(path: str) -> tuple[str, str, bool]:
    """-> (pwd, root, isdam). Accepts name w/ or w/o .db/.dam suffix."""
    pwd = os.path.dirname(path) or "."
    base = os.path.basename(path)
    if base.endswith(".dam"):
        return pwd, base[:-4], True
    if base.endswith(".db"):
        return pwd, base[:-3], False
    # probe
    if os.path.exists(os.path.join(pwd, base + ".db")):
        return pwd, base, False
    if os.path.exists(os.path.join(pwd, base + ".dam")):
        return pwd, base, True
    return pwd, base, False


def _strip_part(root: str) -> tuple[str, int]:
    """root possibly ending in '.<k>' -> (root, part) (Open_DB DB.c:716-725)."""
    m = re.match(r"^(.*)\.(\d+)$", root)
    if m and int(m.group(2)) > 0:
        return m.group(1), int(m.group(2))
    return root, 0


# --- the DB object -----------------------------------------------------------

@dataclass
class DazzDB:
    """In-memory DB/DAM, mirroring DAZZ_DB (DB.h:390-420).

    After `load_bases()`, `seq` holds all reads as one numeric uint8 array with
    `4` sentinels before the first read, between reads, and at the end; the
    `boff` column of `reads` is rewritten to in-memory offsets, exactly like
    Load_All_Reads (DB.c:1389-1441).
    """
    path: str = ""            # pwd/root, no extension
    isdam: bool = False
    ureads: int = 0
    treads: int = 0
    cutoff: int = 0
    allarr: int = 0
    freq: np.ndarray = field(default_factory=lambda: np.zeros(4, np.float32))
    maxlen: int = 0
    totlen: int = 0
    nreads: int = 0
    trimmed: bool = False
    part: int = 0
    ufirst: int = 0
    tfirst: int = 0
    reads: np.ndarray = field(default_factory=lambda: np.zeros(0, READ_DTYPE))
    seq: np.ndarray | None = None      # loaded numeric bases (with sentinels)
    loaded: bool = False
    tracks: dict = field(default_factory=dict)   # name -> (anno int64[n+1], data np.ndarray)
    # sizes of the active block before trimming (the reads[-1] kludge, DB.c:866-867)
    _block_ureads: int = 0
    _block_treads: int = 0

    # -- opening ---------------------------------------------------------

    @staticmethod
    def open(path: str) -> "DazzDB":
        """Open a DB/DAM or block thereof (Open_DB DB.c:690-901)."""
        pwd, root, isdam = _split_db_path(path)
        root, part = _strip_part(root)  # Open_DB always strips a numeric block suffix
        stubp = os.path.join(pwd, root + (".dam" if isdam else ".db"))
        if not os.path.exists(stubp):
            # retry other suffix
            other = os.path.join(pwd, root + (".db" if isdam else ".dam"))
            if os.path.exists(other):
                stubp, isdam = other, not isdam
            else:
                raise FileNotFoundError(f"Could not open DB {path}")
        stub = read_stub(stubp)

        idxp = os.path.join(pwd, "." + root + ".idx")
        with open(idxp, "rb") as fp:
            hdr = np.frombuffer(_fread(fp, HEADER_DTYPE.itemsize, idxp),
                                HEADER_DTYPE)[0]
            db = DazzDB(path=os.path.join(pwd, "." + root), isdam=isdam)
            db.ureads = int(hdr["ureads"])
            db.treads = int(hdr["treads"])
            db.freq = np.array(hdr["freq"], np.float32)
            db.allarr = int(hdr["allarr"])
            if part > 0:
                if part > stub.nblocks:
                    raise ValueError(f"DB {root} has only {stub.nblocks} blocks")
                ufirst, ulast = stub.ublocks[part - 1], stub.ublocks[part]
                tfirst, tlast = stub.tblocks[part - 1], stub.tblocks[part]
                fp.seek(HEADER_DTYPE.itemsize + READ_DTYPE.itemsize * ufirst)
                db.reads = np.frombuffer(
                    _fread(fp, READ_DTYPE.itemsize * (ulast - ufirst), idxp),
                    READ_DTYPE).copy()
                db.maxlen = int(db.reads["rlen"].max(initial=0))
                db.totlen = int(db.reads["rlen"].sum())
            else:
                ufirst = tfirst = 0
                ulast, tlast = db.ureads, db.treads
                db.reads = np.frombuffer(
                    _fread(fp, READ_DTYPE.itemsize * db.ureads, idxp),
                    READ_DTYPE).copy()
                db.maxlen = int(hdr["maxlen"])
                db.totlen = int(hdr["totlen"])
        db.nreads = ulast - ufirst
        db.part = part
        db.cutoff = stub.cutoff if stub.nblocks > 0 else 0
        db.allarr |= stub.all if stub.nblocks > 0 else DB_ALL
        db.ufirst, db.tfirst = ufirst, tfirst
        db._block_ureads = ulast - ufirst
        db._block_treads = tlast - tfirst
        db._stub = stub
        return db

    # -- trimming (Trim_DB DB.c:908-1039) ---------------------------------

    def trim(self) -> None:
        if self.trimmed:
            return
        if self.cutoff <= 0 and (self.allarr & DB_ALL) != 0:
            return
        allflag = 0 if (self.allarr & DB_ALL) != 0 else DB_BEST
        keep = ((self.reads["flags"] & DB_BEST) >= allflag) & \
               (self.reads["rlen"] >= self.cutoff)
        for name, (anno, data, alen) in list(self.tracks.items()):
            mask = np.asarray(keep)
            new_anno = anno[:-1][mask]
            new_alen = alen[mask]
            self.tracks[name] = (np.append(new_anno, anno[-1]), data, new_alen)
        self.reads = self.reads[keep].copy()
        self.nreads = len(self.reads)
        self.totlen = int(self.reads["rlen"].sum())
        self.maxlen = int(self.reads["rlen"].max(initial=0))
        self.trimmed = True

    # -- sequence loading --------------------------------------------------

    def load_bases(self) -> None:
        """Load all reads as numeric strings with sentinels (Load_All_Reads)."""
        if self.loaded:
            return
        bpsp = self.path + ".bps"
        seq = np.full(self.totlen + self.nreads + 4, 4, dtype=np.uint8)
        o = 1  # seq[0] is the leading sentinel (Load_All_Reads DB.c:1406)
        with open(bpsp, "rb") as fp:
            raw = fp.read()
        need = int(self.reads["boff"][-1]) + \
            ((int(self.reads["rlen"][-1]) + 3) >> 2) if self.nreads else 0
        if len(raw) < need:
            raise IOError(f"{bpsp}: The file is corrupted (short read: "
                          f"wanted {need} bytes, got {len(raw)})")
        boffs = self.reads["boff"].copy()
        new_boffs = np.empty(self.nreads + 1, np.int64)
        for i in range(self.nreads):
            ln = int(self.reads["rlen"][i])
            clen = (ln + 3) >> 2
            off = int(boffs[i])
            seq[o:o + ln] = uncompress_bases(
                np.frombuffer(raw, np.uint8, clen, off), ln)
            new_boffs[i] = o
            o += ln + 1
        new_boffs[self.nreads] = o
        self.reads["boff"] = new_boffs[:-1]
        self._boff_end = int(new_boffs[-1])
        self.seq = seq
        self.loaded = True

    def read_seq(self, i: int) -> np.ndarray:
        """Numeric sequence of read i (no sentinels)."""
        assert self.loaded
        o = int(self.reads["boff"][i])
        return self.seq[o:o + int(self.reads["rlen"][i])]

    def complement_inplace(self) -> None:
        """Reverse-complement every read in place + flip freqs + flip track
        intervals (complement_DB damapper.c:433-525)."""
        assert self.loaded
        for i in range(self.nreads):
            o = int(self.reads["boff"][i])
            ln = int(self.reads["rlen"][i])
            self.seq[o:o + ln] = 3 - self.seq[o:o + ln][::-1]
        self.freq = self.freq[::-1].copy()
        for name, (anno, data, alen) in self.tracks.items():
            for i in range(self.nreads):
                rlen = int(self.reads["rlen"][i])
                lo, hi = int(anno[i]), int(anno[i + 1])
                seg = data[lo:hi]
                data[lo:hi] = (rlen - seg)[::-1]

    @property
    def boff_end(self) -> int:
        if self.loaded:
            return getattr(self, "_boff_end",
                           int(self.reads["boff"][-1] + self.reads["rlen"][-1] + 1)
                           if self.nreads else 1)
        return int(self.reads["boff"][-1] + ((self.reads["rlen"][-1] + 3) >> 2)) \
            if self.nreads else 0

    def sizeof(self) -> int:
        """Approximation of sizeof_DB (DB.c:1044-1076) for the -M governor."""
        s = 112 + 40 * (self.nreads + 2) + len(self.path) + 1 + \
            (self.totlen + self.nreads + 4)
        for name, (anno, data, alen) in self.tracks.items():
            s += 64 + len(name) + 1 + 8 * (self.nreads + 1)
            s += 4 * len(data)
        return s


# --- track I/O ---------------------------------------------------------------

def track_paths(dbpath: str, part: int, track: str) -> tuple[str, str]:
    """dbpath is the hidden-root path (pwd/.root)."""
    if part > 0:
        cand = (f"{dbpath}.{part}.{track}.anno", f"{dbpath}.{part}.{track}.data")
        if os.path.exists(cand[0]):
            return cand
    return (f"{dbpath}.{track}.anno", f"{dbpath}.{track}.data")


def open_mask_track(db: DazzDB, track: str) -> bool:
    """Open a mask interval track into db.tracks (Open_Track DB.c:1804-2062 +
    the anno/4 normalization of read_DB damapper.c:377-388).

    Stored in db.tracks[track] = (anno[int64, n+1] in *int units*, data int32
    interval array, alen int32).  Returns False if track missing/mis-sized.
    """
    annop, datap = track_paths(db.path, db.part, track)
    if not os.path.exists(annop):
        return False
    with open(annop, "rb") as fp:
        tracklen = int(np.frombuffer(_fread(fp, 4, annop), "<i4")[0])
        size = int(np.frombuffer(_fread(fp, 4, annop), "<i4")[0])
        if size not in (0, 8):
            raise ValueError(f"track {track}: not a mask track (size={size})")
        ispart = ".%d.%s" % (db.part, track) in annop if db.part else False
        ureads = db._block_ureads if ispart else db.ureads
        treads = db._block_treads if ispart else db.treads
        if tracklen not in (ureads, treads):
            return False
        nreads = treads if tracklen == treads else ureads
        if not ispart and db.part > 0:
            fp.seek(8 * (db.tfirst if tracklen == treads else db.ufirst), 1)
        anno = np.frombuffer(_fread(fp, 8 * (nreads + 1), annop),
                             "<i8").astype(np.int64)
    with open(datap, "rb") as fp:
        fp.seek(int(anno[0]))
        data = np.frombuffer(_fread(fp, int(anno[-1] - anno[0]), datap),
                             "<i4").astype(np.int32)
    anno = (anno - anno[0]) // 4  # to int units (read_DB damapper.c:385-388)
    alen = np.diff(anno).astype(np.int32)
    db.tracks[track] = (anno, data, alen)
    return True


def write_track(dbpath_hidden_root: str, track: str, anno_bytes: np.ndarray,
                data: bytes, size: int) -> None:
    """Write a .anno/.data track pair. anno_bytes: int64[n+1] byte offsets."""
    n = len(anno_bytes) - 1
    with open(f"{dbpath_hidden_root}.{track}.anno", "wb") as fp:
        fp.write(np.int32(n).tobytes())
        fp.write(np.int32(size).tobytes())
        fp.write(anno_bytes.astype("<i8").tobytes())
    with open(f"{dbpath_hidden_root}.{track}.data", "wb") as fp:
        fp.write(data)


# --- importers (fasta2DB / fasta2DAM / DBsplit equivalents) -------------------

def _compute_freq(seqs: list[np.ndarray]) -> np.ndarray:
    counts = np.zeros(4, np.int64)
    for s in seqs:
        counts += np.bincount(s, minlength=4)[:4]
    tot = counts.sum()
    return (counts / max(tot, 1)).astype(np.float32)


def create_dam(path: str, entries, bsize: int = 200_000_000,
               cutoff: int = 0, all_wells: bool = True) -> None:
    """fasta2DAM + DBsplit equivalent: build <root>.dam plus hidden files.

    Each fasta entry is split at runs of N into contigs; each contig becomes a
    DB read with origin = contig index within its entry, fpulse = start offset
    of the contig in the entry, coff = offset of the entry's header in .hdr
    (DB.h:472-478).
    """
    pwd, root, _ = _split_db_path(path)
    os.makedirs(pwd, exist_ok=True)
    recs = []
    seqs = []
    hdr_buf = bytearray()
    bps_buf = bytearray()
    for ent in entries:
        coff = len(hdr_buf)
        hdr_buf += (ent.header + "\n").encode()
        seq = ent.seq
        # split on N runs
        contigs = []
        pos = 0
        for m in re.finditer(r"[^Nn]+", seq):
            contigs.append((m.start(), m.group(0)))
        for origin, (fpulse, cseq) in enumerate(contigs):
            num = seq_to_numeric(cseq)
            boff = len(bps_buf)
            bps_buf += compress_bases(num)
            recs.append((origin, len(num), fpulse, 0, boff, coff, 0, 0))
            seqs.append(num)
    reads = np.array(recs, dtype=READ_DTYPE)
    _write_db_files(pwd, root, ".dam", reads, seqs, bytes(bps_buf),
                    bsize, cutoff, all_wells,
                    stub_files=[(len(reads), root, root)])
    with open(os.path.join(pwd, "." + root + ".hdr"), "wb") as fp:
        fp.write(bytes(hdr_buf))


def create_db(path: str, entries, bsize: int = 200_000_000,
              cutoff: int = 0, all_wells: bool = True) -> None:
    """fasta2DB + DBsplit equivalent for read sets (no N-splitting; N->A like
    Number_Read).  Each entry is one read; origin = index, fpulse = 0."""
    pwd, root, _ = _split_db_path(path)
    os.makedirs(pwd, exist_ok=True)
    recs, seqs = [], []
    bps_buf = bytearray()
    for i, ent in enumerate(entries):
        num = seq_to_numeric(ent.seq)
        boff = len(bps_buf)
        bps_buf += compress_bases(num)
        recs.append((i, len(num), 0, 0, boff, 0, DB_BEST, 0))
        seqs.append(num)
    reads = np.array(recs, dtype=READ_DTYPE)
    _write_db_files(pwd, root, ".db", reads, seqs, bytes(bps_buf),
                    bsize, cutoff, all_wells,
                    stub_files=[(len(reads), root, root)])


def _partition_blocks(reads, bsize, cutoff, all_wells):
    """DBsplit block partition (fill blocks to >= bsize trimmed bases).
    Returns (tkeep, ublocks, tblocks)."""
    rlens = reads["rlen"]
    allflag = 0 if all_wells else DB_BEST
    tkeep = ((reads["flags"] & DB_BEST) >= allflag) & (rlens >= cutoff)
    ublocks, tblocks = [0], [0]
    acc = tcount = 0
    for i in range(len(reads)):
        if tkeep[i]:
            acc += int(rlens[i])
            tcount += 1
            if acc >= bsize:
                ublocks.append(i + 1)
                tblocks.append(tcount)
                acc = 0
    if ublocks[-1] != len(reads):
        if tcount == tblocks[-1] and len(ublocks) > 1:
            # only cutoff-filtered reads trail the last CLOSED block:
            # extend it instead of emitting an empty trimmed block
            # (DBsplit never writes a zero-read block).  When no block
            # closed at all (zero kept reads), keep the single full-range
            # block instead of destroying the leading 0 boundary.
            ublocks[-1] = len(reads)
        else:
            ublocks.append(len(reads))
            tblocks.append(tcount)
    return tkeep, ublocks, tblocks


def _write_db_files(pwd, root, ext, reads, seqs, bps, bsize, cutoff, all_wells,
                    stub_files):
    nreads = len(reads)
    rlens = reads["rlen"]
    tkeep, ublocks, tblocks = _partition_blocks(reads, bsize, cutoff,
                                                all_wells)
    treads = int(tkeep.sum())
    nblocks = len(ublocks) - 1

    stub = DBStub(nfiles=len(stub_files),
                  nreads=[n for n, _, _ in stub_files],
                  fname=[f for _, f, _ in stub_files],
                  prolog=[p for _, _, p in stub_files],
                  all=1 if all_wells else 0, cutoff=cutoff, bsize=bsize,
                  nblocks=nblocks, ublocks=ublocks, tblocks=tblocks)
    write_stub(os.path.join(pwd, root + ext), stub)

    hdr = np.zeros(1, HEADER_DTYPE)
    hdr["ureads"] = nreads
    hdr["treads"] = treads
    hdr["cutoff"] = -1          # set by DBsplit in reference; stub governs
    hdr["allarr"] = 0
    hdr["freq"] = _compute_freq(seqs)
    hdr["maxlen"] = int(rlens.max(initial=0))
    hdr["totlen"] = int(rlens.sum())
    hdr["nreads"] = nreads
    with open(os.path.join(pwd, "." + root + ".idx"), "wb") as fp:
        fp.write(hdr.tobytes())
        fp.write(reads.tobytes())
    with open(os.path.join(pwd, "." + root + ".bps"), "wb") as fp:
        fp.write(bps)


# --- Arrow pseudo-track (DB.c:1458-1647) -------------------------------------

_NUM_PW = np.frombuffer(b"1234", dtype=np.uint8)
_PW_NUM = np.zeros(256, dtype=np.uint8)
for _i, _cs in enumerate(b"1234"):
    _PW_NUM[_cs] = _i


def letter_arrow(arr: np.ndarray) -> str:
    """Numeric pulse widths 0-3 -> '1'..'4' (Letter_Arrow DB.h:266)."""
    return _NUM_PW[arr].tobytes().decode()


def number_arrow(s: str | bytes) -> np.ndarray:
    if isinstance(s, str):
        s = s.encode()
    return _PW_NUM[np.frombuffer(s, np.uint8)].copy()


def write_arrow(path: str, pulses) -> None:
    """Write the hidden .arw companion (2-bit compressed pulse-width streams
    at the same offsets as .bps) and flag the DB as an Arrow DB
    (fasta2DB -arrow equivalent for this framework's writer)."""
    pwd, root, _ = _split_db_path(path)
    root, _ = _strip_part(root)
    idxp = os.path.join(pwd, "." + root + ".idx")
    with open(idxp, "rb") as fp:
        raw = bytearray(fp.read())
    hdr = np.frombuffer(bytes(raw[:HEADER_DTYPE.itemsize]), HEADER_DTYPE)[0].copy()
    reads = np.frombuffer(bytes(raw[HEADER_DTYPE.itemsize:]), READ_DTYPE).copy()
    if len(pulses) != len(reads):
        raise ValueError(f"{len(pulses)} arrow streams for {len(reads)} reads")
    with open(os.path.join(pwd, "." + root + ".arw"), "wb") as fp:
        for rec, pw in zip(reads, pulses):
            pw = np.asarray(pw, np.uint8)
            if len(pw) != int(rec["rlen"]):
                raise ValueError("arrow stream length != read length")
            if fp.tell() != int(rec["boff"]):
                raise ValueError("arrow offsets out of sync with .bps")
            fp.write(compress_bases(pw))
    hdr["allarr"] = int(hdr["allarr"]) | DB_ARROW
    with open(idxp, "wb") as fp:
        fp.write(hdr.tobytes())
        fp.write(reads.tobytes())


class ArrowTrack:
    """Open .arw handle + per-read offsets (DAZZ_ARROW DB.h:360-366)."""

    def __init__(self, fp, aoff, rlens):
        self.fp = fp
        self.aoff = aoff
        self.rlens = rlens

    def load(self, i: int, ascii: bool = False):
        """Load_Arrow (DB.c:1508)."""
        self.fp.seek(int(self.aoff[i]))
        ln = int(self.rlens[i])
        buf = _fread(self.fp, (ln + 3) >> 2, "arrow stream")
        arr = uncompress_bases(buf, ln)
        return letter_arrow(arr) if ascii else arr

    def close(self):
        self.fp.close()


def open_arrow(db: "DazzDB") -> ArrowTrack:
    """Open the DB's .arw (Open_Arrow DB.c:1458).  Must be called before
    trimming, like the reference."""
    if not (db.allarr & DB_ARROW):
        raise ValueError("The DB is not an Arrow database (Open_Arrow)")
    if db.trimmed:
        raise ValueError("Cannot open Arrow vectors after trimming the DB")
    # db.path already carries the hidden-file prefix (pwd/.root, DB.c:735)
    fp = open(db.path + ".arw", "rb")
    return ArrowTrack(fp, db.reads["boff"].copy(), db.reads["rlen"].copy())


def load_all_arrows(db: "DazzDB") -> list[np.ndarray]:
    """Load_All_Arrows (DB.c:1556)."""
    tr = open_arrow(db)
    try:
        return [tr.load(i) for i in range(db.nreads)]
    finally:
        tr.close()


def dbsplit(path: str, bsize: int | None = None, cutoff: int | None = None,
            all_wells: bool | None = None) -> int:
    """Re-partition an existing DB/DAM (DBsplit equivalent): recompute the
    block table in the stub with new -s/-x/-a parameters, keeping the
    hidden files untouched.  Returns the new block count."""
    pwd, root, isdam = _split_db_path(path)
    root, _ = _strip_part(root)
    ext = ".dam" if isdam else ".db"
    stubp = os.path.join(pwd, root + ext)
    stub = read_stub(stubp)
    if bsize is None:
        bsize = stub.bsize
    if cutoff is None:
        cutoff = stub.cutoff
    if all_wells is None:
        all_wells = bool(stub.all)

    with open(os.path.join(pwd, "." + root + ".idx"), "rb") as fp:
        fp.seek(HEADER_DTYPE.itemsize)
        reads = np.frombuffer(fp.read(), READ_DTYPE)
    _, ublocks, tblocks = _partition_blocks(reads, bsize, cutoff, all_wells)

    stub.bsize = bsize
    stub.cutoff = cutoff
    stub.all = 1 if all_wells else 0
    stub.nblocks = len(ublocks) - 1
    stub.ublocks = ublocks
    stub.tblocks = tblocks
    write_stub(stubp, stub)
    return stub.nblocks


def dbshow(path: str, reads_sel=None, width: int = 80, upper: bool = False,
           out=None) -> None:
    """Print reads as FASTA (DBshow equivalent).  reads_sel: 1-based read
    numbers (trimmed index), default all."""
    import sys as _sys
    out = out or _sys.stdout
    db = DazzDB.open(path)
    db.trim()
    db.load_bases()
    idxs = range(1, db.nreads + 1) if not reads_sel else reads_sel
    for r in idxs:
        i = r - 1
        if i < 0 or i >= db.nreads:
            raise ValueError(f"{r} is out of range [1, {db.nreads}]")
        seq = numeric_to_seq(db.read_seq(i), upper=upper)
        origin = int(db.reads["origin"][i])
        fp = int(db.reads["fpulse"][i])
        out.write(f">{os.path.basename(db.path)[1:]}/{origin}/"
                  f"{fp}_{fp + len(seq)}\n")
        for j in range(0, len(seq), width):
            out.write(seq[j:j + width] + "\n")

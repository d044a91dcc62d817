"""QV (quality value) Huffman codec + .qvs pseudo-track store.

Semantics-parity reimplementation of the reference's QV compressor (QV.c):
per-file adaptive Huffman schemes over the five .quiva streams (deletion QV,
deletion tag, insertion QV, merge QV, substitution QV), with

 * escape-truncated Huffman codes: symbols whose code exceeds HUFF_CUTOFF
   bits are folded into the 255 code followed by the raw 8-bit value
   (Huffman QV.c:147-220),
 * run-length coding of the dominant deletion/substitution QV (Encode_Run /
   Decode_Run QV.c:448-700) with 255-escaped 16-bit run lengths,
 * 2-bit packing of the (run-packed) deletion tags (Pack_Tag QV.c:810-858),
 * the bit-stream layout of Encode (MSB-first codes packed into little-
   endian uint32 words, with the double-word tail padding rule,
   QV.c:405-446), and
 * the scheme/coding serialization of Write_Scheme / Write_QVcoding
   (QV.c:300-321, 1173-1212) including the 0x33cc endian key.

The DB side (`write_qvs`, `open_qvs`, `load_qventry`) mirrors the .qvs
pseudo-track of DB.c:2324-2663: per-file coding blocks followed by the
compressed entries; entries located by the read records' coff fields.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

HUFF_CUTOFF = 16      # QV.c:26 ("cannot be larger than 16")


# ---------------------------------------------------------------------------
# Huffman schemes
# ---------------------------------------------------------------------------


@dataclass
class HScheme:
    type: int                      # 0 normal, 1 has long codes, 2 truncated
    codebits: np.ndarray           # uint32[256]
    codelens: np.ndarray           # int32[256]
    _lookup: np.ndarray = field(default=None, repr=False)

    @property
    def lookup(self):
        """16-bit prefix -> symbol decode table (Read_Scheme QV.c:374-382)."""
        if self._lookup is None:
            look = np.zeros(0x10000, np.int32)
            for i in range(256):
                ln = int(self.codelens[i])
                if ln > 0:
                    base = int(self.codebits[i]) << (16 - ln)
                    look[base:base + (1 << (16 - ln))] = i
            self._lookup = look
        return self._lookup


def _reheap(s, heap, hsize):
    """Array min-heap sift-down with the reference's exact comparison order
    (Reheap QV.c:91-120) so tree shapes (and hence codes) match."""
    c = s
    hs = heap[s]
    while 2 * c <= hsize:
        l = 2 * c
        r = l + 1
        hl = heap[l]
        hr = heap[r] if r <= hsize else None
        if r > hsize or hr[0] > hl[0]:
            if hs[0] > hl[0]:
                heap[c] = hl
                c = l
            else:
                break
        else:
            if hs[0] > hr[0]:
                heap[c] = hr
                c = r
            else:
                break
    if c != s:
        heap[c] = hs


def huffman(hist, inscheme: HScheme | None = None) -> HScheme:
    """Huffman tree over the non-zero symbols (Huffman QV.c:147-220).  With
    ``inscheme``, symbols coded longer than HUFF_CUTOFF (and 255) share one
    escape leaf."""
    # node = [count, leaf_symbol_or_None, lft, rgt]
    nodes = []
    heap = [None]                  # 1-based
    if inscheme is not None:
        esc = [0, 255, None, None]
        nodes.append(esc)
        heap.append(esc)
    for i in range(256):
        if hist[i] > 0:
            if inscheme is not None and (inscheme.codelens[i] > HUFF_CUTOFF
                                         or i == 255):
                nodes[0][0] += int(hist[i])
            else:
                nd = [int(hist[i]), i, None, None]
                nodes.append(nd)
                heap.append(nd)
    hsize = len(heap) - 1
    for i in range(hsize // 2, 0, -1):
        _reheap(i, heap, hsize)

    value = hsize
    for _ in range(1, value):
        lft = heap[1]
        heap[1] = heap[hsize]
        hsize -= 1
        _reheap(1, heap, hsize)
        rgt = heap[1]
        nd = [lft[0] + rgt[0], None, lft, rgt]
        heap[1] = nd
        _reheap(1, heap, hsize)

    codebits = np.zeros(256, np.uint32)
    codelens = np.zeros(256, np.int32)

    def build(node, code, ln):
        if node[3] is None:
            codebits[node[1]] = code
            codelens[node[1]] = ln
        else:
            build(node[2], code << 1, ln + 1)
            build(node[3], (code << 1) | 1, ln + 1)

    if hsize >= 1:
        build(heap[1], 0, 0)

    if inscheme is not None:
        stype = 2
        for i in range(255):
            if (inscheme.codelens[i] > HUFF_CUTOFF
                    or codelens[i] > HUFF_CUTOFF):
                codelens[i] = codelens[255]
                codebits[i] = codebits[255]
    else:
        stype = 1 if (codelens > HUFF_CUTOFF).any() else 0
    return HScheme(stype, codebits, codelens)


def make_scheme(hist) -> HScheme:
    """Scheme with escape fallback when codes run long (SCHEME_MACRO
    QV.c:1070-1078)."""
    s = huffman(hist, None)
    if s.type:
        return huffman(hist, s)
    return s


# ---------------------------------------------------------------------------
# Bit stream (Encode/Decode layout: MSB-first in little-endian uint32 words)
# ---------------------------------------------------------------------------


class BitWriter:
    """OCODE packing (QV.c:405-424): an accumulating 32-bit word emitted
    little-endian, plus the tail double-pad rule."""

    def __init__(self):
        self.words = bytearray()
        self.ocode = 0
        self.olen = 0
        self.llen = 0

    def put(self, nbits: int, code: int):
        self.llen = self.olen
        ln = self.olen + nbits
        if ln >= 32:
            self.olen = ln - 32
            self.ocode |= (code >> self.olen)
            self.words += struct.pack("<I", self.ocode & 0xFFFFFFFF)
            if self.olen > 0:
                self.ocode = (code << (32 - self.olen)) & 0xFFFFFFFF
            else:
                self.ocode = 0
        else:
            self.olen = ln
            self.ocode |= (code << (32 - self.olen))
            self.ocode &= 0xFFFFFFFF

    def finish(self) -> bytes:
        # tail padding (QV.c:438-445): the decoder pre-reads 16 bits, so a
        # nearly-full last word may need a second pad word
        if self.olen > 0:
            self.words += struct.pack("<I", self.ocode & 0xFFFFFFFF)
            if self.llen > 16 and self.olen > self.llen:
                self.words += struct.pack("<I", self.ocode & 0xFFFFFFFF)
        elif self.llen > 16:
            self.words += struct.pack("<I", self.ocode & 0xFFFFFFFF)
        out = bytes(self.words)
        self.words = bytearray()
        self.ocode = self.olen = self.llen = 0
        return out


class BitReader:
    """The Decode GET protocol (QV.c:537-556): a 64-bit register whose high
    word refills from the stream; the *next* 16 bits are always visible."""

    def __init__(self, fp, flip=False):
        self.fp = fp
        self.icode = 0            # 64-bit register
        self.ilen = 0
        self.flip = flip

    def _get(self, n):
        if n > self.ilen:
            self.icode = (self.icode << self.ilen) & 0xFFFFFFFFFFFFFFFF
            w = self.fp.read(4)
            if len(w) != 4:
                raise IOError("Could not read more bits (Decode)")
            word = struct.unpack(">I" if self.flip else "<I", w)[0]
            self.icode = (self.icode & 0xFFFFFFFF00000000) | word
            self.ilen = n - self.ilen
            self.icode = (self.icode << self.ilen) & 0xFFFFFFFFFFFFFFFF
            self.ilen = 32 - self.ilen
        else:
            self.icode = (self.icode << n) & 0xFFFFFFFFFFFFFFFF
            self.ilen -= n

    def peek16(self):
        return (self.icode >> 32) & 0xFFFF

    def peek8(self):
        return (self.icode >> 40) & 0xFF


def encode(scheme: HScheme, data, out: BitWriter):
    """Encode data (uint8 iterable) per scheme (Encode QV.c:386)."""
    lens = scheme.codelens
    bits = scheme.codebits
    if scheme.type == 2:
        nspec, nslen = int(bits[255]), int(lens[255])
    else:
        nspec = nslen = 0x7FFFFFFF
    for x in data:
        x = int(x)
        n, c = int(lens[x]), int(bits[x])
        out.put(n, c)
        if c == nspec and n == nslen:
            out.put(8, x)


def encode_run(neme: HScheme, reme: HScheme, data, rchar: int,
               out: BitWriter):
    """Run-encode (Encode_Run QV.c:448): alternating <run-length> and
    <non-run symbol> codes."""
    rlen = len(data)
    k = 0
    nspec = nslen = 0x7FFFFFFF
    if neme.type == 2:
        nspec, nslen = int(neme.codebits[255]), int(neme.codelens[255])
    rspec, rslen = int(reme.codebits[255]), int(reme.codelens[255])
    while k < rlen:
        h = k
        while k < rlen and data[k] == rchar:
            k += 1
        x = 255 if k - h >= 255 else k - h
        n, c = int(reme.codelens[x]), int(reme.codebits[x])
        out.put(n, c)
        if c == rspec and n == rslen:
            out.put(16, k - h)
        if k < rlen:
            x = int(data[k])
            n, c = int(neme.codelens[x]), int(neme.codebits[x])
            out.put(n, c)
            if c == nspec and n == nslen:
                out.put(8, x)
            k += 1


def decode(scheme: HScheme, rd: BitReader, rlen: int) -> np.ndarray:
    """Decode rlen symbols (Decode QV.c:510)."""
    look = scheme.lookup
    lens = scheme.codelens
    signal = 255 if scheme.type == 2 else 256
    out = np.empty(rlen, np.uint8)
    n = 16
    for j in range(rlen):
        rd._get(n)
        c = int(look[rd.peek16()])
        n = int(lens[c])
        if c == signal:
            rd._get(n)
            c = rd.peek8()
            n = 8
        out[j] = c
    return out


def decode_run(neme: HScheme, reme: HScheme, rd: BitReader, rlen: int,
               rchar: int) -> np.ndarray:
    """Decode a run-encoded stream (Decode_Run QV.c:604)."""
    nlook, nlens = neme.lookup, neme.codelens
    rlook, rlens = reme.lookup, reme.codelens
    nsignal = 255 if neme.type == 2 else 256
    out = np.empty(rlen, np.uint8)
    n = 16
    j = 0
    while j < rlen:
        rd._get(n)
        c = int(rlook[rd.peek16()])
        n = int(rlens[c])
        if c == 255:
            rd._get(n)
            c = rd.peek16()
            n = 16
        for _ in range(c):
            out[j] = rchar
            j += 1
        if j < rlen:
            rd._get(n)
            c = int(nlook[rd.peek16()])
            n = int(nlens[c])
            if c == nsignal:
                rd._get(n)
                c = rd.peek8()
                n = 8
            out[j] = c
            j += 1
    return out


# ---------------------------------------------------------------------------
# QVcoding: scan, create, serialize
# ---------------------------------------------------------------------------


@dataclass
class QVcoding:
    delScheme: HScheme
    insScheme: HScheme
    mrgScheme: HScheme
    subScheme: HScheme
    dRunScheme: HScheme | None
    sRunScheme: HScheme | None
    delChar: int
    subChar: int
    prefix: str = ""
    flip: bool = False


class QVScanner:
    """Accumulates the five stream histograms (QVcoding_Scan1 QV.c:866)."""

    def __init__(self):
        self.delHist = np.zeros(256, np.int64)
        self.insHist = np.zeros(256, np.int64)
        self.mrgHist = np.zeros(256, np.int64)
        self.subHist = np.zeros(256, np.int64)
        self.delRun = np.ones(256, np.int64)    # NB: init to 1 (QV.c:884)
        self.subRun = np.ones(256, np.int64)
        self.totChar = 0
        self.delChar = -1
        self.subChar = -1

    def _runs(self, hist, stream, rchar):
        runs = np.flatnonzero(np.diff(np.concatenate(
            [[0], (stream == rchar).astype(np.int8), [0]])))
        for s, e in zip(runs[0::2], runs[1::2]):
            hist[min(e - s, 255)] += 1

    def scan(self, del_qv, del_tag, ins_qv, mrg_qv, sub_qv):
        rlen = len(del_qv)
        np.add.at(self.delHist, del_qv, 1)
        np.add.at(self.insHist, ins_qv, 1)
        np.add.at(self.mrgHist, mrg_qv, 1)
        np.add.at(self.subHist, sub_qv, 1)
        if self.delChar < 0:
            for k in range(rlen):
                if del_tag[k] in (ord("n"), ord("N")):
                    self.delChar = int(del_qv[k])
                    break
        if self.delChar >= 0:
            self._runs(self.delRun, del_qv, self.delChar)
        self.totChar += rlen
        if self.subChar < 0 and self.totChar >= 100000:
            self.subChar = int(np.argmax(self.subHist))
        if self.subChar >= 0:
            self._runs(self.subRun, sub_qv, self.subChar)

    def create(self, lossy=False, prefix="") -> QVcoding:
        """Create_QVcoding (QV.c:1029)."""
        subChar = self.subChar
        if self.totChar < 200000 or \
                self.subHist[subChar if subChar >= 0 else 0] < \
                .5 * self.totChar:
            subChar = -1
        insHist = self.insHist.copy()
        mrgHist = self.mrgHist.copy()
        if lossy:
            for k in range(0, 256, 2):
                insHist[k] += insHist[k + 1]
                insHist[k + 1] = 0
            for k in range(0, 256, 4):
                mrgHist[k] += mrgHist[k + 1] + mrgHist[k + 2] + mrgHist[k + 3]
                mrgHist[k + 1] = mrgHist[k + 2] = mrgHist[k + 3] = 0
        delHist = self.delHist.copy()
        if self.delChar < 0:
            delScheme = make_scheme(delHist)
            dRun = None
        else:
            delHist[self.delChar] = 0
            delScheme = make_scheme(delHist)
            dRun = make_scheme(self.delRun)
        insScheme = make_scheme(insHist)
        mrgScheme = make_scheme(mrgHist)
        subHist = self.subHist.copy()
        if subChar < 0:
            subScheme = make_scheme(subHist)
            sRun = None
        else:
            subHist[subChar] = 0
            subScheme = make_scheme(subHist)
            sRun = make_scheme(self.subRun)
        return QVcoding(delScheme, insScheme, mrgScheme, subScheme,
                        dRun, sRun, self.delChar, subChar, prefix)


def write_scheme(fp, s: HScheme):
    fp.write(bytes([s.type]))
    for i in range(256):
        ln = int(s.codelens[i])
        fp.write(bytes([ln]))
        if ln > 0:
            fp.write(struct.pack("<I", int(s.codebits[i])))


def read_scheme(fp, flip=False) -> HScheme:
    t = fp.read(1)[0]
    lens = np.zeros(256, np.int32)
    bits = np.zeros(256, np.uint32)
    for i in range(256):
        ln = fp.read(1)[0]
        lens[i] = ln
        if ln > 0:
            bits[i] = struct.unpack(">I" if flip else "<I", fp.read(4))[0]
    return HScheme(t, bits, lens)


def write_qvcoding(fp, c: QVcoding):
    fp.write(struct.pack("<H", 0x33CC))
    fp.write(struct.pack("<H", 256 if c.delChar < 0 else c.delChar))
    fp.write(struct.pack("<H", 256 if c.subChar < 0 else c.subChar))
    pf = c.prefix.encode()
    fp.write(struct.pack("<i", len(pf)))
    fp.write(pf)
    write_scheme(fp, c.delScheme)
    if c.delChar >= 0:
        write_scheme(fp, c.dRunScheme)
    write_scheme(fp, c.insScheme)
    write_scheme(fp, c.mrgScheme)
    write_scheme(fp, c.subScheme)
    if c.subChar >= 0:
        write_scheme(fp, c.sRunScheme)


def read_qvcoding(fp) -> QVcoding:
    key = struct.unpack("<H", fp.read(2))[0]
    flip = key != 0x33CC
    fmt = ">H" if flip else "<H"
    delChar = struct.unpack(fmt, fp.read(2))[0]
    subChar = struct.unpack(fmt, fp.read(2))[0]
    delChar = -1 if delChar >= 256 else delChar
    subChar = -1 if subChar >= 256 else subChar
    n = struct.unpack(">i" if flip else "<i", fp.read(4))[0]
    prefix = fp.read(n).decode()
    delScheme = read_scheme(fp, flip)
    dRun = read_scheme(fp, flip) if delChar >= 0 else None
    insScheme = read_scheme(fp, flip)
    mrgScheme = read_scheme(fp, flip)
    subScheme = read_scheme(fp, flip)
    sRun = read_scheme(fp, flip) if subChar >= 0 else None
    return QVcoding(delScheme, insScheme, mrgScheme, subScheme, dRun, sRun,
                    delChar, subChar, prefix, flip)


# ---------------------------------------------------------------------------
# Entry compression (the five streams of one read)
# ---------------------------------------------------------------------------

_TAG_NUM = np.full(256, 0, np.uint8)
for _i, _c in enumerate(b"acgt"):
    _TAG_NUM[_c] = _i
    _TAG_NUM[_c - 32] = _i
_NUM_TAG = np.frombuffer(b"acgt", np.uint8)


def _compressed_len(n):
    return (n + 3) >> 2


def _pack_2bit(tags_num: np.ndarray) -> bytes:
    n = len(tags_num)
    pad = np.zeros(_compressed_len(n) * 4, np.uint8)
    pad[:n] = tags_num
    pad = pad.reshape(-1, 4)
    return ((pad[:, 0] << 6) | (pad[:, 1] << 4) | (pad[:, 2] << 2)
            | pad[:, 3]).astype(np.uint8).tobytes()


def _unpack_2bit(buf: bytes, n: int) -> np.ndarray:
    arr = np.frombuffer(buf, np.uint8)
    out = np.empty(len(arr) * 4, np.uint8)
    out[0::4] = arr >> 6
    out[1::4] = (arr >> 4) & 3
    out[2::4] = (arr >> 2) & 3
    out[3::4] = arr & 3
    return out[:n]


def compress_entry(fp, coding: QVcoding, del_qv, del_tag, ins_qv, mrg_qv,
                   sub_qv, lossy=False):
    """Compress_Next_QVentry1 (QV.c:1343)."""
    rlen = len(del_qv)
    w = BitWriter()
    if coding.delChar < 0:
        encode(coding.delScheme, del_qv, w)
        tags = del_tag
    else:
        encode_run(coding.delScheme, coding.dRunScheme, del_qv,
                   coding.delChar, w)
        keep = np.asarray(del_qv) != coding.delChar
        tags = np.asarray(del_tag)[keep]
    fp.write(w.finish())
    fp.write(_pack_2bit(_TAG_NUM[np.asarray(tags)]))

    ins_qv = np.asarray(ins_qv)
    mrg_qv = np.asarray(mrg_qv)
    if lossy:
        ins_qv = (ins_qv >> 1) << 1
        mrg_qv = (mrg_qv >> 2) << 2
    for scheme, data in ((coding.insScheme, ins_qv),
                         (coding.mrgScheme, mrg_qv)):
        w = BitWriter()
        encode(scheme, data, w)
        fp.write(w.finish())
    w = BitWriter()
    if coding.subChar < 0:
        encode(coding.subScheme, sub_qv, w)
    else:
        encode_run(coding.subScheme, coding.sRunScheme, sub_qv,
                   coding.subChar, w)
    fp.write(w.finish())
    return rlen


def uncompress_entry(fp, coding: QVcoding, rlen: int):
    """Uncompress_Next_QVentry (QV.c:1428).  Returns the 5 streams
    (del_qv, del_tag, ins_qv, mrg_qv, sub_qv)."""
    rd = BitReader(fp, coding.flip)
    if coding.delChar < 0:
        del_qv = decode(coding.delScheme, rd, rlen)
        clen = rlen
    else:
        del_qv = decode_run(coding.delScheme, coding.dRunScheme, rd, rlen,
                            coding.delChar)
        clen = int(np.sum(del_qv != coding.delChar))
    packed = fp.read(_compressed_len(clen))
    tag_num = _unpack_2bit(packed, clen)
    tags = np.full(rlen, ord("n"), np.uint8)
    if coding.delChar < 0:
        tags[:] = _NUM_TAG[tag_num]
    else:
        tags[del_qv != coding.delChar] = _NUM_TAG[tag_num]
    ins_qv = decode(coding.insScheme, BitReader(fp, coding.flip), rlen)
    mrg_qv = decode(coding.mrgScheme, BitReader(fp, coding.flip), rlen)
    rd = BitReader(fp, coding.flip)
    if coding.subChar < 0:
        sub_qv = decode(coding.subScheme, rd, rlen)
    else:
        sub_qv = decode_run(coding.subScheme, coding.sRunScheme, rd, rlen,
                            coding.subChar)
    return del_qv, tags, ins_qv, mrg_qv, sub_qv


# ---------------------------------------------------------------------------
# .qvs pseudo-track (DB side, DB.c:2324-2663)
# ---------------------------------------------------------------------------


def write_qvs(db_path_root: str, entries, lossy=False, prefix="@Sim"):
    """Build the hidden .<root>.qvs file for a DB whose reads are the given
    entries (each a 5-tuple of streams).  Single-file DB equivalent of
    quiva2DB; returns the per-read offsets (to be stored in coff)."""
    import os
    pwd, root = os.path.split(db_path_root)
    sc = QVScanner()
    for e in entries:
        sc.scan(*e)
    coding = sc.create(lossy, prefix)
    offs = []
    with open(os.path.join(pwd, f".{root}.qvs"), "wb") as fp:
        write_qvcoding(fp, coding)
        for e in entries:
            offs.append(fp.tell())
            compress_entry(fp, coding, *e, lossy=lossy)
    return offs


def open_qvs(db_path_root: str):
    """Open the .qvs of a DB: returns (coding, fp) (Open_QVs DB.c:2324,
    single-file variant)."""
    import os
    pwd, root = os.path.split(db_path_root)
    fp = open(os.path.join(pwd, f".{root}.qvs"), "rb")
    coding = read_qvcoding(fp)
    return coding, fp


def load_qventry(fp, coding: QVcoding, coff: int, rlen: int):
    """Load one read's 5 QV streams (Load_QVentry DB.c:2575)."""
    fp.seek(coff)
    return uncompress_entry(fp, coding, rlen)

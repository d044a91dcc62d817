"""Device-resident k-mer index build, packed sequence upload and seed
matching, as PyTorch ops on the card (or on CPU tensors).

The counterpart of damapper_tpu/ops/device_index.py (the single-device
path, :59-1060, and the sharded match over a (dp, ref) mesh, :1062-1298),
producing the same arrays and the same hits as that module and as the host
path (ops.kmers.sort_kmers / ops.seeds.match_seeds, reference
map.c:447-822, 825-1002, 2889-3208):

 * Keys.  The JAX package carries the 2k-bit big-endian code as two uint32
   planes (its TPU runs with x64 off).  Here a key is ONE int64: the
   unsigned 64-bit code ``(hi << 32) | lo`` with its top bit flipped, so
   that torch's signed sort and searches order keys as unsigned codes and
   the all-ones sentinel is INT64_MAX (``key_to_code`` undoes the flip).
   Keys are assembled as ``(hi - 2**31) * 2**32 + lo`` from 32-bit planes,
   which no int64 shift or product overflows.
 * Window validity from a prefix sum over bad positions (read-boundary
   sentinels, soft-mask intervals); invalid windows get the sentinel key
   and a position flagged with _POS_INVALID, so they sort last.
 * The complement-strand index derives elementwise from the forward
   upload: revcomp codes and positions mirrored within each read, the
   read bounds spread over positions by a search of the read table.
 * Multi-key sorts.  torch.sort takes one key: (key, pos) sorts as two
   passes (pos, then key, stable); the hit sorts use one composite int64
   key where the fields' bits fit, else stable passes (``_lex_order``).
 * Seed matching is the two-pass count-then-emit of the reference
   (count_thread/merge_thread map.c:881-1002): the b-range of every query
   entry from a join (DAMAPPER_JOIN: bsearch, the default on the H100 |
   merge | scan | sortg | sort), group totals and the -M histogram, then
   emission by cumsum + searchsorted index algebra and a stable (aread,
   bread, apos) sort.  Where the JAX code sorts only to undo a permutation
   (query slots back into query order) or to histogram, the port scatters:
   the output is the same.
 * Integer arithmetic follows JAX's int32 exactly where it can wrap (the
   emission cumsum, the -M governor's running sum) and the -M group cost
   is JAX's float32 product clamped at float32(0x7FFFFF00).

Every single-device function takes and returns tensors on one device:
the index stays there from the upload to the emitted hits, and the host
pulls only the stacked hit buffer and the two scalars (total, limit) that
the JAX code pulls.  The sharded match runs each mesh position's steps on
that position's device (parallel.mesh).  A CUDA request without a card
raises (ops.wave_engine.resolve_device); nothing falls back to the host
index.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np
import torch

from .kmers import KmerIndex
from .seeds import MAXGRAM, SeedHits, match_limit
from .wave_engine import resolve_device

_I32 = torch.int32
_I64 = torch.int64
_IMAX = 0x7FFFFFFF
#: the key of invalid windows and padding: the all-ones code, flipped
SENT = (1 << 63) - 1
_SIGN = -(1 << 63)


def _bucket(n: int, lo: int = 1 << 12) -> int:
    """Pad size n up to a bounded set of shapes: powers of two with one
    midpoint each (1.0x and 1.5x), minimum lo."""
    if n <= lo:
        return lo
    p = 1 << (int(n - 1).bit_length() - 1)
    return int(p + p // 2) if n <= p + p // 2 else int(2 * p)


def _tight_bucket(n: int, cap: int) -> int:
    """Static slice bound for a padded index: up to 50% of its cap can be
    sentinel rows, and the sorts and joins pay for every one of them.
    1/16-granularity steps bound the pad at ~6%; small arrays keep their
    cap."""
    if cap <= (1 << 22) or n >= cap:
        return cap
    step = 1 << max(20, int(n).bit_length() - 4)
    return min(cap, -(-n // step) * step)


def _pow2_above(n: int) -> int:
    return 1 << max(8, int(n - 1).bit_length())


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap (JAX's int32 arithmetic)."""
    return (((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(_I32)


def join_key(hi: torch.Tensor, lo: torch.Tensor) -> torch.Tensor:
    """Flipped int64 key of 32-bit planes (int64 tensors in [0, 2**32))."""
    return (hi - (1 << 31)) * (1 << 32) + lo


def key_to_code(key) -> np.ndarray:
    """uint64 codes ((hi << 32) | lo) of flipped int64 keys, on the host."""
    k = np.ascontiguousarray(np.asarray(key.cpu() if torch.is_tensor(key)
                                        else key, np.int64))
    return k.view(np.uint64) ^ np.uint64(1 << 63)


# ---------------------------------------------------------------------------
# index build
# ---------------------------------------------------------------------------


#: positions >= this flag bit are invalid/culled entries (parked after all
#: real entries in their sentinel-key group); real positions stay < 2^30
_POS_INVALID = 1 << 30


@dataclass
class DeviceKmerIndex:
    """Sorted k-mer index on a device.

    key/pos are padded tensors of one length; entries [n:] are sentinel
    padding.  ``pos`` is the window's global start in the block's sentinel
    sequence layout; (read, rpos) derive from it and ``boffs``.  nreads and
    max_rlen (host ints) bound the hit-sort fields."""

    key: torch.Tensor     # int64[cap] sorted flipped code
    pos: torch.Tensor     # int32[cap] window global start
    n: int
    boffs: torch.Tensor   # int32[rcap] read start offsets (padding: cap-1)
    kmer: int
    rlens: torch.Tensor   # int32[rcap] read lengths (padding: 0)
    nreads: int = 0
    max_rlen: int = 0

    def __len__(self):
        return self.n

    def to_host(self) -> KmerIndex:
        """The host KmerIndex of the same entries."""
        code = key_to_code(self.key[:self.n])
        pos = self.pos[:self.n].cpu().numpy()
        boffs = self.boffs.cpu().numpy()
        read = np.searchsorted(boffs, pos, side="right").astype(np.int32) - 1
        rpos = pos - boffs[np.maximum(read, 0)] + (self.kmer - 1)
        return KmerIndex(code, read, rpos.astype(np.int32))


def _rev2bit32(v):
    """Reverse the sixteen 2-bit groups of 32-bit values (int64 tensor)."""
    m2, m4, m8 = 0x33333333, 0x0F0F0F0F, 0x00FF00FF
    v = ((v & m2) << 2) | ((v >> 2) & m2)
    v = ((v & m4) << 4) | ((v >> 4) & m4)
    v = ((v & m8) << 8) | ((v >> 8) & m8)
    return ((v << 16) & 0xFFFFFFFF) | ((v >> 16) & 0xFFFF)


def _revcomp_codes(hi, lo, kmer: int):
    """Elementwise reverse-complement of split-plane 2k-bit codes (int64
    tensors holding 32-bit values; the code is (hi << 2*min(k,16)) | lo).
    Complement = XOR of every base, reversal = 2-bit-group reversal of the
    64-bit word, then a right shift to re-align; every left shift masked
    back to 32 bits."""
    klo = min(kmer, 16)
    khi = kmer - klo
    if khi == 0:
        r = _rev2bit32(lo ^ ((1 << (2 * kmer)) - 1))
        return torch.zeros_like(hi), r >> (32 - 2 * kmer)
    him = 0xFFFFFFFF if khi == 16 else (1 << (2 * khi)) - 1
    rhi = _rev2bit32(lo ^ 0xFFFFFFFF)       # top 32 of rev64
    rlo = _rev2bit32(hi ^ him)              # low 32 of rev64
    s = 32 - 2 * khi                        # 64 - 2k
    if s:
        return rhi >> s, (rlo >> s) | ((rhi << (32 - s)) & 0xFFFFFFFF)
    return rhi, rlo


def _sort_key_pos(key, pos, pos_sorted: bool = False):
    """(key, pos) sorted lexicographically; pos is unique.  pos_sorted:
    the rows are already in ascending pos order within every key, so one
    stable pass by key does."""
    if not pos_sorted:
        pos, o = torch.sort(pos)
        key = key[o]
    key, o = torch.sort(key, stable=True)
    return key, pos[o]


def _value_marks(idx, at, vals):
    """out[i] = max(vals[j] for at[j] <= idx[i]), 0 if there is none: the
    JAX package's value-marked cummax (a scatter-max of vals at positions
    at, then a running max over every position), computed as a running max
    over the small mark table sorted by position and one search of it per
    position.  The marks are a read table (hundreds to thousands of
    entries); torch's cummax over a block-sized tensor is far slower on
    the card (PERF.md)."""
    at_s, o = torch.sort(at)
    pm = torch.cummax(vals[o], 0).values
    k = torch.searchsorted(at_s, idx, right=True) - 1
    return torch.where(k >= 0, pm[k.clamp_min(0)], 0).to(vals.dtype)


def _build_index(seq, boffs, eoffs, mask_bad, kmer: int, suppress: int,
                 comp: bool, tight: int | None = None):
    """Index build over a padded sequence tensor (the JAX _build_index).

    seq:      uint8[L] bases with 4-sentinels (padding is sentinel), always
              the forward strand; comp=True derives the complement-strand
              index elementwise (revcomp codes + mirrored positions)
    boffs:    int32[R] read start offsets (padding repeats L-1)
    eoffs:    int32[R] read end offsets (padding: L-1)
    mask_bad: uint8[L] soft-masked positions, or a zero-length tensor
    Returns (key int64[L], pos int32[L], nvalid 0-dim tensor)."""
    L = seq.shape[0]
    n = L - kmer + 1
    dev = seq.device
    s = seq.to(_I64)
    idx = torch.arange(n, dtype=_I32, device=dev)

    # validity: zero bad positions in the window (prefix-sum differencing),
    # orientation-invariant
    bad = (seq >= 4).to(_I32)
    if mask_bad.shape[0]:
        bad = bad | mask_bad.to(_I32)
    cum = torch.cat([torch.zeros(1, dtype=_I32, device=dev),
                     torch.cumsum(bad, 0, dtype=_I32)])
    valid = (cum[kmer:kmer + n] - cum[:n]) == 0
    del bad, cum

    # rolling codes in two 32-bit planes
    klo = min(kmer, 16)
    khi = kmer - klo
    lo = torch.zeros(n, dtype=_I64, device=dev)
    for x in range(khi, kmer):
        lo = (lo << 2) | s[x:x + n]
    hi = torch.zeros(n, dtype=_I64, device=dev)
    for x in range(khi):
        hi = (hi << 2) | s[x:x + n]
    del s

    if comp:
        hi, lo = _revcomp_codes(hi, lo, kmer)
        # in-read mirror of the window start: x' = boff + end - k - x
        pos = (_value_marks(idx, boffs, boffs)
               + _value_marks(idx, boffs, eoffs) - kmer - idx)
    else:
        pos = idx

    key = torch.where(valid, join_key(hi & 0xFFFFFFFF, lo & 0xFFFFFFFF),
                      SENT)
    del hi, lo
    pos = torch.where(valid, pos, idx | _POS_INVALID)

    # the tight prefix: past the loaded sequence every row is trailing
    # sentinel pad, already keyed SENT with ascending pos, i.e. in its final
    # sorted place.  Forward windows below k=32 need one pass: within a
    # real key pos ascends with the row, and the SENT group holds invalid
    # rows only (k=32 adds real all-T windows, which must come first).
    def _sorted(key, pos, pos_sorted):
        if tight is not None and tight < n:
            ks, ps = _sort_key_pos(key[:tight], pos[:tight], pos_sorted)
            return torch.cat([ks, key[tight:]]), torch.cat([ps, pos[tight:]])
        return _sort_key_pos(key, pos, pos_sorted)

    key, pos = _sorted(key, pos, not comp and kmer < 32)
    nvalid = valid.sum(dtype=_I32)

    if suppress:
        # drop k-mers with multiplicity >= suppress (strict <, map.c:604):
        # re-key culled entries to the sentinel and re-sort
        gl, gr = _self_ranges(key)
        live = torch.arange(n, dtype=_I32, device=dev) < nvalid
        keep = ((gr - gl) < suppress) & live
        key = torch.where(keep, key, SENT)
        pos = torch.where(keep, pos, pos | _POS_INVALID)
        key, pos = _sorted(key, pos, False)
        nvalid = keep.sum(dtype=_I32)

    # pad back to L (kmer-1 sentinel entries)
    pad = L - n
    if pad:
        key = torch.cat([key, torch.full((pad,), SENT, dtype=_I64,
                                         device=dev)])
        pos = torch.cat([pos, torch.arange(n, L, dtype=_I32, device=dev)
                         | _POS_INVALID])
    return key, pos, nvalid


def _mask_bad(db, cap: int) -> np.ndarray:
    """uint8[cap]: 1 at soft-masked positions (only when tracks exist)."""
    bad = np.zeros(cap, np.uint8)
    anno, data, _ = next(iter(db.tracks.values()))
    boffs = db.reads["boff"]
    for i in range(db.nreads):
        seg = data[int(anno[i]):int(anno[i + 1])]
        b = int(boffs[i])
        for j in range(0, len(seg), 2):
            bad[b + int(seg[j]):b + int(seg[j + 1])] = 1
    return bad


# ---------------------------------------------------------------------------
# packed upload
# ---------------------------------------------------------------------------


def pack_seq(seq: np.ndarray, cap: int) -> np.ndarray:
    """Pack numeric bases 4-per-byte (big-endian 2-bit groups), cap-padded.
    Sentinels (4) lose their identity: the device side re-marks every
    position outside a read interval (_unpack_seq)."""
    assert cap % 4 == 0
    seq = np.ascontiguousarray(seq, np.uint8)
    n = len(seq)
    if n:
        mx = int(seq.max())
        if mx > 4:
            raise ValueError(
                f"pack_seq: sequence contains value {mx} > 4; the 2-bit "
                f"packed upload only preserves bases 0..3 and sentinels")
    out = np.zeros(cap // 4, np.uint8)
    n4 = n // 4 * 4
    # four bases a little-endian word, each masked to 2 bits: one multiply
    # by 2^30 + 2^20 + 2^10 + 1 lands base i at bits 30-2i, and no other
    # product term reaches bits 24-31 (three passes over the words, where
    # shifting each base out takes seven, PERF.md)
    w = seq[:n4].view("<u4") & np.uint32(0x03030303)
    w *= np.uint32(0x40100401)
    w >>= np.uint32(24)
    out[:n4 // 4] = w
    if n > n4:
        t = np.zeros(4, np.uint8)
        t[:n - n4] = seq[n4:] & 3
        out[n4 // 4] = (t[0] << 6) | (t[1] << 4) | (t[2] << 2) | t[3]
    return out


def _unpack_bases(packed):
    """uint8[4n] bases of uint8[n] packed bytes: a shift and a mask."""
    shifts = torch.tensor([6, 4, 2, 0], dtype=torch.uint8,
                          device=packed.device)
    return ((packed[:, None] >> shifts) & 3).reshape(-1)


def _unpack_chunk(packed, starts, ends, c0: int):
    """Bases c0.. of the packed bytes, sentinel 4 outside every [start,
    end) read interval (int32 tensors, padding 0/0): the covering read's
    bounds are the running maxima of the marks (reads lie in increasing
    order)."""
    seq = _unpack_bases(packed)
    idx = c0 + torch.arange(seq.shape[0], dtype=_I32, device=packed.device)
    inside = ((_value_marks(idx, starts, starts) <= idx)
              & (idx < _value_marks(idx, starts, ends)))
    return torch.where(inside, seq, 4).to(torch.uint8)


def _unpack_seq(packed, starts, ends):
    """uint8[4*len(packed)] bases with 4-sentinels restored at every
    position outside the read intervals."""
    return _unpack_chunk(packed, starts, ends, 0)


# beyond this many bases the single-shot unpack's int32 temporaries get
# large; the chunked form bounds them per chunk
_UNPACK_CHUNK_ABOVE = 1 << 28
_UNPACK_CL = 1 << 27            # bases per chunk (divides every bucket size)


def _unpack_seq_scan(packed, starts, ends, CL: int):
    """_unpack_seq in CL-base chunks, every temporary CL elements, not L.
    (The JAX package carries the running maxima from chunk to chunk; the
    search over the whole mark table gives them directly.)"""
    L = 4 * packed.shape[0]
    assert L % CL == 0
    out = torch.empty(L, dtype=torch.uint8, device=packed.device)
    for c0 in range(0, L, CL):
        out[c0:c0 + CL] = _unpack_chunk(packed[c0 // 4:(c0 + CL) // 4],
                                        starts, ends, c0)
    return out


def unpack_seq_dev(packed, starts, ends):
    """Single-shot unpack below _UNPACK_CHUNK_ABOVE bases, chunked above
    (same results)."""
    if 4 * packed.shape[0] > _UNPACK_CHUNK_ABOVE:
        return _unpack_seq_scan(packed, starts, ends, _UNPACK_CL)
    return _unpack_seq(packed, starts, ends)


def pack_upload(flat: np.ndarray, boffs, rlens, cap: int,
                device) -> torch.Tensor:
    """uint8[cap] sequence memory on ``device`` from a 2-bit-packed copy
    (cap/4 bytes) and the read-interval table: bases in the intervals,
    sentinel 4 everywhere else, the padded tail included."""
    dev = resolve_device(device)
    b = np.asarray(boffs, np.int64)
    rcap = _bucket(len(b), lo=1 << 8)
    s = np.zeros(rcap, np.int32)
    e = np.zeros(rcap, np.int32)
    s[:len(b)] = b
    e[:len(b)] = b + np.asarray(rlens, np.int64)
    return unpack_seq_dev(torch.from_numpy(pack_seq(flat, cap)).to(dev),
                          torch.from_numpy(s).to(dev),
                          torch.from_numpy(e).to(dev))


def packed_upload_on() -> bool:
    """DAMAPPER_PACK_UPLOAD=1 selects the 2-bit packed upload.  The plain
    uint8 upload is the default: on the H100 the host's packing costs more
    than the three quarters of the bytes it saves on the link (PERF.md),
    where the JAX package packs by default for its TPU's link."""
    return os.environ.get("DAMAPPER_PACK_UPLOAD", "0") == "1"


def device_upload_seq(db, device=None) -> torch.Tensor:
    """A loaded block's sentinel sequence on ``device`` (None: the card),
    bucket-padded, uploaded once for both orientations and every k: the
    plain uint8 bytes, or with DAMAPPER_PACK_UPLOAD=1 2-bit-packed (4 bases
    a byte) and unpacked on the device."""
    assert db.seq is not None, "db.load_bases() first"
    dev = resolve_device(device)
    L = len(db.seq)
    cap = _bucket(L)
    if not packed_upload_on():
        seq = np.full(cap, 4, np.uint8)
        seq[:L] = db.seq
        return torch.from_numpy(seq).to(dev)
    return pack_upload(db.seq, db.reads["boff"], db.reads["rlen"], cap, dev)


def device_sort_kmers(db, kmer: int, suppress: int = 0, comp: bool = False,
                      seq_dev: torch.Tensor | None = None,
                      device=None) -> DeviceKmerIndex:
    """The sorted, culled k-mer index of a loaded block on the device
    (Sort_Kmers map.c:655; equal to kmers.sort_kmers).  comp=True derives
    the complement-strand index from the forward upload: ``db`` must not be
    complement_inplace()'d for it.  seq_dev: the block's upload
    (device_upload_seq), else made here on ``device``."""
    assert db.seq is not None, "db.load_bases() first"
    assert kmer <= 32
    if seq_dev is None:
        seq_dev = device_upload_seq(db, device)
    dev = seq_dev.device
    cap = seq_dev.shape[0]
    rcap = _bucket(db.nreads, lo=1 << 8)
    boffs = np.full(rcap, cap - 1, np.int32)
    boffs[:db.nreads] = db.reads["boff"]
    eoffs = np.full(rcap, cap - 1, np.int32)
    eoffs[:db.nreads] = db.reads["boff"] + db.reads["rlen"]
    rlens = np.zeros(rcap, np.int32)
    rlens[:db.nreads] = db.reads["rlen"]
    mb = _mask_bad(db, cap) if db.tracks else np.zeros(0, np.uint8)

    def up(a):
        return torch.from_numpy(a).to(dev)

    boffs_dev = up(boffs)
    n_windows = cap - kmer + 1
    tight = min(n_windows, _tight_bucket(len(db.seq), n_windows))
    key, pos, nvalid = _build_index(seq_dev, boffs_dev, up(eoffs), up(mb),
                                    kmer, suppress, comp, tight)
    return DeviceKmerIndex(
        key, pos, int(nvalid), boffs_dev, kmer, up(rlens), db.nreads,
        int(db.reads["rlen"].max()) if db.nreads else 0)


# ---------------------------------------------------------------------------
# seed matching
# ---------------------------------------------------------------------------


def _group_starts(first):
    """(g, gs) of a group-start mask: g[i] the group of row i (a cumsum),
    gs[j] the first row of group j and n past the last group, scattered
    from the start rows (the JAX package takes cummax/cummin scans, which
    torch runs far slower than a cumsum on the card, PERF.md)."""
    n = first.shape[0]
    dev = first.device
    g = torch.cumsum(first, 0, dtype=_I32) - 1
    gs = torch.full((n + 2,), n, dtype=_I32, device=dev)
    gs.scatter_(0, torch.where(first, g, n + 1).to(_I64),
                torch.arange(n, dtype=_I32, device=dev))
    return g.to(_I64), gs


def _self_ranges(key):
    """(gl, gr) int32 group spans of every entry of a sorted key tensor:
    gl the first row of its key group, gr one past the last."""
    dev = key.device
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       key[1:] != key[:-1]])
    g, gs = _group_starts(first)
    return gs[g], gs[g + 1]


def _bitonic_merge(key, pay):
    """Sort a BITONIC (key, pay) sequence (lexicographic, ascending then
    descending), n a power of two >= 256: compare-exchange stages down to
    stride 128, then each 128-row block (bitonic, ordered against its
    neighbours) sorted on its own.  (key, pay) is a total order wherever
    order matters (rows equal in both are interchangeable)."""
    n = key.shape[0]
    s = n // 2
    while s >= 128:
        r = n // (2 * s)
        k2, p2 = key.view(r, 2, s), pay.view(r, 2, s)
        ka, kb, pa, pb = k2[:, 0], k2[:, 1], p2[:, 0], p2[:, 1]
        swap = (ka > kb) | ((ka == kb) & (pa > pb))
        key = torch.stack([torch.where(swap, kb, ka),
                           torch.where(swap, ka, kb)], 1).view(n)
        pay = torch.stack([torch.where(swap, pb, pa),
                           torch.where(swap, pa, pb)], 1).view(n)
        s //= 2
    kb, pb = key.view(-1, 128), pay.view(-1, 128)
    pb, o = torch.sort(pb, dim=1)
    kb, o2 = torch.sort(kb.gather(1, o), dim=1, stable=True)
    return kb.reshape(n), pb.gather(1, o2).reshape(n)


def _restore(qidt, vals, nq: int):
    """Values of the query rows (even slot ids 2*i, i < nq) back in query
    order: a scatter by slot id (the JAX code sorts by it)."""
    dst = torch.where((qidt & 1) == 0, qidt >> 1, nq).to(_I64)
    out = []
    for v in vals:
        o = torch.zeros(nq + 1, dtype=v.dtype, device=v.device)
        out.append(o.scatter_(0, dst, v)[:nq])
    return out


def _b_counts_scan(ck, tag):
    """After one combined sort of query and b rows: (# b rows strictly
    before each row, # b rows from it to the end of its key group).  The
    JAX package gets the second from a segment broadcast over the reversed
    array, (m - # b rows after the group) - nb_before; here it is the
    inclusive count at the group's end minus nb_before (equal)."""
    dev = ck.device
    cum = torch.cumsum(tag, 0, dtype=_I32)
    nb_before = cum - tag
    _, gr = _self_ranges(ck)
    return nb_before, cum[(gr - 1).to(_I64)] - nb_before


#: slot ids above this overflow the JAX package's int32 ids: the giant-
#: query branch of the "sort" join carries the b/query tag in its own plane
_SLOT_ID_MAX = 0x7FFFFFFF


def _join_ranges(bkey, bn, qkey, join: str = "sort",
                 qsplit: int | None = None):
    """(b_lo, b_hi) int32 spans of each query key in the sorted key tensor
    bkey, clamped to bn (an int or a 0-dim tensor).  The modes of the JAX
    _join_ranges, with the same results:

      merge   — both sides are sorted: concat(q, pad, b reversed) is
                bitonic, one bitonic merge replaces the sort (qsplit: q is
                two sorted halves, pre-merged the same way);
      scan    — one combined sort, b_hi from scans of the merged array;
      sortg   — one combined sort, b_hi from b's own group spans;
      sort    — one combined sort of q, q+1 and b;
      bsearch — binary searches of q in bkey (_searchsorted2).

    In the combined sorts the slot ids already ascend in row order, so one
    stable sort by key gives the (key, slot id) order."""
    dev = qkey.device
    if join == "bsearch":
        b_lo = torch.clamp_max(_searchsorted2(bkey, qkey, "left"), bn)
        b_hi = torch.clamp_max(_searchsorted2(bkey, qkey, "right"), bn)
        return b_lo, b_hi
    m = bkey.shape[0]
    nq = qkey.shape[0]

    def ids(n, shift=1):
        return torch.arange(n, dtype=_I32, device=dev) << shift

    def full(n, v, dt=_I32):
        return torch.full((n,), v, dtype=dt, device=dev)

    if (join == "merge" and 2 * nq <= _SLOT_ID_MAX
            and 256 <= _pow2_above(nq + m) <= (1 << 28)):
        # past 2^28 rows the merge's pow2-padded temporaries outgrow the
        # combined sort's (the JAX bound, kept as the algorithm's switch)
        qid_b = (nq << 1) | 1
        qid_pad = (nq << 1) + 2            # even (q-like), > real ids
        if qsplit is not None:
            np2 = _pow2_above(nq)
            qk_in = torch.cat([qkey[:qsplit], full(np2 - nq, SENT, _I64),
                               qkey[qsplit:].flip(0)])
            qid_in = torch.cat([ids(qsplit), full(np2 - nq, qid_pad),
                                (ids(nq)[qsplit:]).flip(0)])
            qkey, qids = _bitonic_merge(qk_in, qid_in)
            # the pad rows sort last (SENT key, id above every real one)
            qkey, qids = qkey[:nq], qids[:nq]
        else:
            qids = ids(nq)
        npow = _pow2_above(nq + m)
        pad = npow - nq - m
        ck = torch.cat([qkey, full(pad, SENT, _I64), bkey.flip(0)])
        qidt = torch.cat([qids, full(pad, _IMAX), full(m, qid_b)])
        ck, qidt = _bitonic_merge(ck, qidt)
        tag = qidt & 1
        nb_before, cbv = _b_counts_scan(ck, tag)
        res_lo, res_cb = _restore(qidt, (nb_before, cbv), nq)
        return (torch.clamp_max(res_lo, bn),
                torch.clamp_max(res_lo + res_cb, bn))
    if join in ("scan", "sortg") and 2 * nq + 1 <= _SLOT_ID_MAX:
        ck = torch.cat([qkey, bkey])
        qidt = torch.cat([ids(nq), full(m, (nq << 1) | 1)])
        ck, o = torch.sort(ck, stable=True)
        qidt = qidt[o]
        tag = qidt & 1
        if join == "scan":
            nb_before, cbv = _b_counts_scan(ck, tag)
            res_lo, res_cb = _restore(qidt, (nb_before, cbv), nq)
            return (torch.clamp_max(res_lo, bn),
                    torch.clamp_max(res_lo + res_cb, bn))
        # sortg: b_hi = b_lo + |group at b_lo| when the key at b_lo is q
        _, gr = _self_ranges(bkey)
        nb_before = torch.cumsum(tag, 0, dtype=_I32) - tag
        (res,) = _restore(qidt, (nb_before,), nq)
        b_lo = torch.clamp_max(res, bn)
        j = torch.clamp_max(b_lo, m - 1).to(_I64)
        eq = (bkey[j] == qkey) & (b_lo < bn)
        return b_lo, torch.where(eq, torch.clamp_max(gr[j], bn), b_lo)
    # sort: q and q+1 (the all-ones key wraps to 0, then b_hi = bn)
    wrapped = qkey == SENT
    q1 = torch.where(wrapped, _SIGN, qkey + (~wrapped).to(_I64))
    ck = torch.cat([qkey, q1, bkey])
    if 4 * nq + 1 <= _SLOT_ID_MAX:
        # the b/query tag rides the low bit of the slot id
        qidt = torch.cat([ids(2 * nq), full(m, ((2 * nq) << 1) | 1)])
        ck, o = torch.sort(ck, stable=True)
        qidt = qidt[o]
        tag = qidt & 1
        nb_before = torch.cumsum(tag, 0, dtype=_I32) - tag
        (res,) = _restore(qidt, (nb_before,), 2 * nq)
    else:
        # giant query sets: tag and query id in planes of their own
        tag = torch.cat([full(2 * nq, 0), full(m, 1)])
        qid = torch.cat([torch.arange(2 * nq, dtype=_I64, device=dev),
                         full(m, 2 * nq, _I64)])
        ck, o = torch.sort(ck, stable=True)
        tag, qid = tag[o], qid[o]
        nb_before = torch.cumsum(tag, 0, dtype=_I32) - tag
        dst = torch.where(tag == 0, qid, 2 * nq)
        res = torch.zeros(2 * nq + 1, dtype=_I32, device=dev).scatter_(
            0, dst, nb_before)[:2 * nq]
    b_lo = torch.clamp_max(res[:nq], bn)
    b_hi = torch.clamp_max(torch.where(wrapped, bn, res[nq:2 * nq]), bn)
    return b_lo, b_hi


JOIN_MODES = ("bsearch", "merge", "scan", "sortg", "sort")


def _join_mode() -> str:
    """The join, read at call time: DAMAPPER_JOIN, default "bsearch"; any
    other value than JOIN_MODES raises.  The JAX package defaults to
    "merge" (a TPU measurement); on the H100 the binary searches of the
    sorted queries took 2 ms where the combined sort took 35 ms and the
    merge 273 ms at bench.py's 140 Mb block (chip_smoke.py phase 4b,
    PERF.md)."""
    mode = os.environ.get("DAMAPPER_JOIN") or "bsearch"
    if mode not in JOIN_MODES:
        raise ValueError(f"DAMAPPER_JOIN must be one of {JOIN_MODES}, "
                         f"got {mode!r}")
    return mode


def _searchsorted2(key, q, side: str):
    """int32 insertion points of q in the sorted key tensor (the JAX
    package's two-plane binary search; one int64 key here)."""
    return torch.searchsorted(key, q, side=side, out_int32=True)


def _pos_to_read_rpos(p, boffs, kmer: int):
    """(read, rpos) of window-start positions via the sorted read-offset
    table."""
    r = torch.searchsorted(boffs, p, right=True, out_int32=True) - 1
    r = torch.clamp_min(r, 0)
    return r, p - boffs[r.to(_I64)] + (kmer - 1)


def _count_epilogue(key, an: int, b_lo, b_hi, use_gram: bool):
    """Per-row hit counts cb, per-group cost ct (JAX's float32 product,
    clamped at float32(0x7FFFFF00)) and the -M histogram of group costs."""
    return _group_costs(key, an, b_hi - b_lo, use_gram)


def _group_costs(key, an: int, counts, use_gram: bool):
    """_count_epilogue of per-row b counts (rows >= an count 0)."""
    nq = key.shape[0]
    dev = key.device
    idx = torch.arange(nq, dtype=_I32, device=dev)
    live = idx < an
    cb = torch.where(live, counts, 0).to(_I32)
    gl, gr = _self_ranges(key)
    ct = torch.clamp_max((gr - gl).to(torch.float32) * cb.to(torch.float32),
                         float(0x7FFFFF00)).to(_I32)
    gram = torch.zeros(MAXGRAM + 1, dtype=_I32, device=dev)
    if use_gram:
        selg = (gl == idx) & live & (cb > 0) & (ct < MAXGRAM) & (ct > 0)
        gram.scatter_add_(0, torch.where(selg, ct, MAXGRAM).to(_I64),
                          torch.ones_like(ct))
    return cb, ct, gram[:MAXGRAM]


def _match_count_pair(fkey, fan: int, ckey, can: int, bkey, bn: int,
                      use_gram: bool, join: str = "sort",
                      btight: int | None = None):
    """_match_count for both orientations against one b index: ONE join
    over the concatenated forward and revcomp query keys (which must share
    padded capacity), the epilogues per orientation."""
    assert fkey.shape == ckey.shape, \
        "fwd/revcomp query indexes must share padded capacity"
    nq = fkey.shape[0]
    if btight is not None:
        bkey = bkey[:btight]
    b_lo2, b_hi2 = _join_ranges(bkey, bn, torch.cat([fkey, ckey]), join,
                                qsplit=nq if join == "merge" else None)
    f = _count_epilogue(fkey, fan, b_lo2[:nq], b_hi2[:nq], use_gram)
    c = _count_epilogue(ckey, can, b_lo2[nq:], b_hi2[nq:], use_gram)
    return (b_lo2[:nq], *f), (b_lo2[nq:], *c)


def _match_count(akey, bkey, an: int, bn: int, use_gram: bool,
                 join: str = "sort", btight: int | None = None):
    """Pass 1: per-a-entry b-ranges, per-group totals, the histogram."""
    if btight is not None:
        bkey = bkey[:btight]
    b_lo, b_hi = _join_ranges(bkey, bn, akey, join)
    return (b_lo, *_count_epilogue(akey, an, b_lo, b_hi, use_gram))


def _avail_budget(mem_limit: int, db_bytes: int, alen: int,
                  blen: int) -> int:
    """The -M memory budget in 16-byte hit units (map.c:2992-3012)."""
    avail = (mem_limit - db_bytes) // 16
    if avail > alen + 2 * blen:
        avail = (avail - alen) // 2
    else:
        avail = avail - (alen + blen)
    return int(avail * .98)


def _device_limit(gram, avail: int):
    """First histogram bin whose running sum of j*gram[j] (int32, wrapping
    as JAX's) exceeds the budget, else MAXGRAM (map.c:3013-3052)."""
    j = torch.arange(MAXGRAM, dtype=_I64, device=gram.device)
    over = _wrap32(torch.cumsum(_wrap32(j * gram.to(_I64)).to(_I64), 0)) \
        > avail
    return torch.where(over.any(), torch.argmax(over.to(torch.uint8)),
                       MAXGRAM).to(_I32)


def _match_emit_prep(cb, ct, limit):
    """Selection mask, per-a-row output offsets (int32 inclusive cumsum,
    wrapping as JAX's) and the total."""
    sel = (cb > 0) & (ct < limit)
    cum = _wrap32(torch.cumsum(torch.where(sel, cb, 0), 0, dtype=_I64))
    return sel, cum, cum[-1]


def _lex_order(cols, bits):
    """Permutation sorting the rows by cols (major first, each in
    [0, 2**bits)), stable: one composite int64 key when the widths fit in
    63 bits, else stable passes from the minor column up."""
    if sum(bits) <= 63:
        key = torch.zeros_like(cols[0], dtype=_I64)
        for c, b in zip(cols, bits):
            key = (key << b) | c.to(_I64)
        return torch.sort(key, stable=True).indices
    perm = None
    for c in reversed(cols):
        cc = c if perm is None else c[perm]
        o = torch.sort(cc, stable=True).indices
        perm = o if perm is None else perm[o]
    return perm


def _emit_rows(a_pos, aboffs, b_pos, bboffs, b_lo, cum, ncap: int,
               akmer: int, bkmer: int):
    """Emission index algebra: for output slot t, the a row whose
    inclusive cumsum first exceeds t and the b row at its offset, with
    (read, rpos) of both sides; pad marks t >= total.  Returns (pad, ar,
    ap, br, bp, b_row)."""
    dev = cum.device
    t = torch.arange(ncap, dtype=_I32, device=dev)
    total = cum[-1]
    a_row = torch.clamp_max(
        torch.searchsorted(cum, t, right=True, out_int32=True),
        cum.shape[0] - 1).to(_I64)
    prev = torch.where(a_row > 0, cum[torch.clamp_min(a_row - 1, 0)], 0)
    b_row = b_lo[a_row] + (t - prev)
    ar, ap = _pos_to_read_rpos(a_pos[a_row], aboffs, akmer)
    br, bp = _pos_to_read_rpos(
        b_pos[torch.clamp_max(b_row, b_pos.shape[0] - 1).to(_I64)], bboffs,
        bkmer)
    return t >= total, ar, ap, br, bp, b_row


def _bits(v: int) -> int:
    return max(1, int(v).bit_length())


def _match_emit(a_pos, aboffs, b_pos, bboffs, b_lo, cum, ncap: int,
                akmer: int, bkmer: int, widths):
    """Pass 2: the hits in an ncap-padded int32[4, ncap] buffer (aread,
    bread, apos, diag), sorted by (aread, bread, apos), stable.  widths:
    (a reads, b reads, a's longest read) bound the sort fields."""
    pad, ar, ap, br, bp, _ = _emit_rows(a_pos, aboffs, b_pos, bboffs,
                                        b_lo, cum, ncap, akmer, bkmer)
    na, nb, alen = widths
    dg = torch.where(pad, 0, ap - bp)
    ap = torch.where(pad, 0, ap)
    br = torch.where(pad, 0, br)
    o = _lex_order([torch.where(pad, na, ar), br, ap],
                   [_bits(na), _bits(nb), _bits(alen)])
    ar = torch.where(pad, _IMAX, ar)
    return torch.stack([ar[o], br[o], ap[o], dg[o]])


def _match_emit_comp(a_pos, aboffs, a_rlens, b_pos, bboffs, b_rlens, b_lo,
                     cum, ncap: int, akmer: int, bkmer: int, widths):
    """Pass 2 in the complement frame: a is the reads' revcomp index, b
    the forward reference index; each hit is mirrored into the frame of
    the forward reads against the complemented reference (ap ->
    rlen+k-2-ap, bp -> clen+k-2-bp) and sorted by (aread, bread, apos,
    comp bpos), the reference's tie order.  widths: (a reads, b reads,
    a's longest read, b's longest read)."""
    pad, ar, ap_rc, br, bp, _ = _emit_rows(a_pos, aboffs, b_pos, bboffs,
                                           b_lo, cum, ncap, akmer, bkmer)
    na, nb, alen, blen = widths
    ap = torch.where(pad, 0, a_rlens[ar.to(_I64)] + (akmer - 2) - ap_rc)
    bpc = torch.where(pad, 0, b_rlens[br.to(_I64)] + (bkmer - 2) - bp)
    br = torch.where(pad, 0, br)
    o = _lex_order([torch.where(pad, na, ar), br, ap, bpc],
                   [_bits(na), _bits(nb), _bits(alen), _bits(blen)])
    ar, br, ap, bpc = (torch.where(pad, _IMAX, ar)[o], br[o], ap[o], bpc[o])
    dg = torch.where(ar == _IMAX, 0, ap - bpc)
    return torch.stack([ar, br, ap, dg])


def _empty_hits() -> SeedHits:
    return SeedHits(*(np.zeros(0, np.int32),) * 4)


def _finish_match(aidx, bidx, b_lo, cb, ct, gram, mem_limit, db_bytes,
                  comp_frame):
    """The -M limit, emission prep, emission and sort; pulls the two
    scalars and the stacked hits."""
    dev = cb.device
    if mem_limit > 0:
        avail = _avail_budget(mem_limit, db_bytes, aidx.n, bidx.n)
        limit = _device_limit(gram, min(max(avail, 0), _IMAX))
    else:
        limit = torch.tensor(_IMAX, dtype=_I32, device=dev)
    _, cum, total = _match_emit_prep(cb, ct, limit)
    total, limit_v = (int(x) for x in torch.stack([total, limit]).cpu())
    if mem_limit > 0 and limit_v <= 1:
        raise MemoryError("Insufficient memory for seed hits; reduce block "
                          "size or raise -M")
    if total == 0:
        return _empty_hits()
    ncap = _bucket(total)
    if comp_frame:
        packed = _match_emit_comp(
            aidx.pos, aidx.boffs, aidx.rlens, bidx.pos, bidx.boffs,
            bidx.rlens, b_lo, cum, ncap, aidx.kmer, bidx.kmer,
            (aidx.nreads, bidx.nreads, aidx.max_rlen, bidx.max_rlen))
    else:
        packed = _match_emit(aidx.pos, aidx.boffs, bidx.pos, bidx.boffs,
                             b_lo, cum, ncap, aidx.kmer, bidx.kmer,
                             (aidx.nreads, bidx.nreads, aidx.max_rlen))
    h = packed[:, :total].contiguous().cpu().numpy()
    return SeedHits(h[0], h[1], h[2], h[3])


def device_match_seeds(aidx: DeviceKmerIndex, bidx: DeviceKmerIndex,
                       mem_limit: int = 0, db_bytes: int = 0,
                       comp_frame: bool = False) -> SeedHits:
    """Intersect two device k-mer indexes; host SeedHits equal to
    seeds.match_seeds's (Match_Filter, map.c:2889-3135).  comp_frame=True:
    ``aidx`` is the reads' revcomp index and ``bidx`` the forward reference
    index; the hits come out in the reference's complement frame."""
    if aidx.n == 0 or bidx.n == 0:
        return _empty_hits()
    b_lo, cb, ct, gram = _match_count(
        aidx.key, bidx.key, aidx.n, bidx.n, mem_limit > 0, _join_mode(),
        _tight_bucket(bidx.n, bidx.key.shape[0]))
    return _finish_match(aidx, bidx, b_lo, cb, ct, gram, mem_limit,
                         db_bytes, comp_frame)


def device_match_seeds_pair(reads_fwd: DeviceKmerIndex,
                            reads_rc: DeviceKmerIndex,
                            ref_idx: DeviceKmerIndex, mem_limit: int = 0,
                            db_bytes: int = 0):
    """Both orientations of Match_Filter against ONE forward reference
    index with a single join; returns (hits_fwd, hits_comp), each equal to
    the corresponding device_match_seeds call."""
    if ref_idx.n == 0 or (reads_fwd.n == 0 and reads_rc.n == 0):
        return _empty_hits(), _empty_hits()
    f, c = _match_count_pair(
        reads_fwd.key, reads_fwd.n, reads_rc.key, reads_rc.n, ref_idx.key,
        ref_idx.n, mem_limit > 0, _join_mode(),
        _tight_bucket(ref_idx.n, ref_idx.key.shape[0]))
    return (_finish_match(reads_fwd, ref_idx, *f, mem_limit, db_bytes,
                          False),
            _finish_match(reads_rc, ref_idx, *c, mem_limit, db_bytes, True))


# ---------------------------------------------------------------------------
# sharded matching over a (dp, ref) mesh
# ---------------------------------------------------------------------------
#
# The counterpart of damapper_tpu/ops/device_index.py:1062-1298: the reads
# index sharded over "dp", each reference block's index over "ref"
# (parallel.mesh).  Every (dp, ref) position counts its a slice against its
# b slice; the ref shards' counts are summed (the JAX package's psum over
# "ref"; across ranks an all-reduce), the -M histogram and the selection run
# on those global counts exactly as the single-device path runs them, each
# position emits its own hits with two tie planes, and one stable sort of
# every position's buffer restores the reference's hit order.


@dataclass
class ShardedKmerIndex(DeviceKmerIndex):
    """A DeviceKmerIndex split contiguously over one mesh axis.

    key/pos (and the rest of DeviceKmerIndex) stay the whole index on its
    device: the group math of the a side runs on all of it, as the JAX
    package's global arrays do.  ``parts`` maps each position this rank
    owns to its shard's (key, pos) on the position's device (views where
    the device is the index's own); ``reps`` maps each of those devices to
    its (boffs, rlens), which every position replicates."""

    mesh: object = None
    axis: str = "dp"
    parts: dict = field(default_factory=dict)
    reps: dict = field(default_factory=dict)


def _mesh_is_multiprocess(mesh) -> bool:
    """True when the mesh spans more than one rank."""
    return mesh.is_multiprocess()


def shard_index(idx: DeviceKmerIndex, mesh, axis: str) -> ShardedKmerIndex:
    """The index split contiguously over a mesh axis: ``key`` and ``pos``
    in mesh.shape[axis] equal slices, ``boffs`` and ``rlens`` replicated;
    each position this rank owns gets its slice on its device.  Across
    ranks every rank holds the whole index (the host stages are
    replicated) and keeps only its own positions' shards."""
    size = mesh.shape[axis]
    cap = idx.key.shape[0]
    if cap % size:
        raise ValueError(f"an index of {cap} entries does not split into "
                         f"{size} {axis!r} shards")
    per = cap // size
    ax = mesh.axis_names.index(axis)
    parts, placed, reps = {}, {}, {}
    for ix in mesh.local_positions():
        dev = mesh.devices[ix]
        s = ix[ax]
        if (s, dev) not in placed:
            sl = slice(s * per, (s + 1) * per)
            placed[(s, dev)] = (idx.key[sl].to(dev), idx.pos[sl].to(dev))
        parts[ix] = placed[(s, dev)]
        if dev not in reps:
            reps[dev] = (idx.boffs.to(dev), idx.rlens.to(dev))
    return ShardedKmerIndex(idx.key, idx.pos, idx.n, idx.boffs, idx.kmer,
                            idx.rlens, idx.nreads, idx.max_rlen, mesh, axis,
                            parts, reps)


def _local_ranges(akey, bkey, bn: int):
    """A position's b-ranges: (b_lo, count) int32 of its a slice in its b
    slice's first bn (live) entries.  The search itself stops at bn: the
    trailing shards' pads are sentinel keys, which real all-T 32-mers share
    (the JAX package searches the whole slice and clamps to bn, with the
    same result)."""
    b = bkey[:bn]
    b_lo = _searchsorted2(b, akey, "left")
    return b_lo, _searchsorted2(b, akey, "right") - b_lo


def _emit_shard(j: int, nref: int, sel, aidx, bidx, ix, b_lo, cb_l,
                ncap: int, comp_frame: bool):
    """One position's hits: int32[6, ncap] planes (aread, bread, apos,
    tie1, tie2, diag), pad rows (aread = tie1 = tie2 = INT32_MAX) past the
    position's own total.  The tie planes order hits of one a row by b row
    across the shards: (ref shard, local b row), both reversed in the
    complement frame, whose reference order is the descending forward b
    row (damapper_tpu's emit_local)."""
    dev = b_lo.device
    a_pos = aidx.parts[ix][1]
    b_pos = bidx.parts[ix][1]
    aboffs, arlens = aidx.reps[dev]
    bboffs, brlens = bidx.reps[dev]
    take = torch.where(sel, cb_l, 0)
    cum = _wrap32(torch.cumsum(take, 0, dtype=_I64))
    pad, ar, ap, br, bp, b_row = _emit_rows(a_pos, aboffs, b_pos, bboffs,
                                            b_lo, cum, ncap, aidx.kmer,
                                            bidx.kmer)
    if comp_frame:
        ap = arlens[ar.to(_I64)] + (aidx.kmer - 2) - ap
        bp = brlens[br.to(_I64)] + (bidx.kmer - 2) - bp
        tie1 = nref - 1 - j
        tie2 = _IMAX - b_row
    else:
        tie1 = j
        tie2 = b_row
    dg = torch.where(pad, 0, ap - bp)
    ar = torch.where(pad, _IMAX, ar)
    ap = torch.where(pad, 0, ap)
    br = torch.where(pad, 0, br)
    t1 = torch.where(pad, _IMAX, tie1)
    t2 = torch.where(pad, _IMAX, tie2)
    return torch.stack([x.to(_I32) for x in (ar, br, ap, t1, t2, dg)])


def _sort_hits(bufs, widths, per_b: int, comp_frame: bool):
    """The stable (aread, bread, apos, tie1, tie2) sort of the positions'
    buffers, concatenated in the given order, as int32[4, N] (aread,
    bread, apos, diag).  The two tie planes sort as one field, tie1 *
    per_b + the local b row (per_b - 1 - it in the complement frame, where
    tie2 is INT32_MAX - b row): the same order in fewer bits.  widths:
    (a reads, b reads, a's longest read, the b index's length)."""
    ar, br, ap, t1, t2, dg = torch.cat(bufs, 1).unbind(0)
    na, nb, alen, cap_b = widths
    pad = ar == _IMAX
    local = (per_b - 1 - (_IMAX - t2.to(_I64))) if comp_frame else t2
    tie = torch.where(pad, 0, t1.to(_I64) * per_b + local)
    o = _lex_order([torch.where(pad, na, ar), br, ap, tie],
                   [_bits(na), _bits(nb), _bits(alen), _bits(cap_b)])
    return torch.stack([ar[o], br[o], ap[o], dg[o]])


def device_match_seeds_sharded(aidx: ShardedKmerIndex,
                               bidx: ShardedKmerIndex, mesh,
                               mem_limit: int = 0, db_bytes: int = 0,
                               comp_frame: bool = False) -> SeedHits:
    """Sharded Match_Filter: aidx (the reads) sharded over "dp", bidx (a
    reference block) over "ref"; host SeedHits equal to
    device_match_seeds's.  The -M limit is the host match_limit of the
    histogram of the summed counts, as the JAX package's sharded path takes
    it: a limit <= 1 raises MemoryError, and a budget below zero is not
    clamped (the single-device path clamps it, ROADMAP Queue 3).

    Across ranks, every value the host reads (the histogram, the selection
    and total, the per-position totals, the sorted hits) is the same on
    every rank: the counts are all-reduced, the per-position totals and the
    emission buffers all-gathered."""
    if aidx.n == 0 or bidx.n == 0:
        return _empty_hits()
    from ..parallel import mesh as pmesh
    multi = _mesh_is_multiprocess(mesh)
    ndp, nref = mesh.shape["dp"], mesh.shape["ref"]
    home = aidx.key.device
    n = aidx.key.shape[0]
    per_a = n // ndp
    cap_b = bidx.key.shape[0]
    per_b = cap_b // nref
    # live entries per b shard (pads live in the trailing shards)
    bn_l = np.clip(bidx.n - per_b * np.arange(nref), 0, per_b)
    local = mesh.local_positions()

    # count: each position's b-ranges; the ref shards' counts summed
    ranges = {}
    cb_g = torch.zeros(n, dtype=_I32, device=home)
    for ix in local:
        i, j = ix
        ranges[ix] = _local_ranges(aidx.parts[ix][0], bidx.parts[ix][0],
                                   int(bn_l[j]))
        cb_g[i * per_a:(i + 1) * per_a] += ranges[ix][1].to(home)
    if multi:
        cb_g = pmesh.all_reduce_sum(cb_g)

    # the group math on the summed counts, as the single-device path's
    cb, ct, gram = _group_costs(aidx.key, aidx.n, cb_g, mem_limit > 0)
    if mem_limit > 0:
        limit = match_limit(gram.cpu().numpy(), mem_limit, db_bytes, aidx.n,
                            bidx.n)
    else:
        limit = _IMAX
    sel = (cb > 0) & (ct < min(limit, _IMAX))
    total = int(_wrap32(torch.where(sel, cb, 0).sum(dtype=_I64)))
    if total == 0:
        return _empty_hits()

    # each position's own total bounds the emission capacity (one size for
    # every position)
    sels, tots = {}, []
    for ix in local:
        i, _ = ix
        s = sel[i * per_a:(i + 1) * per_a].to(ranges[ix][1].device)
        sels[ix] = s
        tots.append(torch.where(s, ranges[ix][1], 0).sum(dtype=_I64)
                    .to(home))
    tot = torch.stack(tots)
    if multi:
        tot = pmesh.all_gather(tot)
    ncap = _bucket(max(1, int(tot.max())))

    bufs = {ix: _emit_shard(ix[1], nref, sels[ix], aidx, bidx, ix,
                            *ranges[ix], ncap, comp_frame).to(home)
            for ix in local}
    if multi:
        got = pmesh.all_gather(torch.stack([bufs[ix] for ix in local]))
        bufs = {}
        for r in range(got.shape[0]):
            own = [ix for ix in np.ndindex(mesh.devices.shape)
                   if mesh.ranks[ix] == r]
            bufs.update(zip(own, got[r].unbind(0)))
    order = sorted(bufs)           # position order: dp-major, then ref
    h = _sort_hits([bufs[ix] for ix in order],
                   (aidx.nreads, bidx.nreads, aidx.max_rlen, cap_b), per_b,
                   comp_frame)
    h = h[:, :total].contiguous().cpu().numpy()
    return SeedHits(h[0], h[1], h[2], h[3])

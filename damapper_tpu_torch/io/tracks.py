"""Track utilities: mask-track interval merging (union) across several tracks.

Equivalent of merge_size/merge_tracks (reference damapper.c:143-343): a k-way
merge of per-read interval lists producing the union of the masked intervals.
"""

from __future__ import annotations

import numpy as np


def merge_mask_tracks(db) -> None:
    """Replace all mask tracks on `db` with a single merged 'merge' track
    holding the per-read union of intervals (damapper.c:253-343)."""
    names = list(db.tracks.keys())
    if len(names) <= 1:
        return
    n = db.nreads
    out_anno = np.zeros(n + 1, np.int64)
    out_chunks: list[np.ndarray] = []
    total = 0
    tracks = [db.tracks[nm] for nm in names]
    for r in range(n):
        events = []
        for anno, data, _ in tracks:
            seg = data[int(anno[r]):int(anno[r + 1])]
            for j in range(0, len(seg) - 1, 2):
                events.append((int(seg[j]), int(seg[j + 1])))
        events.sort()
        merged = []
        for b, e in events:
            if merged and b <= merged[-1][1]:
                if e > merged[-1][1]:
                    merged[-1] = (merged[-1][0], e)
            else:
                merged.append((b, e))
        flat = np.array([x for iv in merged for x in iv], np.int32)
        out_anno[r] = total
        out_chunks.append(flat)
        total += len(flat)
    out_anno[n] = total
    data = np.concatenate(out_chunks) if out_chunks else np.zeros(0, np.int32)
    db.tracks.clear()
    db.tracks["merge"] = (out_anno,
                          data,
                          np.diff(out_anno).astype(np.int32))


# ---------------------------------------------------------------------------
# EXTRA metadata records (reference DB.c:2148-2322, DB.h:318-338): trailing
# [vtype, nelem, accum, slen, name, 8*nelem value bytes] records at the end
# of a .anno track file, reduced across block tracks by EXACT equality or
# summation.
# ---------------------------------------------------------------------------

DB_INT = 0
DB_REAL = 1
DB_EXACT = 0
DB_SUM = 1


class DazzExtra:
    """One EXTRA record (DAZZ_EXTRA DB.h:332-338)."""

    def __init__(self, name: str, value, vtype: int | None = None,
                 accum: int = DB_EXACT):
        value = np.asarray(value)
        if vtype is None:
            vtype = DB_REAL if value.dtype.kind == "f" else DB_INT
        self.vtype = vtype
        self.value = value.astype("<f8" if vtype == DB_REAL else "<i8")
        self.nelem = len(self.value)
        self.accum = accum
        self.name = name

    def __eq__(self, other):
        return (isinstance(other, DazzExtra) and self.vtype == other.vtype
                and self.accum == other.accum and self.name == other.name
                and np.array_equal(self.value, other.value))


def write_extra(fp, extra: DazzExtra) -> None:
    """Append one EXTRA record (Write_Extra DB.c:2273-2287)."""
    name = extra.name.encode()
    fp.write(np.array([extra.vtype, extra.nelem, extra.accum, len(name)],
                      "<i4").tobytes())
    fp.write(name)
    fp.write(extra.value.tobytes())


def read_extra(fp, into: DazzExtra | None = None):
    """Read one EXTRA record; None at end of file (Read_Extra
    DB.c:2148-2269).  With `into`, reduce the just-read record into it:
    DB_EXACT values must agree, DB_SUM values accumulate."""
    hdr = fp.read(16)
    if len(hdr) < 16:
        if len(hdr) == 0:
            return None
        raise IOError("corrupted EXTRA record header")
    vtype, nelem, accum, slen = np.frombuffer(hdr, "<i4")
    nm = fp.read(int(slen))
    if len(nm) != int(slen):
        raise IOError("corrupted EXTRA record name")
    name = nm.decode()
    raw = fp.read(8 * int(nelem))
    if len(raw) != 8 * int(nelem):
        raise IOError("corrupted EXTRA record value")
    value = np.frombuffer(raw, "<f8" if vtype == DB_REAL else "<i8").copy()
    got = DazzExtra(name, value, vtype=int(vtype), accum=int(accum))
    if into is None or into.nelem == 0:
        return got
    if got.vtype != into.vtype:
        raise ValueError(f"Type of extra {name} does not agree with "
                         "previous .anno block files")
    if got.nelem != into.nelem:
        raise ValueError(f"Length of extra {name} does not agree with "
                         "previous .anno block files")
    if got.accum != into.accum:
        raise ValueError(f"Reduction indicator of extra {name} does not "
                         "agree with previous .anno block files")
    if got.name != into.name:
        raise ValueError(f"Expecting extra {into.name} in .anno block "
                         f"file, not {name}")
    if into.accum == DB_EXACT:
        if not np.array_equal(got.value, into.value):
            raise ValueError(f"Value of extra {name} does not agree with "
                             "previous .anno block files")
    else:
        into.value = into.value + got.value
    return into


def read_all_extras(path: str, skip_bytes: int) -> list[DazzExtra]:
    """All EXTRA records trailing a .anno file whose payload (header +
    anno array) occupies skip_bytes."""
    out = []
    with open(path, "rb") as fp:
        fp.seek(skip_bytes)
        while True:
            e = read_extra(fp)
            if e is None:
                return out
            out.append(e)

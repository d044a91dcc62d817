"""Minimal FASTA reading/writing used by the DB/DAM importers.

The reference tool-chain imports FASTA via fasta2DB/fasta2DAM (DAZZ_DB package,
not part of the reference repo); we provide equivalent importers in
io.db built on this module.
"""

from __future__ import annotations

import io
from dataclasses import dataclass


@dataclass
class FastaEntry:
    header: str  # header line without '>'
    seq: str     # sequence, as given (may contain N's, mixed case)


def read_fasta(path_or_fp) -> list[FastaEntry]:
    if isinstance(path_or_fp, (str, bytes)):
        with open(path_or_fp, "rt") as fp:
            return read_fasta(fp)
    fp = path_or_fp
    entries: list[FastaEntry] = []
    header = None
    chunks: list[str] = []
    for line in fp:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if header is not None:
                entries.append(FastaEntry(header, "".join(chunks)))
            header = line[1:]
            chunks = []
        else:
            chunks.append(line)
    if header is not None:
        entries.append(FastaEntry(header, "".join(chunks)))
    return entries


def write_fasta(path_or_fp, entries, width: int = 80) -> None:
    if isinstance(path_or_fp, (str, bytes)):
        with open(path_or_fp, "wt") as fp:
            write_fasta(fp, entries, width)
            return
    fp = path_or_fp
    for e in entries:
        fp.write(">" + e.header + "\n")
        for i in range(0, len(e.seq), width):
            fp.write(e.seq[i:i + width] + "\n")

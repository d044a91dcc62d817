from . import db, las, tracks, fasta  # noqa: F401

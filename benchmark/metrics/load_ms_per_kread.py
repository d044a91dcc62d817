"""load_ms_per_kread: DB load (pipeline/mapper.py read_block, io/db.py),
the program's ``LAST_STATS["times"]["load"]`` summed over the window's
blocks, in ms a 1,000 reads."""


def read(w):
    return w.per_kread(w.stats["times"]["load"])

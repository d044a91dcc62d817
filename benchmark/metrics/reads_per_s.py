"""reads_per_s: the reads of every block mapped in the window over the
window's wall, from the first block's start to the last block's end and
its synchronize (host clock)."""


def read(w):
    return w.reads / w.wall_s

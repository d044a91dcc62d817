"""setup_s: from the harness's first statement to the window's start
(host clock): imports and the card's start, drawing and writing the DAZZ
files, loading or building the program's libraries, and the warm-up, which
maps one block of the cell's traffic."""


def read(w):
    return w.setup_s

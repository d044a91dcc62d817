"""glibc's malloc held steady for the benchmark's processes."""

import ctypes

M_MMAP_MAX, M_TRIM_THRESHOLD = -4, -1     # mallopt's parameters (malloc.h)


def steady_malloc() -> None:
    """glibc's malloc in this process: no allocation served by its own
    mmap (M_MMAP_MAX 0) and no trimming of the heap's top (M_TRIM_THRESHOLD
    -1), as mallopt(3) defines them.  A block's large arrays then reuse heap
    pages that earlier blocks mapped, instead of an mmap, page faults and a
    munmap each: system time that varies with the host's load (2.4-3.2 s of
    a 30 s window before, 0.2 s after, on an H100's host).  Raises where
    mallopt is missing or refuses."""
    libc = ctypes.CDLL("libc.so.6")
    libc.mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    libc.mallopt.restype = ctypes.c_int
    for param, value in ((M_MMAP_MAX, 0), (M_TRIM_THRESHOLD, -1)):
        if libc.mallopt(param, value) != 1:
            raise RuntimeError(f"mallopt({param}, {value}) refused")

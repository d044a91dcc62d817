"""Native (C++) host components, built on demand with the system toolchain.

The shared libraries go to ``build/torch_native/`` beside the package (a
directory the repository's .gitignore lists), never into the package."""

from __future__ import annotations

import ctypes
import os
import pathlib
import subprocess

_DIR = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent.parent / "build" / "torch_native"


def _build(name: str) -> pathlib.Path:
    src = _DIR / f"{name}.cpp"
    so = BUILD_DIR / f"lib{name}.so"
    if so.exists() and so.stat().st_mtime > src.stat().st_mtime:
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(".so.tmp%d" % os.getpid())
    subprocess.run(
        ["g++", "-O3", "-march=native", "-shared", "-fPIC", "-pthread",
         "-o", str(tmp), str(src)],
        check=True, capture_output=True)
    os.replace(tmp, so)
    return so


_chain_lib = None


def chain_lib():
    """ctypes handle to the chain sweep and push library (lazy build)."""
    global _chain_lib
    if _chain_lib is None:
        lib = ctypes.CDLL(str(_build("chain_sweep")))
        lib.chain_sweep.restype = ctypes.c_void_p
        lib.chain_sweep.argtypes = [
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.result_meta_len.restype = ctypes.c_int64
        lib.result_meta_len.argtypes = [ctypes.c_void_p]
        lib.result_meta.restype = ctypes.POINTER(ctypes.c_int32)
        lib.result_meta.argtypes = [ctypes.c_void_p]
        lib.result_jumps_len.restype = ctypes.c_int64
        lib.result_jumps_len.argtypes = [ctypes.c_void_p]
        lib.result_jumps.restype = ctypes.POINTER(ctypes.c_int32)
        lib.result_jumps.argtypes = [ctypes.c_void_p]
        lib.result_free.restype = None
        lib.result_free.argtypes = [ctypes.c_void_p]
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.chain_state_new.restype = p
        lib.chain_state_new.argtypes = [i64, p, p, ctypes.c_int32]
        lib.chain_push.restype = i64
        lib.chain_push.argtypes = [p, p, ctypes.c_int32, ctypes.c_int32]
        lib.chain_state_count.restype = i64
        lib.chain_state_count.argtypes = [p]
        lib.chain_state_jumps_len.restype = i64
        lib.chain_state_jumps_len.argtypes = [p]
        lib.chain_state_export.restype = i64
        lib.chain_state_export.argtypes = [p, p, p, p, p]
        lib.chain_state_free.restype = None
        lib.chain_state_free.argtypes = [p]
        _chain_lib = lib
    return _chain_lib


_radix_lib = None


def radix_lib():
    """ctypes handle to the threaded radix sort (lazy build)."""
    global _radix_lib
    if _radix_lib is None:
        lib = ctypes.CDLL(str(_build("radix_sort")))
        lib.radix_sort_u64.restype = ctypes.c_int
        lib.radix_sort_u64.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int, ctypes.c_uint64]
        _radix_lib = lib
    return _radix_lib


def radix_sort_u64(key, nthreads: int = 0, active_mask: int = None):
    """Sort a uint64 numpy array ascending in place (stable threaded LSD
    radix, the lex_sort equivalent).  Falls back to np.sort when the
    native library is unavailable."""
    import numpy as np

    n = len(key)
    if n <= 1:
        return key
    if nthreads <= 0:
        nthreads = min(8, os.cpu_count() or 4)
    if active_mask is None:
        # full OR over the keys: one cheap pass, and unlike sampling it can
        # never skip a radix byte that is nonzero only in unsampled keys
        active_mask = int(np.bitwise_or.reduce(key))
    try:
        lib = radix_lib()
    except Exception:
        key.sort()
        return key
    tmp = np.empty_like(key)
    r = lib.radix_sort_u64(key.ctypes.data, tmp.ctypes.data, n, nthreads,
                           ctypes.c_uint64(active_mask & ((1 << 64) - 1)))
    if r == 1:
        np.copyto(key, tmp)
    return key


_kmer_lib = None


def kmer_lib():
    """ctypes handle to the native k-mer index builder (lazy build)."""
    global _kmer_lib
    if _kmer_lib is None:
        lib = ctypes.CDLL(str(_build("kmer_index")))
        lib.kmer_count.restype = ctypes.c_int64
        lib.kmer_count.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                                   ctypes.c_int, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
        lib.kmer_index.restype = None
        lib.kmer_index.argtypes = [ctypes.c_void_p] * 3 + [
            ctypes.c_int32, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p]
        lib.merge_ranges.restype = None
        lib.merge_ranges.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        _kmer_lib = lib
    return _kmer_lib


_trace_lib = None


def trace_lib():
    """ctypes handle to the wave engine's trace walk (lazy build)."""
    global _trace_lib
    if _trace_lib is None:
        lib = ctypes.CDLL(str(_build("trace_walk")))
        p, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.trace_forward.restype = i64
        lib.trace_forward.argtypes = [i64, i64] + [p] * 13
        lib.trace_reverse.restype = i64
        lib.trace_reverse.argtypes = [i64, i64] + [p] * 7 + [i64] + [p] * 12
        _trace_lib = lib
    return _trace_lib

"""State carried across from the JAX package.

The mapper has no weights: what a run depends on is the error-model spec
(AlignSpec) and the data.  DAZZ files on disk are shared as they are; these
helpers carry the rest over as plain numpy and ints, so that both packages
see identical inputs."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.device_index import DeviceKmerIndex, join_key
from .ops.spec import AlignSpec
from .ops.wave_engine import trace_offsets
from .ops.wave_persistent import persistent_windows
from .parallel.mesh import AXES, Mesh


def align_spec_from_numpy(fields) -> AlignSpec:
    """The port's AlignSpec from another AlignSpec's fields: a mapping (or
    any object with the same attributes) of plain numpy arrays and
    numbers."""
    get = (fields.get if isinstance(fields, dict)
           else lambda nm: getattr(fields, nm))
    kw = {}
    for f in dataclasses.fields(AlignSpec):
        v = get(f.name)
        if f.name in ("freq", "score", "table"):
            v = np.array(v, copy=True)
        elif f.name == "reach":
            v = bool(v)
        elif f.name == "ave_corr":
            v = float(v)
        else:
            v = int(v)
        kw[f.name] = v
    spec = AlignSpec(**kw)
    spec.freq = spec.freq.astype(np.float32)
    spec.score = spec.score.astype(np.int16)
    spec.table = spec.table.astype(np.int16)
    return spec


def lanes_from_numpy(seeds, seqmem, device, trace_space=100, L=None,
                     reverse=False):
    """Kernel inputs for the forward wave of each seed.

    seeds: dicts with abase, alen, bbase, blen, diag, anti, flags (the
    engine's seed records).  seqmem: uint8 sequence memory of both sides.
    Returns a dict of int32 [N] tensors abase, bbase, mida, k0, aoffp,
    boffp and the uint8 tensors A and B (the same tensor), all on
    ``device``: ``wave_lanes(**lanes, ts=...)``-ready.  With a window
    length L it also holds the lanes' window starts awst and bwst for the
    ``reverse`` (or forward) wave: ``wave_lanes_persistent(**lanes, L=L,
    reverse=reverse, ...)``-ready."""
    def col(nm):
        return np.array([s[nm] for s in seeds], np.int64)

    aoffp, boffp = trace_offsets(col("flags"), col("alen"), col("blen"),
                                 trace_space)
    cols = dict(abase=col("abase"), bbase=col("bbase"), mida=col("anti"),
                k0=col("diag"), aoffp=aoffp, boffp=boffp)
    out = {nm: torch.from_numpy(np.ascontiguousarray(v, np.int32)).to(device)
           for nm, v in cols.items()}
    out["A"] = out["B"] = torch.from_numpy(
        np.ascontiguousarray(seqmem, np.uint8)).to(device)
    if L is not None:
        out["awst"], out["bwst"] = persistent_windows(
            out["abase"], out["bbase"], out["mida"], out["k0"], len(seqmem),
            len(seqmem), L, reverse)
    return out


def device_index_from_numpy(hi, lo, pos, n, boffs, kmer, rlens, device,
                            nreads=None, max_rlen=None) -> DeviceKmerIndex:
    """The port's DeviceKmerIndex of another index's arrays as numpy: the
    uint32 key planes hi/lo (one int64 key here, ops.device_index
    .join_key), int32 pos, boffs (padding: len(pos) - 1) and rlens
    (padding: 0), the live count n and k.  nreads and max_rlen default to
    the real rows of the read table."""
    cap = len(pos)
    boffs = np.asarray(boffs, np.int32)
    rlens = np.asarray(rlens, np.int32)
    if nreads is None:
        nreads = int((boffs < cap - 1).sum())
    if max_rlen is None:
        max_rlen = int(rlens[:nreads].max()) if nreads else 0

    def up(a, dt):
        return torch.from_numpy(np.array(a, dt)).to(device)

    key = join_key(up(hi, np.int64), up(lo, np.int64))
    return DeviceKmerIndex(key, up(pos, np.int32), int(n), up(boffs, np.int32),
                           int(kmer), up(rlens, np.int32), nreads, max_rlen)


def mesh_like(shape, devices) -> Mesh:
    """The port's mesh of another mesh's shape ({"dp": a, "ref": b}, or a
    tuple) over ``devices`` in order, dp-major: the layout make_mesh gives
    one process."""
    dims = tuple(shape.values()) if isinstance(shape, dict) else tuple(shape)
    devs = list(devices)[:int(np.prod(dims))]
    arr = np.empty(len(devs), dtype=object)
    arr[:] = devs
    return Mesh(arr.reshape(dims), AXES[:len(dims)])

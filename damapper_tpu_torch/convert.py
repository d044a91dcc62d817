"""State carried across from the JAX package.

The mapper has no weights: what a run depends on is the error-model spec
(AlignSpec) and the data.  DAZZ files on disk are shared as they are; these
helpers carry the rest over as plain numpy and ints, so that both packages
see identical inputs."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .ops.spec import AlignSpec
from .ops.wave_engine import trace_offsets
from .ops.wave_persistent import persistent_windows


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

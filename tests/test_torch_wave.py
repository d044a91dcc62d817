"""The port's wave lanes against the JAX package's classic segment driver.

Inputs come from numpy seeds and go unchanged to both packages; every
comparison is exact (integer outputs, tolerance 0).  On the CPU the port's
``wave_lanes`` runs its plain PyTorch version; the CUDA kernel is compared
with that plain version by tests/test_torch_cuda.py (on the card) and by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damapper_tpu.ops.spec import new_align_spec
from damapper_tpu.ops.wave_pallas import make_driver
from damapper_tpu_torch.convert import lanes_from_numpy
from damapper_tpu_torch.ops.wave_cuda import OUT_FIELDS, wave_lanes
from tests.test_wave_jax import make_cases

SPEC = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
CONSTS = (SPEC.trace_space, SPEC.ave_path, SPEC.mscore, SPEC.dscore)
W, P, BW, DBUF, G = 64, 512, 128, 192, 8

_DRIVERS = {}


def _jax_driver(reverse, use_pallas=False, interpret=False):
    key = (reverse, use_pallas, interpret)
    if key not in _DRIVERS:
        _DRIVERS[key] = jax.jit(make_driver(W, P, BW, DBUF, G, reverse,
                                            use_pallas=use_pallas,
                                            interpret=interpret))
    return _DRIVERS[key]


def _run_both(seqmem, insts, reverse, use_pallas=False, interpret=False):
    lanes = lanes_from_numpy(insts, seqmem, "cpu")
    ins = [lanes[nm].numpy() for nm in
           ("abase", "bbase", "mida", "k0", "aoffp", "boffp")]
    j = _jax_driver(reverse, use_pallas, interpret)(
        *(jnp.asarray(x) for x in ins), jnp.asarray(seqmem),
        jnp.asarray(seqmem), *(jnp.int32(c) for c in CONSTS))
    j = {k: np.asarray(v) for k, v in j.items()}
    r = wave_lanes(**lanes, ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2],
                   dsc=CONSTS[3], W=W, P=P, reverse=reverse)
    r = {k: v.numpy() for k, v in r.items()}
    return j, r


def _assert_lanes_equal(j, r):
    jo, ro = j["overflow"].astype(bool), r["overflow"].astype(bool)
    # the port has no sequence window, so it never flags a window reload
    # past the sequence ends: its overflow set is a subset of JAX's
    assert not (ro & ~jo).any(), (np.flatnonzero(ro), np.flatnonzero(jo))
    both = np.flatnonzero(~jo & ~ro)
    for i in both:
        bad = [f for f in OUT_FIELDS if f != "overflow" and j[f][i] != r[f][i]]
        assert not bad, (i, [(f, j[f][i], r[f][i]) for f in bad])
        av = int(r["avail"][i])
        np.testing.assert_array_equal(j["pool"][i][:av], r["pool"][i][:av])
    return len(both)


@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("seed,err,glen,rlen", [(1002, 0.05, 6000, 2500),
                                                (1001, 0.15, 6000, 2500),
                                                (1003, 0.30, 6000, 2500),
                                                (2000, 0.15, 2600, 2500),
                                                (2000, 0.15, 2700, 2400)])
def test_wave_lanes_ref_matches_jax_driver(seed, err, glen, rlen, reverse):
    """(a) The plain version equals the JAX classic segment driver (its XLA
    path) field for field and pool cell for pool cell.  The short genomes
    put the seeds next to the contig ends (boundary clips + REACH).  At
    glen=2600 the JAX driver's reverse window reload runs past the genome
    start on every lane, so there only the overflow-subset rule is
    checkable; glen=2700 holds the reverse boundary lanes field for
    field."""
    seqmem, insts = make_cases(seed, ncases=4, err=err, glen=glen,
                               rlen=rlen)
    j, r = _run_both(seqmem, insts, reverse)
    n = _assert_lanes_equal(j, r)
    if not (glen == 2600 and reverse):
        assert n > 0


def test_wave_lanes_ref_matches_pallas_interpret():
    """(b) The real pallas_call (interpret mode on the CPU) on two lanes,
    both directions."""
    seqmem, insts = make_cases(2000, ncases=2, err=0.15)
    for reverse in (False, True):
        j, r = _run_both(seqmem, insts, reverse, use_pallas=True,
                         interpret=True)
        assert _assert_lanes_equal(j, r) > 0


def test_wave_lanes_wave_cap_flags_overflow():
    """A lane still live at the wave cap is flagged as overflowed (so the
    engine re-aligns it on the oracle), never reported as finished; lanes
    that end below the cap are unchanged."""
    seqmem, insts = make_cases(1001, ncases=4, err=0.15)
    lanes = lanes_from_numpy(insts, seqmem, "cpu")
    args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2], dsc=CONSTS[3],
                W=W, P=P, reverse=False)
    full = wave_lanes(**lanes, **args)
    cap = int(full["waves"].min()) + 1
    capped = wave_lanes(**lanes, **args, max_waves=cap)
    long_ = full["waves"] > cap
    assert long_.any() and (~long_).any()
    assert capped["overflow"][long_].all()
    assert (capped["waves"][long_] == cap).all()
    for f in OUT_FIELDS:
        assert torch.equal(capped[f][~long_], full[f][~long_]), f

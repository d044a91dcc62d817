"""The port's device chain sweep (ops.chain_device) against the JAX
package's (ops.chain_jax) and the host sweeps, on the CPU.

Random hits from a numpy seed go through chain_jax.sweep_hits_device (XLA
on the CPU) and chain_device.sweep_hits_device (PyTorch ops on CPU
tensors): every per-hit state array must be equal (tolerance 0).
ChainState.process_hits(device=True) must push the candidates of the
Python and native host sweeps, in the same order.
"""

import numpy as np
import pytest
import torch

from damapper_tpu.ops import chain_jax
from damapper_tpu_torch.ops import chain_device
from damapper_tpu_torch.ops.chain import ChainState
from damapper_tpu_torch.ops.seeds import SeedHits
from tests.test_chain import _two_expired_chains, dump, random_hits

torch.set_num_threads(1)


def _groups(hits):
    apos1 = np.ascontiguousarray(hits.apos + 1, np.int32)
    bpos1 = np.ascontiguousarray(apos1 - hits.diag, np.int32)
    n = len(apos1)
    brk = np.flatnonzero((np.diff(hits.aread.astype(np.int64)) != 0)
                         | (np.diff(hits.bread.astype(np.int64)) != 0)) + 1
    return (apos1, bpos1, np.concatenate([[0], brk]),
            np.concatenate([brk, [n]]))


def _port_hits(h):
    return SeedHits(h.aread, h.bread, h.apos, h.diag)


@pytest.mark.parametrize("seed", range(4))
def test_sweep_state_matches_jax(seed):
    """Every group's (cost, frm, orig, best, absorbed, expired, estep)
    equals chain_jax's, over buckets of several capacities."""
    rng = np.random.default_rng(500 + seed)
    hits = random_hits(rng, 2500, nreads=4, nctg=3)
    apos1, bpos1, starts, ends = _groups(hits)
    j = chain_jax.sweep_hits_device(apos1, bpos1, starts, ends, 20)
    t = chain_device.sweep_hits_device(apos1, bpos1, starts, ends, 20,
                                       device="cpu")
    assert sorted(j) == sorted(t) and len(t) == len(starts)
    for gi in j:
        for a, b in zip(j[gi], t[gi]):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert (chain_jax.emit_group(j[gi], apos1[starts[gi]:ends[gi]],
                                     bpos1[starts[gi]:ends[gi]],
                                     ends[gi] - starts[gi], 20, 60)
                == chain_device.emit_group(
                    t[gi], apos1[starts[gi]:ends[gi]],
                    bpos1[starts[gi]:ends[gi]], ends[gi] - starts[gi], 20,
                    60))


@pytest.mark.parametrize("seed", range(4))
def test_device_matches_host_sweeps(seed):
    """process_hits(device=True) pushes the Python sweep's and the native
    sweep's candidates."""
    rng = np.random.default_rng(700 + seed)
    hits = _port_hits(random_hits(rng, 3000))
    states = [ChainState(3, kmer=20, device="cpu") for _ in range(3)]
    states[0].process_hits(hits, bstart=5, comp=1, native=False)
    states[1].process_hits(hits, bstart=5, comp=1)
    states[2].process_hits(hits, bstart=5, comp=1, device=True)
    states[1].finish()
    assert dump(states[2]) == dump(states[0]) == dump(states[1])
    assert dump(states[2])


def test_oversized_groups_take_the_native_sweep(monkeypatch):
    """Groups above the device capacity go to the native sweep; the mix
    keeps the host result, order included."""
    monkeypatch.setattr(chain_device, "_MAXC", 256)
    rng = np.random.default_rng(4321)
    hits = _port_hits(random_hits(rng, 5000, nreads=2, nctg=2))
    assert max(np.unique(hits.aread * 2 + hits.bread,
                         return_counts=True)[1]) > 256
    s1 = ChainState(2, kmer=14)
    s1.process_hits(hits, bstart=0, comp=0, native=False)
    s2 = ChainState(2, kmer=14, device="cpu")
    s2.process_hits(hits, bstart=0, comp=0, device=True)
    assert dump(s1) == dump(s2)


def test_multi_pass_accumulation_and_lifo():
    """Candidates accumulate across passes as on the host; two expired
    chains come out in the reference's LIFO order."""
    rng = np.random.default_rng(777)
    h1 = _port_hits(random_hits(rng, 2500))
    h2 = _port_hits(random_hits(rng, 2500))
    s1 = ChainState(3, kmer=14)
    s2 = ChainState(3, kmer=14, device="cpu")
    for h, comp in ((h1, 0), (h2, 1)):
        s1.process_hits(h, bstart=0, comp=comp, native=False)
        s2.process_hits(h, bstart=0, comp=comp, device=True)
    assert dump(s1) == dump(s2)
    st = ChainState(1, kmer=20, device="cpu")
    st.process_hits(_port_hits(_two_expired_chains()), bstart=0, comp=0,
                    device=True)
    assert [c.alast for c in st.cands[0]] == sorted(
        c.alast for c in st.cands[0]) and len(st.cands[0]) == 2


def test_device_sweep_without_card_raises(monkeypatch):
    """The device sweep on the card is asked for by default; with no card
    it raises, never sweeping on the host instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hits = _port_hits(_two_expired_chains())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ChainState(1, kmer=20).process_hits(hits, bstart=0, comp=0,
                                            device=True)

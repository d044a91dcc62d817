"""The port's native candidate push (native/chain_sweep.cpp chain_push,
stacks and -p cover held in C++ across a read block's passes) against its
Python sweep and push (process_hits(native=False)) and against the JAX
package's ChainState, on the CPU.

Every case compares the candidates of every read (order, fields and jumps)
and every read's cover, at tolerance 0.
"""

import numpy as np
import pytest

from damapper_tpu.ops.chain import ChainState as JaxChainState
from damapper_tpu.ops.seeds import SeedHits as JaxSeedHits
from damapper_tpu_torch.ops.chain import MIN_PIECE, ChainState
from damapper_tpu_torch.ops.seeds import SeedHits
from damapper_tpu_torch.utils import spans
from tests.test_chain import _two_expired_chains, dump, random_hits

K = 20


def _states(nreads, rlens=None, **kw):
    """(native, Python, JAX package) states over the same reads."""
    profile = rlens is not None
    return (ChainState(nreads, K, profile=profile, rlens=rlens, **kw),
            ChainState(nreads, K, profile=profile, rlens=rlens, **kw),
            JaxChainState(nreads, K, profile=profile, rlens=rlens, **kw))


def _run(states, passes):
    """Feed every pass (hits, bstart, comp) to the three states."""
    nat, py, jx = states
    for h, bstart, comp in passes:
        nat.process_hits(SeedHits(h.aread, h.bread, h.apos, h.diag),
                         bstart, comp)
        py.process_hits(SeedHits(h.aread, h.bread, h.apos, h.diag),
                        bstart, comp, native=False)
        jx.process_hits(JaxSeedHits(h.aread, h.bread, h.apos, h.diag),
                        bstart, comp, native=False)


def _assert_equal(states):
    nat, py, jx = states
    nat.finish()
    assert dump(nat) == dump(py) == dump(jx)
    if py.cover is None:
        assert nat.cover is None and jx.cover is None
        return
    assert len(nat.cover) == len(py.cover) == len(jx.cover)
    for a, b, c in zip(nat.cover, py.cover, jx.cover):
        assert a.dtype == b.dtype == c.dtype == np.int32
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def _chain(aread, bread, a0, n, diag, step=25):
    """n hits on one diagonal, step apart (>= K): one chain of score n*K
    over A [a0 + 1 - K, a0 + 1 + (n-1)*step]."""
    apos = a0 + step * np.arange(n, dtype=np.int32)
    return (np.full(n, aread, np.int32), np.full(n, bread, np.int32),
            apos.astype(np.int32), np.full(n, diag, np.int32))


def _hits(*chains):
    """The chains' hits sorted by (aread, bread, apos)."""
    aread, bread, apos, diag = (np.concatenate(x) for x in zip(*chains))
    order = np.lexsort((apos, bread, aread))
    return JaxSeedHits(aread[order], bread[order], apos[order], diag[order])


@pytest.mark.parametrize("seed", range(6))
def test_passes_into_one_state(seed):
    """Three reference blocks x both orientations, nonzero bstart, -p on:
    the stacks and covers of all passes equal the Python push's and the
    JAX package's."""
    rng = np.random.default_rng(2200 + seed)
    rlens = rng.integers(20_100, 26_000, 4)
    states = _states(4, rlens)
    passes = [(random_hits(rng, 2500, nreads=4, nctg=3), 3 * blk + 7, comp)
              for blk in range(3) for comp in (0, 1)]
    _run(states, passes)
    assert states[0].ncands() == states[1].ncands() > 0
    _assert_equal(states)


@pytest.mark.parametrize("seed", range(3))
def test_without_profile(seed):
    rng = np.random.default_rng(2300 + seed)
    states = _states(3)
    _run(states, [(random_hits(rng, 3000), 11, comp) for comp in (0, 1)])
    _assert_equal(states)


@pytest.mark.parametrize("cell, value", [("tb", 0x7FFF - 1),
                                         ("te", -0xFFFF + 1)])
def test_cover_caps(cell, value):
    """A cover cell set one short of its cap: the first candidate reaching
    it counts, the next ones leave both cells as they are."""
    rlens = np.array([5000, 5000])
    states = _states(2, rlens)
    # three equal chains starting in cell 10 and ending in cell 31
    chains = [_chain(0, b, 1019, 5, -200 * b, step=500) for b in range(3)]
    tb, te = (1019 + 1 - K) // 100, (1019 + 1 + 4 * 500 - 1) // 100 + 1
    for st in states:
        st.cover[0][tb if cell == "tb" else te] = value
    _run(states, [(_hits(*chains), 0, 0)])
    _assert_equal(states)
    cover = states[0].cover[0]
    if cell == "tb":
        assert cover[tb] == 0x7FFF and cover[te] == -1
    else:
        assert cover[te] == -0xFFFF and cover[tb] == 1


# case: (branch, D's chain, X's chain, candidates left); D is pushed in the
# first pass, X in the second; a chain is (a0, step, hits), 20 a hit
DOMINANCE = {
    # X inside D
    "in_a_dominated_tie": ("in_a", (1000, 222, 10), (1500, 125, 9), 1),
    "in_a_kept": ("in_a", (1000, 200, 11), (1500, 100, 11), 2),
    # D inside X
    "in_b_deleted_tie": ("in_b", (1500, 125, 9), (1000, 222, 10), 1),
    "in_b_kept": ("in_b", (1500, 100, 10), (1000, 200, 11), 2),
    # the same span within MIN_PIECE
    "both_dominated_tie": ("both", (1000, 222, 10), (1100, 200, 9), 1),
    "both_deleted_tie": ("both", (1100, 200, 9), (1000, 222, 10), 1),
    "both_kept": ("both", (1000, 200, 11), (1100, 180, 11), 2),
    "neither": ("neither", (1000, 100, 5), (4000, 100, 9), 2),
}
BRANCH = {"in_a": (True, False), "in_b": (False, True), "both": (True, True),
          "neither": (False, False)}


def _span(a0, step, n):
    return a0 + 1 - K, a0 + 1 + (n - 1) * step


@pytest.mark.parametrize("case", sorted(DOMINANCE))
def test_dominance_branches(case):
    """Each branch of the MIN_PIECE/0.9 rule on hand-built chains, with
    ties exactly at .9 (180 against 200): a dominated X is not pushed, a
    deleted D leaves the stack, the rest stay."""
    branch, d, x, left = DOMINANCE[case]
    (dab, dae), (xab, xae) = _span(*d), _span(*x)
    in_a = dab < xab + MIN_PIECE and dae > xae - MIN_PIECE
    in_b = xab < dab + MIN_PIECE and xae > dae - MIN_PIECE
    assert (in_a, in_b) == BRANCH[branch]
    if "tie" in case:
        assert {d[2] * K, x[2] * K} == {180, 200}
    states = _states(1, np.array([6000]))
    _run(states, [(_hits(_chain(0, 0, d[0], d[2], 0, d[1])), 0, 0),
                  (_hits(_chain(0, 0, x[0], x[2], 0, x[1])), 0, 1)])
    _assert_equal(states)
    cands = states[0].cands[0]
    assert len(cands) == left
    if "dominated" in case:
        assert [c.comp for c in cands] == [0]
    elif "deleted" in case:
        assert [c.comp for c in cands] == [1]
    else:
        assert [c.comp for c in cands] == [1, 0]


def test_a_dominated_push_keeps_its_deletions():
    """X deletes the newer D1 (inside X within MIN_PIECE) and is then
    dominated by the older D0: D1 stays deleted and X is not pushed."""
    states = _states(1, np.array([6000]))
    d0 = _chain(0, 0, 19, 41, 0, 125)       # [0, 5020], score 820
    d1 = _chain(0, 0, 119, 7, 0, 900)       # [100, 5520], score 140
    x = _chain(0, 0, 319, 10, 0, 550)       # [300, 5270], score 200
    _run(states, [(_hits(d0), 0, 0), (_hits(d1), 0, 1), (_hits(x), 5, 0)])
    _assert_equal(states)
    assert [c.score for c in states[0].cands[0]] == [820]


def test_expired_chains_stay_lifo():
    """Two expired chains: candidates in the reference's LIFO order."""
    h = _two_expired_chains()
    states = _states(1, np.array([6000]))
    _run(states, [(h, 0, 0)])
    _assert_equal(states)
    cands = states[0].cands[0]
    assert len(cands) == 2 and cands[0].alast < cands[1].alast


def test_empty_pass_and_a_read_without_hits():
    """An empty pass changes nothing; read 1 has no hits in any pass and
    keeps an empty stack and a zero cover."""
    rng = np.random.default_rng(2400)
    h = random_hits(rng, 2000, nreads=3)
    h = JaxSeedHits(*(np.asarray(a)[h.aread != 1]
                      for a in (h.aread, h.bread, h.apos, h.diag)))
    empty = JaxSeedHits(*(np.zeros(0, np.int32) for _ in range(4)))
    states = _states(3, np.array([20_100] * 3))
    _run(states, [(empty, 0, 0), (h, 2, 0), (empty, 4, 1), (h, 6, 1)])
    _assert_equal(states)
    assert states[0].cands[1] == [] and not states[0].cover[1].any()
    assert states[0].cands[0] and states[0].cands[2]
    only_empty = _states(2, np.array([500, 600]))
    _run(only_empty, [(empty, 0, 0)])
    _assert_equal(only_empty)
    assert only_empty[0].cands == [[], []]


def test_finish_once_then_a_no_op():
    """finish() exports once; a second call changes nothing and counts
    nothing, and the counters of the passes are the sweep's rows."""
    rng = np.random.default_rng(2500)
    passes = [(random_hits(rng, 1500), 1, comp) for comp in (0, 1)]
    spans.begin_call()
    py = ChainState(3, K)
    for h, bstart, comp in passes:
        py.process_hits(SeedHits(h.aread, h.bread, h.apos, h.diag), bstart,
                        comp, native=False)
    py.finish()
    rows = spans.end_call()["counts"]["chain.cands"]
    spans.begin_call()
    nat = ChainState(3, K)
    for h, bstart, comp in passes:
        nat.process_hits(SeedHits(h.aread, h.bread, h.apos, h.diag), bstart,
                         comp)
    kept = nat.ncands()
    nat.finish()
    first = dump(nat)
    nat.finish()
    tot = spans.end_call()
    assert dump(nat) == first == dump(py) and len(first) == kept
    assert tot["counts"] == {"chain.cands": rows, "chain.cands_native": rows,
                             "chain.cands_kept": kept}
    assert rows > kept > 0
    assert tot["spans"]["chain.export"]["n"] == 1
    assert tot["spans"]["chain.sweep"]["n"] == 2
    assert tot["spans"]["chain.push"]["n"] == 2


@pytest.mark.parametrize("seed", range(2))
def test_reading_cands_between_passes(seed):
    """finish() is the only export: reading cands while the native stacks
    are live raises, and so does a native pass after the export; the
    export is the Python push's."""
    rng = np.random.default_rng(2600 + seed)
    rlens = np.array([20_100] * 3)
    states = _states(3, rlens)
    passes = [(random_hits(rng, 2000), 3 * i, i % 2) for i in range(3)]
    _run(states, passes[:2])
    with pytest.raises(RuntimeError, match="finish"):
        states[0].cands
    assert states[0].ncands() == states[1].ncands() > 0
    _assert_equal(states)
    h, bstart, comp = passes[2]
    with pytest.raises(RuntimeError, match="native chain pass"):
        states[0].process_hits(SeedHits(h.aread, h.bread, h.apos, h.diag),
                               bstart, comp)


@pytest.mark.parametrize("threads", [2, 4])
def test_threaded_sweep(monkeypatch, threads):
    """Above 65,536 hits a thread the native sweep splits the groups over
    threads: the result is the one-thread sweep's and the Python push's."""
    from damapper_tpu_torch.ops import chain as port_chain
    rng = np.random.default_rng(2700 + threads)
    h = random_hits(rng, 300_000, nreads=60, nctg=4)
    assert len(h) >= threads * (1 << 16)
    h = SeedHits(h.aread, h.bread, h.apos, h.diag)
    monkeypatch.setattr(port_chain, "SWEEP_THREADS", 1)
    one = ChainState(60, K)
    one.process_hits(h, 3, 1)
    monkeypatch.setattr(port_chain, "SWEEP_THREADS", threads)
    many = ChainState(60, K)
    many.process_hits(h, 3, 1)
    py = ChainState(60, K)
    py.process_hits(h, 3, 1, native=False)
    one.finish()
    many.finish()
    assert dump(many) == dump(one) == dump(py) and dump(py)


@pytest.mark.parametrize("seed", range(2))
def test_export_shares_a_tuple_a_distinct_jump(seed):
    """The export builds one (adisp, bdisp) tuple a distinct pair, over
    more pairs than its table's first size: every jump is a tuple of two
    ints, equal jumps are one object, and the candidates are the Python
    push's."""
    rng = np.random.default_rng(2800 + seed)
    h = random_hits(rng, 150_000, nreads=20, nctg=3)
    h = SeedHits(h.aread, h.bread, h.apos, h.diag)
    nat, py = ChainState(20, K), ChainState(20, K)
    nat.process_hits(h, 2, 0)
    py.process_hits(h, 2, 0, native=False)
    nat.finish()
    assert dump(nat) == dump(py)
    jumps = [j for c in nat.cands for x in c for j in x.jumps]
    assert all(type(j) is tuple and len(j) == 2 and
               all(type(v) is int for v in j) for j in jumps)
    distinct = {j: j for j in jumps}
    assert len(distinct) > 2048
    assert all(j is distinct[j] for j in jumps)

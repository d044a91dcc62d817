"""The port's device index, packed upload and seed match against the JAX
package's, on the CPU.

Every case draws its inputs from a numpy seed and runs damapper_tpu's
ops.device_index (XLA on the CPU) and damapper_tpu_torch's
ops.device_index (PyTorch ops on CPU tensors) on them; the arrays, join
ranges and hits must be equal (tolerance 0), and the index and hits also
equal the port's host path (ops.kmers, ops.seeds).  End to end,
run_damapper with the device index on the CPU writes the .las records (and
-p track bytes) of damapper_tpu's DAMAPPER_INDEX=device run and of the
port's host-index run.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from damapper_tpu.io import db as jdbio
from damapper_tpu.io import fasta
from damapper_tpu.ops import device_index as jdx
from damapper_tpu.pipeline.mapper import DamapperConfig as JaxConfig
from damapper_tpu.pipeline.mapper import run_damapper as jax_run
from damapper_tpu_torch.io import db as tdbio
from damapper_tpu_torch.io import las as tlas
from damapper_tpu_torch.ops import device_index as tdx
from damapper_tpu_torch.ops.kmers import sort_kmers
from damapper_tpu_torch.ops.seeds import match_seeds
from damapper_tpu_torch.pipeline import mapper as tmapper
from damapper_tpu_torch.pipeline import reporter as treporter
from tests import helpers

# xdist workers share the cores: torch's intra-op threads would spin
torch.set_num_threads(1)
CPU = torch.device("cpu")
HITS = ("aread", "bread", "apos", "diag")


def _code(hi, lo):
    return ((np.asarray(hi).astype(np.uint64) << np.uint64(32))
            | np.asarray(lo).astype(np.uint64))


def _load(mod, path):
    db = mod.DazzDB.open(str(path))
    db.trim()
    db.load_bases()
    return db


def _write(tmp, seed, glen, nreads, repeat=False, bsize=None):
    rng = np.random.default_rng(seed)
    if repeat:      # a repetitive genome: large k-mer groups
        genome = helpers.sim_genome(rng, 400) * (glen // 400)
    else:
        genome = helpers.sim_genome(rng, glen)
    half = len(genome) // 2
    entries = [fasta.FastaEntry("ctg0", genome[:half]),
               fasta.FastaEntry("ctg1", genome[half:])]
    reads = [helpers.sim_read(rng, genome, min_len=1200, max_len=4000)[0]
             for _ in range(nreads)]
    jdbio.create_dam(str(tmp / "ref.dam"), entries, bsize=bsize or glen)
    jdbio.create_db(str(tmp / "reads.db"), [
        fasta.FastaEntry(f"r{i}", r) for i, r in enumerate(reads)])


def _add_mask(dbs, seed):
    """The same soft-mask track (one interval a read) on each DB object."""
    rng = np.random.default_rng(seed)
    n = dbs[0].nreads
    anno = np.zeros(n + 1, np.int64)
    data = []
    for i in range(n):
        rl = int(dbs[0].reads["rlen"][i])
        b = int(rng.integers(0, max(1, rl // 2)))
        data += [b, min(rl, b + int(rng.integers(50, 400)))]
        anno[i + 1] = anno[i] + 2
    for db in dbs:
        db.tracks["dust"] = (anno, np.asarray(data, np.int32),
                             np.full(n, 2, np.int32))


@pytest.fixture(scope="module")
def dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dix")
    _write(tmp, 5, 30_000, 8)
    return tmp


def _assert_index(j, t, label=""):
    """damapper_tpu's DeviceKmerIndex j and the port's t: equal entry for
    entry."""
    assert j.n == t.n, label
    np.testing.assert_array_equal(_code(j.hi, j.lo), tdx.key_to_code(t.key),
                                  err_msg=label)
    for f in ("pos", "boffs", "rlens"):
        np.testing.assert_array_equal(np.asarray(getattr(j, f)),
                                      getattr(t, f).numpy(), err_msg=label)


def _assert_hits(a, b, label=""):
    assert len(a) == len(b), label
    for f in HITS:
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f"{label} {f}")


# ---------------------------------------------------------------------------
# index build
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", ["fwd", "comp", "t", "comp_t", "mask",
                                     "comp_mask"])
@pytest.mark.parametrize("kmer", [14, 20, 32])
def test_index_matches_jax_and_host(dbs, kmer, variant):
    """Index arrays equal damapper_tpu's (key, pos, n, boffs, rlens) at
    k=14/20/32, forward and complement, with -t culling and a mask track;
    to_host() equals the host index of the same strand."""
    comp = variant.startswith("comp")
    sup = 2 if variant.endswith("t") else 0
    jd, td, hd = (_load(m, dbs / "reads.db") for m in (jdbio, tdbio, tdbio))
    if variant.endswith("mask"):
        _add_mask([jd, td, hd], kmer)
    j = jdx.device_sort_kmers(jd, kmer, sup, comp=comp)
    t = tdx.device_sort_kmers(td, kmer, sup, comp=comp, device=CPU)
    _assert_index(j, t, f"k={kmer} {variant}")
    if comp:
        hd.complement_inplace()
    host = sort_kmers(hd, kmer, sup)
    got = t.to_host()
    for f in ("code", "read", "rpos"):
        np.testing.assert_array_equal(getattr(got, f), getattr(host, f),
                                      err_msg=f)
    if sup and kmer < 32:   # (no 32-mer repeats in these reads)
        assert t.n < tdx.device_sort_kmers(td, kmer, device=CPU).n


def test_build_index_tight_prefix_matches_full(dbs):
    """The tight-prefix sort equals the full-cap sort and JAX's, both
    orientations, with and without -t."""
    td = _load(tdbio, dbs / "ref.dam")
    jd = _load(jdbio, dbs / "ref.dam")
    seq = tdx.device_upload_seq(td, CPU)
    cap = seq.shape[0]
    rcap = tdx._bucket(td.nreads, lo=1 << 8)
    boffs = np.full(rcap, cap - 1, np.int32)
    boffs[:td.nreads] = td.reads["boff"]
    eoffs = np.full(rcap, cap - 1, np.int32)
    eoffs[:td.nreads] = td.reads["boff"] + td.reads["rlen"]
    mb = np.zeros(0, np.uint8)
    tight = len(td.seq) + 64
    jseq = jdx.device_upload_seq(jd)
    for comp in (False, True):
        for sup in (0, 3):
            args = [torch.from_numpy(a) for a in (boffs, eoffs, mb)]
            full = tdx._build_index(seq, *args, 14, sup, comp, None)
            tt = tdx._build_index(seq, *args, 14, sup, comp, tight)
            for a, b in zip(full, tt):
                assert torch.equal(a, b), (comp, sup)
            jh, jl, jp, jn = jdx._build_index(
                jseq, jnp.asarray(boffs), jnp.asarray(eoffs),
                jnp.asarray(mb), 14, sup, comp, tight)
            np.testing.assert_array_equal(_code(jh, jl),
                                          tdx.key_to_code(tt[0]))
            np.testing.assert_array_equal(np.asarray(jp), tt[1].numpy())
            assert int(jn) == int(tt[2])


@pytest.mark.parametrize("kmer", range(1, 33))
def test_revcomp_codes_matches_jax(kmer):
    """_revcomp_codes on random k-mer codes and the all-ones code equals
    JAX's on uint32 planes."""
    rng = np.random.default_rng(kmer)
    klo = min(kmer, 16)
    khi = kmer - klo
    lo = rng.integers(0, 1 << (2 * klo), 500, dtype=np.uint64)
    hi = (rng.integers(0, 1 << (2 * khi), 500, dtype=np.uint64) if khi
          else np.zeros(500, np.uint64))
    lo[:3] = (1 << (2 * klo)) - 1
    hi[:3] = (1 << (2 * khi)) - 1 if khi else 0
    jh, jl = jdx._revcomp_codes(jnp.asarray(hi.astype(np.uint32)),
                                jnp.asarray(lo.astype(np.uint32)), kmer)
    th, tl = tdx._revcomp_codes(torch.from_numpy(hi.astype(np.int64)),
                                torch.from_numpy(lo.astype(np.int64)), kmer)
    np.testing.assert_array_equal(np.asarray(jh).astype(np.int64), th.numpy())
    np.testing.assert_array_equal(np.asarray(jl).astype(np.int64), tl.numpy())
    # twice is the identity
    bh, bl = tdx._revcomp_codes(th, tl, kmer)
    np.testing.assert_array_equal(bh.numpy(), hi.astype(np.int64))
    np.testing.assert_array_equal(bl.numpy(), lo.astype(np.int64))


# ---------------------------------------------------------------------------
# packed upload
# ---------------------------------------------------------------------------


def _layout(seed, cap, used):
    """A sentinel-layout sequence of random reads in [1, used), its read
    table padded to 256 entries with 0/0."""
    rng = np.random.default_rng(seed)
    starts, ends = [], []
    pos = 1
    seq = np.full(used, 4, np.uint8)
    while pos < used - 1:
        ln = int(rng.integers(40, 600))
        e = min(pos + ln, used - 1)
        starts.append(pos)
        ends.append(e)
        seq[pos:e] = rng.integers(0, 4, e - pos)
        pos = e + 1
    s = np.zeros(256, np.int32)
    e = np.zeros(256, np.int32)
    s[:len(starts)] = starts
    e[:len(ends)] = ends
    return seq, s, e


def test_pack_unpack_matches_jax():
    """pack_seq equals JAX's bytes; _unpack_seq equals JAX's (sentinels
    restored between reads and in the padded tail) and the input; the
    chunked _unpack_seq_scan at a small CL equals it too."""
    cap = 4096
    seq, s, e = _layout(11, cap, 3000)
    packed = tdx.pack_seq(seq, cap)
    np.testing.assert_array_equal(packed, jdx.pack_seq(seq, cap))
    ref = np.asarray(jdx._unpack_seq(jnp.asarray(packed), jnp.asarray(s),
                                     jnp.asarray(e)))
    got = tdx._unpack_seq(torch.from_numpy(packed), torch.from_numpy(s),
                          torch.from_numpy(e)).numpy()
    np.testing.assert_array_equal(ref, got)
    np.testing.assert_array_equal(got[:3000], seq)
    assert (got[3000:] == 4).all()
    for CL in (512, 1024):
        scan = tdx._unpack_seq_scan(torch.from_numpy(packed),
                                    torch.from_numpy(s), torch.from_numpy(e),
                                    CL).numpy()
        np.testing.assert_array_equal(scan, got)
    # every tail length of the last packed word, and an empty sequence
    for n in range(10):
        np.testing.assert_array_equal(tdx.pack_seq(seq[:n], 16),
                                      jdx.pack_seq(seq[:n], 16), str(n))
    with pytest.raises(ValueError, match="> 4"):
        tdx.pack_seq(np.full(8, 5, np.uint8), 8)


def test_unpack_dispatch_and_plain_upload(dbs, monkeypatch):
    """device_upload_seq's plain upload (the default) and packed upload
    (DAMAPPER_PACK_UPLOAD=1) are equal and equal JAX's; unpack_seq_dev
    takes the chunked form past its threshold (same bytes)."""
    td = _load(tdbio, dbs / "reads.db")
    assert not tdx.packed_upload_on()
    plain = tdx.device_upload_seq(td, CPU)
    np.testing.assert_array_equal(
        plain.numpy(), np.asarray(jdx.device_upload_seq(_load(
            jdbio, dbs / "reads.db"))))
    monkeypatch.setenv("DAMAPPER_PACK_UPLOAD", "1")
    assert tdx.packed_upload_on()
    packed = tdx.device_upload_seq(td, CPU)
    assert torch.equal(packed, plain)
    monkeypatch.setattr(tdx, "_UNPACK_CHUNK_ABOVE", 1 << 12)
    monkeypatch.setattr(tdx, "_UNPACK_CL", 1 << 12)
    assert torch.equal(tdx.device_upload_seq(td, CPU), packed)


def test_align_upload_section_and_cache_key(dbs, monkeypatch):
    """The align stage's section is the plain bytes by default; its packed
    section (DAMAPPER_PACK_UPLOAD=1) is the plain bytes followed by a
    sentinel tail; the reference copy's cache keys on the upload format."""
    td = _load(tdbio, dbs / "ref.dam")
    monkeypatch.setattr(treporter, "_ref_seq_cache", {})
    n = len(td.seq)
    plain = treporter._upload_section(td.seq, td.reads["boff"],
                                      td.reads["rlen"], CPU)
    np.testing.assert_array_equal(plain.numpy(), td.seq)
    monkeypatch.setenv("DAMAPPER_PACK_UPLOAD", "1")
    got = treporter._upload_section(td.seq, td.reads["boff"],
                                    td.reads["rlen"], CPU)
    assert got.shape[0] == tdx._bucket(n) > n
    np.testing.assert_array_equal(got[:n].numpy(), td.seq)
    assert (got[n:] == 4).all()
    a = treporter._ref_seq_cached(td, CPU)
    assert treporter._ref_seq_cached(td, CPU) is a
    assert a.shape[0] == tdx._bucket(n)
    monkeypatch.delenv("DAMAPPER_PACK_UPLOAD")
    b = treporter._ref_seq_cached(td, CPU)
    assert b is not a and b.shape[0] == n
    np.testing.assert_array_equal(b.numpy(), td.seq)


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------


def _keys(rng, nreal, cap, maxk, ones=0):
    """Sorted (hi, lo) planes of nreal random keys (ones of them the
    all-ones code, as real k=32 all-T windows) padded with sentinels."""
    hi = rng.integers(0, maxk, nreal).astype(np.uint32)
    lo = rng.integers(0, 4, nreal).astype(np.uint32)
    hi[:ones] = lo[:ones] = 0xFFFFFFFF
    hi[ones:ones + 3] = 0xFFFFFFFF         # next to the all-ones code
    lo[ones:ones + 3] = 0xFFFFFFFE
    o = np.lexsort((lo, hi))
    H = np.full(cap, 0xFFFFFFFF, np.uint32)
    L = np.full(cap, 0xFFFFFFFF, np.uint32)
    H[:nreal], L[:nreal] = hi[o], lo[o]
    return H, L


def _tkey(h, l):
    return torch.from_numpy(_code(h, l).view(np.int64)) ^ tdx._SIGN


def _join_inputs(seed):
    rng = np.random.default_rng(seed)
    qh, ql = _keys(rng, 700, 1024, 90, ones=2)
    q2h, q2l = _keys(rng, 650, 1024, 90, ones=1)
    bh, bl = _keys(rng, 1500, 2048, 90, ones=3)
    return (qh, ql), (q2h, q2l), (bh, bl), 1500


MODES = ("merge", "scan", "sortg", "sort", "bsearch")


@pytest.mark.parametrize("split", [False, True], ids=["one", "qsplit"])
@pytest.mark.parametrize("mode", MODES)
def test_join_mode_matches_jax(mode, split):
    """_join_ranges in each mode equals JAX's in that mode: duplicate keys,
    real all-ones keys, sentinel padding (clamped to bn); qsplit: the query
    is two sorted halves (the pair join)."""
    (qh, ql), (q2h, q2l), (bh, bl), bn = _join_inputs(17)
    if split:
        qh, ql = np.concatenate([qh, q2h]), np.concatenate([ql, q2l])
    qsplit = 1024 if split else None
    jlo, jhi = jdx._join_ranges(jnp.asarray(bh), jnp.asarray(bl),
                                jnp.int32(bn), jnp.asarray(qh),
                                jnp.asarray(ql), mode, qsplit=qsplit)
    tlo, thi = tdx._join_ranges(_tkey(bh, bl), bn, _tkey(qh, ql), mode,
                                qsplit=qsplit)
    assert tlo.dtype == thi.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(jlo), tlo.numpy())
    np.testing.assert_array_equal(np.asarray(jhi), thi.numpy())
    # the all-ones real keys of the query find the b side's three
    assert (thi - tlo).numpy()[int(np.argmax(
        _code(qh, ql) == np.uint64(2**64 - 1)))] == 3


def test_join_modes_agree(monkeypatch):
    """The five modes, the merge's qsplit pre-merge and the sort join's
    giant-query branch (two planes; forced by a small slot-id bound) give
    the same ranges, equal to a plain searchsorted.  The merge takes a
    sorted query, or two sorted halves with qsplit."""
    (qh, ql), (q2h, q2l), (bh, bl), bn = _join_inputs(23)
    q = _tkey(np.concatenate([qh, q2h]), np.concatenate([ql, q2l]))
    b = _tkey(bh, bl)
    want = (torch.searchsorted(b, q).clamp_max(bn),
            torch.searchsorted(b, q, right=True).clamp_max(bn))
    runs = {m: tdx._join_ranges(b, bn, q, m) for m in MODES if m != "merge"}
    runs["merge_qsplit"] = tdx._join_ranges(b, bn, q, "merge", qsplit=1024)
    monkeypatch.setattr(tdx, "_SLOT_ID_MAX", 1000)
    runs["sort_giant"] = tdx._join_ranges(b, bn, q, "sort")
    for name, (lo, hi) in runs.items():
        assert torch.equal(lo.long(), want[0]), name
        assert torch.equal(hi.long(), want[1]), name
    lo, hi = tdx._join_ranges(b, bn, q[:1024], "merge")
    assert torch.equal(lo.long(), want[0][:1024])
    assert torch.equal(hi.long(), want[1][:1024])


def test_bitonic_merge_sorts():
    """A bitonic (key, payload) sequence, ascending then descending in the
    pair order, comes out sorted."""
    rng = np.random.default_rng(3)
    key = rng.integers(-50, 50, 1024).astype(np.int64)
    pay = rng.permutation(1024).astype(np.int32)
    o = np.lexsort((pay, key))
    o = np.concatenate([o[:600], o[600:][::-1]])
    k, p = tdx._bitonic_merge(torch.from_numpy(key[o]),
                              torch.from_numpy(pay[o]))
    want = np.lexsort((pay, key))
    np.testing.assert_array_equal(k.numpy(), key[want])
    np.testing.assert_array_equal(p.numpy(), pay[want])


# ---------------------------------------------------------------------------
# seed matching
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def match_dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dix_match")
    _write(tmp, 11, 40_000, 10)
    return tmp


def _indexes(path, k):
    """(JAX indexes, port indexes) of reads fwd, reads revcomp, ref fwd."""
    jr, jd = _load(jdbio, path / "reads.db"), _load(jdbio, path / "ref.dam")
    tr, td = _load(tdbio, path / "reads.db"), _load(tdbio, path / "ref.dam")
    j = (jdx.device_sort_kmers(jr, k), jdx.device_sort_kmers(jr, k, comp=True),
         jdx.device_sort_kmers(jd, k))
    t = (tdx.device_sort_kmers(tr, k, device=CPU),
         tdx.device_sort_kmers(tr, k, comp=True, device=CPU),
         tdx.device_sort_kmers(td, k, device=CPU))
    return j, t


@pytest.mark.parametrize("join", MODES)
def test_match_seeds_matches_jax_and_host(match_dbs, monkeypatch, join):
    """device_match_seeds (forward and comp frame) and the pair match
    equal JAX's hits in content and order and the host match_seeds (comp:
    against the complemented reference), with and without -M, under every
    join."""
    monkeypatch.setenv("DAMAPPER_JOIN", join)
    k = 16
    (ja, jc, jb), (ta, tc, tb) = _indexes(match_dbs, k)
    tr = _load(tdbio, match_dbs / "reads.db")
    tref = _load(tdbio, match_dbs / "ref.dam")
    ha = sort_kmers(tr, k)
    hb = sort_kmers(tref, k)
    tref.complement_inplace()
    hbc = sort_kmers(tref, k)
    for mem in (0, 1 << 34):
        tf = tdx.device_match_seeds(ta, tb, mem, 1000)
        tcf = tdx.device_match_seeds(tc, tb, mem, 1000, comp_frame=True)
        _assert_hits(jdx.device_match_seeds(ja, jb, mem, 1000), tf, "fwd")
        _assert_hits(jdx.device_match_seeds(jc, jb, mem, 1000,
                                            comp_frame=True), tcf, "comp")
        _assert_hits(match_seeds(ha, hb, mem, 1000), tf, "host fwd")
        _assert_hits(match_seeds(ha, hbc, mem, 1000), tcf, "host comp")
        pf, pc = tdx.device_match_seeds_pair(ta, tc, tb, mem, 1000)
        _assert_hits(tf, pf, "pair fwd")
        _assert_hits(tcf, pc, "pair comp")
        assert len(tf) > 0 and len(tcf) > 0


def test_match_count_arrays_match_jax(match_dbs):
    """Pass 1's arrays (b_lo, cb, ct, the -M histogram), the -M limit and
    the emission buffer equal JAX's entry for entry (pad rows included)."""
    k = 16
    (ja, jc, jb), (ta, tc, tb) = _indexes(match_dbs, k)
    jout = jdx._match_count(ja.hi, ja.lo, jb.hi, jb.lo, jnp.int32(ja.n),
                            jnp.int32(jb.n), True, "merge", None)
    tout = tdx._match_count(ta.key, tb.key, ta.n, tb.n, True, "merge", None)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    gram = tout[3]
    assert int(gram.sum()) > 0
    for avail in (0, 5, 100, 10 ** 9):
        assert int(jdx._device_limit(jout[3], jnp.int32(avail))) == \
            int(tdx._device_limit(gram, avail))
    # the comp-frame emission buffer of the reads' revcomp index
    j_lo, j_cb, j_ct, _ = jdx._match_count(jc.hi, jc.lo, jb.hi, jb.lo,
                                           jnp.int32(jc.n), jnp.int32(jb.n),
                                           False, "sort", None)
    _, j_cum, j_total = jdx._match_emit_prep(j_cb, j_ct, jnp.int32(10 ** 9))
    ncap = tdx._bucket(int(j_total))
    jbuf = jdx._match_emit_comp(jc.pos, jc.boffs, jc.rlens, jb.pos, jb.boffs,
                                jb.rlens, j_lo, j_cum, ncap, k, k)
    c_lo, c_cb, c_ct, _ = tdx._match_count(tc.key, tb.key, tc.n, tb.n,
                                           False, "sort", None)
    _, c_cum, _ = tdx._match_emit_prep(c_cb, c_ct, torch.tensor(10 ** 9))
    tbuf = tdx._match_emit_comp(tc.pos, tc.boffs, tc.rlens, tb.pos, tb.boffs,
                                tb.rlens, c_lo, c_cum, ncap, k, k,
                                (tc.nreads, tb.nreads, tc.max_rlen,
                                 tb.max_rlen))
    assert ncap > int(j_total)
    np.testing.assert_array_equal(np.asarray(jbuf), tbuf.numpy())


def test_int32_wrap_matches_jax():
    """The -M governor's running sum and the emission cumsum wrap as JAX's
    int32 does; the -M group cost is JAX's clamped float32 product."""
    rng = np.random.default_rng(1)
    gram = rng.integers(0, 1 << 20, tdx.MAXGRAM).astype(np.int32)
    for avail in (0, 1 << 20, 2 ** 31 - 1):
        assert int(jdx._device_limit(jnp.asarray(gram), jnp.int32(avail))) \
            == int(tdx._device_limit(torch.from_numpy(gram), avail))
    cb = np.array([1 << 30, 1 << 30, 3, 1 << 30, 0, 7], np.int32)
    ct = np.array([1, 2, 3, 4, 5, 6], np.int32)
    js, jc, jt = jdx._match_emit_prep(jnp.asarray(cb), jnp.asarray(ct),
                                      jnp.int32(5))
    ts, tc, tt = tdx._match_emit_prep(torch.from_numpy(cb),
                                      torch.from_numpy(ct), torch.tensor(5))
    np.testing.assert_array_equal(np.asarray(jc), tc.numpy())
    assert int(jt) == int(tt) < 0
    key = torch.from_numpy(np.repeat(np.arange(3), [70000, 2, 5]))
    b_lo = torch.zeros(70007, dtype=torch.int32)
    b_hi = torch.full((70007,), 40000, dtype=torch.int32)
    cbt, ctt, _ = tdx._count_epilogue(key, 70007, b_lo, b_hi, False)
    assert int(ctt[0]) == int(np.float32(0x7FFFFF00)) and int(ctt[-1]) == \
        200000


@pytest.fixture(scope="module")
def repeat_dbs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_dix_repeat")
    _write(tmp, 3, 16_000, 6, repeat=True)
    return tmp


def test_match_governor_and_memory_error(repeat_dbs, match_dbs):
    """-M on a repetitive genome: a budget that engages the histogram's
    limit gives JAX's and the host's hit set, and a budget below zero
    JAX's (which clamps it to zero: groups of cost 1 decide, and here
    there are none).  A zero budget with unique k-mer pairs raises
    MemoryError in all three."""
    k = 14
    for path in (repeat_dbs, match_dbs):
        jr, jd = (_load(jdbio, path / f) for f in ("reads.db", "ref.dam"))
        tr, td = (_load(tdbio, path / f) for f in ("reads.db", "ref.dam"))
        ja, jb = jdx.device_sort_kmers(jr, k), jdx.device_sort_kmers(jd, k)
        ta = tdx.device_sort_kmers(tr, k, device=CPU)
        tb = tdx.device_sort_kmers(td, k, device=CPU)
        ha, hb = sort_kmers(tr, k), sort_kmers(td, k)
        db_bytes = tr.sizeof() + td.sizeof()
        if path is repeat_dbs:
            mem = db_bytes + 16 * (len(ha) + 2 * len(hb)) + (64 << 10)
            t = tdx.device_match_seeds(ta, tb, mem, db_bytes)
            assert 0 < len(t) < len(tdx.device_match_seeds(ta, tb, 0, 0))
            _assert_hits(jdx.device_match_seeds(ja, jb, mem, db_bytes), t,
                         "jax")
            _assert_hits(match_seeds(ha, hb, mem, db_bytes), t, "host")
            _assert_hits(jdx.device_match_seeds(ja, jb, db_bytes, db_bytes),
                         tdx.device_match_seeds(ta, tb, db_bytes, db_bytes),
                         "negative budget")
            continue
        zero = db_bytes + 16 * (len(ha) + len(hb))
        for fn, a, b in ((jdx.device_match_seeds, ja, jb),
                         (tdx.device_match_seeds, ta, tb),
                         (match_seeds, ha, hb)):
            with pytest.raises(MemoryError):
                fn(a, b, zero, db_bytes)


def test_lex_order_passes_equal_composite():
    """The stable LSD passes give the composite key's order."""
    rng = np.random.default_rng(9)
    cols = [torch.from_numpy(rng.integers(0, 1 << b, 5000))
            for b in (3, 5, 4)]
    a = tdx._lex_order(cols, [3, 5, 4])
    b = tdx._lex_order(cols, [30, 30, 30])
    assert torch.equal(a, b)
    want = np.lexsort([c.numpy() for c in cols[::-1]], axis=0)
    np.testing.assert_array_equal(a.numpy(), want)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _write_mask_track(dbfile, track, seed):
    """A reference-format soft-mask track: one or two intervals a read."""
    db = jdbio.DazzDB.open(str(dbfile))
    rng = np.random.default_rng(seed)
    anno = np.zeros(db.nreads + 1, np.int64)
    chunks, total = [], 0
    for r, L in enumerate(db.reads["rlen"]):
        b = int(rng.integers(0, int(L) // 2))
        iv = [b, min(int(L), b + int(rng.integers(100, 600)))]
        if r % 2:
            iv += [min(int(L) - 1, iv[1] + 300), int(L)]
        anno[r] = 4 * total
        chunks.append(np.asarray(iv, np.int32))
        total += len(iv)
    anno[db.nreads] = 4 * total
    jdbio.write_track(db.path, track, anno, np.concatenate(chunks).tobytes(),
                      0)


@pytest.fixture(scope="module")
def mapping(tmp_path_factory):
    from tests.test_torch_pipeline import _write_dataset
    tmp = tmp_path_factory.mktemp("torch_dix_map")
    _write_dataset(tmp)
    for dbf in ("ref.dam", "refmb.dam", "reads.db"):
        _write_mask_track(tmp / dbf, "msk", 7)
    return tmp


VARIANTS = {
    "default_p": dict(profile=True),
    "C": dict(do_b=True),
    "n95": dict(best_tie=.95),
    "t": dict(suppress=6),
    "mask": dict(masks=["msk"]),
    "multiblock": {},
    "chain_device": dict(chain_backend="device"),
    "packed_upload": {},
}


def _records(paths, out_dir, profile):
    got = []
    for p in paths:
        if p is not None:
            recs, tspace = tlas.read_las(p)
            got.append((tspace, [r.key() for r in recs]))
    if profile:
        got.append([(out_dir / f".reads{e}").read_bytes()
                    for e in (".prof.anno", ".prof.data")])
    return got


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_run_damapper_device_index_matches_jax(mapping, monkeypatch,
                                               variant):
    """run_damapper with index_backend="device" on the CPU: .las records
    identical (-p bytes identical) to damapper_tpu's DAMAPPER_INDEX=device
    run and to the port's host-index run.  The default and packed_upload
    variants align through the wave engine (plain, and with
    DAMAPPER_PACK_UPLOAD=1 packed, uploads), the others through the host
    oracle."""
    monkeypatch.setattr(tmapper, "_ref_index_cache", {})
    monkeypatch.setattr(tmapper, "_ref_index_cache_bytes", [0])
    kw = VARIANTS[variant]
    if variant == "packed_upload":
        monkeypatch.setenv("DAMAPPER_PACK_UPLOAD", "1")
    ref = str(mapping / ("refmb.dam" if variant == "multiblock"
                         else "ref.dam"))
    reads = str(mapping / "reads.db")
    outs = {}
    for nm in ("jax", "device", "host"):
        d = mapping / f"{variant}_{nm}"
        d.mkdir()
        if nm == "jax":
            paths = jax_run(ref, reads, JaxConfig(
                wave_backend="oracle", index_backend="device", mesh=None,
                **kw), out_dir=str(d))
        else:
            wave = (dict(host_min=0) if variant in ("default_p",
                                                    "packed_upload") and
                    nm == "device" else dict(wave_backend="oracle"))
            paths = tmapper.run_damapper(ref, reads, tmapper.DamapperConfig(
                device="cpu", index_backend=nm, **wave, **kw),
                out_dir=str(d))
            st = tmapper.LAST_STATS
            assert st["index_backend"] == nm
            assert st["chain_backend"] == kw.get("chain_backend", "host")
            if nm == "device":
                nblk = 2 if variant == "multiblock" else 1
                assert st["ref_index_builds"] == nblk
                assert st["ref_index_cache_hits"] == 0
                if "host_min" in wave:
                    assert st["n_lanes"] > 0 and st["n_hostmin"] == 0
        outs[nm] = _records(paths, d, kw.get("profile"))
    assert outs["jax"][0][1], "no record mapped"
    assert outs["device"] == outs["jax"]
    assert outs["device"] == outs["host"]


def test_ref_index_cache(mapping, monkeypatch):
    """The reference-index cache: a hit on the second call; a miss after a
    .bps rewrite of another size whose mtime is restored; none with
    DAMAPPER_REFCACHE=0.  Every run writes the same records."""
    monkeypatch.setattr(tmapper, "_ref_index_cache", {})
    monkeypatch.setattr(tmapper, "_ref_index_cache_bytes", [0])
    import shutil
    root = mapping / "cache"
    root.mkdir()
    for f in os.listdir(mapping):
        if (f.startswith(("ref.", ".ref.", "reads.", ".reads."))
                and (mapping / f).is_file()):
            shutil.copy2(mapping / f, root / f)
    cfg = tmapper.DamapperConfig(device="cpu", index_backend="device",
                                 wave_backend="oracle")

    def run(tag):
        d = root / tag
        d.mkdir()
        a, _ = tmapper.run_damapper(str(root / "ref.dam"),
                                    str(root / "reads.db"), cfg,
                                    out_dir=str(d))
        st = tmapper.LAST_STATS
        return (st["ref_index_builds"], st["ref_index_cache_hits"],
                _records([a], d, False))

    b1, h1, r1 = run("first")
    assert (b1, h1) == (1, 0)
    assert run("second")[:2] == (0, 1)
    bps = root / ".ref.bps"
    st = os.stat(bps)
    with open(bps, "ab") as fp:
        fp.write(b"\0")
    os.utime(bps, ns=(st.st_atime_ns, st.st_mtime_ns))
    assert os.stat(bps).st_mtime_ns == st.st_mtime_ns
    b3, h3, r3 = run("rewritten")
    assert (b3, h3) == (1, 0) and r3 == r1
    monkeypatch.setenv("DAMAPPER_REFCACHE", "0")
    assert run("off1")[:2] == (1, 0)
    assert run("off2")[:2] == (1, 0)


def test_index_backend_choice(monkeypatch):
    """The backends: the argument, then DAMAPPER_INDEX / DAMAPPER_CHAIN,
    then host on the CPU; unknown names raise."""
    monkeypatch.delenv("DAMAPPER_INDEX", raising=False)
    monkeypatch.delenv("DAMAPPER_CHAIN", raising=False)
    cfg = tmapper.DamapperConfig(device="cpu")
    assert (cfg.index_backend, cfg.chain_backend) == ("host", "host")
    monkeypatch.setenv("DAMAPPER_INDEX", "device")
    monkeypatch.setenv("DAMAPPER_CHAIN", "device")
    cfg = tmapper.DamapperConfig(device="cpu")
    assert (cfg.index_backend, cfg.chain_backend) == ("device", "device")
    cfg = tmapper.DamapperConfig(device="cpu", index_backend="host",
                                 chain_backend="host")
    assert (cfg.index_backend, cfg.chain_backend) == ("host", "host")
    with pytest.raises(ValueError, match="index_backend"):
        tmapper.DamapperConfig(device="cpu", index_backend="gpu")


def test_join_mode_rejects_unknown(monkeypatch):
    """DAMAPPER_JOIN: bsearch by default, each of the five modes taken as
    named, any other value raised when a device-index run is configured
    and when a join runs (a typo never picks a join of its own)."""
    monkeypatch.delenv("DAMAPPER_JOIN", raising=False)
    assert tdx._join_mode() == "bsearch"
    for mode in MODES:
        monkeypatch.setenv("DAMAPPER_JOIN", mode)
        assert tdx._join_mode() == mode
    monkeypatch.setenv("DAMAPPER_JOIN", "bsaerch")
    with pytest.raises(ValueError, match="DAMAPPER_JOIN"):
        tdx._join_mode()
    with pytest.raises(ValueError, match="DAMAPPER_JOIN"):
        tmapper.DamapperConfig(device="cpu", index_backend="device")
    cfg = tmapper.DamapperConfig(device="cpu", index_backend="host")
    assert cfg.index_backend == "host"

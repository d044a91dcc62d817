"""The CUDA kernels (wave, op-cost probes) against their plain PyTorch
versions, on the card, and the device index, chain sweep and mesh path on
the card against their CPU runs.

These tests need a CUDA card and skip without one.  They import nothing of
JAX, so they run on a machine that has only PyTorch:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from damapper_tpu_torch.convert import lanes_from_numpy
from damapper_tpu_torch.ops import probes
from damapper_tpu_torch.ops.spec import new_align_spec
from damapper_tpu_torch.ops.wave_cuda import (IN_FIELDS, LAYOUTS, OUT_FIELDS,
                                              pack_record, wave_lanes,
                                              wave_lanes_ref)
from damapper_tpu_torch.ops.wave_persistent import (
    lanes_per_sm, persistent_windows, ring_bytes, wave_lanes_persistent,
    wave_lanes_persistent_ref, window_length)
from damapper_tpu_torch.utils.sim import (make_adversarial_lane_cases,
                                          make_lane_cases,
                                          make_long_lane_cases)

SPEC = new_align_spec(0.85, 100, [.25, .25, .25, .25], True)
CONSTS = (SPEC.trace_space, SPEC.ave_path, SPEC.mscore, SPEC.dscore)
P = 512
# ring geometries (chunk bytes, slots a window) the persistent kernels are
# held at: the shipped one (None), one 128-byte slot (every chunk edge an
# advance, every long run past the ring), four, and sixteen 2 KB chunks
RINGS = (None, (128, 1), (128, 4), (2048, 16))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU build")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_wave_kernel_matches_plain_version_on_card(cuda_device, reverse):
    """Each classic kernel (plain, packed, lanepack) equals the plain
    version on the same CUDA tensors, at W=128 (the card's band) and W=64
    (lanepack: W=64 only).  Seven lanes: the last lane-packed block has one
    idle half.  The packed kernel also takes a ready-made record."""
    seqmem, insts = make_lane_cases(1000, 7, err=0.15)
    lanes = lanes_from_numpy(insts, seqmem, cuda_device)
    for w in (64, 128):
        args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2],
                    dsc=CONSTS[3], W=w, P=P, reverse=reverse)
        r = wave_lanes_ref(**lanes, **args)
        rec = pack_record([lanes[nm] for nm in IN_FIELDS])
        runs = [(lay, {}) for lay in LAYOUTS if w == 64 or lay != "lanepack"]
        for layout, kw in runs + [("packed", dict(record=rec))]:
            cnt = "launches_" + layout
            launches = getattr(wave_lanes, cnt)
            k = wave_lanes(**lanes, **args, layout=layout, **kw)
            torch.cuda.synchronize()
            assert getattr(wave_lanes, cnt) == launches + 1
            _assert_equal(k, r, len(insts))


def _assert_equal(k, r, n):
    for f in OUT_FIELDS:
        assert torch.equal(k[f], r[f]), f
    for i in range(n):
        av = int(r["avail"][i])
        assert torch.equal(k["pool"][i, :av], r["pool"][i, :av]), i


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("small", [False, True], ids=["L", "L1024"])
def test_persistent_kernels_match_plain_version_on_card(cuda_device, reverse,
                                                        small):
    """Each persistent kernel (plain, packed, lanepack; packed also from a
    ready-made record), at every ring geometry of RINGS, equals the plain
    version on the same CUDA tensors.  Seven lanes of 0.3-2.5 kb reads.
    L1024 is too small for the longer reads: window misses."""
    seqmem, insts = make_lane_cases(1000, 7, err=0.15, mix=True, rmin=300)
    lanes = lanes_from_numpy(insts, seqmem, cuda_device)
    L = 1024 if small else window_length(max(s["blen"] for s in insts))
    args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2], dsc=CONSTS[3],
                W=64, P=P, L=L, reverse=reverse)
    r = wave_lanes_persistent_ref(**lanes, **args)
    assert r["overflow"].any() == small
    aw, bw = persistent_windows(lanes["abase"], lanes["bbase"], lanes["mida"],
                                lanes["k0"], len(seqmem), len(seqmem), L,
                                reverse)
    rec = pack_record([lanes[nm] for nm in IN_FIELDS] + [aw, bw])
    runs = [(lay, {}) for lay in LAYOUTS] + [("packed", dict(record=rec))]
    for layout, kw in runs:
        for ring in RINGS:
            cnt = "launches_" + layout
            launches = getattr(wave_lanes_persistent, cnt)
            k = wave_lanes_persistent(**lanes, **args, layout=layout,
                                      ring=ring, **kw)
            torch.cuda.synchronize()
            assert getattr(wave_lanes_persistent, cnt) == launches + 1
            _assert_equal(k, r, len(insts))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_wave_kernels_match_plain_version_on_adversarial_lanes(cuda_device,
                                                               reverse):
    """All six wave kernels on the adversarial set (exact repeats, exact
    runs of 60-600 bases, seeds next to the memory's ends): the classic
    ones at W=128 and W=64, the persistent ones at every ring geometry of
    RINGS (the exact runs walk across chunk edges and past the ring)."""
    seqmem, insts = make_adversarial_lane_cases(7)
    lanes = lanes_from_numpy(insts, seqmem, cuda_device)
    for w in (64, 128):
        args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2],
                    dsc=CONSTS[3], W=w, P=P, reverse=reverse)
        r = wave_lanes_ref(**lanes, **args)
        for layout in LAYOUTS:
            if w == 64 or layout != "lanepack":
                _assert_equal(wave_lanes(**lanes, **args, layout=layout), r,
                              len(insts))
    L = window_length(max(s["blen"] for s in insts))
    args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2], dsc=CONSTS[3],
                W=64, P=P, L=L, reverse=reverse)
    r = wave_lanes_persistent_ref(**lanes, **args)
    for layout in LAYOUTS:
        for ring in RINGS:
            _assert_equal(wave_lanes_persistent(**lanes, **args,
                                                layout=layout, ring=ring), r,
                          len(insts))


# the plain version's results, once per lane set and direction
_REFS = {}


def _lanepack_set(name):
    """(seqmem, insts, copies, P) of a lane-packed test set: n<N> is N lanes
    of 0.3-2.5 kb reads (1,024: 128 of them 8 times over), "apart" lanes of
    0.2-6 kb reads that end hundreds of waves apart, "adversarial" the
    adversarial set, "miss" 3-9 kb reads (run against 2,048-base windows),
    "long" 40-45 kb reads (65,536-base windows, a 2,048-row pool)."""
    if name.startswith("n"):
        n = int(name[1:])
        base = min(n, 128)
        seqmem, insts = make_lane_cases(2000 + n, base, err=0.15, mix=True,
                                        rmin=300)
        return seqmem, insts, n // base, P
    if name == "apart":
        return (*make_lane_cases(3000, 9, rlen=6000, rmin=200, mix=True,
                                 err=0.15), 1, P)
    if name == "adversarial":
        return (*make_adversarial_lane_cases(7), 1, P)
    if name == "miss":
        return (*make_lane_cases(1000, 33, glen=200_000, rlen=9000,
                                 rmin=3000, mix=True, err=0.15), 1, P)
    seqmem, insts, _ = make_long_lane_cases(1002, 8)
    return seqmem, insts, 1, 2048


def _tile(d, copies, fields):
    return {f: (v.repeat(copies, *[1] * (v.dim() - 1)) if f in fields
                else v) for f, v in d.items()}


def _lanepack_ref(name, reverse, L, dev):
    """The set's lanes (each copy), its plain version's result (tiled) and
    its pool size, for the classic kernel (L None) or the persistent one."""
    key = (name, reverse, L)
    if key not in _REFS:
        seqmem, insts, copies, Pn = _lanepack_set(name)
        lanes = lanes_from_numpy(insts, seqmem, dev, L=L, reverse=reverse)
        args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2],
                    dsc=CONSTS[3], W=64, P=Pn, reverse=reverse)
        r = (wave_lanes_ref(**lanes, **args) if L is None else
             wave_lanes_persistent_ref(**lanes, **args, L=L))
        fields = IN_FIELDS + ("awst", "bwst")
        _REFS[key] = (_tile(lanes, copies, fields),
                      _tile(r, copies, (*OUT_FIELDS, "pool")), args)
    return _REFS[key]


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("name", ["n1", "n7", "n33", "n1024", "apart",
                                  "adversarial"])
def test_lanepack_kernels_match_plain_version(cuda_device, name, reverse):
    """Rows 3 and 6 (one lane a 64-thread block) equal their plain versions
    at 1, 7, 33 and 1,024 lanes, on lanes of one launch that end hundreds
    of waves apart, and on the adversarial set (drop trips, clips); row 6
    at the shipped ring and at one 128-byte slot a window."""
    lanes, r, args = _lanepack_ref(name, reverse, None, cuda_device)
    if name == "apart" and not reverse:
        assert int(r["waves"].max() - r["waves"].min()) > 200
    k = wave_lanes(**lanes, **args, layout="lanepack")
    torch.cuda.synchronize()
    _assert_equal(k, r, int(r["waves"].shape[0]))
    _, insts, _, _ = _lanepack_set(name)
    L = window_length(max(s["blen"] for s in insts))
    lanes, r, args = _lanepack_ref(name, reverse, L, cuda_device)
    for ring in (None, (128, 1)):
        k = wave_lanes_persistent(**lanes, **args, L=L, layout="lanepack",
                                  ring=ring)
        torch.cuda.synchronize()
        _assert_equal(k, r, int(r["waves"].shape[0]))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("name,L", [("miss", 2048), ("long", 65536)])
def test_lanepack_persistent_windows(cuda_device, name, L, reverse):
    """Row 6 on window misses (3-9 kb reads against 2,048-base windows: the
    kernel flags them as its plain version does) and on 40-45 kb reads,
    whose 65,536-base windows take the same ring as short ones (the shared
    memory a lane asks for does not grow with L); the classic row 3 on the
    long reads too."""
    lanes, r, args = _lanepack_ref(name, reverse, L, cuda_device)
    if name == "miss":
        assert bool(r["overflow"].any())
    assert ring_bytes() <= 16 * 1024
    for ring in (None, (128, 2)):
        k = wave_lanes_persistent(**lanes, **args, L=L, layout="lanepack",
                                  ring=ring)
        torch.cuda.synchronize()
        _assert_equal(k, r, int(r["waves"].shape[0]))
    if name == "long":
        lanes, r, args = _lanepack_ref(name, reverse, None, cuda_device)
        _assert_equal(wave_lanes(**lanes, **args, layout="lanepack"), r,
                      int(r["waves"].shape[0]))


def _phase3_set(name):
    """chip_smoke.py phase 3's persistent sets, seed 42: (seqmem, insts, L,
    P).  "reads" 128 lanes of 3-9 kb reads, "ends" 32 seeds next to contig
    ends, "long" 8 lanes of 40-45 kb reads (L = 65,536), "miss" the reads
    against 2,048-base windows, "adversarial" the adversarial set."""
    def with_L(cases, Pn=P):
        seqmem, insts = cases
        return seqmem, insts, window_length(max(s["blen"]
                                                for s in insts)), Pn
    if name in ("reads", "miss"):
        seqmem, insts, L, Pn = with_L(make_lane_cases(
            42, 128, glen=200_000, rlen=9000, rmin=3000, mix=True,
            err=0.15))
        return seqmem, insts, (2048 if name == "miss" else L), Pn
    if name == "ends":
        return with_L(make_lane_cases(43, 32, glen=9400, rlen=9000,
                                      rmin=8500, mix=True, err=0.15))
    if name == "long":
        seqmem, insts, L = make_long_lane_cases(44, 8)
        return seqmem, insts, L, 2048
    return with_L(make_adversarial_lane_cases(42))


def _persistent_all_layouts(lanes, args, r, n, rings=(None,)):
    """Every layout (packed also from a ready-made record) at each ring
    equals the plain version's result r; each launch is counted."""
    rec = pack_record([lanes[f] for f in IN_FIELDS + ("awst", "bwst")])
    runs = [(lay, {}) for lay in LAYOUTS] + [("packed", dict(record=rec))]
    for layout, kw in runs:
        for ring in rings:
            cnt = "launches_" + layout
            launches = getattr(wave_lanes_persistent, cnt)
            k = wave_lanes_persistent(**lanes, **args, layout=layout,
                                      ring=ring, **kw)
            torch.cuda.synchronize()
            assert getattr(wave_lanes_persistent, cnt) == launches + 1
            _assert_equal(k, r, n)


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("name", ["reads", "ends", "long", "miss",
                                  "adversarial"])
def test_persistent_kernels_on_phase3_sets(cuda_device, name, reverse):
    """Rows 4-6 on chip smoke's phase-3 sets (the reads, seeds next to
    contig ends, 40-45 kb reads at L = 65,536, the reads against 2,048-base
    windows, the adversarial set), plain, packed and lane-packed at the
    shipped ring: max abs error 0 against the plain version."""
    seqmem, insts, L, Pn = _phase3_set(name)
    lanes = lanes_from_numpy(insts, seqmem, cuda_device, L=L,
                             reverse=reverse)
    args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2], dsc=CONSTS[3],
                W=64, P=Pn, L=L, reverse=reverse)
    r = wave_lanes_persistent_ref(**lanes, **args)
    if name == "miss":
        assert bool(r["overflow"].any())
    _persistent_all_layouts(lanes, args, r, len(insts))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("L", [2048, 4096, 16384, 65536, 131072])
def test_persistent_kernels_at_every_window_length(cuda_device, L, reverse):
    """Rows 4-6 at window lengths 2,048 to 131,072 on 33 lanes of 0.3-6 kb
    reads in a memory whose length is no multiple of 16: the windows of the
    last reads run past the memory's end (their tail reads 4 in place), the
    shortest windows miss; at the shipped ring and at one 128-byte slot."""
    seqmem, insts = make_lane_cases(4000 + L // 128, 33, glen=60_000,
                                    rlen=6000, rmin=300, mix=True, err=0.15)
    seqmem = np.concatenate([seqmem, np.full(7, 4, np.uint8)])
    assert len(seqmem) % 16
    lanes = lanes_from_numpy(insts, seqmem, cuda_device, L=L,
                             reverse=reverse)
    args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2], dsc=CONSTS[3],
                W=64, P=P, L=L, reverse=reverse)
    r = wave_lanes_persistent_ref(**lanes, **args)
    if L == 2048:
        assert bool(r["overflow"].any())
    _persistent_all_layouts(lanes, args, r, len(insts),
                            rings=(None, (128, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_persistent_kernels_on_unaligned_sequence_views(cuda_device,
                                                        reverse):
    """Rows 4-6 on sequence memories that are views at byte offsets 1-15
    of a larger tensor (no 16-byte alignment: no bulk copy, every read in
    place) and at offset 16 (aligned again: the ring), against the plain
    version on the same views."""
    seqmem, insts = make_lane_cases(5000, 7, err=0.15, mix=True, rmin=300)
    L = window_length(max(s["blen"] for s in insts))
    base = torch.full((len(seqmem) + 32,), 4, dtype=torch.uint8,
                      device=cuda_device)
    lanes = lanes_from_numpy(insts, seqmem, cuda_device, L=L,
                             reverse=reverse)
    args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2], dsc=CONSTS[3],
                W=64, P=P, L=L, reverse=reverse)
    r = wave_lanes_persistent_ref(**lanes, **args)
    for off in range(1, 17):
        view = base[off:off + len(seqmem)]
        view.copy_(lanes["A"])
        assert (view.data_ptr() % 16 == 0) == (off == 16)
        _persistent_all_layouts(dict(lanes, A=view, B=view), args, r,
                                len(insts), rings=(None, (128, 1)))


@pytest.mark.cuda
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
def test_persistent_kernels_on_1024_long_lanes(cuda_device, reverse):
    """Rows 4-6 on 1,024 lanes of 40-45 kb reads (8 lanes 128 times over,
    L = 65,536): a launch of more long lanes than the card holds at once,
    each taking the ring's shared memory, not its 128 KB window's."""
    seqmem, insts, L = make_long_lane_cases(1002, 8)
    lanes = lanes_from_numpy(insts, seqmem, cuda_device, L=L,
                             reverse=reverse)
    args = dict(ts=CONSTS[0], pave=CONSTS[1], msc=CONSTS[2], dsc=CONSTS[3],
                W=64, P=2048, L=L, reverse=reverse)
    r = wave_lanes_persistent_ref(**lanes, **args)
    fields = IN_FIELDS + ("awst", "bwst")
    _persistent_all_layouts(_tile(lanes, 128, fields), args,
                            _tile(r, 128, (*OUT_FIELDS, "pool")), 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["plain", "packed"])
def test_persistent_lanes_per_sm_do_not_fall_with_the_window(cuda_device,
                                                             layout):
    """The lanes an SM holds of the shipped kernel at L = 65,536 are no
    fewer than at L = 16,384 (the ring's shared memory does not grow with
    the window), and as many as with one 128-byte slot a window: shared
    memory does not set them."""
    for reverse in (False, True):
        at = {L: lanes_per_sm(L, layout, reverse) for L in (16384, 65536)}
        assert at[65536] >= at[16384] > 0
        assert at[65536] == lanes_per_sm(65536, layout, reverse,
                                         ring=(128, 1))


# (W, barrier policy) of each probe kernel, as its launchers serve them
PROBE_CASES = {
    "floor": [(64, "block"), (64, "warp"), (128, "block"), (128, "warp"),
              (256, "block"), (256, "warp")],
    "ops": [(64, "block"), (64, "warp"), (128, "block"), (128, "warp")],
    "carry": [(64, "block"), (64, "warp"), (128, "block"), (128, "warp")]}


def _seeded(seed, shape, dev):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2**31, 2**31, shape, dtype=np.int64)
                            .astype(np.int32)).to(dev)


def _probe_runs(kind, x, s, n, barrier):
    """(wrapper, name, kernel call, plain call) of every pattern of one
    probe kernel."""
    if kind == "floor":
        return [(probes.floor_probe, v, lambda v=v: probes.floor_probe(
            x, n, 96, v, barrier), lambda v=v: (probes.floor_probe_ref(
                x, n, 96, v),)) for v in probes.FLOOR_VARIANTS]
    if kind == "ops":
        return [(probes.ops_probe, p, lambda p=p: probes.ops_probe(
            x, s, n, 28, p, barrier), lambda p=p: probes.ops_probe_ref(
                x, s, n, 28, p)) for p in probes.OPS_PATTERNS]
    return [(probes.carry_probe, b, lambda b=b: probes.carry_probe(
        x, n, b, barrier), lambda b=b: probes.carry_probe_ref(x, n, b))
        for b in probes.CARRY_BODIES]


@pytest.mark.cuda
@pytest.mark.parametrize("G", [9, 128])
@pytest.mark.parametrize("kind,W,barrier", [
    (k, W, b) for k, cases in PROBE_CASES.items() for W, b in cases])
def test_probe_kernels_match_plain_version_on_card(cuda_device, kind, W,
                                                   barrier, G):
    """Every pattern of each probe kernel equals its plain version
    (torch.equal) on seeded int32 inputs under each policy the kernel
    serves.  G=9: the last warp-policy block (four rows) has warps past
    G.  At G=128 the low bits
    of s run through every residue of s & (W-1) (the grab's column).  Each
    launch is counted."""
    n = 4
    x = _seeded(1, (G, W), cuda_device)
    s = _seeded(2, (G, 1), cuda_device)
    if G == 128:
        s = (s & ~(W - 1)) | (torch.arange(G, device=cuda_device,
                                           dtype=torch.int32)[:, None] % W)
    for neg in (False, True) if kind == "ops" else (False,):
        si = -s.abs() if neg else s
        for wrapper, name, kernel, plain in _probe_runs(kind, x, si, n,
                                                        barrier):
            launches = wrapper.launches
            k = kernel()
            torch.cuda.synchronize()
            assert wrapper.launches == launches + 1
            k = k if isinstance(k, tuple) else (k,)
            for a, b in zip(k, plain()):
                assert torch.equal(a, b), (name, neg)


def _small_dbs(tmp, seed=5, glen=40_000, nreads=10):
    """A two-contig reference and simulated reads, written with the port's
    own io and loaded."""
    from damapper_tpu_torch.io import db as dbio
    from damapper_tpu_torch.io import fasta
    from damapper_tpu_torch.utils.sim import sim_genome, sim_read
    rng = np.random.default_rng(seed)
    g = sim_genome(rng, glen)
    dbio.create_dam(str(tmp / "ref.dam"),
                    [fasta.FastaEntry("c0", g[:glen // 2]),
                     fasta.FastaEntry("c1", g[glen // 2:])], bsize=glen)
    dbio.create_db(str(tmp / "reads.db"), [
        fasta.FastaEntry(f"r{i}", sim_read(rng, g, min_len=1500,
                                           max_len=4000)[0])
        for i in range(nreads)])
    out = []
    for f in ("reads.db", "ref.dam"):
        db = dbio.DazzDB.open(str(tmp / f))
        db.trim()
        db.load_bases()
        out.append(db)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("join", ["merge", "scan", "sortg", "sort",
                                  "bsearch"])
def test_device_index_and_hits_on_card_equal_cpu(cuda_device, tmp_path,
                                                 monkeypatch, join):
    """The packed upload, the index (forward, revcomp, -t) and the hits of
    both orientations on CUDA tensors equal the same functions' run on CPU
    tensors, under every join."""
    from damapper_tpu_torch.ops import device_index as dix
    monkeypatch.setenv("DAMAPPER_JOIN", join)
    reads, ref = _small_dbs(tmp_path)
    runs = {}
    for dev in ("cpu", cuda_device):
        seq = dix.device_upload_seq(reads, dev)
        assert seq.device.type == torch.device(dev).type
        idx = [dix.device_sort_kmers(reads, 16, seq_dev=seq),
               dix.device_sort_kmers(reads, 16, comp=True, seq_dev=seq),
               dix.device_sort_kmers(ref, 16, device=dev),
               dix.device_sort_kmers(reads, 12, 3, device=dev)]
        hits = dix.device_match_seeds_pair(*idx[:3], 1 << 34, 1000)
        runs[str(dev)] = (seq.cpu(), [(i.key.cpu(), i.pos.cpu(), i.n)
                                      for i in idx], hits)
    (sa, ia, ha), (sb, ib, hb) = runs.values()
    assert torch.equal(sa, sb)
    for a, b in zip(ia, ib):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        assert a[2] == b[2]
    for x, y in zip(ha, hb):
        assert len(x) > 0
        for f in ("aread", "bread", "apos", "diag"):
            assert np.array_equal(getattr(x, f), getattr(y, f)), f


@pytest.mark.cuda
def test_device_chain_sweep_on_card_equals_cpu(cuda_device):
    """The device chain sweep's state on CUDA equals its CPU run."""
    from damapper_tpu_torch.ops import chain_device
    rng = np.random.default_rng(3)
    starts = np.array([0, 300, 310, 1500])
    ends = np.array([300, 310, 1500, 1600])
    apos1 = np.concatenate([np.sort(rng.integers(25, 9000, e - s))
                            for s, e in zip(starts, ends)]).astype(np.int32)
    bpos1 = (apos1 - rng.integers(-50, 50, len(apos1))).astype(np.int32)
    a = chain_device.sweep_hits_device(apos1, bpos1, starts, ends, 20,
                                       device="cpu")
    b = chain_device.sweep_hits_device(apos1, bpos1, starts, ends, 20,
                                       device=cuda_device)
    assert sorted(a) == sorted(b) == [0, 1, 2, 3]
    for gi in a:
        for x, y in zip(a[gi], b[gi]):
            assert np.array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 2), (1, 8)],
                         ids=lambda s: f"dp{s[0]}_ref{s[1]}")
def test_sharded_match_on_card_virtual_shards_equals_cpu(cuda_device,
                                                        tmp_path, shape):
    """The sharded match on eight virtual shards of the card equals its run
    on virtual shards of the CPU and the card's single-device match, in
    both frames."""
    from damapper_tpu_torch.convert import mesh_like
    from damapper_tpu_torch.ops import device_index as dix
    reads, ref = _small_dbs(tmp_path)
    runs = {}
    for dev in ("cpu", cuda_device):
        mesh = mesh_like(shape, [dev] * 8)
        f, c, b = (dix.device_sort_kmers(reads, 16, device=dev),
                   dix.device_sort_kmers(reads, 16, comp=True, device=dev),
                   dix.device_sort_kmers(ref, 16, device=dev))
        bs = dix.shard_index(b, mesh, "ref")
        runs[str(dev)] = [dix.device_match_seeds_sharded(
            dix.shard_index(a, mesh, "dp"), bs, mesh, 1 << 34, 1000,
            comp_frame=comp) for a, comp in ((f, False), (c, True))]
        if dev is cuda_device:
            single = [dix.device_match_seeds(a, b, 1 << 34, 1000,
                                             comp_frame=comp)
                      for a, comp in ((f, False), (c, True))]
    for x, y, z in zip(runs["cpu"], runs[str(cuda_device)], single):
        assert len(x) > 0
        for fld in ("aread", "bread", "apos", "diag"):
            assert np.array_equal(getattr(x, fld), getattr(y, fld)), fld
            assert np.array_equal(getattr(z, fld), getattr(y, fld)), fld


@pytest.mark.cuda
def test_dp_sharded_engine_on_card_equals_unsharded(cuda_device):
    """The wave engine on a dp mesh of 3 virtual shards of the card gives
    the unsharded engine's paths, one classic launch a shard a round."""
    from damapper_tpu_torch.ops.wave_engine import WaveEngine
    from damapper_tpu_torch.parallel.mesh import Mesh
    seqmem, insts = make_lane_cases(2024, 50, err=0.15)
    outs = {}
    for nm, mesh in (("single", None),
                     ("dp3", Mesh(np.array([cuda_device] * 3, object),
                                  ("dp",)))):
        eng = WaveEngine(SPEC, device=cuda_device, host_min=0, mesh=mesh)
        mem = eng.upload(seqmem)
        res = eng.local_alignment_batch(mem, mem, seqmem, seqmem, insts)
        outs[nm] = ([(p.abpos, p.bbpos, p.aepos, p.bepos, p.diffs,
                      list(p.trace)) for pair in res for p in pair],
                    eng.total_waves, eng.n_fallback)
        outs[nm + "_launches"] = eng.launches["wave_lanes"]
    assert outs["dp3"] == outs["single"]
    assert outs["dp3_launches"] == 3 * outs["single_launches"] > 0


@pytest.mark.cuda
def test_dryrun_multichip_on_card(cuda_device):
    """The real-mapper dryrun on eight virtual shards of the card: the
    (4, 2) mesh run's .las equals the single-device run's (asserted
    inside), and its wave ran on the classic kernel."""
    from damapper_tpu_torch.parallel.mesh import dryrun_multichip
    out = dryrun_multichip(8)
    assert out["records"] > 0
    assert out["mesh"]["mesh"] == {"dp": 4, "ref": 2}
    assert out["mesh"]["kernel_launches"]["wave_lanes"] > 0

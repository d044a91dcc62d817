"""The generator and the DAZZ writers: determinism, the read model's
rates, DBsplit's blocks, and files equal to the program's own writer."""

import filecmp
import hashlib
import json
import pathlib
import tracemalloc

import numpy as np
import pytest

from benchmark import dazz, gen
from conftest import REPO, TINY_CONFIG, TINY_TRAFFIC

MODEL = {"read_len": {"mean": 6000, "sd": 1500, "min": 3000},
         "error_rate": 0.15, "ins_share": 0.55, "del_share": 0.25,
         "block_bases": 400_000}
GENOME = {"contigs": [["x", 700_000], ["y", 20_000], ["z", 1_280_000]]}


def test_same_seed_same_bytes_other_seed_other_bytes():
    a = gen.draw_cell(2**40 + 3, TINY_CONFIG, TINY_TRAFFIC)
    b = gen.draw_cell(2**40 + 3, TINY_CONFIG, TINY_TRAFFIC)
    c = gen.draw_cell(2**40 + 4, TINY_CONFIG, TINY_TRAFFIC)
    assert np.array_equal(a[0].seq, b[0].seq)
    for x, y in zip(a[1], b[1]):
        assert np.array_equal(x.seq, y.seq)
        assert np.array_equal(x.offs, y.offs)
    assert not np.array_equal(a[0].seq, c[0].seq)
    assert not np.array_equal(a[1][0].seq, c[1][0].seq)


@pytest.mark.parametrize("seed", [-1, 0, 2**31 + 5, 2**70])
def test_any_whole_number_is_a_seed(seed):
    g, blocks = gen.draw_cell(seed, TINY_CONFIG, TINY_TRAFFIC)
    assert len(g.seq) == sum(c[1] for c in TINY_CONFIG["contigs"])
    assert g.names == [c[0] for c in TINY_CONFIG["contigs"]]
    assert len(blocks) == TINY_TRAFFIC["distinct_blocks"]


def _within(observed, n, p, sigmas=5.0):
    return abs(observed - n * p) <= sigmas * np.sqrt(n * p * (1 - p))


def test_error_model_rates():
    rng = np.random.default_rng(11)
    n = 2_000_000
    frag = rng.integers(0, 4, size=n, dtype=np.uint8)
    out, count = gen._error_pass(np.random.default_rng(12), frag.copy(),
                                 0.15, 0.55, 0.25)
    assert _within(int((count == 2).sum()), n, 0.15 * 0.55)
    assert _within(int((count == 0).sum()), n, 0.15 * 0.25)
    # a substitution keeps one base and changes it: the kept bases are the
    # last of each base's run of output
    ends = np.cumsum(count)
    kept = count > 0
    changed = int((out[ends[kept] - 1] != frag[kept]).sum())
    assert _within(changed, n, 0.15 * 0.20)
    assert len(out) == int(count.sum())


def test_reads_lengths_orientation_and_truth():
    g = gen.draw_genome(gen.seed_sequence(5), GENOME)
    blk = gen.draw_block(gen.seed_sequence(6), g, MODEL)
    assert blk.lens.sum() >= MODEL["block_bases"]
    assert blk.lens[:-1].sum() < MODEL["block_bases"]
    assert 0.35 < blk.comp.mean() < 0.65
    assert (blk.start >= 0).all()
    assert (blk.start + MODEL["read_len"]["min"]
            <= g.lens[blk.contig]).all()
    # reads land on contigs in proportion to their length
    share = np.bincount(blk.contig, minlength=3) / blk.nreads
    assert share[2] > share[0] > share[1]
    # a read's bases resemble its true fragment: most of its 12-mers occur
    # in the fragment's strand
    i = int(np.flatnonzero(~blk.comp)[0])
    read = blk.read(i)
    frag = g.contig(int(blk.contig[i]))[blk.start[i]:blk.start[i] + 9000]
    k = 12
    def kmers(s):
        return {s[j:j + k].tobytes() for j in range(len(s) - k + 1)}
    shared = len(kmers(read) & kmers(frag)) / (len(read) - k + 1)
    assert shared > 0.05


def test_dazz_files_equal_the_programs_writer(tmp_path):
    from damapper_tpu_torch.io import db as dbio
    from damapper_tpu_torch.io import fasta
    g = gen.draw_genome(gen.seed_sequence(5), GENOME)
    t = dict(MODEL, read_len={"mean": 600, "sd": 150, "min": 300},
             block_bases=50_000)
    blocks = [gen.draw_block(gen.seed_sequence(s), g, t) for s in (7, 8)]
    dazz.write_dam(str(tmp_path / "a" / "ref"), g, 1_000_000)
    dazz.write_reads(str(tmp_path / "a" / "reads"), blocks, 50_000)
    ents = [fasta.FastaEntry(g.names[i],
                             dbio.numeric_to_seq(g.contig(i)).upper())
            for i in range(g.ncontigs)]
    dbio.create_dam(str(tmp_path / "b" / "ref.dam"), ents, bsize=1_000_000)
    reads = [b.read(j) for b in blocks for j in range(b.nreads)]
    dbio.create_db(str(tmp_path / "b" / "reads.db"),
                   [fasta.FastaEntry(f"r{i}", dbio.numeric_to_seq(r).upper())
                    for i, r in enumerate(reads)], bsize=50_000)
    names = sorted(p.name for p in (tmp_path / "a").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "b").iterdir())
    for name in names:
        assert filecmp.cmp(tmp_path / "a" / name, tmp_path / "b" / name,
                           shallow=False), name


def test_lognormal_lengths_keep_their_mean_sd_and_minimum():
    model = {"mean": 10000, "sd": 2000, "min": 4000}
    ln = gen.draw_lengths(np.random.default_rng(3), 200_000, model)
    kept = ln[ln > 0]
    # under 4,000 lies 3 sd below the mean: about 0.1% of the draws
    assert 0.998 * len(ln) < len(kept) < len(ln)
    assert kept.min() >= 4000
    assert abs(kept.mean() - 10000) < 5 * 2000 / np.sqrt(len(kept))
    assert abs(kept.std() - 2000) < 40


def test_repeat_copies_cover_their_share_and_repeat_kmers():
    cls = {"name": "rep", "genome_share": 0.05, "families": 4,
           "consensus_len": [1000, 3000], "copy_len_min": 500,
           "divergence": [0.0, 0.02]}
    rng = np.random.default_rng(9)
    seq = rng.integers(0, 4, size=2_000_000, dtype=np.uint8)
    flat = seq.copy()
    placed = gen.place_repeats(rng, seq, cls)
    assert placed >= 0.05 * len(seq)
    # copies overlap one another a little: most of what they wrote landed
    changed = int((seq != flat).sum())
    assert 0.035 * len(seq) < changed < 0.05 * len(seq)
    # a uniform genome of 2 Mb repeats no 20-mer three times; with the
    # copies (~8 kb of consensus over 100 kb) thousands occur that often
    def repeated(s, k=20):
        codes = np.zeros(len(s) - k + 1, np.int64)
        for x in range(k):
            codes = codes * 4 + s[x:len(s) - k + 1 + x]
        _, counts = np.unique(codes, return_counts=True)
        return int((counts > 2).sum())
    assert repeated(flat) == 0
    assert repeated(seq) > 5_000


# --- the same bytes as the generator and writers always gave ----------------

DMEL = json.loads((REPO / "benchmark" / "configs" / "dmel_140M.json")
                  .read_text())
GRCH38 = json.loads((pathlib.Path(__file__).parent / "grch38_shape.json")
                    .read_text())
CLR = json.loads((REPO / "benchmark" / "traffic" / "clr_rb200M.json")
                 .read_text())
SIX_CLASSES = dict(GRCH38, contigs=[["c1", 900_001], ["c2", 600_002],
                                    ["c3", 300_003]],
                   ref_block_bases=1_000_000)
#: name: (configuration, BATCH_BASES)
DIGEST_CASES = {
    # dm6's arms at a 64th of their lengths, with their TE class
    "dmel_140M/64": (dict(DMEL, contigs=[[c, n // 64]
                                         for c, n in DMEL["contigs"]],
                          ref_block_bases=1_000_000), gen.BATCH_BASES),
    # the six classes of the GRCh38 shape on contigs whose lengths are
    # no multiple of 4 (the writers' padding)
    "six_classes": (SIX_CLASSES, gen.BATCH_BASES),
    # the same in batches of 64 kb: each class places its copies over many
    # batches, as the full-size genomes do
    "six_classes/batch64k": (SIX_CLASSES, 65_536),
}
DIGEST_TRAFFIC = dict(CLR, block_bases=200_000, distinct_blocks=2)
DIGEST_SEEDS = (0, 3000000201, 2**63 + 11)


def cell_digests(cfg: dict, traffic: dict, seed: int, root) -> dict:
    """SHA-256 of the genome's bases and of every file write_dam and
    write_reads write for one cell and seed."""
    g, blocks = gen.draw_cell(seed, cfg, traffic)
    dazz.write_dam(str(root / "ref"), g, int(cfg["ref_block_bases"]))
    dazz.write_reads(str(root / "reads"), blocks,
                     int(traffic["block_bases"]))
    out = {"genome.seq": hashlib.sha256(g.seq.tobytes()).hexdigest()}
    for p in sorted(root.iterdir()):
        out[p.name] = hashlib.sha256(p.read_bytes()).hexdigest()
    return out


#: "<case> <seed>": cell_digests, computed with the generator and writers
#: as they were before their index arithmetic was narrowed (per-base int64
#: arrays)
GOLDEN = json.loads((pathlib.Path(__file__).parent / "bytes_golden.json")
                    .read_text())


@pytest.mark.parametrize("case", sorted(DIGEST_CASES))
@pytest.mark.parametrize("seed", DIGEST_SEEDS)
def test_the_same_bytes_as_before(case, seed, tmp_path, monkeypatch):
    cfg, batch = DIGEST_CASES[case]
    monkeypatch.setattr(gen, "BATCH_BASES", batch)
    got = cell_digests(cfg, DIGEST_TRAFFIC, seed, tmp_path)
    assert got == GOLDEN[f"{case} {seed}"]


@pytest.mark.parametrize("n", [0, 1, 4, 5, 8, 9, 4099, 100_003])
def test_uniform_bases_are_the_calls_bases_from_raw_words(n):
    a, b = np.random.default_rng(n), np.random.default_rng(n)
    want = a.integers(0, 4, size=n, dtype=np.uint8)
    assert np.array_equal(gen._raw_bases(b.bit_generator, n), want)
    assert b.bit_generator.state == a.bit_generator.state
    assert np.array_equal(b.integers(0, 4, size=9, dtype=np.uint8),
                          a.integers(0, 4, size=9, dtype=np.uint8))


def test_uniform_bases_raise_where_numpy_draws_otherwise():
    class OtherDraws:
        """A generator whose integers are not the top bits of its words."""
        def __init__(self):
            self.bit_generator = np.random.PCG64(7)

        def integers(self, lo, hi, size, dtype):
            self.bit_generator.random_raw(size)
            return np.zeros(size, dtype)

    rng = OtherDraws()
    start = rng.bit_generator.state
    with pytest.raises(RuntimeError, match="numpy"):
        gen.uniform_bases(rng, 100)
    assert rng.bit_generator.state == start


def _padded_reads(n: int):
    """A 2-bit sequence of about n bases cut into reads of 1-20 kb, none
    of a length a multiple of 4: (seq, offs)."""
    rng = np.random.default_rng(4)
    lens = 4 * rng.integers(250, 5000, size=n // 10_000 + 2) \
        + rng.integers(1, 4, size=n // 10_000 + 2)
    lens = lens[:int(np.searchsorted(np.cumsum(lens), n)) + 1]
    offs = np.concatenate([[0], np.cumsum(lens)])
    return rng.integers(0, 4, size=int(offs[-1]), dtype=np.uint8), offs


@pytest.mark.parametrize("step", ["pack", "base_freq"])
def test_the_writers_stay_under_3_bytes_a_base(step):
    seq, offs = _padded_reads(64 << 20)
    tracemalloc.start()
    try:
        if step == "pack":
            dazz._pack(seq, offs)
        else:
            dazz.base_freq(seq)
        peak = tracemalloc.get_traced_memory()[1]
    finally:
        tracemalloc.stop()
    assert peak < 3 * len(seq), peak / len(seq)

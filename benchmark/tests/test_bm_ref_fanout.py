"""The plain reference's reads on a pool of host processes give the very
answers of its serial run, the control's included."""

import hashlib

import pytest
import torch

from benchmark import check, dazz, gen
from test_bm_ref import CONTROL_CONFIG, CONTROL_TRAFFIC

#: 13 sampled reads over 2 read blocks, against 2 reference blocks in both
#: orientations, with -p; the control differs from the reference in 2 reads
SEED = 4
TRAFFIC = dict(CONTROL_TRAFFIC, check_reads=12)
#: SHA-256 of the answers in order of their keys, as the reference gave them
#: when one ChainState held every sampled read of a block
SOUND_SHA = "fcf1a26fec72e5123cbad320e26bc8a1decaa9fd673474436b73b6f725cc5e8f"
CONTROL_SHA = "0ab4ccf8ea572c50de6a5ce2dd0e3b80afb091641ea00837ca43e225c80a4079"


def sha256(answers):
    return hashlib.sha256(repr(sorted(answers.items())).encode()).hexdigest()


@pytest.fixture(scope="module")
def answer(tmp_path_factory):
    """answer(control, workers): the reference's answers for the cell."""
    work = tmp_path_factory.mktemp("fanout")
    genome, blocks = gen.draw_cell(SEED, CONTROL_CONFIG, TRAFFIC)
    ref_cut = dazz.write_dam(str(work / "ref"), genome,
                             CONTROL_CONFIG["ref_block_bases"])
    read_cut = dazz.write_reads(str(work / "reads"), blocks,
                                TRAFFIC["block_bases"])
    sample = check.draw_sample(SEED, TRAFFIC, blocks, range(len(blocks)))
    assert len(ref_cut) - 1 >= 2 and len({b for b, _ in sample}) == 2
    assert len(sample) >= 12
    memo = {}

    def get(control, workers):
        if (control, workers) not in memo:
            memo[control, workers] = check.reference_answers(
                sample, genome, blocks, ref_cut, read_cut,
                CONTROL_CONFIG["options"], work, torch.device("cpu"),
                control=control, workers=workers)
        return memo[control, workers]
    return get


@pytest.mark.parametrize("workers", [1, 2, 3])
def test_the_pool_gives_the_serial_answers(answer, workers):
    got = answer(False, workers)
    assert got == answer(False, 1)
    assert sha256(got) == SOUND_SHA
    assert all(recs and prof for recs, prof in got.values())


@pytest.mark.parametrize("workers", [1, 3])
def test_the_workers_run_the_control(answer, workers):
    got = answer(True, workers)
    assert got == answer(True, 1)
    assert sha256(got) == CONTROL_SHA
    # the control's lag reached the workers: it differs where it should
    reads, _ = check.compare(got, answer(False, 1))
    assert reads >= 1

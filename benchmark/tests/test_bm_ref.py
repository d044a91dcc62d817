"""The plain reference and its control: a changed record or -p value is
found, and the control (the wave's give-up lag cut) fails the comparison."""

import pytest
import torch

from benchmark import check, control, dazz, gen
from conftest import TINY_CONFIG

#: big enough that the control's shorter give-up lag changes some reads
CONTROL_TRAFFIC = {"name": "ctl",
                   "read_len": {"mean": 6000, "sd": 2000, "min": 3000},
                   "error_rate": 0.15,
                   "ins_share": 0.55, "del_share": 0.25,
                   "block_bases": 150_000, "distinct_blocks": 2,
                   "check_reads": 40}
CONTROL_CONFIG = dict(TINY_CONFIG, contigs=[[f"c{i}", 500_000]
                                            for i in range(4)],
                      ref_block_bases=1_000_000)


@pytest.fixture(scope="module")
def answers(tmp_path_factory):
    work = tmp_path_factory.mktemp("ref")
    traffic = dict(CONTROL_TRAFFIC, check_reads=6)
    genome, blocks = gen.draw_cell(5, CONTROL_CONFIG, traffic)
    ref_cut = dazz.write_dam(str(work / "ref"), genome,
                             CONTROL_CONFIG["ref_block_bases"])
    read_cut = dazz.write_reads(str(work / "reads"), blocks,
                                traffic["block_bases"])
    sample = check.draw_sample(5, traffic, blocks, range(len(blocks)))
    return check.reference_answers(sample, genome, blocks, ref_cut,
                                   read_cut, CONTROL_CONFIG["options"], work,
                                   torch.device("cpu"))


def test_the_sample_holds_records_and_profiles(answers):
    assert all(recs and prof for recs, prof in answers.values())
    assert check.compare(answers, answers) == (0, 0)


@pytest.mark.parametrize("field", [1, 2, 4, 6, 9])
def test_one_changed_field_of_one_record_is_found(answers, field):
    got = dict(answers)
    key = next(iter(got))
    recs, prof = got[key]
    rec = list(recs[0])
    rec[field] += 1
    got[key] = ([tuple(rec)] + recs[1:], prof)
    assert check.compare(got, answers) == (1, 0)


def test_one_changed_profile_value_is_found(answers):
    got = dict(answers)
    key = next(iter(got))
    recs, prof = got[key]
    got[key] = (recs, bytes([prof[0] + 1]) + prof[1:])
    assert check.compare(got, answers) == (0, 1)


@pytest.mark.parametrize("seed", [2, 3, 4])
def test_the_control_fails(tmp_path, seed):
    row = control.control_numbers(seed, CONTROL_CONFIG, CONTROL_TRAFFIC,
                                  torch.device("cpu"), tmp_path)
    assert row["records"] > 0
    assert row["reads_differ"] > check.LIMITS["reads_differ"]

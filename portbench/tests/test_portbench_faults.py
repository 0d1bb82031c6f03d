"""`correct` must come out false when the timed path is wrong: the control
(the fp8 reference in the program's place), and faults planted in the
program underneath a whole run. The tiny cells' own limits (fp32 against
fp32) judge every fault; the real cells' limits judge the one whose size
does not depend on the model's, an answer altered by a quarter."""

import json
import shutil
from unittest import mock

import pytest
import torch

from conftest import ROOT
from portbench import check, harness, spec

SEED = 2**35 + 3
# tiny cell -> the real cell whose limits judge it
JUDGED_BY = {"tiny-score": "score-2b-bf16", "tiny-qknorm-score": "score-26b-bf16",
             "tiny-serve": "serve-2b-bf16"}


def _answer_altered(cls):
    """The score head's answer a quarter too high where it is produced."""
    real = cls._score
    return mock.patch.object(cls, "_score", lambda self, r: real(self, r) * 1.25)


def _token_altered(cls):
    """The readout taken one position early: a token off by one."""
    real = cls.readout
    return mock.patch.object(cls, "readout",
                             lambda self, hidden, mask: real(self, hidden.roll(1, dims=1), mask))


def _frame_altered(cls):
    """One frame's image tokens zeroed after the projector."""
    real = cls._extract_feature

    def extract(self, pixels):
        out = real(self, pixels).clone()
        out[-1] = 0
        return out

    return mock.patch.object(cls, "_extract_feature", extract)


FAULTS = {"answer": _answer_altered, "token": _token_altered, "frame": _frame_altered}


def _judged_cell(root, cell):
    shutil.copy(ROOT / "portbench" / "limits" / f"{JUDGED_BY[cell]}.json",
                root / "portbench" / "limits" / f"{cell}.json")
    return spec.load_cell(cell, root)


@pytest.mark.parametrize("cell", sorted(JUDGED_BY))
def test_sound_tiny_run_passes_the_real_limits(tiny_root, cell):
    torch.set_num_threads(2)
    out = harness.run_cell(_judged_cell(tiny_root, cell), SEED, 0.5, False, "cpu")
    assert out["correct"], out["check"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", sorted(JUDGED_BY))
def test_a_planted_fault_is_not_correct(tiny_root, cell, fault):
    from aigv_assessor_torch.models.assessor import AIGVAssessor

    torch.set_num_threads(2)
    c = spec.load_cell(cell, tiny_root)
    with FAULTS[fault](AIGVAssessor):
        out = harness.run_cell(c, SEED, 0.5, False, "cpu")
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("cell", sorted(JUDGED_BY))
def test_an_altered_answer_fails_the_real_limits(tiny_root, cell):
    from aigv_assessor_torch.models.assessor import AIGVAssessor

    torch.set_num_threads(2)
    c = _judged_cell(tiny_root, cell)
    with _answer_altered(AIGVAssessor):
        out = harness.run_cell(c, SEED, 0.5, False, "cpu")
    assert not out["correct"], out["check"]
    assert not check.within(out["check"]["score_head_gap"]["value"],
                            out["check"]["score_head_gap"]["limit"])


@pytest.mark.parametrize("cell", sorted(JUDGED_BY))
def test_the_control_is_not_correct(tiny_root, cell):
    """The fp8 reference in the program's place fails the tiny cell's limits
    (the fp32 program against the fp32 reference, rounding alone) by far."""
    torch.set_num_threads(2)
    c = spec.load_cell(cell, tiny_root)
    out = harness.run_cell(c, SEED, 0.5, False, "cpu", control=True)
    assert out["correct"]
    control = out["control"]
    assert not all(check.within(control.get(k), lim) for k, lim in c.limits.items())
    for key, value in out["numbers"].items():
        assert control[key] > 100 * max(value, 1e-7), (key, value, control[key])
    json.dumps(out)

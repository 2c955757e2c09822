"""The controls: the plain reference one precision below the
configuration's, put in the program's place, has to come out not
correct. On the CPU at small shapes where the lower precision exists
there (fp8 convolutions); on the card at the cell's own size
for TF32, which exists only there (`chip`)."""

import os
import time

import pytest
import torch

import controls
import harness
from portbench_tiny import SHAPES


def _cell(name, shapes=True):
    cell = harness.Cell(harness.spec(), name)
    if shapes:
        for base, key in ((cell.config, "config"), (cell.traffic, "traffic")):
            for k, v in SHAPES[name].get(key, {}).items():
                if isinstance(v, dict):
                    base[k].update(v)
                else:
                    base[k] = v
    return cell


def _limits(name):
    return harness.load_json(os.path.join(harness.BENCH, "limits",
                                          name + ".json"))


def test_fp8_extractor_fails_the_extract_check():
    got = controls.extract_controls(_cell("bert3.extract"), 5, "cpu")
    lim = _limits("bert3.extract")["feature_error"]
    assert got["fp8"]["feature_error"] > lim
    assert got["answer_altered"]["feature_error"] > lim


@pytest.mark.chip
@pytest.mark.parametrize("name", ["bert3.train", "bigru.train"])
def test_tf32_and_half_batch_fail_the_train_check(name, tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: TF32 exists only there")
    cell = _cell(name, shapes=False)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    r = cell.driver().run(dict(cell=cell, seed=7, seconds=1.0, trace=False,
                               device=dev, t_start=time.time(), control=True,
                               work=str(tmp_path)))
    lim = _limits(name)
    assert r["correct"]
    for control in ("tf32", "half_batch"):
        assert any(v > lim[k] for k, v in r["controls"][control].items()), (
            control, r["controls"][control])

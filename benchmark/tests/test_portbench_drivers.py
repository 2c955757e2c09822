"""Each driver run on the CPU at small shapes: one well-formed result
line, correct; and with the timed path broken underneath, `correct`
comes out false (the harness's look for a card skipped)."""

import json

import numpy as np
import pytest
import torch

from portbench_tiny import run_cpu

KEYS = {"correct", "attempted", "failed", "metrics", "device", "card",
        "checks"}


def _check_line(lines, result):
    last = json.loads(lines[-1])
    assert set(last) == KEYS and list(last)[-1] == "checks"
    assert last == json.loads(json.dumps(result))
    for m in last["metrics"].values():
        assert set(m) == {"value", "unit"} and np.isfinite(m["value"])
    for c in last["checks"].values():
        assert set(c) == {"value", "limit"}
    return last


@pytest.mark.parametrize("cell", ["bert3.train", "bigru.train",
                                  "bert3.extract"])
def test_cell_runs_on_the_cpu(cell, tmp_path, monkeypatch):
    result, lines = run_cpu(cell, 2 ** 31 + 5, tmp_path, monkeypatch)
    last = _check_line(lines, result)
    assert last["correct"] is True, last["checks"]
    assert last["attempted"] > 0 and last["failed"] == 0
    assert "setup_s" in last["metrics"] and len(last["metrics"]) == 2


def _train_step_fault(monkeypatch, kind):
    import fancyrec_tpu_torch.train.trainer as trainer
    real = trainer.train_step

    def step(model, opt, cfg, state, sb):
        if kind == "half_batch":
            b = sb["frames"].shape[1]
            sb = {k: (v[:, :b // 2] if v.dim() > 1 else v)
                  for k, v in sb.items()}
            return real(model, opt, cfg, state, sb)
        before = [p.detach().clone() for p in model.parameters()]
        out = real(model, opt, cfg, state, sb)
        with torch.no_grad():
            for p, q in zip(model.parameters(), before):
                p.copy_(q)
        return out

    monkeypatch.setattr(trainer, "train_step", step)


@pytest.mark.parametrize("kind", ["state_unchanged", "half_batch"])
def test_train_fault_is_not_correct(kind, tmp_path, monkeypatch):
    _train_step_fault(monkeypatch, kind)
    result, lines = run_cpu("bert3.train", 17, tmp_path, monkeypatch)
    assert _check_line(lines, result)["correct"] is False


def test_extract_altered_answer_is_not_correct(tmp_path, monkeypatch):
    import fancyrec_tpu_torch.models.resnet as resnet
    real = resnet.make_extractor

    def make(*a, **kw):
        fn = real(*a, **kw)
        return lambda images: fn(images).roll(1, 0)   # rows one frame off

    monkeypatch.setattr(resnet, "make_extractor", make)
    result, lines = run_cpu("bert3.extract", 29, tmp_path, monkeypatch)
    assert _check_line(lines, result)["correct"] is False

"""The train cells' reference draws the program's random masks again, from
generators seeded alike, without reading the program's state. That holds
only while both draw the same things in the same order, so this test
names the order the check depends on:

- every tower dropout (`models/layers.Dropout`) draws its mask with
  `Tensor.bernoulli_(keep, generator=...)` from the one device generator
  that `FancyRec.seed_dropout(seed)` hands every Dropout, the whole
  tensor at once, in the order the layers run;
- the brand dropout (`models/brand.py`) draws two 32-bit seed words a call
  with `torch.randint(0, 2**32, (2,))` from a host generator seeded
  seed + 1, and keeps the aspects that Philox4x32-10 keeps under them
  (`ops/brand_dropout.py`, `reference/philox.py`);
- the batches are the loader's: numpy's RandomState(seed + epoch)
  shuffle, cut in batches, each sorted by caption length
  (`reference/batches.py`).

A change to the program that draws otherwise (another mask shape, a
fused dropout that draws in another order, `F.dropout`, another seed
word) computes the same model and still reads `correct` false in the
train cells: it needs a `benchmark` change to the reference first.
"""

import pytest
import torch

from portbench_tiny import run_cpu
from reference import fancyrec_ref


@pytest.mark.parametrize("cell", ["bert3.train", "bigru.train"])
def test_program_and_reference_draw_alike(cell, tmp_path, monkeypatch):
    import fancyrec_tpu_torch.train.trainer as trainer
    phase = [None]
    log = {"program": [], "reference": []}
    real_bernoulli, real_randint = torch.Tensor.bernoulli_, torch.randint
    real_epoch, real_ref = trainer.train_epoch, fancyrec_ref.train

    def bernoulli_(self, p=0.5, *args, **kw):
        if phase[0] and kw.get("generator") is not None:
            log[phase[0]].append(("mask", tuple(self.shape), float(p)))
        return real_bernoulli(self, p, *args, **kw)

    def randint(*args, **kw):
        out = real_randint(*args, **kw)
        if phase[0] and kw.get("generator") is not None:
            log[phase[0]].append(("seed words", tuple(out.tolist())))
        return out

    def train_epoch(model, opt, cfg, state, loader, epoch, device):
        # the set-up updates (epochs < 0) are the ones the reference follows
        phase[0] = "program" if epoch < 0 else None
        try:
            return real_epoch(model, opt, cfg, state, loader, epoch, device)
        finally:
            phase[0] = None

    def ref_train(*args, **kw):
        phase[0] = "reference"
        try:
            return real_ref(*args, **kw)
        finally:
            phase[0] = None

    monkeypatch.setattr(torch.Tensor, "bernoulli_", bernoulli_)
    monkeypatch.setattr(torch, "randint", randint)
    monkeypatch.setattr(trainer, "train_epoch", train_epoch)
    monkeypatch.setattr(fancyrec_ref, "train", ref_train)
    result, _ = run_cpu(cell, 29, tmp_path, monkeypatch)
    prog, ref = log["program"], log["reference"]
    assert any(d[0] == "mask" for d in prog)
    assert any(d[0] == "seed words" for d in prog)
    assert prog == ref, (
        "the program's random draws no longer match the order the "
        "benchmark's reference copies (see this file's docstring)")
    assert result["correct"] is True

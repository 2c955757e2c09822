"""Brand tower: learned aspect mixtures.

Port of fancyrec_tpu/models/brand.py: a (brand_num+1, num_aspects) table of
per-brand aspect weights scales a shared (num_aspects, common_dim) aspect
matrix, and the brand embedding is the mean over the aspect axis, never
with the (B, A, C) intermediate in memory:
  * evaluation mode: one (B, A) @ (A, C) product / A;
  * training mode: dropout (p, default 0.5) on the product and the mean,
    fused in `ops.brand_dropout.aspect_dropout_mean` (the CUDA kernels on
    the card, whatever the widths or the device count; the JAX package
    keeps its TPU kernel to one device and 128-lane widths).
The gathered weights pass through `l1_penalty` in both modes.
The tower computes in float32 whatever the model's compute dtype, as the
JAX tower does: its parameters are float32, it never reads its `dtype`,
and its TPU kernel casts to float32. So K2 takes float32 only.

Tensor parallelism (`shard`: this model rank's (offset, size) of the
aspects, from `parallel.mesh.Mesh.part`): the rank holds its contiguous
A/M aspects, the rows of the aspect matrix and the columns of the brand
table, as the JAX package's rules split them. Its product over its
aspects, divided by the FULL A (or K2 on the shard, with the table's A and
the shard's first aspect), is its share of the mean, and the shares are
summed over the model group (`collectives.model_reduce`).
"""

from __future__ import annotations

import torch
from torch import nn

from fancyrec_tpu_torch.ops.brand_dropout import aspect_dropout_mean
from fancyrec_tpu_torch.parallel import collectives


class _L1Penalty(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + 0.0001 * torch.sign(x)


def l1_penalty(x: torch.Tensor) -> torch.Tensor:
    """Identity whose backward adds 1e-4 * sign(x) to the incoming grad: an
    L1 pull on the gathered brand aspect weights, applied per gathered row
    (before duplicate ids are summed into the table)."""
    return _L1Penalty.apply(x)


class BrandAspects(nn.Module):
    def __init__(self, brand_num: int, num_aspects: int, common_dim: int,
                 shard=None):
        super().__init__()
        self.num_aspects = num_aspects
        self.shard = shard               # (first aspect, aspects) or None
        local = num_aspects if shard is None else shard[1]
        self.p = 0.5                     # dropout probability, as nn.Dropout.p
        self.seed_generator = None       # host generator of the seed words
        # an iterator of (2,) device tensors that stands in for the draws
        # while a CUDA graph captures a training update (`train/step.py`):
        # each training call takes the next one, the seed words that the
        # graph's caller draws with `draw_seed` and writes there
        self.seed_rows = None
        self.brand_embeddings = nn.Parameter(
            torch.empty(brand_num + 1, local))
        self.aspects_embeddings = nn.Parameter(torch.empty(local, common_dim))

    def draw_seed(self) -> torch.Tensor:
        """The seed words of one training call: two 32-bit key words in an
        int64 host tensor, drawn on the host (no device sync)."""
        if self.seed_generator is None:
            raise RuntimeError("the brand dropout in training mode draws its "
                               "seed words from an explicit generator: call "
                               "seed_dropout(seed) on the model first")
        return torch.randint(0, 2 ** 32, (2,), generator=self.seed_generator,
                             dtype=torch.int64)

    def forward(self, brand_ids: torch.Tensor) -> torch.Tensor:
        weights = l1_penalty(self.brand_embeddings[brand_ids])   # (B, A)
        if not self.training:
            out = (weights @ self.aspects_embeddings) / self.num_aspects
            return out if self.shard is None else collectives.model_reduce(out)
        seed = (self.draw_seed() if self.seed_rows is None
                else next(self.seed_rows))
        if self.shard is None:
            return aspect_dropout_mean(weights, self.aspects_embeddings, seed,
                                       1.0 - self.p)
        return collectives.model_reduce(aspect_dropout_mean(
            weights, self.aspects_embeddings, seed, 1.0 - self.p,
            a_total=self.num_aspects, a_off=self.shard[0]))

"""Shared building blocks for the dual-branch encoders.

Port of fancyrec_tpu/models/layers.py. Batch-shape semantics are the JAX
package's: tensors are padded to a fixed maximum, and every reduction that
the reference bounds by its batch's own max length takes that dynamic
batch-max length (`batch_len`, a 0-d tensor) to bound the valid region.

Parameter names and shapes follow the JAX parameter tree with torch
layouts (Linear weights (out, in), Conv1d weights (K, D, ws)), so
`fancyrec_tpu_torch.interop` maps one onto the other by name.

`dtype` is flax's `dtype=`, the compute dtype: parameters stay float32 in
storage; a Dense or Conv casts its input, weight and bias to `dtype`,
forms the product in it and adds the bias in it, so its output is in
`dtype`. Everything else takes the dtype its inputs give it, under the
same promotion rules as jax.numpy (bfloat16 with float32 is float32).
These are explicit casts where the JAX modules have them, not
`torch.autocast`, whose per-op lists are not flax's.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from fancyrec_tpu_torch.parallel import collectives


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 0.0) -> torch.Tensor:
    """Row L2-normalization (no epsilon, as in the reference)."""
    return x / (torch.sqrt((x * x).sum(dim=dim, keepdim=True)) + eps)


def batch_max_len(mask: torch.Tensor) -> torch.Tensor:
    """Dynamic max valid length over the batch from a (B, T) 0/1 mask."""
    return mask.sum(dim=1).max().to(torch.int64)


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-sample mean over valid positions: (B,T,D),(B,T) -> (B,D)."""
    mask = mask.to(x.dtype)
    s = torch.einsum("btd,bt->bd", x, mask)
    cnt = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    return s / cnt


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit generator, never
    the global RNG, so a seeded run replays. `FancyRec.seed_dropout` hands
    every Dropout of a model one generator on the model's device. Identity
    in evaluation mode and at p = 0, as flax's nn.Dropout."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        if self.generator is None:
            raise RuntimeError("dropout in training mode draws from an "
                               "explicit generator: call seed_dropout(seed) "
                               "on the model first")
        keep = 1.0 - self.p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.generator)
        return x * mask / keep


def dense(linear: nn.Linear, x: torch.Tensor,
          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype) with `linear`'s parameters: x, the weight
    and the bias cast to `dtype`, the product rounded to `dtype`, then the
    bias added in it. In float32 it is `linear(x)`."""
    if dtype == torch.float32 and x.dtype == torch.float32:
        return linear(x)
    y = F.linear(x.to(dtype), linear.weight.to(dtype))
    return y if linear.bias is None else y + linear.bias.to(dtype)


class MFC(nn.Module):
    """Linear -> ReLU -> Dropout common-space mapping."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc1 = nn.Linear(in_dim, out_dim)
        self.drop = Dropout(dropout)

    def forward(self, x):
        return self.drop(F.relu(dense(self.fc1, x, self.dtype)))


class AttentionPool(nn.Module):
    """Structured self-attention pooler: scores = mean over heads of
    W2 tanh(W1 x); softmax over valid frames only; output = sum of
    weight * x divided by the batch-max length (kept from the reference)."""

    def __init__(self, feat_dim: int, hidden: int, heads: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.w_1 = nn.Linear(feat_dim, hidden, bias=False)
        self.w_2 = nn.Linear(hidden, heads, bias=False)

    def forward(self, x, mask, batch_len=None):
        """batch_len: the 0-d batch-max valid length (default: from mask)."""
        # the scores and weights in the compute dtype; weight * x promotes
        # to x's dtype
        a = torch.tanh(dense(self.w_1, x, self.dtype))
        score = dense(self.w_2, a, self.dtype).mean(dim=-1)    # (B, T)
        valid = mask > 0
        score = torch.where(valid, score,
                            torch.full_like(score, torch.finfo(score.dtype).min))
        weight = torch.softmax(score, dim=1)
        weight = torch.where(valid, weight, torch.zeros_like(weight))
        if batch_len is None:
            batch_len = batch_max_len(mask)
        t_batch = torch.clamp(batch_len, min=1).to(x.dtype)
        return (weight[..., None] * x).sum(dim=1) / t_batch


class ConvBank(nn.Module):
    """Parallel 1-D convolutions over time + masked global max-pool.

    Each branch: kernel ws over time with ws-1 zero padding on both sides,
    ReLU, then max over the T_batch + ws - 1 valid output positions
    (T_batch the dynamic batch-max input length)."""

    def __init__(self, in_dim: int, kernel_num: int,
                 kernel_sizes: Sequence[int],
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.kernel_sizes = tuple(kernel_sizes)
        for ws in self.kernel_sizes:
            setattr(self, "conv_w%d" % ws,
                    nn.Conv1d(in_dim, kernel_num, ws, padding=ws - 1))

    def _conv(self, conv: nn.Conv1d, xt):
        """flax nn.Conv(dtype=...): the product, then the bias, in dtype."""
        if self.dtype == torch.float32 and xt.dtype == torch.float32:
            return conv(xt)
        y = F.conv1d(xt.to(self.dtype), conv.weight.to(self.dtype),
                     padding=conv.padding)
        return y + conv.bias.to(self.dtype)[None, :, None]

    def forward(self, x, batch_len):
        xt = x.transpose(1, 2)                          # (B, D, T)
        t = x.shape[1]
        outs = []
        for ws in self.kernel_sizes:
            y = F.relu(self._conv(getattr(self, "conv_w%d" % ws), xt))
            pos = torch.arange(t + ws - 1, device=x.device)
            valid = (pos < batch_len + ws - 1)[None, None, :]
            y = torch.where(valid, y, torch.full_like(y, torch.finfo(y.dtype).min))
            outs.append(y.amax(dim=2))
        return torch.cat(outs, dim=1)


class BatchNorm1dTorch(nn.Module):
    """BatchNorm with torch's defaults (eps 1e-5, momentum 0.1), written out
    as the JAX package writes it. Evaluation mode normalizes with the
    running statistics (the JAX package's 'batch_stats' collection);
    training mode with the batch's mean and biased variance, and moves the
    running statistics toward the mean and the unbiased variance.
    A bfloat16 x keeps the batch statistics and the normalized values in
    bfloat16; the float32 scale and bias (and running statistics) promote
    the output to float32, as in the JAX module.

    In a world of R ranks (each holding an equal slice of the batch) the
    training statistics are the GLOBAL batch's, as GSPMD gives the JAX
    package over its sharded batch: the sum, then the centered sum of
    squares, are all-reduced (with autograd) and divided by the global
    count, and every rank moves its running statistics the same way."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif collectives.world_size() > 1:
            n = x.shape[0] * collectives.world_size()
            mean = (collectives.all_reduce_sum(x.float().sum(dim=0))
                    / n).to(x.dtype)
            var = (collectives.all_reduce_sum(
                ((x - mean) ** 2).float().sum(dim=0)) / n).to(x.dtype)
        else:
            mean = x.mean(dim=0)
            var = ((x - mean) ** 2).mean(dim=0)
            n = x.shape[0]
        if self.training:
            with torch.no_grad():
                unbiased = var * n / max(n - 1, 1)
                self.running_mean.copy_(0.9 * self.running_mean + 0.1 * mean)
                self.running_var.copy_(0.9 * self.running_var + 0.1 * unbiased)
        y = (x - mean) * torch.rsqrt(var + 1e-5)
        return y * self.weight + self.bias

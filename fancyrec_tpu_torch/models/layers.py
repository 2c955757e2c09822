"""Shared building blocks for the dual-branch encoders.

Port of fancyrec_tpu/models/layers.py. Batch-shape semantics are the JAX
package's: tensors are padded to a fixed maximum, and every reduction that
the reference bounds by its batch's own max length takes that dynamic
batch-max length (`batch_len`, a 0-d tensor) to bound the valid region.

Parameter names and shapes follow the JAX parameter tree with torch
layouts (Linear weights (out, in), Conv1d weights (K, D, ws)), so
`fancyrec_tpu_torch.interop` maps one onto the other by name.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


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


class MFC(nn.Module):
    """Linear -> ReLU common-space mapping (dropout is identity in eval)."""

    def __init__(self, in_dim: int, out_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, out_dim)

    def forward(self, x):
        return F.relu(self.fc1(x))


class AttentionPool(nn.Module):
    """Structured self-attention pooler: scores = mean over heads of
    W2 tanh(W1 x); softmax over valid frames only; output = sum of
    weight * x divided by the batch-max length (kept from the reference)."""

    def __init__(self, feat_dim: int, hidden: int, heads: int = 3):
        super().__init__()
        self.w_1 = nn.Linear(feat_dim, hidden, bias=False)
        self.w_2 = nn.Linear(hidden, heads, bias=False)

    def forward(self, x, mask):
        score = self.w_2(torch.tanh(self.w_1(x))).mean(dim=-1)   # (B, T)
        valid = mask > 0
        score = torch.where(valid, score,
                            torch.full_like(score, torch.finfo(score.dtype).min))
        weight = torch.softmax(score, dim=1)
        weight = torch.where(valid, weight, torch.zeros_like(weight))
        t_batch = torch.clamp(batch_max_len(mask), min=1).to(x.dtype)
        return (weight[..., None] * x).sum(dim=1) / t_batch


class ConvBank(nn.Module):
    """Parallel 1-D convolutions over time + masked global max-pool.

    Each branch: kernel ws over time with ws-1 zero padding on both sides,
    ReLU, then max over the T_batch + ws - 1 valid output positions
    (T_batch the dynamic batch-max input length)."""

    def __init__(self, in_dim: int, kernel_num: int,
                 kernel_sizes: Sequence[int]):
        super().__init__()
        self.kernel_sizes = tuple(kernel_sizes)
        for ws in self.kernel_sizes:
            setattr(self, "conv_w%d" % ws,
                    nn.Conv1d(in_dim, kernel_num, ws, padding=ws - 1))

    def forward(self, x, batch_len):
        xt = x.transpose(1, 2)                          # (B, D, T)
        t = x.shape[1]
        outs = []
        for ws in self.kernel_sizes:
            y = F.relu(getattr(self, "conv_w%d" % ws)(xt))    # (B, K, T+ws-1)
            pos = torch.arange(t + ws - 1, device=x.device)
            valid = (pos < batch_len + ws - 1)[None, None, :]
            y = torch.where(valid, y, torch.full_like(y, torch.finfo(y.dtype).min))
            outs.append(y.amax(dim=2))
        return torch.cat(outs, dim=1)


class BatchNorm1dTorch(nn.Module):
    """BatchNorm with torch's defaults (eps 1e-5), evaluation mode only:
    normalizes with the running statistics, which the JAX package keeps in
    its 'batch_stats' collection."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + 1e-5)
        return y * self.weight + self.bias

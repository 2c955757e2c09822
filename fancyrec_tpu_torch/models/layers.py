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

Tensor parallelism: a module built with a `shard` (this model rank's
(offset, size) of a dimension the model axis splits, `parallel.mesh.Mesh.
part`) holds only its part of the split weight; `row_parallel` is the
layer whose input columns are split (Megatron's row-parallel Linear).

Sequence parallelism (`--seq_shard`): `seq_shard_pool` computes a tower's
masked mean and conv bank with the time axis split over the model group,
where the JAX package's `constrain_seq_sharding` lets GSPMD split it.
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


def row_parallel(linear: nn.Linear, x: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """`dense` of the whole layer, from `linear`, which holds this model
    rank's input columns of the weight, and x, this rank's columns of the
    input: the partial products summed over the model group
    (`collectives.model_reduce`), then the replicated bias once. The
    partial products stay float32 until after the sum, and are rounded to
    `dtype` once, as one rank's `dense` rounds its product once: under
    bfloat16 each partial is the float32 product of the bfloat16 operands
    (exact products, float32 sums), so the model axis moves a result only
    by the float32 sum order."""
    if dtype == torch.float32 and x.dtype == torch.float32:
        y = F.linear(x, linear.weight)
    else:
        y = F.linear(x.to(dtype).float(), linear.weight.to(dtype).float())
    y = collectives.model_reduce(y).to(dtype)
    return y if linear.bias is None else y + linear.bias.to(dtype)


class MFC(nn.Module):
    """Linear -> ReLU -> Dropout common-space mapping. With a `shard` of
    the input features, fc1 is row-parallel: the replicated input enters
    through `collectives.model_copy` (its grad summed over the model group
    in the backward) and fc1 holds the shard's input columns."""

    def __init__(self, in_dim: int, out_dim: int, dropout: float = 0.2,
                 dtype: torch.dtype = torch.float32, shard=None):
        super().__init__()
        self.dtype = dtype
        self.shard = shard
        self.fc1 = nn.Linear(in_dim if shard is None else shard[1], out_dim)
        self.drop = Dropout(dropout)

    def forward(self, x):
        if self.shard is None:
            return self.drop(F.relu(dense(self.fc1, x, self.dtype)))
        lo, n = self.shard
        x = collectives.model_copy(x)[..., lo:lo + n]
        return self.drop(F.relu(row_parallel(self.fc1, x, self.dtype)))


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


def conv1d(xt, weight, bias, padding, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Conv(dtype=...) over (B, D, T): the product, then the bias,
    in dtype (in float32, `nn.Conv1d`'s own call)."""
    if dtype == torch.float32 and xt.dtype == torch.float32:
        return F.conv1d(xt, weight, bias, padding=padding)
    y = F.conv1d(xt.to(dtype), weight.to(dtype), padding=padding)
    return y + bias.to(dtype)[None, :, None]


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
        return conv1d(xt, conv.weight, conv.bias, conv.padding, self.dtype)

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


def seq_shardable(x: torch.Tensor) -> bool:
    """Does `seq_shard_pool` split x's time axis: a model group of M > 1
    ranks and a padded time length T (bucket included) that M divides?
    Elsewhere it computes replicated, as `constrain_seq_sharding` leaves
    an activation unconstrained where its dims do not divide the mesh."""
    m = collectives.model_size()
    return m > 1 and x.shape[1] % m == 0


def seq_shard_pool(x: torch.Tensor, mask: torch.Tensor, convs: ConvBank,
                   batch_len, conv_keep: torch.Tensor):
    """(masked_mean(x, mask), convs(where(conv_keep, x, 0), batch_len)) of a
    replicated (B, T, D) activation x, with the time axis split over the
    model group (`seq_shardable` must hold): model rank m of M owns the
    rows [m*T/M, (m+1)*T/M).

    x enters through `collectives.model_copy` once, so the replicated
    layers before it see the whole grad on every model rank, and so do
    the conv bank's (replicated) weights, each rank's grad of them being
    that of its own positions: one flat `model_copy` of them. The mean is
    the partial sum over the owned rows, summed over the model group
    (`model_reduce`), over the full valid count. Each conv branch of width
    ws computes the output positions its rank owns, the last rank also
    the ws - 1 tail positions [T, T + ws - 1); its ws - 1 halo rows come
    from the replicated input, zeros outside [0, T), so the forward needs
    no collective. ReLU, the valid-range mask pos < batch_len + ws - 1,
    a local max, then the max over the model group (`model_max`). A rank
    whose positions all lie past the valid range holds finfo.min there.

    mask: (B, T) 0/1; conv_keep: (B or 1, T) bool, the rows of x the conv
    bank sees (the rest read as zeros); batch_len: the 0-d batch-max
    valid length (the global batch's under data parallelism)."""
    m, r = collectives.model_size(), collectives.model_rank()
    b, t, _ = x.shape
    n = t // m
    lo, hi = r * n, (r + 1) * n
    last = r == m - 1
    x = collectives.model_copy(x)
    mask = mask.to(x.dtype)
    part = torch.einsum("btd,bt->bd", x[:, lo:hi], mask[:, lo:hi])
    cnt = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)
    mean = collectives.model_reduce(part.float()).to(part.dtype) / cnt
    # the rows [lo - P, hi (+ P on the last rank)) of x padded with P zeros
    # a side, P the widest branch's ws - 1: local[k] is padded row lo + k
    p = max(convs.kernel_sizes) - 1
    keep = conv_keep.expand(b, t)[:, max(lo - p, 0):hi, None]
    src = x[:, max(lo - p, 0):hi]
    src = torch.where(keep, src, torch.zeros_like(src))
    local = F.pad(src, (0, 0, max(p - lo, 0), p if last else 0))
    xt = local.transpose(1, 2)                          # (B, D, rows)
    branches = [getattr(convs, "conv_w%d" % ws) for ws in convs.kernel_sizes]
    weights = [w for c in branches for w in (c.weight, c.bias)]
    flat = collectives.model_copy(torch.cat([w.reshape(-1) for w in weights]))
    weights = [v.view_as(w) for w, v in
               zip(weights, flat.split([w.numel() for w in weights]))]
    outs = []
    for k, ws in enumerate(convs.kernel_sizes):
        end = (t + ws - 1) if last else hi              # owned positions
        y = F.relu(conv1d(xt[:, :, p - ws + 1:end + p - lo], weights[2 * k],
                          weights[2 * k + 1], 0, convs.dtype))
        pos = torch.arange(lo, end, device=x.device)
        valid = (pos < batch_len + ws - 1)[None, None, :]
        y = torch.where(valid, y,
                        torch.full_like(y, torch.finfo(y.dtype).min))
        outs.append(y.amax(dim=2))
    return mean, collectives.model_max(torch.cat(outs, dim=1))


class BatchNorm1dTorch(nn.Module):
    """BatchNorm with torch's defaults (eps 1e-5, momentum 0.1), written out
    as the JAX package writes it. Evaluation mode normalizes with the
    running statistics (the JAX package's 'batch_stats' collection);
    training mode with the batch's mean and biased variance, and moves the
    running statistics toward the mean and the unbiased variance.
    A bfloat16 x keeps the batch statistics and the normalized values in
    bfloat16; the float32 scale and bias (and running statistics) promote
    the output to float32, as in the JAX module.

    Over R data slots (each holding an equal slice of the batch) the
    training statistics are the GLOBAL batch's, as GSPMD gives the JAX
    package over its sharded batch: the sum, then the centered sum of
    squares, are all-reduced over the data group (with autograd) and
    divided by the global count, and every rank moves its running
    statistics the same way. The model ranks of a slot hold the same rows
    and take no part in the sums."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        if not self.training:
            mean, var = self.running_mean, self.running_var
        elif collectives.data_size() > 1:
            n = x.shape[0] * collectives.data_size()
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

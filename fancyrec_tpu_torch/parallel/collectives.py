"""The collectives of data parallelism, written out where the JAX package
lets GSPMD insert them.

Under the JAX package's (data=R, model=1) mesh, the loss, the contrastive
queue and the projection head's BatchNorm see the global batch because XLA
reduces over the logical batch axis. Here each rank holds its slice of the
batch, and these functions join the slices:

  * `all_gather(x)`: the ranks' x concatenated along dim 0 in rank order.
    Its backward returns this rank's rows of the incoming grad: every rank
    computes the same loss from the same gathered rows, so the grad it
    holds for those rows is already the whole grad, not a share of it.
  * `all_reduce_sum(x)`: the sum over ranks; its backward sums the grads
    over ranks too (each rank's output depends on every rank's input).
  * `all_reduce_sum_(t)`: the same in place, without autograd (the flat
    grads of an update).

All of them are the identity in a world of one, or outside a world. Under
gloo (the CPU, or ranks that share a card) a CUDA tensor goes through host
memory, explicitly, so any gloo build takes it; under NCCL it stays on the
card. They must be issued in the same order on every rank, from one
thread: a collective on the loader's prefetch thread while the main
thread waits in another deadlocks gloo.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def comm_device() -> torch.device:
    """Where the world's collectives take their tensors: the current card
    under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum_(t: torch.Tensor) -> torch.Tensor:
    """t <- the sum of t over the ranks, in place; returns t."""
    if world_size() <= 1:
        return t
    via = comm_device()
    if t.device == via and t.is_contiguous():
        dist.all_reduce(t)
        return t
    buf = t.detach().to(via).contiguous()
    dist.all_reduce(buf)
    t.copy_(buf)
    return t


def _gather(x: torch.Tensor) -> torch.Tensor:
    via = comm_device()
    src = x.detach().to(via).contiguous()
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts, dim=0).to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        lo = rank() * ctx.rows
        return g[lo:lo + ctx.rows]


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum_(x.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone())


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """The ranks' x (equal shapes) concatenated along dim 0 in rank order,
    with autograd; x itself in a world of one."""
    if world_size() <= 1:
        return x
    return _AllGather.apply(x)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks, with autograd; x in a world of one."""
    if world_size() <= 1:
        return x
    return _AllReduceSum.apply(x)

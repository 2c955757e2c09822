"""The collectives of the (data, model) mesh, written out where the JAX
package lets GSPMD insert them.

A world of R*M ranks is laid out row-major as the JAX package's
`build_mesh` reshapes its devices: rank r holds data index r // M and
model index r % M (`set_layout`). Each rank belongs to two process
groups: its **data group**, the R ranks with its model index, and its
**model group**, the M ranks with its data index.

Data parallelism. Under the JAX package's mesh the loss, the contrastive
queue and the projection head's BatchNorm see the global batch because
XLA reduces over the logical batch axis. Here each data slot holds its
slice of the batch, and these functions join the slices over the data
group (the default `axis`):

  * `all_gather(x)`: the data ranks' x concatenated along dim 0 in data
    order. Its backward returns this slot's rows of the incoming grad:
    every rank computes the same loss from the same gathered rows, so the
    grad it holds for those rows is already the whole grad.
  * `all_reduce_sum(x)`: the sum over the data ranks; its backward sums
    the grads over them too (each output depends on every slot's input).
  * `all_reduce_sum_(t)`: the same in place, without autograd (the flat
    grads of an update).

Tensor parallelism (Megatron's pair, over the model group): a layer whose
weight is split over the model ranks takes its replicated input through
`model_copy` (f: the identity forward, an all-reduce of the grad
backward) and sums its partial products through `model_reduce` (g: an
all-reduce forward, the identity backward). Everything outside the pair
is replicated and computed identically on every model rank, so the grads
of the replicated weights come out whole and equal on every model rank,
with no extra reduction.

Sequence parallelism (`--seq_shard`, `models.layers.seq_shard_pool`):
model rank m owns the time rows [m*T/M, (m+1)*T/M) of a replicated
(B, T, D) activation, which enters through `model_copy`. A masked mean
leaves through `model_reduce` of the partial sums; a max-pool through
`model_max`: the ranks' local maxima all-gathered over the model group and
reduced there, whose backward hands each rank its own rows of the grad,
so the grad reaches only the ranks that hold the maximum.

Pipeline parallelism (`--pp_stages S`, `parallel/pipeline.py`): model
rank s is stage s of a GPipe schedule. Activations go to stage s+1 and
their grads back to stage s-1 by point-to-point messages between
neighbours of the model group (`model_isend`, `model_recv`), in the
order of the microbatches on both sides of each pair; the last stage's
output leaves through `model_reduce`, and the stage-local grads of the
replicated layers are summed over the model group by one flat
`all_reduce_sum_` a backward.

Each function is the identity where its group has one rank, outside a
world included. Under gloo (the CPU, or ranks that share a card) a CUDA
tensor goes through host memory, explicitly, so any gloo build takes it;
under NCCL it stays on the card. Collectives must be issued in the same
order on every rank of their group, from one thread: a collective on the
loader's prefetch thread while the main thread waits in another
deadlocks gloo.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

DATA, MODEL = "data", "model"

# the model axis and this rank's groups; model 1: the data group is the
# world (None, torch.distributed's default group) and there is no model
# group
_LAYOUT = {"shape": None, "model": 1, "groups": {DATA: None, MODEL: None}}


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def set_layout(data: int, model: int) -> None:
    """Lay the world out as a (data, model) mesh and build this rank's data
    and model groups. Every rank of the world calls it with the same shape
    (torch.distributed builds a group on every rank, member or not); a
    second call with the same shape keeps the groups. Outside a world the
    layout is recorded only."""
    if _LAYOUT["shape"] == (data, model):
        return
    if dist.is_initialized() and data * model != world_size():
        raise ValueError("a %d x %d mesh does not cover a world of %d"
                         % (data, model, world_size()))
    groups = {DATA: None, MODEL: None}
    if dist.is_initialized() and model > 1:
        me = rank()
        for m in range(model):                 # data groups: one a model index
            g = dist.new_group([d * model + m for d in range(data)])
            if me % model == m:
                groups[DATA] = g
        for d in range(data):                  # model groups: one a data index
            g = dist.new_group([d * model + m for m in range(model)])
            if me // model == d:
                groups[MODEL] = g
    _LAYOUT.update(shape=(data, model), model=model, groups=groups)


def model_size() -> int:
    """Ranks on the model axis (1 outside a world)."""
    return _LAYOUT["model"] if dist.is_initialized() else 1


def data_size() -> int:
    """Ranks on the data axis: the world over the model axis."""
    return world_size() // model_size()


def data_rank() -> int:
    """This rank's index on the data axis."""
    return rank() // model_size()


def model_rank() -> int:
    """This rank's index on the model axis."""
    return rank() % model_size()


def _axis(axis: str) -> Tuple[Optional[object], int, int]:
    """-> (process group, its size, this rank's index in it)."""
    if axis == DATA:
        return _LAYOUT["groups"][DATA], data_size(), data_rank()
    if axis == MODEL:
        return _LAYOUT["groups"][MODEL], model_size(), model_rank()
    raise ValueError("axis must be %r or %r, got %r" % (DATA, MODEL, axis))


def comm_device() -> torch.device:
    """Where the world's collectives take their tensors: the current card
    under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce_sum_(t: torch.Tensor, axis: str = DATA) -> torch.Tensor:
    """t <- the sum of t over the ranks of `axis`, in place; returns t."""
    group, size, _ = _axis(axis)
    if size <= 1:
        return t
    via = comm_device()
    if t.device == via and t.is_contiguous():
        dist.all_reduce(t, group=group)
        return t
    buf = t.detach().to(via).contiguous()
    dist.all_reduce(buf, group=group)
    t.copy_(buf)
    return t


def _gather(x: torch.Tensor, axis: str) -> torch.Tensor:
    group, size, _ = _axis(axis)
    src = x.detach().to(comm_device()).contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=0).to(x.device)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.rows, ctx.index = x.shape[0], _axis(axis)[2]
        return _gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.index * ctx.rows
        return g[lo:lo + ctx.rows], None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return all_reduce_sum_(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), ctx.axis), None


def all_gather(x: torch.Tensor, axis: str = DATA) -> torch.Tensor:
    """The ranks' x (equal shapes) concatenated along dim 0 in their order
    on `axis`, with autograd; x itself where the axis has one rank."""
    if _axis(axis)[1] <= 1:
        return x
    return _AllGather.apply(x, axis)


def all_reduce_sum(x: torch.Tensor, axis: str = DATA) -> torch.Tensor:
    """The sum of x over the ranks of `axis`, with autograd; x where the
    axis has one rank."""
    if _axis(axis)[1] <= 1:
        return x
    return _AllReduceSum.apply(x, axis)


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_sum_(g.clone(), MODEL)


class _ModelReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return all_reduce_sum_(x.clone(), MODEL)

    @staticmethod
    def backward(ctx, g):
        return g


def model_copy(x: torch.Tensor) -> torch.Tensor:
    """Megatron's f: the identity forward; backward, the grad summed over
    the model group. Where a replicated tensor enters a split layer."""
    if model_size() <= 1:
        return x
    return _ModelCopy.apply(x)


def model_reduce(x: torch.Tensor) -> torch.Tensor:
    """Megatron's g: the sum over the model group forward; the identity
    backward. Where a split layer's partial products leave it."""
    if model_size() <= 1:
        return x
    return _ModelReduce.apply(x)


def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of x over the model group, with autograd: the
    ranks' x all-gathered (`all_gather` over MODEL, whose backward returns
    this rank's rows of the grad) and reduced by `amax`, so the grad goes
    only to the ranks that hold the maximum (split evenly over exact ties,
    as `amax` splits it). The gather runs in float32, where every value of
    a lower float dtype is exact. x where the model group has one rank."""
    if model_size() <= 1:
        return x
    parts = all_gather(x.float(), MODEL)
    return parts.view(model_size(), *x.shape).amax(dim=0).to(x.dtype)


def _model_peer(index: int) -> int:
    """The world rank of model index `index` in this rank's model group."""
    return data_rank() * model_size() + index


def model_isend(t: torch.Tensor, index: int):
    """Start sending t to model index `index` of this rank's model group ->
    a handle for `wait_all`, which holds the buffer until the message is
    out. Under gloo a CUDA tensor goes through host memory."""
    buf = t.detach().to(comm_device()).contiguous()
    return dist.isend(buf, _model_peer(index),
                      group=_LAYOUT["groups"][MODEL]), buf


def model_recv(like: torch.Tensor, index: int) -> torch.Tensor:
    """Receive a tensor of like's shape and dtype from model index `index`
    of this rank's model group -> on like's device. Blocks until it
    arrives; the sender's `model_isend` must be issued in the same order."""
    buf = torch.empty(like.shape, dtype=like.dtype, device=comm_device())
    dist.recv(buf, _model_peer(index), group=_LAYOUT["groups"][MODEL])
    return buf.to(like.device)


def wait_all(handles) -> None:
    """Wait for the sends that `model_isend` started."""
    for work, _ in handles:
        work.wait()

"""GPipe pipeline parallelism over the model group: port of
fancyrec_tpu/parallel/pipeline.py.

The JAX package shards a stacked layer axis over the 'model' mesh axis
under `shard_map`, moves activations stage to stage with `lax.ppermute`
and replicates the last stage's output with a `psum`. Here the model
group's M ranks are the S = M stages, one process each: stage s (the
model rank) owns the layers [s*L/S, (s+1)*L/S) and runs them on each of
the M microbatches in turn (M = S by default). It receives a
microbatch's input from stage s-1 and sends its output to stage s+1
(`collectives.model_isend` / `model_recv`, in microbatch order on both
sides of each pair, so the sends and receives pair up on every stage,
the middle ones of a longer ring included). The last stage's output
leaves through `model_reduce` of (the output there, zeros elsewhere):
the JAX `psum`.

The schedule fits the trainer's one `loss.backward()` as an autograd
Function (`_Pipe`). Its forward builds each microbatch's subgraph of the
stage's layers on a detached input that requires grad; its backward runs
the microbatches in reverse, receives a microbatch's output grad from
stage s+1 (the last stage takes the one the loss gives it), takes the
grads of the input and of the layers' parameters with
`torch.autograd.grad`, and sends the input's grad to stage s-1. So every
dropout mask is drawn once, in the forward. Each rank then holds the
grads of its own layers and zeros for the others; one flat all-reduce
over the model group a backward sums them, and every model rank's copy
of the (replicated) layers gets the same grads, hence the same update.

Two differences from the JAX package, neither of which moves a row's
output:
  * Row grouping. JAX cuts the global batch into M microbatches and
    shards each over the data axis; here a data slot cuts its own
    contiguous rows into M microbatches. Every BERT layer is row-wise,
    so each row meets the same layers either way.
  * Dropout draws. JAX folds its key per (data shard, global layer,
    microbatch); here each (data slot, global layer, microbatch) draws
    from a torch generator of its own, seeded from one draw of the slot's
    dropout stream a call (every model rank of the slot makes that same
    draw, so their streams stay in step). Neither package's masks are
    the sequential encoder's; at p = 0 both fold back to the
    deterministic path exactly, the same seed replays, and data slots
    and microbatches draw different masks.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Optional, Sequence

import torch

from fancyrec_tpu_torch.parallel import collectives


def _stage_layers(n_layers: int) -> range:
    """The global layer indices of this rank's stage."""
    stages = collectives.model_size()
    if n_layers % stages:
        raise ValueError("num layers %d not divisible by %d pipeline "
                         "stages (mesh axis %r)"
                         % (n_layers, stages, collectives.MODEL))
    per = n_layers // stages
    s = collectives.model_rank()
    return range(s * per, (s + 1) * per)


def _forward(layer_fn, n_layers, x, aux, build):
    """The forward ticks of this stage -> (its output, or zeros where this
    is not the last stage; per microbatch (input, output) subgraphs when
    `build`)."""
    stages, s = collectives.model_size(), collectives.model_rank()
    own = _stage_layers(n_layers)
    out = torch.zeros_like(x)
    sends, saved = [], []
    for m in range(x.shape[0]):
        h = x[m] if s == 0 else collectives.model_recv(x[m], s - 1)
        aux_m = None if aux is None else aux[m]
        with torch.enable_grad() if build else contextlib.nullcontext():
            h_in = h.detach().requires_grad_() if build else h
            y = h_in
            for i in own:
                y = layer_fn(i, y, aux_m, m)
        if s < stages - 1:
            sends.append(collectives.model_isend(y, s + 1))
        else:
            out[m] = y.detach()
        if build:
            saved.append((h_in, y))
    collectives.wait_all(sends)
    return out, saved


class _Pipe(torch.autograd.Function):
    """x (M, mb, ...) -> this stage's share of the pipeline's output, with
    the grads of x (stage 0's; zeros elsewhere) and of `params` (summed
    over the model group) in the backward."""

    @staticmethod
    def forward(ctx, layer_fn, n_layers, x, aux, *params):
        out, saved = _forward(layer_fn, n_layers, x, aux, build=True)
        ctx.saved, ctx.params, ctx.x_meta = saved, params, (x.shape, x.dtype)
        return out

    @staticmethod
    def backward(ctx, dout):
        stages, s = collectives.model_size(), collectives.model_rank()
        params, saved = ctx.params, ctx.saved
        shape, dtype = ctx.x_meta
        dx = torch.zeros(shape, dtype=dtype, device=dout.device)
        acc = [torch.zeros_like(p) for p in params]
        sends = []
        for m in reversed(range(len(saved))):
            h_in, y = saved[m]
            dy = (dout[m].to(y.dtype) if s == stages - 1
                  else collectives.model_recv(y, s + 1))
            grads = torch.autograd.grad(y, [h_in, *params], dy,
                                        allow_unused=True)
            if s > 0:
                sends.append(collectives.model_isend(grads[0], s - 1))
            else:
                dx[m] = grads[0]
            for a, g in zip(acc, grads[1:]):
                if g is not None:
                    a += g
        collectives.wait_all(sends)
        ctx.saved = None
        if acc:
            # one flat all-reduce: each element is one stage's grad plus
            # zeros, so every rank gets the same bits
            flat = collectives.all_reduce_sum_(
                torch.cat([a.reshape(-1) for a in acc]), collectives.MODEL)
            acc = [part.view_as(a) for a, part in
                   zip(acc, flat.split([a.numel() for a in acc]))]
        return (None, None, dx, None, *acc)


def pipeline_apply(layer_fn: Callable, n_layers: int,
                   params: Sequence[torch.Tensor], x: torch.Tensor,
                   aux: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Run x through n_layers layers as a GPipe schedule over the model
    group, the stages its ranks.

    layer_fn(i, h, aux_m, m) -> h' applies global layer i to microbatch m,
    h of shape (mb, ...); it must be row-wise (no mixing of rows). Each
    rank holds every layer and calls layer_fn only for its own.
    params: every tensor the layers read that takes a grad (all layers',
    the same on every rank); their grads come out summed over the model
    group, whole on every rank. x: (M, mb, ...), the M microbatches;
    aux: None or (M, mb, ...), indexed per microbatch, not differentiated.
    -> (M, mb, ...), the last stage's output, replicated over the model
    group (`model_reduce`). x enters through `collectives.model_copy`, so
    its grad, which stage 0 alone computes, comes out whole on every
    model rank, as JAX's transpose of its replicated x gives it (both
    collectives carry float32).

    Builds autograd subgraphs only where grad mode is on; in evaluation
    the same ticks run without them."""
    x = collectives.model_copy(x.float()).to(x.dtype)
    if torch.is_grad_enabled():
        out = _Pipe.apply(layer_fn, n_layers, x, aux, *params)
    else:
        out = _forward(layer_fn, n_layers, x, aux, build=False)[0]
    return collectives.model_reduce(out.float()).to(out.dtype)


def _fold(*words: int) -> int:
    """A 63-bit seed from words (splitmix64 steps), as JAX folds keys."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h ^ (w & 0xFFFFFFFFFFFFFFFF)) * 0xBF58476D1CE4E5B9
        h &= 0xFFFFFFFFFFFFFFFF
        h = ((h ^ (h >> 31)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
        h ^= h >> 29
    return h & 0x7FFFFFFFFFFFFFFF


def _layer_dropouts(layer):
    return (layer.attention.probs_drop, layer.attention_drop,
            layer.output_drop)


def bert_pipeline_forward(bert, input_ids, token_type_ids, attention_mask,
                          n_micro: int = 0) -> torch.Tensor:
    """`bert` (a `models.bert.BertEncoder`, whole on every model rank) on
    this data slot's rows, its layer stack pipelined over the model group
    -> the last hidden states (B, T, H), replicated over the group.

    The embeddings, their LayerNorm and dropout run replicated on every
    model rank before the pipe (from the slot's dropout stream, which
    every model rank of the slot draws in step), and their grad comes out
    whole on every rank (`pipeline_apply`). The rows
    are cut into n_micro microbatches (default: one a stage). `remat`
    recomputes each layer inside its stage (`models.bert._remat_layer`),
    as JAX wraps its layer in `jax.checkpoint`; the recompute binds the
    microbatch's generator again and replays its masks. In bfloat16 the
    residual stream between layers stays bfloat16 (each layer's float32
    LayerNorm output is cast back), as in the JAX pipeline, unlike the
    sequential encoder, which carries the float32 LayerNorm output.

    Raises the JAX package's ValueError where the global batch does not
    divide into the microbatches, or a microbatch not over the data
    axis."""
    from fancyrec_tpu_torch.models.bert import _remat_layer

    cfg = bert.cfg
    b, t = input_ids.shape
    data = collectives.data_size()
    n_micro = n_micro or collectives.model_size()
    if (b * data) % n_micro:
        raise ValueError("batch %d not divisible into %d microbatches"
                         % (b * data, n_micro))
    if (b * data // n_micro) % data:
        raise ValueError(
            "microbatch size %d not divisible by the %d-wide %r axis "
            "(use fewer microbatches or data_axis=None)"
            % (b * data // n_micro, data, collectives.DATA))
    layers = [getattr(bert, "layer_%d" % i)
              for i in range(cfg.num_hidden_layers)]
    hidden = bert.embed(input_ids, token_type_ids).to(cfg.dt)
    bias = bert.attention_bias(attention_mask)
    stochastic = bert.training and (cfg.hidden_dropout_prob > 0.0
                                    or cfg.attention_probs_dropout_prob > 0.0)
    shared = bert.embeddings_drop.generator
    base = None
    if stochastic:
        if shared is None:
            raise RuntimeError("dropout in training mode draws from an "
                               "explicit generator: call seed_dropout(seed) "
                               "on the model first")
        base = int(torch.randint(0, 2 ** 62, (1,), generator=shared,
                                 device=shared.device).item())
    remat = bert.remat()

    def layer_fn(i, h, bias_m, m):
        layer = layers[i]
        if base is not None:
            gen = torch.Generator(device=h.device).manual_seed(
                _fold(base, collectives.data_rank(), i, m))
            for d in _layer_dropouts(layer):
                d.generator = gen
        y = _remat_layer(layer, h, bias_m) if remat else layer(h, bias_m)
        return y.to(h.dtype)

    mb = b // n_micro
    params = [p for layer in layers for p in layer.parameters()]
    try:
        out = pipeline_apply(layer_fn, cfg.num_hidden_layers, params,
                             hidden.reshape(n_micro, mb, t, -1),
                             bias.reshape(n_micro, mb, *bias.shape[1:]))
    finally:
        if base is not None:
            for layer in layers:
                for d in _layer_dropouts(layer):
                    d.generator = shared
    return out.reshape(b, t, -1)

"""The training step: A microbatches, grads summed, one optimizer update.

Port of fancyrec_tpu/train/step.py. As there (and in the reference), the
optimizer steps on the *sum* of the A microbatches' grads, not their mean.
The microbatches run in order with the same parameters; each one's
forward moves the BatchNorm running statistics and the contrastive queue
before the next one runs. Then the global-norm clip, one optimizer step,
and Eiters advances by A.

Data parallelism (a world of R ranks, each with a contiguous 1/R of every
microbatch): what the JAX package computes on a (data=R, model=1) mesh.
Each rank encodes its rows, and the post and brand embeddings are
gathered in rank order into the global microbatch before the loss, so the
loss, the contrastive queue (the global batch's posts, in global order)
and the BatchNorm statistics are the global batch's and the same on every
rank. The per-rank grads are then summed over the ranks with one
all-reduce of the flat grads an update: a sum, not DDP's mean, since the
JAX package applies Adam to the grad sum. The clip, `grad_norm` and the
update use the summed grads, so every rank takes the same step.

Over a (data=R, model=M) mesh both of those collectives run over the
data group: the M model ranks of a slot hold the same rows, so the
gathered batch holds each row once, and the grads are summed over the R
slots only. The flat all-reduce covers every local tensor, a model rank's
shard of a split weight as much as a replicated one: either needs the sum
over the slots and no more (the model group's sums are in the forward and
backward of the split layers). The clip's norm is of the full tensors
(`state.global_norm`).

On one card (`graphable`: the parameters on a CUDA device, a world of
one, no model mesh, no BERT remat) the whole update is a CUDA graph
(`UpdateGraphs`): captured once for each super-batch signature and then
replayed, so the host launches one graph an update where it would issue
every kernel of every microbatch. The graph computes what the eager
update computes, with the same random draws.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.losses import (
    ContrastiveQueueState, contrastive_loss, crossclr_loss, lab_loss,
    triplet_loss)
from fancyrec_tpu_torch.models.bert import BertEncoder
from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
from fancyrec_tpu_torch.models.layers import Dropout
from fancyrec_tpu_torch.ops import kernel_wrappers
from fancyrec_tpu_torch.parallel import collectives
from fancyrec_tpu_torch.train.state import (
    TrainState, clip_grad_norm, global_norm, make_capturable, sharded_params)
from fancyrec_tpu_torch.utils.profiling import span


def micro_loss(model, cfg: Config, queue, mb: Dict[str, torch.Tensor]):
    """One microbatch's forward and loss -> (loss, next queue state).
    Arrays staged in bfloat16 (--transfer_dtype) are upcast to float32 on
    the device first. In a world, mb holds this rank's rows plus the
    global batch-max lengths ('flen_max', 'tlen_max'), and the loss is
    the global microbatch's. A DeepSeek-V2 caption tower's balance loss
    (`FancyRec.take_aux_loss`) joins it."""
    mb = {k: v.float() if v.dtype == torch.bfloat16 else v
          for k, v in mb.items()}
    v = VisualBatch(frames=mb["frames"], mean_origin=mb["origin"],
                    mask=mb["vmask"], max_len=mb.get("flen_max"))
    t = TextBatch(bows=mb["bows"], tokens=mb["tokens"].long(),
                  type_ids=mb["type_ids"].long(), mask=mb["tmask"],
                  max_len=mb.get("tlen_max"))
    brand_emb, post_emb = model(mb["brand_ids"].long(), v, t)
    loss, queue = _recipe_loss(cfg, queue, mb, brand_emb, post_emb)
    aux = model.take_aux_loss()
    if aux is not None:
        # the rank's rows' balance loss, a 1/R share of the global batch's
        loss = loss + aux / collectives.data_size()
    return loss, queue


def _recipe_loss(cfg: Config, queue, mb, brand_emb, post_emb):
    brand_emb = collectives.all_gather(brand_emb)
    post_emb = collectives.all_gather(post_emb)
    brand_ids = collectives.all_gather(mb["brand_ids"].long())
    if cfg.loss_fun == "CrossCLR":
        # the reference builds its CrossCLR loss with every default, so
        # --cost_style does not reach it: always 'sum'
        return crossclr_loss(brand_emb, post_emb, cost_style="sum"), queue
    if cfg.loss_fun == "mrl":
        return triplet_loss(brand_ids, brand_emb, post_emb, margin=cfg.margin,
                            cost_style=cfg.cost_style,
                            direction=cfg.direction), queue
    if cfg.loss_fun == "cl":
        return contrastive_loss(brand_emb, post_emb, queue,
                                cost_style=cfg.cost_style,
                                no_queue=cfg.no_queue, no_intra=cfg.no_intra)
    if cfg.loss_fun == "lab":
        return lab_loss(brand_emb), queue
    raise ValueError("unknown loss_fun: %s" % cfg.loss_fun)


def train_step(model, opt: torch.optim.Optimizer, cfg: Config,
               state: TrainState, superbatch: Dict[str, torch.Tensor]):
    """superbatch: tensors on the model's device, leading axis A.

    -> (state, metrics) with metrics {"loss": the mean over A, "last_loss",
    "grad_norm": the summed grads' global norm before the clip}, all 0-d
    tensors on the device (reading them waits for the device).

    The call is the span `train.step`. Where the update is graphed
    (`graphable`), a replay is the span `train.replay` inside it. Else,
    and in the first update of each super-batch signature, each
    microbatch's `train.forward` (the forward and loss) and
    `train.backward`, then one `train.optimizer` (the clip or the norm,
    and the optimizer's step). They are the host's time: the device runs
    what they issue later, unless an operation inside them waits for it."""
    with span("train.step"):
        graphs = UpdateGraphs.of(model, opt, cfg)
        if graphs is None:
            return _train_step(model, opt, cfg, state, superbatch)
        return graphs.step(state, superbatch)


def _train_step(model, opt, cfg, state, superbatch, grads=None):
    """The update, issued kernel by kernel. grads: None, or every
    parameter's grad (the graphed path's), which is zeroed in place and
    summed into in place, so that a captured update writes the same
    tensors on every replay."""
    model.train()
    a = superbatch["frames"].shape[0]
    params = list(model.parameters())
    if grads is None:
        for p in params:
            p.grad = None
    else:
        torch._foreach_zero_(grads)
    queue = state.queue
    losses = []
    for i in range(a):
        with span("train.forward"):
            loss, queue = micro_loss(model, cfg, queue,
                                     {k: v[i] for k, v in superbatch.items()})
        with span("train.backward"):
            loss.backward()                    # sums into .grad
        losses.append(loss.detach())
    # a parameter the loss does not reach gets a zero grad, as under optax,
    # so its moments still decay: torch's optimizers skip grad=None
    grads: List[torch.Tensor] = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if collectives.data_size() > 1:
        flat = collectives.all_reduce_sum_(torch.cat(
            [g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
    sharded = sharded_params(model)
    with span("train.optimizer"):
        if cfg.grad_clip > 0:
            grad_norm = clip_grad_norm(grads, cfg.grad_clip, sharded)
        else:
            grad_norm = global_norm(grads, sharded)
        opt.step()
    losses = torch.stack(losses)
    return (TrainState(queue=queue, step=state.step + a),
            {"loss": losses.mean(), "last_loss": losses[-1],
             "grad_norm": grad_norm})


def graphable(model) -> bool:
    """Is the model's update captured as a CUDA graph? Where its
    parameters are on a CUDA device and it runs in a world of one: a data
    axis of one rank, no model mesh, no pipeline. A BERT that recomputes
    its layers in the backward (`remat`) stays eager: its recompute
    rewinds the dropout generator on the host, while a captured graph
    draws at the offsets the capture recorded, so the recompute would not
    draw the forward's masks again."""
    return (next(model.parameters()).is_cuda
            and collectives.data_size() == 1
            and getattr(model, "mesh", None) is None
            and not getattr(model, "pp", False)
            and not any(isinstance(m, BertEncoder) and m.cfg.remat
                        for m in model.modules()))


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    inputs: Dict[str, torch.Tensor]   # the super-batch, copied in a replay
    seeds: torch.Tensor               # (A, 2): microbatch i's brand seed words
    out: torch.Tensor                 # (3,): loss, last loss, grad norm
    launches: tuple                   # (kernel wrapper, its launches a replay)


class UpdateGraphs:
    """The CUDA graphs of one model's update under one optimizer and
    config, one a super-batch signature (each key's shape and dtype; A is
    the leading axis), sharing one memory pool: they never run at once.

    A signature's first update runs eagerly: it warms every kernel and
    shape up and makes the optimizer's state. Its second is captured and
    replayed, and later ones are replayed. What a replay reads and writes
    stays at fixed addresses: the parameters, the BatchNorm statistics,
    the optimizer's moments, step counts and lr (`state.make_capturable`),
    every parameter's grad (made once, zeroed and summed into in place),
    the contrastive queue and its pointer (a 0-d device tensor here), the
    super-batch inputs and the brand seed words, which the host copies in
    before each replay. The tower dropouts' generator is registered with
    each graph, so a replay advances its offsets as the eager update
    would; the brand dropout's seed words are drawn on the host, A pairs
    an update in the eager order, and each microbatch's K2 reads its row.
    """

    def __init__(self, model, opt, cfg):
        self.model, self.opt, self.cfg = model, opt, cfg
        self.opt_state = opt.state
        self.device = next(model.parameters()).device
        make_capturable(opt, self.device)
        self.params = list(model.parameters())
        self.grads = None              # every parameter's, after an update
        self.queue = None              # ContrastiveQueueState, static
        self.graphs: Dict[tuple, _Graph] = {}
        self.seen = set()              # signatures whose warm-up has run
        self.pool = None
        self.replays = 0
        gens = {}
        for m in model.modules():
            if isinstance(m, Dropout) and m.generator is not None:
                gens[id(m.generator)] = m.generator
        self.generators = list(gens.values())

    @classmethod
    def of(cls, model, opt, cfg) -> Optional["UpdateGraphs"]:
        """The graphs of `model`'s update under `opt` and `cfg`, kept on
        the optimizer and made on first use; None where the update is not
        graphed (`graphable`). A new optimizer state (`load_state_dict`)
        starts new graphs."""
        have = getattr(opt, "_update_graphs", None)
        if (have is not None and have.model is model and have.cfg is cfg
                and have.opt_state is opt.state):
            return have
        if not graphable(model):
            return None
        opt._update_graphs = cls(model, opt, cfg)
        return opt._update_graphs

    def step(self, state: TrainState, superbatch: Dict[str, torch.Tensor]):
        sig = tuple((k, tuple(v.shape), v.dtype)
                    for k, v in sorted(superbatch.items()))
        g = self.graphs.get(sig)
        if g is None and sig not in self.seen:
            self.seen.add(sig)
            out = _train_step(self.model, self.opt, self.cfg, state,
                              superbatch, self.grads)
            self.grads = [p.grad for p in self.params]
            return out
        if g is None:
            g = self.graphs[sig] = self._capture(state, superbatch)
        return self._replay(g, state, superbatch)

    def _capture(self, state, superbatch) -> _Graph:
        if self.queue is None:
            self.queue = ContrastiveQueueState(
                torch.empty_like(state.queue.queue),
                torch.zeros((), dtype=torch.int64, device=self.device))
        inputs = {k: torch.empty_like(v) for k, v in superbatch.items()}
        a = superbatch["frames"].shape[0]
        seeds = torch.empty((a, 2), dtype=torch.int64, device=self.device)
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        brand = self.model.brand_encoding
        rows = iter(seeds.unbind(0))
        brand.seed_rows = rows
        wrappers = list(kernel_wrappers().values())
        before = [f.launches for f in wrappers]
        try:
            # thread_local: the prefetch thread pins memory meanwhile
            with torch.cuda.graph(graph, pool=self.pool,
                                  capture_error_mode="thread_local"):
                new, metrics = _train_step(
                    self.model, self.opt, self.cfg,
                    TrainState(queue=self.queue), inputs, self.grads)
                if new.queue.queue is not self.queue.queue:
                    self.queue.queue.copy_(new.queue.queue)
                    self.queue.ptr.copy_(new.queue.ptr)
                out = torch.stack([metrics["loss"], metrics["last_loss"],
                                   metrics["grad_norm"]])
        finally:
            brand.seed_rows = None
        # the wrappers count the kernels they launch: a capture launches
        # none, each replay those it recorded
        launches = tuple((f, f.launches - n) for f, n in zip(wrappers, before)
                         if f.launches != n)
        for f, n in zip(wrappers, before):
            f.launches = n
        left = sum(1 for _ in rows)
        if left:
            raise RuntimeError("the captured update drew %d brand seed pairs "
                               "of %d" % (a - left, a))
        if any(p.grad is not g for p, g in zip(self.params, self.grads)):
            raise RuntimeError("the captured backward replaced a grad "
                               "instead of summing into it")
        self.pool = graph.pool()
        return _Graph(graph, inputs, seeds, out, launches)

    def _replay(self, g: _Graph, state, superbatch):
        self.model.train()
        for k, v in g.inputs.items():
            v.copy_(superbatch[k])
        queue, ptr = state.queue
        if queue is not self.queue.queue:
            self.queue.queue.copy_(queue)
        if ptr is not self.queue.ptr:
            if isinstance(ptr, torch.Tensor):
                self.queue.ptr.copy_(ptr)
            else:
                self.queue.ptr.fill_(ptr)
        a = g.seeds.shape[0]
        brand = self.model.brand_encoding
        # a page-locked block is not handed out again before its copy ran
        words = torch.empty((a, 2), dtype=torch.int64, pin_memory=True)
        torch.stack([brand.draw_seed() for _ in range(a)], out=words)
        g.seeds.copy_(words, non_blocking=True)
        with span("train.replay"):
            g.graph.replay()
        self.replays += 1
        for f, n in g.launches:
            f.launches += n
        out = g.out.clone()            # the next replay overwrites g.out
        return (TrainState(queue=self.queue, step=state.step + a),
                {"loss": out[0], "last_loss": out[1], "grad_norm": out[2]})


_BOOKKEEPING_KEYS = ("n_valid", "idxs", "tlen_max", "flen_max",
                     "brand_ids_global")


def stack_microbatches(batches) -> Dict[str, np.ndarray]:
    """List of A batch dicts -> one super-batch dict with leading axis A.
    Host-side bookkeeping (scatter indices, valid counts) is left out: the
    step never reads it. A process-sharded loader's global length maxima
    are kept, one a microbatch ('flen_max', 'tlen_max' of shape (A,)):
    the model bounds its reductions by them."""
    keys = [k for k in batches[0] if k not in _BOOKKEEPING_KEYS]
    out = {k: np.stack([b[k] for b in batches]) for k in keys}
    for k in ("flen_max", "tlen_max"):
        if k in batches[0]:
            out[k] = np.array([b[k] for b in batches], np.int64)
    return out

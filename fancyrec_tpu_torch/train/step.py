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
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.losses import (
    contrastive_loss, crossclr_loss, lab_loss, triplet_loss)
from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
from fancyrec_tpu_torch.parallel import collectives
from fancyrec_tpu_torch.train.state import (
    TrainState, clip_grad_norm, global_norm)


def micro_loss(model, cfg: Config, queue, mb: Dict[str, torch.Tensor]):
    """One microbatch's forward and loss -> (loss, next queue state).
    Arrays staged in bfloat16 (--transfer_dtype) are upcast to float32 on
    the device first. In a world, mb holds this rank's rows plus the
    global batch-max lengths ('flen_max', 'tlen_max'), and the loss is
    the global microbatch's."""
    mb = {k: v.float() if v.dtype == torch.bfloat16 else v
          for k, v in mb.items()}
    v = VisualBatch(frames=mb["frames"], mean_origin=mb["origin"],
                    mask=mb["vmask"], max_len=mb.get("flen_max"))
    t = TextBatch(bows=mb["bows"], tokens=mb["tokens"].long(),
                  type_ids=mb["type_ids"].long(), mask=mb["tmask"],
                  max_len=mb.get("tlen_max"))
    brand_emb, post_emb = model(mb["brand_ids"].long(), v, t)
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
    tensors on the device (reading them waits for the device)."""
    model.train()
    a = superbatch["frames"].shape[0]
    params = list(model.parameters())
    for p in params:
        p.grad = None
    queue = state.queue
    losses = []
    for i in range(a):
        loss, queue = micro_loss(model, cfg, queue,
                                 {k: v[i] for k, v in superbatch.items()})
        loss.backward()                        # sums into .grad
        losses.append(loss.detach())
    # a parameter the loss does not reach gets a zero grad, as under optax,
    # so its moments still decay: torch's optimizers skip grad=None
    grads: List[torch.Tensor] = []
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        grads.append(p.grad)
    if collectives.world_size() > 1:
        flat = collectives.all_reduce_sum_(torch.cat(
            [g.reshape(-1) for g in grads]))
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))
    if cfg.grad_clip > 0:
        grad_norm = clip_grad_norm(grads, cfg.grad_clip)
    else:
        grad_norm = global_norm(grads)
    opt.step()
    losses = torch.stack(losses)
    return (TrainState(queue=queue, step=state.step + a),
            {"loss": losses.mean(), "last_loss": losses[-1],
             "grad_norm": grad_norm})


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

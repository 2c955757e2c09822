"""Train state: the optimizer, the global-norm clip, the lr, the seeded model.

Port of fancyrec_tpu/train/state.py. Parameters and the BatchNorm running
statistics live in the model; the optimizer holds the moments and the lr;
`TrainState` carries what else moves from step to step: the contrastive
queue and the update counter (Eiters).
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List

import torch

from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.losses import ContrastiveQueueState, init_queue_state
from fancyrec_tpu_torch.models import FancyRec, init_fancyrec
from fancyrec_tpu_torch.parallel import distributed


@dataclasses.dataclass
class TrainState:
    queue: ContrastiveQueueState
    step: int = 0                      # Eiters: microbatches consumed


def make_optimizer(cfg: Config, params: Iterable[torch.nn.Parameter]
                   ) -> torch.optim.Optimizer:
    """Adam (eps 1e-8) or RMSprop (alpha 0.99, eps 1e-8 outside the sqrt)
    at cfg.learning_rate: the JAX package's optax transforms, which take
    these torch semantics. The global-norm clip is `clip_grad_norm`, called
    by the train step before the optimizer's step."""
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.learning_rate, eps=1e-8)
    if cfg.optimizer == "rmsprop":
        return torch.optim.RMSprop(params, lr=cfg.learning_rate, alpha=0.99,
                                   eps=1e-8)
    raise ValueError(cfg.optimizer)


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, as optax.global_norm."""
    return torch.sqrt(sum((t * t).sum() for t in tensors))


def clip_grad_norm(grads: List[torch.Tensor], max_norm: float
                   ) -> torch.Tensor:
    """optax.clip_by_global_norm, in place: g -> (g / norm) * max_norm when
    norm >= max_norm, unchanged otherwise. Unlike
    torch.nn.utils.clip_grad_norm_ it neither adds 1e-6 to the norm nor
    scales when under the limit. Stays on the device (no host sync).
    Returns the norm before clipping."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def load_optimizer_state(opt: torch.optim.Optimizer, model: torch.nn.Module,
                         saved: dict) -> None:
    """Restore a checkpoint's optimizer state into `opt`, built by
    `make_optimizer` over `model.parameters()`: a torch state_dict (the
    port's checkpoints) as it is; the name-keyed moments of an FRTPU1 file
    (`checkpoints.optax_moments`) in the model's parameter order, with
    optax's update count as every parameter's step and its injected lr
    as every group's."""
    if "param_groups" in saved:
        opt.load_state_dict(saved)
        return
    kind = {torch.optim.Adam: "adam", torch.optim.RMSprop: "rmsprop"}.get(
        type(opt))
    if saved["optimizer"] != kind:
        raise ValueError("the checkpoint holds %s moments, the optimizer is "
                         "%s" % (saved["optimizer"], type(opt).__name__))
    names = [n for n, _ in model.named_parameters()]
    own = opt.state_dict()
    if [len(g["params"]) for g in own["param_groups"]] != [len(names)]:
        raise ValueError("the optimizer is not one group over the model's "
                         "parameters")
    if set(saved["state"]) != set(names):
        raise ValueError(
            "the checkpoint's moments do not match the model: missing %s, "
            "unexpected %s" % (sorted(set(names) - set(saved["state"])),
                               sorted(set(saved["state"]) - set(names))))
    step = torch.tensor(float(saved["step"]))
    opt.load_state_dict({
        "state": {i: {"step": step.clone(), **saved["state"][n]}
                  for i, n in enumerate(names)},
        "param_groups": [dict(g, lr=saved["lr"])
                         for g in own["param_groups"]]})


def current_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def scale_lr(opt: torch.optim.Optimizer, factor: float) -> None:
    """Multiplicative lr decay, in place on every param group."""
    for group in opt.param_groups:
        group["lr"] = group["lr"] * factor


def init_state(cfg: Config, device, seed: int = None):
    """-> (model, optimizer, TrainState): random weights from `seed`
    (default cfg.seed), the model on `device` with its dropouts seeded
    (in a world, each rank's dropouts from a stream of its own)."""
    seed = cfg.seed if seed is None else seed
    model = init_fancyrec(FancyRec(cfg), torch.Generator().manual_seed(seed))
    model.to(device).seed_dropout(distributed.dropout_seed(seed))
    opt = make_optimizer(cfg, model.parameters())
    state = TrainState(queue=init_queue_state(
        cfg.queue_size, cfg.common_embedding_size, device=device))
    return model, opt, state

"""Carry the JAX package's FancyRec weights into the port.

`load_jax_variables` takes the `{"params", "batch_stats"}` trees as numpy
arrays (what flax.serialization or jax.device_get gives) and fills the
port's state dict. The port names its modules after the JAX tree, so each
leaf's path maps onto a state-dict key; only layouts change:
  * flax Dense kernels (in, out) -> torch Linear weights (out, in);
  * flax Conv kernels (ws, D, K) -> torch Conv1d weights (K, D, ws);
  * flax 2-D Conv kernels (kh, kw, I, O) -> torch Conv2d weights
    (O, I, kh, kw) (the ResNet-152 extractor);
  * LayerNorm/BatchNorm `scale` -> `weight`;
  * BatchNorm running stats `batch_stats/.../mean|var` ->
    `running_mean|running_var` buffers;
  * GRU weights and the 'attn' fusion's vectors (vis_linear, text_linear,
    b) are already in torch layout.
`models.torch_import` builds the same trees from the reference's torch
checkpoints.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = prefix + str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, path + "."))
        else:
            out[path] = np.asarray(v)
    return out


def _param_entry(path: str, value: np.ndarray):
    head, _, leaf = path.rpartition(".")
    if leaf == "kernel":
        if value.ndim == 2:
            return head + ".weight", value.T
        if value.ndim == 3:
            return head + ".weight", value.transpose(2, 1, 0)
        if value.ndim == 4:
            return head + ".weight", value.transpose(3, 2, 0, 1)
        raise ValueError("unexpected kernel rank at %s: %s"
                         % (path, value.shape))
    if leaf == "scale":
        return head + ".weight", value
    return path, value


def torch_params_from_jax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A tree shaped like the JAX `params` -> float32 tensors keyed by the
    port's parameter names, each in its torch layout. Takes the parameters
    themselves or anything laid out like them, such as an optimizer's
    moments (optax's Adam `mu` and `nu`): a moment carried without its
    layout change would load and then train wrongly."""
    out = {}
    for path, value in _flatten(tree).items():
        key, arr = _param_entry(path, value)
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return out


def torch_state_from_jax(params: Mapping, batch_stats: Mapping = None
                         ) -> Dict[str, torch.Tensor]:
    """The JAX variable trees -> a state dict keyed like the port's."""
    state = torch_params_from_jax(params)
    for path, value in _flatten(batch_stats or {}).items():
        head, _, leaf = path.rpartition(".")
        names = {"mean": "running_mean", "var": "running_var"}
        if leaf not in names:
            raise ValueError("unexpected batch_stats leaf %s" % path)
        state[head + "." + names[leaf]] = torch.from_numpy(
            np.ascontiguousarray(value, np.float32))
    return state


def load_jax_variables(model: nn.Module, params: Mapping,
                       batch_stats: Mapping = None) -> nn.Module:
    """Fill `model` (a port FancyRec or ResNetFeatures) from the JAX
    package's variables.

    Strict: every port parameter and buffer must be covered and every JAX
    leaf must land, with matching shapes."""
    state = torch_state_from_jax(params, batch_stats)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError("JAX variables do not match the port model: "
                         "missing %s, unexpected %s" % (missing, extra))
    for k, v in state.items():
        if tuple(v.shape) != tuple(own[k].shape):
            raise ValueError("shape mismatch at %s: JAX %s, port %s"
                             % (k, tuple(v.shape), tuple(own[k].shape)))
    model.load_state_dict(state)
    return model

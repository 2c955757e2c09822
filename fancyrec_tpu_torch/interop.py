"""Carry the JAX package's FancyRec weights into the port.

`load_jax_variables` takes the `{"params", "batch_stats"}` trees as numpy
arrays (what flax.serialization or jax.device_get gives) and fills the
port's state dict. The port names its modules after the JAX tree, so each
leaf's path maps onto a state-dict key; only layouts change:
  * flax Dense kernels (in, out) -> torch Linear weights (out, in);
  * flax Conv kernels (ws, D, K) -> torch Conv1d weights (K, D, ws);
  * LayerNorm/BatchNorm `scale` -> `weight`;
  * BatchNorm running stats `batch_stats/.../mean|var` ->
    `running_mean|running_var` buffers;
  * GRU weights are already in torch layout.
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
        raise ValueError("unexpected kernel rank at %s: %s"
                         % (path, value.shape))
    if leaf == "scale":
        return head + ".weight", value
    return path, value


def torch_state_from_jax(params: Mapping, batch_stats: Mapping = None
                         ) -> Dict[str, torch.Tensor]:
    """The JAX variable trees -> a state dict keyed like the port's."""
    state = {}
    for path, value in _flatten(params).items():
        key, arr = _param_entry(path, value)
        state[key] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
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
    """Fill `model` (a port FancyRec) from the JAX package's variables.

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

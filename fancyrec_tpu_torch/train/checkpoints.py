"""The port's own checkpoint: the config JSON plus the model state dict.

One `torch.save` file holding plain tensors and strings, so it loads with
`weights_only=True` on any device. Reading the JAX package's FRTPU1
checkpoints (msgpack) is not ported: carry JAX weights across with
`fancyrec_tpu_torch.interop.load_jax_variables` instead.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import torch
from torch import nn

from fancyrec_tpu_torch.config import Config

FORMAT = "fancyrec_tpu_torch/1"


def save_checkpoint(path: str, cfg: Config, model: nn.Module,
                    **meta: Any) -> None:
    """Write atomically (tmp + rename): a crash mid-save leaves no
    truncated file behind. `meta` holds JSON-serializable scalars."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    tmp = path + ".tmp"
    torch.save({"format": FORMAT, "config": cfg.to_json(),
                "meta": json.dumps(meta), "state_dict": state}, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """-> {"config": Config, "state_dict": {name: CPU tensor}, **meta}."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError("not a %s checkpoint: %s" % (FORMAT, path))
    return {"config": Config.from_json(blob["config"]),
            "state_dict": blob["state_dict"], **json.loads(blob["meta"])}

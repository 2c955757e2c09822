"""The port's own checkpoint: config JSON, model state dict, optimizer state.

One `torch.save` file holding plain tensors, numbers and strings, so it
loads with `weights_only=True` on any device. The serving path reads the
config and the state dict; the trainer also the optimizer's state_dict
(the Adam moments, for an exact resume) and the meta fields (epoch,
best_rsum, Eiters, no_impr, lr_counter, pending_lr_scale). The file names
and the save policy are the JAX package's (fancyrec_tpu/train/
checkpoints.py): checkpoint_epoch_<e>.pth.tar and model_best.pth.tar.

`load_any` also reads the two other formats a FancyRec model comes in:
  * the JAX package's FRTPU1 files (a magic line, then four
    length-prefixed blobs: config JSON, meta JSON, the msgpack of the flax
    `{params, batch_stats}` and the msgpack of the optax state), decoded
    by `io.msgpack` and carried across by `interop`; the optax Adam or
    RMSprop moments come back keyed by the port's parameter names
    (`optax_moments`), for `train.state.load_optimizer_state`;
  * the reference's own torch checkpoints (a list-form state dict beside
    the pickled argparse options), converted through
    `models.torch_import` and `interop`.
So a model trained by the JAX package or the reference evaluates, serves
and resumes training in the port.

A file always holds the whole model. Under a model axis, saving gathers
every split parameter and Adam moment over the model group (every rank
takes part; the primary writes), and loading cuts the whole tree to the
rank's shard (`FancyRec.load_full_state_dict`,
`state.load_optimizer_state`), so a file from any mesh, or from the JAX
package, loads under any other.
"""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
import re
import shutil
import struct
from typing import Any, Dict, Optional

import torch
from torch import nn

from fancyrec_tpu_torch.config import Config

FORMAT = "fancyrec_tpu_torch/1"
_JAX_MAGIC = b"FRTPU1\n"      # the JAX package's msgpack checkpoints
_EPOCH_FILE = re.compile(r"checkpoint_epoch_(\d+)\.pth\.tar$")


def save_checkpoint(path: str, cfg: Config, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    write: bool = True, **meta: Any) -> None:
    """Write atomically (tmp + rename): a crash mid-save leaves no
    truncated file behind for a resume to pick. `meta` holds
    JSON-serializable scalars. A model built for a model rank is gathered
    first, a collective: every rank of its model group calls this, and
    only the one with `write` writes."""
    from fancyrec_tpu_torch.train.state import full_optimizer_state

    sharded = getattr(model, "mesh", None) is not None
    if not (write or sharded):
        return
    state = model.full_state_dict() if sharded else model.state_dict()
    opt_state = None
    if optimizer is not None:
        # its tensors stay where they are; load_checkpoint maps them to CPU
        opt_state = full_optimizer_state(optimizer, model)
    if not write:
        return
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().cpu() for k, v in state.items()}
    blob = {"format": FORMAT, "config": cfg.to_json(),
            "meta": json.dumps(meta), "state_dict": state}
    if opt_state is not None:
        blob["optimizer"] = opt_state
    tmp = path + ".tmp"
    torch.save(blob, tmp)
    os.replace(tmp, path)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """-> {"config": Config, "state_dict": {name: CPU tensor}, **meta}, and
    "optimizer" (a state_dict) where one was saved."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError("not a %s checkpoint: %s" % (FORMAT, path))
    return _unpack(blob)


def _unpack(blob: Dict[str, Any]) -> Dict[str, Any]:
    out = {"config": Config.from_json(blob["config"]),
           "state_dict": blob["state_dict"], **json.loads(blob["meta"])}
    if "optimizer" in blob:
        out["optimizer"] = blob["optimizer"]
    return out


def _config_from_reference_opt(opt) -> Config:
    """The reference's pickled argparse options -> Config, as the JAX
    package rebuilds it: unknown options dropped, the list forms that the
    reference's setup leaves behind undone, the optimizer object dropped."""
    known = {f.name for f in dataclasses.fields(Config)}
    raw = {k: v for k, v in vars(opt).items() if k in known}
    for k in ("text_mapping_size", "visual_mapping_size"):
        if isinstance(raw.get(k), (list, tuple)):
            raw[k] = raw[k][1]
    for k in ("text_kernel_sizes", "visual_kernel_sizes"):
        if isinstance(raw.get(k), (list, tuple)):
            raw[k] = "-".join(str(x) for x in raw[k])
    raw.pop("optimizer", None)   # the reference stores the optimizer here
    return Config(**{k: v for k, v in raw.items()
                     if not k.startswith("_")}).finalize()


def _find(tree, *keys):
    """The first map in `tree` (depth first) that holds every key."""
    if not isinstance(tree, dict):
        return None
    if all(k in tree for k in keys):
        return tree
    for v in tree.values():
        hit = _find(v, *keys)
        if hit is not None:
            return hit
    return None


def optax_moments(opt_tree) -> Dict[str, Any]:
    """The msgpack-restored optax state of the JAX package's optimizer
    (`chain([clip_by_global_norm,] inject_hyperparams(adam | rmsprop))`)
    -> {"optimizer": "adam" | "rmsprop", "step": the update count, "lr":
    the injected learning rate, "state": {port parameter name: {"exp_avg",
    "exp_avg_sq"} (Adam's mu, nu) or {"square_avg"} (RMSprop's nu)}},
    each moment in its parameter's torch layout."""
    from fancyrec_tpu_torch.interop import torch_params_from_jax

    inject = _find(opt_tree, "hyperparams", "inner_state")
    if inject is None:
        raise ValueError("no inject_hyperparams state in the optax tree")
    lr = float(inject["hyperparams"]["learning_rate"])
    adam = _find(inject["inner_state"], "mu", "nu")
    if adam is not None:
        mu, nu = (torch_params_from_jax(adam[k]) for k in ("mu", "nu"))
        return {"optimizer": "adam", "step": int(adam["count"]), "lr": lr,
                "state": {k: {"exp_avg": mu[k], "exp_avg_sq": nu[k]}
                          for k in mu}}
    rms = _find(inject["inner_state"], "nu")
    if rms is None:
        raise ValueError("neither Adam nor RMSprop moments in the optax tree")
    nu = torch_params_from_jax(rms["nu"])
    return {"optimizer": "rmsprop", "step": int(inject["count"]), "lr": lr,
            "state": {k: {"square_avg": v} for k, v in nu.items()}}


def _read_blobs(path: str):
    blobs = []
    with open(path, "rb") as f:
        if f.read(len(_JAX_MAGIC)) != _JAX_MAGIC:
            raise ValueError("not an FRTPU1 checkpoint: %s" % path)
        while True:
            size = f.read(8)
            if not size:
                break
            if len(size) < 8:
                raise ValueError("FRTPU1 checkpoint %s: truncated length"
                                 % path)
            (n,) = struct.unpack("<Q", size)
            blob = f.read(n)
            if len(blob) != n:
                raise ValueError("FRTPU1 checkpoint %s: blob %d truncated "
                                 "(%d of %d bytes)"
                                 % (path, len(blobs), len(blob), n))
            blobs.append(blob)
    if len(blobs) < 3:
        raise ValueError("FRTPU1 checkpoint %s: %d blobs, want config, meta "
                         "and model" % (path, len(blobs)))
    return blobs


def load_frtpu1(path: str) -> Dict[str, Any]:
    """The JAX package's checkpoint -> {"config", "state_dict", **meta},
    and "optimizer" (the `optax_moments` of its optax state) where the
    file holds one (meta `has_opt_state`)."""
    from fancyrec_tpu_torch.interop import torch_state_from_jax
    from fancyrec_tpu_torch.io.msgpack import msgpack_restore

    blobs = _read_blobs(path)
    meta = json.loads(blobs[1].decode())
    variables = msgpack_restore(blobs[2])
    out = {"config": Config.from_json(blobs[0].decode()),
           "state_dict": torch_state_from_jax(
               variables["params"], variables.get("batch_stats") or {}),
           **meta}
    if meta.get("has_opt_state") and len(blobs) > 3 and blobs[3]:
        out["optimizer"] = optax_moments(msgpack_restore(blobs[3]))
    return out


def load_any(path: str) -> Dict[str, Any]:
    """The port's checkpoint, the JAX package's FRTPU1 or a reference
    torch checkpoint (auto-detected) -> {"config", "state_dict", **meta},
    and "optimizer" where the file carries the optimizer's state (a torch
    state_dict from the port's files, `optax_moments` from FRTPU1). A
    reference checkpoint's config comes from its pickled options, with the
    BERT dimensions read off its weights."""
    from fancyrec_tpu_torch.interop import torch_state_from_jax
    from fancyrec_tpu_torch.models.torch_import import (
        fancyrec_variables_from_reference)

    with open(path, "rb") as f:
        if f.read(len(_JAX_MAGIC)) == _JAX_MAGIC:
            return load_frtpu1(path)
    try:
        blob = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:      # objects beyond tensors and numbers
        blob = None
    if isinstance(blob, dict) and blob.get("format") == FORMAT:
        return _unpack(blob)
    # The reference pickles its argparse.Namespace of options, optimizer
    # object included, beside the weights: only a full unpickling
    # (weights_only=False) restores it. Load only checkpoints you trust.
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if not (isinstance(ckpt, dict) and isinstance(ckpt.get("model"), list)):
        raise ValueError("neither a %s nor a reference FancyRec checkpoint: "
                         "%s" % (FORMAT, path))
    cfg = _config_from_reference_opt(ckpt["opt"])
    variables = fancyrec_variables_from_reference(ckpt["model"], cfg)
    return {"config": cfg,
            "state_dict": torch_state_from_jax(
                variables["params"], variables.get("batch_stats")),
            "epoch": ckpt.get("epoch", 0),
            "best_rsum": ckpt.get("best_rsum", 0.0),
            "Eiters": ckpt.get("Eiters", 0)}


def latest_epoch_checkpoint(logdir: str):
    """-> (epoch, path) of the newest epoch checkpoint, or (-1, None)."""
    best = (-1, None)
    if os.path.isdir(logdir):
        for f in os.listdir(logdir):
            m = _EPOCH_FILE.match(f)
            if m and int(m.group(1)) > best[0]:
                best = (int(m.group(1)), os.path.join(logdir, f))
    return best


def prune_old_checkpoints(state_dir: str, keep: int) -> None:
    """Delete all but the newest `keep` epoch checkpoints (by epoch number);
    keep <= 0 keeps everything. model_best.pth.tar is a copy and is never
    pruned."""
    if keep <= 0 or not os.path.isdir(state_dir):
        return
    epochs = sorted((int(m.group(1)), f) for f in os.listdir(state_dir)
                    for m in [_EPOCH_FILE.match(f)] if m)
    for _, f in epochs[:-keep]:
        try:
            os.remove(os.path.join(state_dir, f))
        except FileNotFoundError:
            pass


def maybe_save_best(state_dir: str, cfg: Config, model: nn.Module,
                    epoch: int, score: float, best_rsum: float, eiters: int,
                    best_epoch: Optional[int],
                    optimizer: Optional[torch.optim.Optimizer] = None,
                    extra_meta: Optional[dict] = None,
                    write: bool = True) -> float:
    """The reference's policy: write the epoch file when there is no best
    yet or score > 0.99 best, copy it to model_best on improvement, return
    the new best. The file records the running best (the JAX package's
    fix: the reference stores the epoch's own score). In a world every
    rank calls it with the same score (a model rank's part goes into the
    file), and only the primary, `write`, touches the disk."""
    filename = os.path.join(state_dir, "checkpoint_epoch_%s.pth.tar" % epoch)
    new_best = max(score, best_rsum)
    if best_epoch is None or score > best_rsum * 0.99:
        save_checkpoint(filename, cfg, model, optimizer, write=write,
                        epoch=epoch + 1, best_rsum=new_best, Eiters=eiters,
                        **(extra_meta or {}))
    if not write:
        return new_best
    if score > best_rsum:
        shutil.copyfile(filename, os.path.join(state_dir, "model_best.pth.tar"))
    prune_old_checkpoints(state_dir, cfg.keep_checkpoints)
    return new_best

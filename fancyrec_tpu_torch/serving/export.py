"""Serialized serving artifacts: `torch.export` programs of the model.

Port of fancyrec_tpu/serving/export.py. Each serving entry point is traced
once with `torch.export` into a program that reloads and runs without the
model code. The weights are an ARGUMENT of every program (the entry is
traced through `torch.func.functional_call` in a parameter-free wrapper)
and ship once beside them, so the N entry points share one copy.

Artifact layout (out_dir/):
  manifest.json   format "fancyrec-torch-export-v1", torch version,
                  platforms, model dims, the custom operators the programs
                  call, and per entry its args, arg shapes ("b" for a
                  symbolic batch), arg dtypes, out shape and bytes
  weights.pt      the parameters and buffers (BatchNorm running statistics
                  included), one torch.save'd dict
  <entry>.pt2     the `torch.export.save`d program of one entry point

Entry points (deterministic forwards, the batch symbolic by default):
  encode_post  (weights, frames, origin, vmask, bows, tokens, type_ids,
                tmask) -> (B, common) fused post embeddings
  embed_brand  (weights) -> (brand_num, common) all brands
  embed_vis    visual-only embedding, where the visual tower exists
  embed_txt    text-only embedding, where the text tower exists

The bi-GRU recurrence is the operator `fancyrec::gru_scan_fwd`
(`ops/gru_scan.py`): one node of the graph, which runs the CUDA kernel on
the card and its plain version on the CPU. A program records the device
of the exporting run; `ExportedModel` moves it to the device it loads on,
so one artifact serves on either.

CLI (exports on CUDA unless --device cpu):
  python -m fancyrec_tpu_torch.serving.export out/ --checkpoint CKPT \\
      [--batch 0] [--entries encode_post,embed_brand] [--platforms cuda,cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from fancyrec_tpu_torch.device import resolve_device
from fancyrec_tpu_torch.eval.evaluator import (
    encode_batch, encode_txt, encode_vis)

FORMAT = "fancyrec-torch-export-v1"
MANIFEST = "manifest.json"
WEIGHTS_FILE = "weights.pt"
CUSTOM_OPS = ("fancyrec::gru_scan_fwd",)

# model-input array order of the encode_post entry point: the loader's
# batch-dict keys
POST_ARGS = ("frames", "origin", "vmask", "bows", "tokens", "type_ids",
             "tmask")
VIS_ARGS = ("frames", "origin", "vmask")
TXT_ARGS = ("bows", "tokens", "type_ids", "tmask")
_EXAMPLE_BATCH = 2      # traced batch size when the batch is symbolic


def _arg_specs(cfg) -> Dict[str, tuple]:
    """name -> (per-row shape, dtype) of one loader batch."""
    tok = cfg.max_tokens if cfg.text_net == "transformers" else cfg.max_words
    f32, i32 = torch.float32, torch.int32
    return {"frames": ((cfg.max_frames, cfg.visual_feat_dim), f32),
            "origin": ((cfg.visual_feat_dim,), f32),
            "vmask": ((cfg.max_frames,), f32),
            "bows": ((cfg.bow_vocab_size,), f32),
            "tokens": ((tok,), i32),
            "type_ids": ((tok,), i32),
            "tmask": ((tok,), i32)}


class _Entry(nn.Module):
    """The model with one serving entry point as its forward."""

    def __init__(self, model, name: str, arg_names: Sequence[str]):
        super().__init__()
        self.model = model
        self.name = name
        self.arg_names = tuple(arg_names)

    def forward(self, *arrays):
        batch = dict(zip(self.arg_names, arrays))
        if self.name == "embed_brand":
            ids = torch.arange(self.model.cfg.brand_num,
                               device=self.model.brand_encoding
                               .aspects_embeddings.device)
            return self.model.embed_brand(ids)
        fn = {"encode_post": encode_batch, "embed_vis": encode_vis,
              "embed_txt": encode_txt}[self.name]
        return fn(self.model, batch)


class _Program(nn.Module):
    """Parameter-free: the weights come in as the first argument."""

    def __init__(self, entry: _Entry):
        super().__init__()
        object.__setattr__(self, "entry", entry)    # not a submodule

    def forward(self, weights: Dict[str, torch.Tensor], *arrays):
        return torch.func.functional_call(self.entry, weights, arrays)


def _entry_args(cfg) -> Dict[str, tuple]:
    entries = {"encode_post": POST_ARGS, "embed_brand": ()}
    if not cfg.single_modal_text:        # the visual tower exists
        entries["embed_vis"] = VIS_ARGS
    if not cfg.single_modal_visual:      # the text tower exists
        entries["embed_txt"] = TXT_ARGS
    return entries


def export_model(checkpoint_path: str, out_dir: str,
                 platforms: Sequence[str] = ("cuda", "cpu"),
                 batch: int = 0,
                 entries: Optional[Sequence[str]] = None,
                 device="cuda") -> dict:
    """Export every serving entry point of a checkpoint (any file
    `train.checkpoints.load_any` reads), traced on `device`.

    batch: 0 = a symbolic batch dimension (one artifact serves every batch
    size); N = a fixed batch. Returns the manifest, whose "seconds" hold
    each entry's export time."""
    from fancyrec_tpu_torch.models import FancyRec
    from fancyrec_tpu_torch.train.checkpoints import load_any

    dev = resolve_device(device)
    ckpt = load_any(checkpoint_path)
    cfg = ckpt["config"]
    if cfg.bow_vocab_size <= 0 or (
            cfg.text_net == "bi-gru" and cfg.vocab_size <= 0):
        raise ValueError(
            "checkpoint config has no vocab sizes -- was it saved by the "
            "trainer? (bow_vocab_size=%d)" % cfg.bow_vocab_size)
    fns = _entry_args(cfg)
    if entries:
        unknown = set(entries) - set(fns)
        if unknown:
            raise ValueError("unknown entry points: %s (have %s)"
                             % (sorted(unknown), sorted(fns)))
        fns = {k: v for k, v in fns.items() if k in entries}

    model = FancyRec(cfg)
    model.load_state_dict(ckpt["state_dict"])
    model.to(dev).eval()
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    specs = _arg_specs(cfg)
    b_dim = torch.export.Dim("b", min=1) if batch == 0 else None
    n_ex = _EXAMPLE_BATCH if batch == 0 else int(batch)

    os.makedirs(out_dir, exist_ok=True)
    manifest = {
        "format": FORMAT,
        "torch_version": torch.__version__,
        "platforms": list(platforms),
        "batch": batch,
        "weights_file": WEIGHTS_FILE,
        "custom_ops": list(CUSTOM_OPS),
        "model": {
            "brand_num": int(cfg.brand_num),
            "common_dim": int(cfg.common_embedding_size),
            "text_net": cfg.text_net,
            "fusion_style": cfg.fusion_style,
            "max_frames": int(cfg.max_frames),
            "visual_feat_dim": int(cfg.visual_feat_dim),
            "bow_vocab_size": int(cfg.bow_vocab_size),
            "tokens": int(cfg.max_tokens if cfg.text_net == "transformers"
                          else cfg.max_words),
        },
        "entries": {},
        "seconds": {},
    }
    for name, arg_names in fns.items():
        t0 = time.perf_counter()
        program = _Program(_Entry(model, name, arg_names))
        wkeys = {"model." + k: v for k, v in weights.items()}
        example = tuple(torch.zeros((n_ex,) + specs[a][0], dtype=specs[a][1],
                                    device=dev) for a in arg_names)
        dynamic = ({k: None for k in wkeys},)
        if arg_names:
            dynamic += (tuple({0: b_dim} if b_dim is not None else None
                              for _ in arg_names),)
        with torch.no_grad():
            ep = torch.export.export(program, (wkeys,) + example,
                                     dynamic_shapes=dynamic, strict=False)
        # the example inputs (the weights among them) are not saved beside
        # the program: the weights ship once, in WEIGHTS_FILE
        ep._example_inputs = None
        path = os.path.join(out_dir, name + ".pt2")
        torch.export.save(ep, path)
        out = [n for n in ep.graph.nodes if n.op == "output"][0].args[0]
        out_shape = [str(d) if isinstance(d, int) else "b"
                     for d in out[0].meta["val"].shape]
        manifest["entries"][name] = {
            "args": list(arg_names),
            "arg_shapes": {a: ["b" if b_dim is not None else str(n_ex)]
                           + [str(d) for d in specs[a][0]]
                           for a in arg_names},
            "arg_dtypes": {a: str(specs[a][1]).replace("torch.", "")
                           for a in arg_names},
            "out_shape": out_shape,
            "bytes": os.path.getsize(path),
        }
        manifest["seconds"][name] = time.perf_counter() - t0
    torch.save({k: v.cpu() for k, v in weights.items()},
               os.path.join(out_dir, WEIGHTS_FILE))
    with open(os.path.join(out_dir, MANIFEST), "w") as f:
        f.write(json.dumps(manifest, indent=1))
    return manifest


class ExportedModel:
    """Run exported serving artifacts: no model code, no Config.

    >>> m = ExportedModel("artifacts/", device="cuda")
    >>> post_embs = m.encode_post(batch)      # loader batch dict
    >>> brands = m.embed_brand()              # (brand_num, common_dim)
    """

    def __init__(self, artifact_dir: str, device="cuda"):
        # registers fancyrec::gru_scan_fwd, which the programs call
        import fancyrec_tpu_torch.ops.gru_scan  # noqa: F401
        from torch.export.passes import move_to_device_pass

        self.device = resolve_device(device)
        with open(os.path.join(artifact_dir, MANIFEST)) as f:
            self.manifest = json.loads(f.read())
        if self.manifest.get("format") != FORMAT:
            raise ValueError("not a fancyrec export dir: %s" % artifact_dir)
        # the weights go to the device once, at load
        weights = torch.load(
            os.path.join(artifact_dir, self.manifest["weights_file"]),
            map_location="cpu", weights_only=True)
        self._weights = {"model." + k: v.to(self.device)
                         for k, v in weights.items()}
        self._fns = {}
        self.load_seconds = {}
        for name in self.manifest["entries"]:
            t0 = time.perf_counter()
            ep = torch.export.load(os.path.join(artifact_dir, name + ".pt2"))
            # the program recorded the exporting device (factory ops such as
            # torch.arange(..., device=...)): move it to this one
            ep = move_to_device_pass(ep, str(self.device))
            self._fns[name] = ep.module()
            self.load_seconds[name] = time.perf_counter() - t0

    @property
    def entry_points(self):
        return sorted(self._fns)

    def _call(self, name: str, batch: Optional[dict]) -> torch.Tensor:
        if name not in self._fns:
            raise KeyError("entry %r not in artifact (has %s)"
                           % (name, self.entry_points))
        entry = self.manifest["entries"][name]
        args = []
        for a in entry["args"]:
            # cast by the manifest's dtypes: JSON lists arrive as
            # float64/int64, which the traced program would reject
            dt = getattr(torch, entry["arg_dtypes"][a])
            x = batch[a]
            if not isinstance(x, torch.Tensor):
                x = torch.from_numpy(np.asarray(x))
            args.append(x.to(device=self.device, dtype=dt))
        with torch.no_grad():
            return self._fns[name](self._weights, *args)

    def encode_post(self, batch: dict) -> torch.Tensor:
        return self._call("encode_post", batch)

    def embed_brand(self) -> torch.Tensor:
        return self._call("embed_brand", None)

    def embed_vis(self, batch: dict) -> torch.Tensor:
        return self._call("embed_vis", batch)

    def embed_txt(self, batch: dict) -> torch.Tensor:
        return self._call("embed_txt", batch)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="export serving entry points as torch.export artifacts")
    p.add_argument("out_dir")
    p.add_argument("--checkpoint", required=True)
    p.add_argument("--batch", type=int, default=0,
                   help="0 = symbolic batch dim (default); N = fixed batch")
    p.add_argument("--platforms", default="cuda,cpu",
                   help="comma-separated devices the artifact is meant for "
                        "(recorded in the manifest; every program moves to "
                        "the device it loads on)")
    p.add_argument("--entries", default="",
                   help="comma-separated subset of entry points "
                        "(default: all)")
    p.add_argument("--device", default="cuda",
                   help="device to trace on: cuda (default) or cpu")
    a = p.parse_args(argv)
    manifest = export_model(
        a.checkpoint, a.out_dir,
        platforms=[s for s in a.platforms.split(",") if s],
        batch=a.batch,
        entries=[s for s in a.entries.split(",") if s] or None,
        device=a.device)
    print(json.dumps({"out": a.out_dir,
                      "entries": sorted(manifest["entries"]),
                      "platforms": manifest["platforms"],
                      "seconds": manifest["seconds"]}))


if __name__ == "__main__":
    main()

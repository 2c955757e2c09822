"""Encode a collection's posts and the brands with the port's model.

Port of `encode_data` and `brand_embeddings` from
fancyrec_tpu/eval/evaluator.py, on one device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fancyrec_tpu_torch.data.loader import bucket_batch, prefetch_to_device
from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch

# model-input keys of a batch dict; the rest (idxs, n_valid) is host-side
# scatter bookkeeping that never reaches the device
_MODEL_KEYS = ("frames", "origin", "vmask", "bows", "tokens", "type_ids",
               "tmask")


def encode_batch(model, dev: dict) -> torch.Tensor:
    """One batch of device tensors -> post embeddings (B, common)."""
    v = VisualBatch(frames=dev["frames"], mean_origin=dev["origin"],
                    mask=dev["vmask"])
    t = TextBatch(bows=dev["bows"], tokens=dev["tokens"].long(),
                  type_ids=dev["type_ids"].long(), mask=dev["tmask"])
    return model.embed_post(v, t)


@torch.no_grad()
def encode_data(model, loader, common_dim: int, device: torch.device,
                token_buckets=None, frame_buckets=None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every post in `loader` -> (brands, post_embs) scattered by
    dataset index. `model` is in evaluation mode on `device`.

    token_buckets/frame_buckets: quantized dynamic padding (exact -- see
    data/loader.bucket_batch); pair with a length-sorted loader."""
    n = len(loader.dataset)
    post_embs = np.zeros((n, common_dim), np.float32)
    brands = np.zeros(n, np.int32)

    def stage(batch):
        if token_buckets or frame_buckets:
            return bucket_batch(batch, token_buckets, frame_buckets)
        return batch

    for batch, dev in prefetch_to_device(iter(loader), device, _MODEL_KEYS,
                                         size=2, stage=stage):
        embs = encode_batch(model, dev).cpu().numpy()
        # padding rows repeat the last item and write identical values
        post_embs[batch["idxs"]] = embs
        brands[batch["idxs"]] = batch["brand_ids"]
    return brands, post_embs


@torch.no_grad()
def brand_embeddings(model, brand_num: int, device: torch.device
                     ) -> torch.Tensor:
    """All-brand embeddings: aspect mixtures meaned over the aspect axis."""
    ids = torch.arange(brand_num, device=device)
    return model.embed_brand(ids)

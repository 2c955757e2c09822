"""Encode a collection's posts and the brands, and rank posts for brands.

Port of `encode_data`, the single-modality encoders, `random_sim`,
`brand_embeddings` and `test_post_ranking` from
fancyrec_tpu/eval/evaluator.py. The brands x posts cosine of
`test_post_ranking` is the cosine kernel (`ops.similarity.
cosine_scores`: `csrc/cosine_scores.cu` for CUDA tensors). In a world of
R ranks with a process-sharded loader, each rank encodes its slice of
every batch and the slices are all-gathered; the ranking then splits the
posts into R shards, each rank scores its own with the cosine kernel, and
`metrics.ranking_metrics_sharded` computes the exact metrics without
gathering the (brands, posts) matrix. Post
embeddings leave the towers as float32 (a bfloat16 model's are upcast,
exactly), as the JAX package collects them into float32 buffers: the
cosine kernel, the index's int8 quantization and the files on disk take
float32. The brand tower is float32 under any compute dtype.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from fancyrec_tpu_torch.data.loader import bucket_batch, prefetch_to_device
from fancyrec_tpu_torch.eval.metrics import (
    RankingMetrics, ranking_metrics, ranking_metrics_sharded)
from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
from fancyrec_tpu_torch.parallel import collectives
from fancyrec_tpu_torch.ops.similarity import cosine_scores
from fancyrec_tpu_torch.utils.meters import Progress

# model-input keys of a batch dict; the rest (idxs, n_valid) is host-side
# scatter bookkeeping that never reaches the device
_MODEL_KEYS = ("frames", "origin", "vmask", "bows", "tokens", "type_ids",
               "tmask")
# what the loaders stage on the device: the model inputs and, on a
# process-sharded loader, the global batch's max valid lengths
_DEVICE_KEYS = _MODEL_KEYS + ("flen_max", "tlen_max")


def _visual(dev: dict) -> VisualBatch:
    return VisualBatch(frames=dev["frames"], mean_origin=dev["origin"],
                       mask=dev["vmask"], max_len=dev.get("flen_max"))


def _text(dev: dict) -> TextBatch:
    return TextBatch(bows=dev["bows"], tokens=dev["tokens"].long(),
                     type_ids=dev["type_ids"].long(), mask=dev["tmask"],
                     max_len=dev.get("tlen_max"))


def encode_batch(model, dev: dict) -> torch.Tensor:
    """One batch of device tensors -> post embeddings (B, common)."""
    return model.embed_post(_visual(dev), _text(dev))


def encode_vis(model, dev: dict) -> torch.Tensor:
    """Visual-only embedding of one batch (frames, origin, vmask), without
    the fusion head: the JAX package's make_encode_vis_fn."""
    return model.embed_vis(_visual(dev))


def encode_txt(model, dev: dict) -> torch.Tensor:
    """Text-only embedding of one batch (bows, tokens, type_ids, tmask):
    the JAX package's make_encode_txt_fn."""
    return model.embed_txt(_text(dev))


@torch.no_grad()
def encode_data(model, loader, common_dim: int, device: torch.device,
                token_buckets=None, frame_buckets=None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Encode every post in `loader` -> (brands, post_embs) scattered by
    dataset index. `model` is in evaluation mode on `device`.

    token_buckets/frame_buckets: quantized dynamic padding (exact -- see
    data/loader.bucket_batch); pair with a length-sorted loader.

    A process-sharded loader (a world) gives each rank its slice of every
    batch: the rank encodes it, the slices are all-gathered (on this, the
    main thread) into the batch's collate order, and every rank scatters
    the whole batch by its global 'idxs', so every rank returns all of
    the split's embeddings."""
    n = len(loader.dataset)
    post_embs = np.zeros((n, common_dim), np.float32)
    brands = np.zeros(n, np.int32)
    progress = Progress(n, label="encode")

    def stage(batch):
        if token_buckets or frame_buckets:
            maxima = ({k: batch[k] for k in ("tlen_max", "flen_max")}
                      if "tlen_max" in batch else None)
            return bucket_batch(batch, token_buckets, frame_buckets,
                                maxima=maxima)
        return batch

    sharded = getattr(loader, "process_shard", None) is not None
    for batch, dev in prefetch_to_device(iter(loader), device, _DEVICE_KEYS,
                                         size=2, stage=stage):
        embs = encode_batch(model, dev).float()
        if sharded:
            embs = collectives.all_gather(embs)
        # padding rows repeat the last item and write identical values
        post_embs[batch["idxs"]] = embs.cpu().numpy()
        brands[batch["idxs"]] = batch.get("brand_ids_global",
                                          batch["brand_ids"])
        progress.add(batch["n_valid"])
    return brands, post_embs


def random_sim(num_brands: int, num_test_posts: int,
               seed: int = None) -> np.ndarray:
    """Random-baseline similarity matrix (the reference evaluator's
    random_sim, whose one call site there is commented out): swap it for
    the cosine scores to check that the metrics fall to chance. Seeded as
    the JAX package seeds it, so a seed gives the same matrix."""
    rng = np.random.RandomState(seed) if seed is not None else np.random
    return rng.rand(num_brands, num_test_posts)


@torch.no_grad()
def brand_embeddings(model, brand_num: int, device: torch.device
                     ) -> torch.Tensor:
    """All-brand embeddings: aspect mixtures meaned over the aspect axis."""
    ids = torch.arange(brand_num, device=device)
    return model.embed_brand(ids)


@torch.no_grad()
def test_post_ranking(model, brand_num: int, post_embs, brands,
                      device: torch.device) -> RankingMetrics:
    """The brands x posts cosine matrix on `device` and its ranking
    metrics (the reference evaluator's test_post_ranking).

    In a world of R ranks (every rank holding all the embeddings, as
    encode_data leaves them) the posts are padded to a multiple of R (pad
    posts labelled -1, which the metrics exclude) and split into R
    contiguous shards; each rank scores its own shard with the cosine
    kernel, and the exact metrics come from ranking_metrics_sharded."""
    aspects = brand_embeddings(model, brand_num, device)
    ranks = collectives.world_size()
    if ranks <= 1:
        scores = cosine_scores(aspects,
                               torch.as_tensor(post_embs, device=device))
        return ranking_metrics(scores, brands, brand_num)
    post_embs = np.asarray(post_embs, np.float32)
    brands = np.asarray(brands, np.int64)
    pad = (-post_embs.shape[0]) % ranks
    if pad:
        post_embs = np.concatenate(
            [post_embs, np.ones((pad, post_embs.shape[1]), np.float32)])
        brands = np.concatenate([brands, np.full(pad, -1, np.int64)])
    n_l = post_embs.shape[0] // ranks
    lo = collectives.rank() * n_l
    scores = cosine_scores(aspects, torch.as_tensor(
        post_embs[lo:lo + n_l], device=device))
    return ranking_metrics_sharded(scores, brands[lo:lo + n_l], brand_num)

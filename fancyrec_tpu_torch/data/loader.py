"""Batch iteration + host->device prefetch.

A single-process pipeline, as in the JAX package: the dataset's vectorized
mmap gathers run inline, and a background thread assembles the next
batches into pinned host tensors while the device computes on the current
one. The consumer thread issues the non-blocking copies to the device, so
every CUDA call, and every collective of a world, stays on the caller's
thread and stream. In a world of R ranks each rank's loader gathers only
its contiguous 1/R of every batch (`BatchLoader(process_shard=)`).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from fancyrec_tpu_torch.data.dataset import PostDataset


def _pick_bucket(need: int, buckets, cap: int) -> int:
    for b in buckets:
        if b >= need:
            return min(b, cap)
    return cap


def bucket_batch(batch: Dict[str, np.ndarray], token_buckets=None,
                 frame_buckets=None, maxima: Optional[Dict[str, int]] = None
                 ) -> Dict[str, np.ndarray]:
    """Slice the pad axes down to the smallest configured bucket covering
    the batch's max valid length (quantized dynamic padding).

    Token arrays are sliced on the last axis, frames on axis -2. Exact in
    real arithmetic vs the full static pad: every model reduction is
    bounded by the dynamic batch-max length / mask, so removing all-pad
    tail columns cannot change any output. `maxima` ({"tlen_max",
    "flen_max"}) are given on a process-sharded loader: the GLOBAL batch's
    maxima, so that every rank slices the same shapes from its rows.
    """
    out = dict(batch)
    if token_buckets:
        cap = batch["tmask"].shape[-1]
        need = (maxima["tlen_max"] if maxima
                else int(batch["tmask"].sum(-1).max()))
        tl = _pick_bucket(max(need, 1), token_buckets, cap)
        if tl < cap:
            for k in ("tokens", "type_ids", "tmask"):
                out[k] = np.ascontiguousarray(batch[k][..., :tl])
    if frame_buckets:
        cap = batch["vmask"].shape[-1]
        need = (maxima["flen_max"] if maxima
                else int(batch["vmask"].sum(-1).max()))
        fl = _pick_bucket(max(need, 1), frame_buckets, cap)
        if fl < cap:
            out["frames"] = np.ascontiguousarray(batch["frames"][..., :fl, :])
            out["vmask"] = np.ascontiguousarray(batch["vmask"][..., :fl])
    return out


class BatchLoader:
    """Deterministic epoch iterator over a PostDataset.

    final_batch: 'drop' (train default: contrastive losses want full
    batches), or 'pad' (eval: repeat-pad to full size; padding rows are
    marked by n_valid and skipped at scatter time).
    grouped: 'off', 'sort' (global length sort -- eval; embeddings scatter
    back by dataset index) or 'window' (shuffle, then sort within windows
    of 64 batches and shuffle the batch order -- train).

    process_shard=(rank, ranks): every rank computes the same GLOBAL batch
    order (the epoch permutation and the collate sort are deterministic in
    seed and epoch), then gathers only rows [B rank / ranks, B (rank + 1) /
    ranks) of each collate-sorted batch. Its batches carry those local
    arrays beside the global bookkeeping: 'idxs' (the whole ordered index
    list), 'n_valid', 'brand_ids_global' and the global length maxima
    'flen_max' and 'tlen_max'.
    """

    def __init__(self, dataset: PostDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 2,
                 final_batch: str = "drop", grouped: str = "off",
                 process_shard: Optional[Tuple[int, int]] = None):
        if final_batch not in ("drop", "pad"):
            raise ValueError("final_batch must be 'drop' or 'pad'")
        if grouped not in ("off", "sort", "window"):
            raise ValueError("grouped must be 'off', 'sort' or 'window'")
        if process_shard is not None:
            r, ranks = process_shard
            if not 0 <= r < ranks:
                raise ValueError("process_shard rank %d outside [0, %d)"
                                 % (r, ranks))
            if batch_size % ranks:
                raise ValueError(
                    "process-sharded loading needs batch_size %% ranks == 0 "
                    "(got %d %% %d)" % (batch_size, ranks))
        self.process_shard = process_shard
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.final_batch = final_batch
        self.grouped = grouped
        self.epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.final_batch == "drop":
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        n = len(self.dataset)
        order = np.arange(n)
        rng = np.random.RandomState(self.seed + self.epoch)
        if self.shuffle:
            rng.shuffle(order)
        self.epoch += 1
        bs = self.batch_size
        if self.grouped == "sort":
            keys = self.dataset.length_keys()
            order = order[np.argsort(keys[order], kind="stable")]
        elif self.grouped == "window":
            keys = self.dataset.length_keys()
            win = bs * 64
            order = np.concatenate([
                chunk[np.argsort(keys[chunk], kind="stable")]
                for chunk in (order[s: s + win]
                              for s in range(0, n, win))])
        stop = (n // bs) * bs if self.final_batch == "drop" else n
        starts = list(range(0, stop, bs))
        if self.grouped == "window":
            rng.shuffle(starts)
        for start in starts:
            idx = order[start: start + bs]
            if self.process_shard is None:
                yield self.dataset.gather_batch(idx, pad_to=bs)
                continue
            r, ranks = self.process_shard
            ordered = self.dataset.collate_order(idx, pad_to=bs)
            lo, hi = len(ordered) * r // ranks, len(ordered) * (r + 1) // ranks
            batch = self.dataset.gather_batch(ordered[lo:hi], presort=False)
            batch["idxs"] = np.asarray(ordered, np.int64)
            batch["n_valid"] = len(idx)
            batch["brand_ids_global"] = self.dataset.brand_ids[
                np.asarray(ordered)]
            batch.update(self.dataset.length_maxima(ordered))
            yield batch


def _pin(batch: Dict[str, np.ndarray], keys, pin: bool
         ) -> Dict[str, torch.Tensor]:
    """numpy arrays, scalars (or host tensors) -> host tensors, page-locked
    when `pin`, so the copy to the device can run asynchronously. A scalar
    becomes a 0-d tensor."""
    out = {}
    for k in keys:
        if k in batch:
            t = batch[k]
            if not isinstance(t, torch.Tensor):
                a = np.asarray(t)
                t = torch.from_numpy(np.ascontiguousarray(a)).reshape(a.shape)
            out[k] = t.pin_memory() if pin else t
    return out


def prefetch_to_device(iterator, device: torch.device, keys, size: int = 2,
                       stage=None):
    """Run `iterator` in a background thread, staging batches for `device`.

    The producer builds each host batch (through `stage`, if given) and
    turns `keys` into pinned tensors; up to `size` batches wait in the
    queue. The consumer copies them with `non_blocking=True` and yields
    (host_batch, device_tensors). A producer failure is re-raised here.
    """
    pin = device.type == "cuda"
    q: "queue.Queue" = queue.Queue(maxsize=size)
    _END = object()
    stop = threading.Event()

    def _put(item):
        # give up when the consumer is gone, instead of blocking forever
        # on a full queue with pinned batches held
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        try:
            for batch in iterator:
                host = stage(batch) if stage is not None else batch
                if not _put((batch, _pin(host, keys, pin))):
                    return
            _put(_END)
        except BaseException as exc:  # noqa: BLE001 - re-raised below
            _put(_ProducerError(exc))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                break
            if isinstance(item, _ProducerError):
                raise item.exc
            batch, host = item
            yield batch, {k: v.to(device, non_blocking=True)
                          for k, v in host.items()}
    finally:
        stop.set()
        while not q.empty():
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=10)


class _ProducerError:
    """Wraps an exception crossing the producer-thread queue boundary."""

    def __init__(self, exc: BaseException):
        self.exc = exc

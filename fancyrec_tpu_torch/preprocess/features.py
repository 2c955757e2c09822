"""Feature extraction: images or frames -> BigFile, through the
ResNet-152 extractor, with decode overlapped with the device.

The reference dumps jpgs, runs them through a torch DataLoader and the
ResNet, writes txt lines and packs them with txt2bin
(extract_frame_feature.py, preprocess_images.py:78-113). Here decode and
resize run on a producer thread while the card computes the previous
batch, and rows stream straight into a BigFileWriter: the same artifacts
(feature.bin, id.txt, shape.txt), no intermediate txt (an optional writer
emits the txt lines, for byte-level checks of the pipeline).
"""

from __future__ import annotations

import os
import time
from typing import Callable, Iterable, Iterator, Optional, Tuple

import numpy as np

from fancyrec_tpu_torch.io.bigfile import BigFileWriter


def iter_image_files(image_dir: str, names: Optional[Iterable[str]] = None,
                     resize=(224, 224)) -> Iterator[Tuple[str, np.ndarray]]:
    """(name_without_ext, 224x224x3 uint8 RGB) over jpgs in a directory."""
    from PIL import Image

    names = sorted(names) if names is not None else sorted(os.listdir(image_dir))
    for fname in names:
        if not fname.lower().endswith((".jpg", ".jpeg", ".png")):
            continue
        path = os.path.join(image_dir, fname)
        try:
            img = Image.open(path).convert("RGB").resize(resize)
        except Exception:
            continue
        yield os.path.splitext(fname)[0], np.asarray(img, np.uint8)


def _batched(stream, batch_size: int):
    names, imgs = [], []
    for name, img in stream:
        names.append(name)
        imgs.append(img)
        if len(names) == batch_size:
            yield names, np.stack(imgs)
            names, imgs = [], []
    if names:
        pad = batch_size - len(names)
        yield names, np.concatenate(
            [np.stack(imgs), np.zeros((pad,) + imgs[0].shape, np.uint8)])


def extract_features(stream: Iterable[Tuple[str, np.ndarray]],
                     out_dir: str, batch_size: int = 128,
                     params=None, extract_fn: Optional[Callable] = None,
                     txt_path: Optional[str] = None,
                     prefetch: int = 2,
                     stats: Optional[dict] = None, device=None) -> int:
    """Stream (name, image) pairs through the extractor into a BigFile.

    Returns the number of feature rows written. Batches are fixed-size
    (the tail is zero-padded and trimmed after the forward pass).

    Without `extract_fn`, the ResNet-152 of `params` (a JAX param tree or
    a port state dict; a random tree from seed 0 when None) runs on
    `device`, the card unless the caller asks for the CPU: the producer
    thread decodes and pins each uint8 batch, the consumer copies it to
    the card asynchronously and normalizes it there. An `extract_fn` of
    the caller's gets each uint8 numpy batch, as in the JAX package, and
    returns an array (B, D).

    A producer exception re-raises here, and the BigFile is then left
    without id.txt and shape.txt (never silently truncated).

    If `stats` is a dict, it is filled with wall-clock attribution for the
    consumer side: `wait_s` (blocked on the decode queue: producer
    starvation), `compute_s` (extractor forward + device fetch), `write_s`
    (BigFile append), and `batches`.
    """
    import torch

    from fancyrec_tpu_torch.data.loader import prefetch_to_device

    if extract_fn is None:
        from fancyrec_tpu_torch.device import resolve_device
        from fancyrec_tpu_torch.models.resnet import (init_random_params,
                                                      make_extractor)
        dev = resolve_device(device)
        params = params if params is not None else init_random_params()
        extractor = make_extractor(params, batch_size, device=dev)
        keys = ("images",)
    else:
        dev, keys = torch.device("cpu"), ()

    batches = prefetch_to_device(
        _batched(stream, batch_size), dev, keys, size=prefetch,
        stage=lambda batch: {"images": batch[1]})

    txt = open(txt_path, "w") if txt_path else None
    written = 0
    wait_s = compute_s = write_s = 0.0
    n_batches = 0
    try:
        with BigFileWriter(out_dir) as w:
            while True:
                t0 = time.perf_counter()
                try:
                    (names, images), staged = next(batches)
                except StopIteration:
                    break
                t1 = time.perf_counter()
                if extract_fn is None:
                    feats = extractor(staged["images"]).cpu().numpy()
                else:
                    feats = np.asarray(extract_fn(images))
                feats = feats[: len(names)]
                t2 = time.perf_counter()
                written += w.write_batch(names, feats)
                if txt is not None:
                    for n, row in zip(names, feats):
                        txt.write(n + " " + " ".join("%g" % v for v in row)
                                  + "\n")
                t3 = time.perf_counter()
                wait_s += t1 - t0
                compute_s += t2 - t1
                write_s += t3 - t2
                n_batches += 1
    finally:
        batches.close()
        if txt is not None:
            txt.close()
    if stats is not None:
        stats.update(wait_s=wait_s, compute_s=compute_s, write_s=write_s,
                     batches=n_batches)
    return written

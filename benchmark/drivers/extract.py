"""The feature-extraction cell: the program's `extract_features` streaming
uint8 frames through its ResNet-152 into a BigFile.

Set-up makes the extractor's weights on the card and a pool of frames in
host memory from the seed, and runs `extract_features` once over two
batches (building the extractor and warming cuDNN at the cell's batch).
The window is one `extract_features` call over a stream that cycles the
pool, named as videos of `frames_per_video` frames, and ends at the
first whole batch after --seconds; the features go to a BigFile in the
run's TMPDIR.

The check: frames drawn from the seed among those written, their rows in
the BigFile against a float32 ResNet-152 forward of the same frames and
weights: the widest relative L2 error.
"""

from __future__ import annotations

import os
import shutil
import time

import numpy as np
import torch

import generate
import harness
import weights as bench_weights
from reference import resnet_ref


def stream(pool: np.ndarray, batch: int, per_video: int, brand_num: int,
           deadline=None, count=None):
    """(name, frame) pairs cycling the pool, until `count` frames or the
    first whole batch after `deadline` (perf_counter seconds)."""
    i = 0
    while True:
        if count is not None and i >= count:
            return
        if (deadline is not None and i % batch == 0
                and time.perf_counter() >= deadline):
            return
        v = i // per_video
        yield ("video%d_%d_cls%d" % (v + 1, (i % per_video) * 15,
                                     v % brand_num), pool[i % len(pool)])
        i += 1


def run(ctx) -> dict:
    cell, dev, seed = ctx["cell"], ctx["device"], int(ctx["seed"])
    conf, traffic = cell.config, cell.traffic
    ext = conf["extractor"]
    limits = harness.load_json(os.path.join(
        harness.BENCH, "limits", cell.name + ".json"))
    work = ctx["work"]
    os.makedirs(work, exist_ok=True)
    batch, per_video = ext["batch_size"], traffic["frames_per_video"]
    nb = conf["model"]["brand_num"]
    blocks = ext["blocks"]
    params = bench_weights.make(bench_weights.resnet_spec(blocks), seed, dev)
    pool = generate.frame_pool(traffic["pool_frames"], ext["image_size"],
                               seed, dev).cpu().numpy()

    from fancyrec_tpu_torch.preprocess.features import extract_features
    extract_features(stream(pool, batch, per_video, nb, count=2 * batch),
                     os.path.join(work, "warm"), batch_size=batch,
                     params=params, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - ctx["t_start"]

    out_dir = os.path.join(work, "features")
    stats = {}
    with harness.Window(ctx["trace"], dev) as win:
        with win.span("extract_features"):
            written = extract_features(
                stream(pool, batch, per_video, nb,
                       deadline=win.t0 + ctx["seconds"]),
                out_dir, batch_size=batch, params=params, stats=stats,
                device=dev)
    device = harness.device_record(dev, cell.chips)
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    rows = np.memmap(os.path.join(out_dir, "feature.bin"), np.float32, "r",
                     shape=(written, ext["feat_dim"]))
    pick = np.sort(generate.rng_for(seed, 4).choice(
        written, min(traffic["check_frames"], written), replace=False))
    got = torch.from_numpy(np.array(rows[pick])).to(dev)
    frames = torch.from_numpy(pool[pick % len(pool)]).to(dev)
    want = torch.cat([resnet_ref.features(params, blocks, frames[i:i + 8])
                      for i in range(0, len(pick), 8)])
    err = float(((got - want).norm(dim=1) / want.norm(dim=1)).max())
    del rows
    shutil.rmtree(work, ignore_errors=True)
    checks = {"feature_error": (err, limits["feature_error"])}
    return {"e2e": {"extract_frames_per_s": written / win.seconds,
                    "setup_s": setup_s},
            "correct": all(v <= lim for v, lim in checks.values()),
            "attempted": written, "failed": 0, "device": device,
            "checks": checks, "card": harness.smi(),
            "observed": {"window": win, "config": conf, "frames": written,
                         "stats": stats}}

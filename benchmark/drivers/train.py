"""Training cells: the recipe trained by the program's `train_epoch`.

Set-up writes a train collection made from the seed (BigFile frame and
image features, captions, vocabularies) into the run's TMPDIR, builds
the program's datasets and loader over it, makes the weights on the card
and loads them into the program's model, and runs the first three
updates through `train_epoch` itself (one update a call, the loader's
first 24 batches): they build and warm every kernel and shape, and they
are what the plain reference follows. The window then runs whole
epochs of `train_epoch` over the loader, a fresh contrastive queue each
epoch as the trainer keeps it, until --seconds have passed.

The check: the first update's loss, its gradient as Adam holds it (the
first moment over 1 - beta1) leaf by leaf, and each leaf's change over
the three updates, against the plain reference run from the same weights
on the same posts with the same random draws (`compare`).
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import statistics
import sys
import time

import numpy as np
import torch

import generate
import harness
import weights as bench_weights
from reference import batches as ref_batches
from reference import fancyrec_ref

COLL = "benchtrain"
VIDEO_FEATURE = "resnet152_dim_2048"
IMG_FEATURE = "imgfeat_dim_2048"
SETUP_UPDATES = 3


def _write_store(path: str, names, rows: np.ndarray) -> None:
    os.makedirs(path, exist_ok=True)
    rows.astype(np.float32).tofile(os.path.join(path, "feature.bin"))
    with open(os.path.join(path, "id.txt"), "w") as f:
        f.write("#".join(names))
    with open(os.path.join(path, "shape.txt"), "w") as f:
        f.write("%d %d" % rows.shape)


def write_collection(root: str, posts: dict, feats: np.ndarray, words,
                     data: dict, brand_num: int) -> None:
    """The collection in the FancyRec data layout: cls.txt, img_info.txt,
    captions, a video-frame store and an image store, bag and rnn
    vocabularies and a WordPiece vocabulary file."""
    if os.path.isdir(root):
        shutil.rmtree(root)
    text_dir = os.path.join(root, COLL, "TextData")
    feat_dir = os.path.join(root, COLL, "FeatureData")
    os.makedirs(text_dir)
    brands = ["brand%d" % b for b in range(brand_num)]
    with open(os.path.join(root, "cls.txt"), "w") as f:
        f.write(json.dumps({"cls2idx": {b: i for i, b in enumerate(brands)},
                            "idx2cls": {i: b for i, b in enumerate(brands)}}))
    lines, v2f, frame_names, img_names = [], {}, [], []
    idx2img, img2idx = {}, {}
    n_vid = n_img = 0
    for i in range(posts["n"]):
        b = int(posts["brands"][i])
        cap = " ".join(words[w] for w in posts["words"][i])
        if posts["is_video"][i]:
            n_vid += 1
            vid = "video%d" % n_vid
            names = ["%s_%d_cls%d" % (vid, 15 * k, b)
                     for k in range(int(posts["frames"][i]))]
            v2f[vid] = names
            frame_names += names
            lines.append("%s#enc#0 %s" % (vid, cap))
        else:
            n_img += 1
            name = "%s/img_%06d.jpg" % (brands[b], n_img)
            idx2img[n_img], img2idx[name] = name, n_img
            img_names.append(name)
            lines.append("img%d#enc#0 %s" % (n_img, cap))
    with open(os.path.join(text_dir, "%s.caption.txt" % COLL), "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "img_info.txt"), "w") as f:
        f.write(str({"idx2img": idx2img, "img2idx": img2idx}))
    per_frame = np.repeat(posts["is_video"], posts["frames"])
    _write_store(os.path.join(feat_dir, VIDEO_FEATURE), frame_names,
                 feats[per_frame])
    with open(os.path.join(feat_dir, VIDEO_FEATURE, "video2frames.txt"),
              "w") as f:
        f.write(str(v2f))
    _write_store(os.path.join(feat_dir, IMG_FEATURE), img_names,
                 feats[~per_frame])
    vdir = os.path.join(text_dir, "vocabulary")
    n_rnn = data["rnn_vocab_size"] - len(ref_batches.RNN_SPECIALS)
    for style, vocab in (
            ("bow", generate.Vocabulary(words[:data["bow_vocab_size"]], "bow")),
            ("rnn", generate.Vocabulary(words[:n_rnn], "rnn",
                               ref_batches.RNN_SPECIALS))):
        os.makedirs(os.path.join(vdir, style))
        with open(os.path.join(vdir, style, "word_vocab_5.pkl"), "wb") as f:
            pickle.dump(vocab, f, pickle.HIGHEST_PROTOCOL)
    with open(os.path.join(root, "bert_vocab.txt"), "w") as f:
        f.write("\n".join(list(ref_batches.BERT_SPECIALS) + words) + "\n")


class RecordingLoader:
    """The program's loader, passed through; it keeps each batch's valid
    frame and token counts for the metrics that count the work."""

    def __init__(self, loader):
        self.loader = loader
        self.lengths = []

    def __iter__(self):
        for batch in self.loader:
            self.lengths.append((batch["vmask"].sum(1).astype(np.int64),
                                 batch["tmask"].sum(1).astype(np.int64)))
            yield batch


def leaf_gaps(prog: dict, ref: dict):
    """Each leaf's |prog - ref| / max(ref, the median leaf's ref) ->
    {leaf: gap}."""
    med = statistics.median(ref.values())
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med) for k in ref}


def run(ctx) -> dict:
    cell, dev, seed = ctx["cell"], ctx["device"], int(ctx["seed"])
    conf, traffic = cell.config, cell.traffic
    model_cfg, data = conf["model"], conf["data"]
    text_net = model_cfg["text_net"]
    limits = harness.load_json(os.path.join(
        harness.BENCH, "limits", cell.name + ".json"))
    loader_seed = seed % (2 ** 31)
    drop_seed = seed + 11
    work = ctx["work"]
    os.makedirs(work, exist_ok=True)

    words = generate.vocabulary(model_cfg["bert_vocab_size"]
                                - len(ref_batches.BERT_SPECIALS))
    posts = generate.posts(traffic, model_cfg["brand_num"],
                           data["bow_vocab_size"], seed)
    feats = generate.frame_features(posts, data["feat_dim"],
                                    model_cfg["brand_num"], seed, dev).cpu()
    root = os.path.join(work, "root")
    write_collection(root, posts, feats.numpy(), words, data,
                     model_cfg["brand_num"])

    from fancyrec_tpu_torch.config import Config
    from fancyrec_tpu_torch.data.loader import BatchLoader
    from fancyrec_tpu_torch.losses import init_queue_state
    from fancyrec_tpu_torch.models import FancyRec
    from fancyrec_tpu_torch.train.state import TrainState, make_optimizer
    from fancyrec_tpu_torch.train.trainer import build_datasets, train_epoch

    cfg = Config(**model_cfg, rootpath=root, trainCollection=COLL,
                 valCollection=COLL, testCollection=COLL,
                 video_feature=VIDEO_FEATURE, img_feature=IMG_FEATURE,
                 bert_vocab=os.path.join(root, "bert_vocab.txt"),
                 seed=loader_seed, max_frames=data["max_frames"],
                 max_tokens=data["max_tokens"], max_words=data["max_words"])
    datasets = build_datasets(cfg)
    cfg.finalize()
    weights = bench_weights.make(
        bench_weights.fancyrec_spec(model_cfg, data), seed, dev)
    with torch.device(dev):
        model = FancyRec(cfg)
    model.load_state_dict(weights)
    model.seed_dropout(drop_seed)
    weights = {k: v.cpu() for k, v in weights.items()}
    opt = make_optimizer(cfg, model.parameters())
    loader = BatchLoader(datasets["train"], cfg.batch_size, shuffle=True,
                         seed=cfg.seed, final_batch="drop")
    a = cfg.accumulation_step
    it = iter(loader)
    first = [next(it) for _ in range(SETUP_UPDATES * a)]
    del it

    def fresh(step=0):
        return TrainState(queue=init_queue_state(
            cfg.queue_size, cfg.common_embedding_size, device=dev), step=step)

    state, losses = fresh(), []
    for u in range(SETUP_UPDATES):
        state, st = train_epoch(model, opt, cfg, state,
                                first[u * a:(u + 1) * a], u - SETUP_UPDATES,
                                dev)
        losses += st["losses"]
        if u == 0:
            grad1 = {n: float(opt.state[p]["exp_avg"].norm()) / 0.1
                     for n, p in model.named_parameters()}
    change3 = {n: float((p.detach().cpu() - weights[n]).norm())
               for n, p in model.named_parameters()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    setup_s = time.time() - ctx["t_start"]

    rec = RecordingLoader(loader)
    posts_done = updates = bad = 0
    epoch = 0
    with harness.Window(ctx["trace"], dev) as win:
        while True:
            state = fresh(state.step)
            with win.span("train_epoch %d" % epoch):
                state, st = train_epoch(model, opt, cfg, state, rec, epoch,
                                        dev)
            posts_done += st["posts"]
            updates += len(st["losses"])
            bad += sum(not np.isfinite(x) for x in st["losses"])
            epoch += 1
            if time.perf_counter() - win.t0 >= ctx["seconds"]:
                break
    device = harness.device_record(dev, cell.chips)
    del model, opt, state, datasets, loader, rec.loader
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the reference: the same first three updates, from the same weights
    keys = ref_batches.sort_keys(posts, words, text_net)
    order = ref_batches.epoch_batches(posts["n"], cfg.batch_size,
                                      loader_seed, 0, keys)
    feats_dev = feats.to(dev)
    ups = [[ref_batches.tensors(posts, feats_dev, idx, data, text_net)
            for idx in order[u * a:(u + 1) * a]]
           for u in range(SETUP_UPDATES)]
    ref_cfg = reference_config(model_cfg, data)
    ref = fancyrec_ref.train({k: v.to(dev) for k, v in weights.items()},
                             ref_cfg, ups, drop_seed, dev)
    shutil.rmtree(work, ignore_errors=True)
    checks = compare(losses, grad1, change3, ref, limits)
    controls = {}
    if ctx.get("control"):
        controls = run_controls(ref, ref_cfg, weights, ups, drop_seed, dev,
                                limits)
    return {"e2e": {"train_posts_per_s": posts_done / win.seconds,
                    "setup_s": setup_s},
            "correct": all(v <= lim for v, lim in checks.values()),
            "attempted": updates, "failed": bad, "device": device,
            "checks": checks, "card": harness.smi(), "controls": controls,
            "observed": {"window": win, "config": conf,
                         "batches": rec.lengths, "updates": updates}}


def reference_config(model_cfg: dict, data: dict) -> dict:
    s = bench_weights.sizes(model_cfg, data)
    out = dict(model_cfg)
    out.update(s)
    out["buffers"] = ("fusion_encoding.bn.running_mean",
                      "fusion_encoding.bn.running_var")
    return out


def compare(losses, grad1, change3, ref, limits) -> dict:
    """The numbers compared, those the cell's limits file names: the first
    update's loss (relative gap), the first gradient by the median leaf
    (`grad_gap_median`) or the worst leaf (`grad_gap`), and the three
    updates' change by the worst leaf. A near tie that rounding breaks the
    other way (two entries of a max-pool, or the hardest negative of the
    loss) sends a gradient to another row in a sound run and moves a few
    leaves by up to about 1e-3; the median leaf barely sees it, rounding
    in a lower precision moves every leaf. The later updates' losses are
    printed, not compared: the loss weighs each post by the rank of its
    brand's score among the batch's, and a near tie that rounding reorders
    moves a later loss by up to 2e-3 in a sound run. Leaves whose
    reference gradient is under a thousandth of the median leaf's are left
    out: round-off alone moves them."""
    steps = [abs(p - r) / abs(r) for p, r in zip(losses, ref["losses"])]
    med = statistics.median(ref["grad_norms"].values())
    counted = [k for k, v in ref["grad_norms"].items() if v >= 1e-3 * med]
    g = leaf_gaps({k: grad1[k] for k in counted},
                  {k: ref["grad_norms"][k] for k in counted})
    c = leaf_gaps({k: change3[k] for k in counted},
                  {k: ref["change_norms"][k] for k in counted})
    leaf_g, leaf_c = max(g, key=g.get), max(c, key=c.get)
    first = steps[0] if len(losses) == len(ref["losses"]) else float("inf")
    print("loss gap by step %s; worst leaf: gradient %s %.3g, change %s; %d "
          "of %d leaves counted" % (["%.3g" % x for x in steps], leaf_g,
                                    g[leaf_g], leaf_c, len(counted),
                                    len(ref["grad_norms"])), file=sys.stderr)
    numbers = {"first_loss_gap": first, "grad_gap": g[leaf_g],
               "grad_gap_median": statistics.median(g.values()),
               "change_gap": c[leaf_c]}
    return {k: (numbers[k], limits[k]) for k in numbers if k in limits}


def run_controls(ref, ref_cfg, weights, ups, drop_seed, dev, limits):
    """The readings that the limits' upper ends come from: the reference
    with TF32 on (the precision below the configuration's float32) and
    the reference with half of each microbatch left out (its mean taken
    over the rest), each judged against the float32 reference."""
    def judged(run):
        return {k: v for k, (v, _) in compare(
            run["losses"], run["grad_norms"], run["change_norms"], ref,
            limits).items()}

    w = {k: v.to(dev) for k, v in weights.items()}
    out = {}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        out["tf32"] = judged(fancyrec_ref.train(w, ref_cfg, ups, drop_seed,
                                                dev))
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
    half = [[{k: v[:v.shape[0] // 2] for k, v in mb.items()} for mb in up]
            for up in ups]
    out["half_batch"] = judged(fancyrec_ref.train(w, ref_cfg, half,
                                                  drop_seed, dev))
    return out

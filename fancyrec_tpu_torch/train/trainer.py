"""The training CLI, the port's `fancyrec-train`.

    python -m fancyrec_tpu_torch.train.trainer insCartrain insCarval \\
        insCartest --rootpath ROOT [the flags of bin/instance.sh] \\
        [--device cpu]

Port of fancyrec_tpu/train/trainer.py. The same flags, on-disk layout,
checkpoint policy, lr schedule
(x lr_decay_rate each epoch, a further x0.5 after 2 stale epochs), early
stop after 10 stale epochs, a fresh contrastive queue each epoch, and
model selection on --validate_split (default the test split, the
reference's choice). With --w2v_feature the bi-GRU text tower's word
embeddings start from a word2vec store. Each epoch prints its updates and
posts/s and appends its metrics to <rootpath>/model/<postfix>/
metrics.jsonl and a TensorBoard event file beside it. The JAX package's
throughput mode runs too: --dtype bfloat16 (the towers in bfloat16),
--transfer_dtype bfloat16 (float batch arrays staged in bfloat16 on the
host, upcast on the device), --bert_remat 1 and --profile_dir DIR (a
torch.profiler trace of epoch min(1, num_epochs - 1)).

Data parallelism: launched as R processes (`torchrun --nproc_per_node R
-m fancyrec_tpu_torch.train.trainer ... --mesh_shape R,1`, or any launcher
that sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and MASTER_PORT), each
rank loads and encodes its contiguous 1/R of every batch and the update
is the global batch's (`parallel/`, `train/step.py`), as the JAX package
computes it on a (data=R, model=1) mesh. --mesh_shape "" puts every rank
on data. Skip decisions are the primary's; only the primary (rank 0)
writes metrics, checkpoints and val_metric.txt.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict

import numpy as np
import torch

from fancyrec_tpu_torch.config import (
    Config, build_train_parser, config_from_args)
from fancyrec_tpu_torch.data.dataset import PostDataset, load_info
from fancyrec_tpu_torch.data.loader import (
    BatchLoader, bucket_batch, prefetch_to_device)
from fancyrec_tpu_torch.data.tokenizer import WordPieceTokenizer
from fancyrec_tpu_torch.eval.evaluator import (
    _DEVICE_KEYS, encode_data, test_post_ranking)
from fancyrec_tpu_torch.eval.metrics import composite_score
from fancyrec_tpu_torch.io.bigfile import ImageBigFile
from fancyrec_tpu_torch.io.dictfile import read_dict
from fancyrec_tpu_torch.io.vocab import Bow2Vec, load_vocab
from fancyrec_tpu_torch.io.word2vec import get_we_parameter
from fancyrec_tpu_torch.losses import init_queue_state
from fancyrec_tpu_torch.parallel import collectives, distributed
from fancyrec_tpu_torch.parallel.mesh import (
    Mesh, build_mesh, process_batch_shard, require_divisible_batch)
from fancyrec_tpu_torch.train import checkpoints
from fancyrec_tpu_torch.train.state import (
    TrainState, current_lr, init_state, load_optimizer_state, scale_lr)
from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
from fancyrec_tpu_torch.utils import profiling
from fancyrec_tpu_torch.utils.tb_events import TBEventWriter

_TRAIN_KEYS = ("brand_ids",) + _DEVICE_KEYS


def check_to_skip(filename: str, overwrite: int) -> bool:
    if os.path.exists(filename):
        print("%s exists." % filename, "overwrite" if overwrite else "skip")
        return not overwrite
    return False


def build_datasets(cfg: Config) -> Dict[str, PostDataset]:
    """The reference's on-disk layout -> {train, val, test} datasets; sets
    the config's feature and vocabulary sizes."""
    colls = {"train": cfg.trainCollection, "val": cfg.valCollection,
             "test": cfg.testCollection}
    root = cfg.rootpath
    video_feats = {k: ImageBigFile(os.path.join(root, c, "FeatureData",
                                                cfg.video_feature))
                   for k, c in colls.items()}
    img_feats = {k: ImageBigFile(os.path.join(root, c, "FeatureData",
                                              cfg.img_feature))
                 for k, c in colls.items()}
    cfg.visual_feat_dim = video_feats["train"].ndims
    vocab_dir = os.path.join(root, cfg.trainCollection, "TextData",
                             "vocabulary")
    bow_vocab = load_vocab(os.path.join(vocab_dir, "bow", cfg.vocab + ".pkl"))
    rnn_vocab = load_vocab(os.path.join(vocab_dir, "rnn", cfg.vocab + ".pkl"))
    cfg.bow_vocab_size = len(bow_vocab)
    cfg.vocab_size = len(rnn_vocab)
    bow2vec = Bow2Vec(bow_vocab)
    tokenizer = None
    if cfg.text_net == "transformers":
        vocab_path = cfg.bert_vocab or os.path.join(root, "bert_vocab.txt")
        if not os.path.exists(vocab_path):
            raise FileNotFoundError(
                "transformers text_net needs a WordPiece vocab: pass "
                "--bert_vocab or place bert_vocab.txt under rootpath")
        tokenizer = WordPieceTokenizer(vocab_path)
    img_info, cls_info = load_info(root)
    datasets = {}
    for split, coll in colls.items():
        video2frames = read_dict(os.path.join(
            root, coll, "FeatureData", cfg.video_feature, "video2frames.txt"))
        datasets[split] = PostDataset(
            os.path.join(root, coll, "TextData", "%s.caption.txt" % coll),
            video_feats[split], img_feats[split], bow2vec,
            text_net=cfg.text_net, rnn_vocab=rnn_vocab, tokenizer=tokenizer,
            video2frames=video2frames, img_info=img_info, cls_info=cls_info,
            max_frames=cfg.max_frames, max_tokens=cfg.max_tokens,
            max_words=cfg.max_words)
    return datasets


def init_word_embeddings(model, cfg: Config) -> None:
    """--w2v_feature: overwrite the bi-GRU text tower's embedding table
    with word2vec vectors (OOV words U(-1, 1) from cfg.seed), as the JAX
    trainer does; a table of another shape keeps its random init."""
    rnn_vocab = load_vocab(os.path.join(
        cfg.rootpath, cfg.trainCollection, "TextData", "vocabulary", "rnn",
        cfg.vocab + ".pkl"))
    we = get_we_parameter(rnn_vocab, cfg.w2v_feature, seed=cfg.seed)
    embed = model.text_encoding.embed
    if we.shape == tuple(embed.shape):
        with torch.no_grad():
            embed.copy_(torch.from_numpy(we))
        print("initialized word embeddings from %s" % cfg.w2v_feature)
    else:
        print("w2v shape %s != embed %s; keeping random init"
              % (we.shape, tuple(embed.shape)))


def validate(model, loader, cfg: Config, device: torch.device):
    """Encode `loader`'s posts, rank them for every brand -> (composite
    score, RankingMetrics). Leaves the model in evaluation mode."""
    model.eval()
    brands, post_embs = encode_data(model, loader, cfg.common_embedding_size,
                                    device,
                                    token_buckets=cfg.token_buckets_list,
                                    frame_buckets=cfg.frame_buckets_list)
    m = test_post_ranking(model, cfg.brand_num, post_embs, brands, device)
    print("MedR:", m.medr)
    print("MeanR:", m.meanr)
    print("AUC[0-1]:", m.auc)
    print("NDCG@10[0-1]:", m.ndcg10)
    print("NDCG@50[0-1]:", m.ndcg50)
    print("recall@1:", m.r1)
    print("recall@5:", m.r5)
    print("recall@10:", m.r10)
    return composite_score(m), m


def _superbatches(loader, accumulation_step: int, token_buckets=None,
                  frame_buckets=None, transfer_dtype: str = ""):
    """Group loader batches into super-batches of A microbatches. The
    trailing partial group is skipped: the reference steps the optimizer
    on full accumulation groups only. transfer_dtype 'bfloat16' rounds the
    float32 arrays to bfloat16 tensors on the host (round to nearest even),
    halving the bytes of the copy to the device; the step upcasts them."""
    group = []
    for batch in loader:
        group.append(batch)
        if len(group) == accumulation_step:
            sb = stack_microbatches(group)
            if token_buckets or frame_buckets:
                # the whole super-batch shares one bucket shape; a
                # process-sharded loader carries the GLOBAL length maxima,
                # so that every rank slices the same shapes
                maxima = ({k: max(b[k] for b in group)
                           for k in ("tlen_max", "flen_max")}
                          if "tlen_max" in group[0] else None)
                sb = bucket_batch(sb, token_buckets, frame_buckets,
                                  maxima=maxima)
            if transfer_dtype:
                dt = getattr(torch, transfer_dtype)
                sb = {k: (torch.from_numpy(v).to(dt)
                          if v.dtype == np.float32 else v)
                      for k, v in sb.items()}
            yield sb
            group = []


def train_epoch(model, opt, cfg: Config, state: TrainState, loader,
                epoch: int, device: torch.device):
    """One pass over `loader` -> (state, {"losses", "seconds", "posts"}).
    A background thread assembles and pins the next super-batches while
    the device runs the current step; every collective stays on this
    thread. "posts" counts the global batches' posts."""
    print("Epoch[{0} / {1}] LR: {2}".format(epoch, cfg.num_epochs,
                                             current_lr(opt)))
    losses = []
    n_items = 0
    t0 = time.time()
    stream = prefetch_to_device(
        _superbatches(loader, cfg.accumulation_step, cfg.token_buckets_list,
                      cfg.frame_buckets_list, cfg.transfer_dtype),
        device, _TRAIN_KEYS, size=2)
    for _, superbatch in stream:
        state, metrics = train_step(model, opt, cfg, state, superbatch)
        # kept on the device: reading it here would wait for every step
        losses.append(metrics["loss"])
        n_items += (superbatch["frames"].shape[0]
                    * superbatch["frames"].shape[1] * collectives.world_size())
    losses = [float(x) for x in losses]
    dt = time.time() - t0
    if losses:
        print("epoch %d: mean loss %.4f  (%d updates, %.1f posts/s)"
              % (epoch, float(np.mean(losses)), len(losses),
                 n_items / max(dt, 1e-9)))
    return state, {"losses": losses, "seconds": dt, "posts": n_items}


class MetricsLog:
    """Per-epoch records to metrics.jsonl and a TensorBoard event file."""

    def __init__(self, logdir: str):
        self.path = os.path.join(logdir, "metrics.jsonl")
        self.tb = TBEventWriter(logdir)

    def write(self, record: dict) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")
        self.tb.add_scalars(record.get("epoch", 0),
                            {k: v for k, v in record.items()
                             if isinstance(v, (int, float))})


def main(argv=None):
    args = build_train_parser().parse_args(argv)
    cfg = config_from_args(args)
    device = distributed.initialize_multihost(args.device)
    print(json.dumps(vars(args), indent=2, default=str))
    mesh = build_mesh(cfg.mesh_shape)
    # an explicit --mesh_shape's batch is checked by cfg.finalize; the
    # default mesh's data axis is known only here
    require_divisible_batch(mesh, cfg.batch_size)
    if mesh.data > 1:
        print("mesh: data=%d, model=1; rank %d on %s"
              % (mesh.data, mesh.rank, device))
    return _run(cfg, device, mesh)


def _run(cfg: Config, device: torch.device, mesh: Mesh):
    cfg.logger_name = os.path.join(cfg.rootpath, "model", cfg.postfix)
    # skip decisions follow the primary (its files are the truth), so that
    # every rank returns together or none does
    if cfg.auto_resume:
        # a finished run (val_metric.txt) still skips; a crashed one
        # resumes from its newest epoch checkpoint
        if distributed.primary_decision(check_to_skip(
                os.path.join(cfg.logger_name, "val_metric.txt"),
                cfg.overwrite)):
            return None
        latest_epoch, latest = checkpoints.latest_epoch_checkpoint(
            cfg.logger_name)
        # every rank must resume from the same checkpoint
        distributed.assert_agreement("auto_resume latest epoch",
                                     latest_epoch)
        if latest and not cfg.resume:
            cfg.resume = latest
            print("auto_resume: continuing from %s" % latest)
    elif (distributed.primary_decision(check_to_skip(
            os.path.join(cfg.logger_name, "model_best.pth.tar"),
            cfg.overwrite))
          or distributed.primary_decision(check_to_skip(
              os.path.join(cfg.logger_name, "val_metric.txt"),
              cfg.overwrite))):
        return None
    os.makedirs(cfg.logger_name, exist_ok=True)

    datasets = build_datasets(cfg)
    cfg.finalize()
    # eval loaders length-sort whenever buckets are on (embeddings scatter
    # back by dataset index); the train loader regroups only on request
    eval_grouped = ("sort" if cfg.token_buckets_list or cfg.frame_buckets_list
                    else "off")
    # in a world each rank gathers only its 1/R of every batch's rows
    pshard = process_batch_shard(mesh, cfg.batch_size)
    if pshard is not None:
        print("process-sharded loading: rank %d/%d gathers %d of %d rows a "
              "batch" % (pshard[0], pshard[1], cfg.batch_size // pshard[1],
                         cfg.batch_size))
    loaders = {
        "train": BatchLoader(datasets["train"], cfg.batch_size, shuffle=True,
                             seed=cfg.seed, final_batch="drop",
                             grouped="window" if cfg.length_grouped else "off",
                             process_shard=pshard),
        "val": BatchLoader(datasets["val"], cfg.batch_size, final_batch="pad",
                           grouped=eval_grouped, process_shard=pshard),
        # 'check': the train split re-scored, to see overfitting
        # (--validate_split check)
        "check": BatchLoader(datasets["train"], cfg.batch_size,
                             final_batch="pad", grouped=eval_grouped,
                             process_shard=pshard),
        "test": BatchLoader(datasets["test"], cfg.batch_size,
                            final_batch="pad", grouped=eval_grouped,
                            process_shard=pshard),
    }

    model, opt, state = init_state(cfg, device)
    if cfg.w2v_feature and cfg.text_net == "bi-gru":
        init_word_embeddings(model, cfg)
    print("model parameters: %d" % sum(p.numel() for p in model.parameters()))
    best_rsum, no_impr, lr_counter = 0.0, 0, 0
    best_epoch = None
    eiters = 0
    start_epoch = 0
    primary = distributed.is_primary()
    mlog = MetricsLog(cfg.logger_name) if primary else None

    if cfg.resume:
        if os.path.isfile(cfg.resume):
            print("=> loading checkpoint '%s'" % cfg.resume)
            # the port's own checkpoint, the JAX package's FRTPU1 or a
            # reference torch one; the first two carry the optimizer state
            ckpt = checkpoints.load_any(cfg.resume)
            model.load_state_dict(ckpt["state_dict"])
            if "optimizer" in ckpt:
                load_optimizer_state(opt, model, ckpt["optimizer"])
                print("=> optimizer state restored (exact Adam trajectory)")
            eiters = ckpt.get("Eiters", 0)
            if cfg.auto_resume:
                start_epoch = int(ckpt.get("epoch", 0))
                best_rsum = float(ckpt.get("best_rsum", 0.0))
                no_impr = int(ckpt.get("no_impr", 0))
                lr_counter = int(ckpt.get("lr_counter", 0))
                # the end-of-epoch lr scalings that ran after the save
                scale_lr(opt, float(ckpt.get("pending_lr_scale", 1.0)))
            print("=> loaded checkpoint (epoch %s, best_rsum %s)"
                  % (ckpt.get("epoch"), ckpt.get("best_rsum")))
            # the reference validates a resumed model on the val loader
            validate(model, loaders["val"], cfg, device)
        else:
            print("=> no checkpoint found at '%s'" % cfg.resume)

    val_loader = loaders.get(cfg.validate_split, loaders["test"])
    for epoch in range(start_epoch, cfg.num_epochs):
        # the reference builds a fresh loss module, so a fresh queue, each
        # epoch
        state = TrainState(queue=init_queue_state(
            cfg.queue_size, cfg.common_embedding_size, device=device),
            step=state.step)
        # profile epoch 1 (epoch 0 carries the first calls' set-up)
        profiled = cfg.profile_dir and epoch == min(1, cfg.num_epochs - 1)
        with profiling.trace(cfg.profile_dir if profiled else "", device):
            state, stats = train_epoch(model, opt, cfg, state,
                                       loaders["train"], epoch, device)
        print("=" * 58)
        print("=" * 23 + "Test Phase" + "=" * 25)
        print("=" * 58)
        score, metrics = validate(model, val_loader, cfg, device)
        record = {"epoch": epoch, "score": score, "lr": current_lr(opt),
                  "Eiters": state.step + eiters, **metrics._asdict(),
                  "updates": len(stats["losses"]),
                  "train_seconds": stats["seconds"],
                  "posts_per_s": stats["posts"] / max(stats["seconds"], 1e-9)}
        if stats["losses"]:
            record["loss"] = float(np.mean(stats["losses"]))
        if device.type == "cuda":
            record["device_peak_bytes"] = torch.cuda.max_memory_allocated(
                device)
        if primary:
            mlog.write(record)
        is_best = score > best_rsum
        print(" * Current perf in Test: {}".format(score))
        print(" * Best perf in Test: {}".format(best_rsum))

        # the lr-decay / early-stop counters move before the save, so that
        # an auto_resume restores them; the lr scalings apply after it
        lr_counter += 1
        stop = half = False
        if not is_best:
            no_impr += 1
            if no_impr > 10:
                stop = True
            elif lr_counter > 2:
                half = True
        else:
            no_impr = 0
        if primary:
            best_rsum = checkpoints.maybe_save_best(
                cfg.logger_name, cfg, model, epoch, score, best_rsum,
                state.step + eiters, best_epoch, optimizer=opt,
                extra_meta={"no_impr": no_impr,
                            "lr_counter": 0 if half else lr_counter,
                            # the saved optimizer predates this epoch's lr
                            # scalings; auto_resume applies this factor
                            "pending_lr_scale": cfg.lr_decay_rate * (
                                0.5 if half else 1.0)})
        else:
            # the other ranks track the same best without writing
            best_rsum = max(score, best_rsum)
        if is_best:
            best_epoch = epoch
        scale_lr(opt, cfg.lr_decay_rate)
        if stop:
            print("Early stopping happened.\n")
            break
        if half:
            scale_lr(opt, 0.5)
            lr_counter = 0

    if primary:
        with open(os.path.join(cfg.logger_name, "val_metric.txt"), "w") as f:
            f.write(str(best_rsum))
    print("best performance on Val: {}\n".format(best_rsum))
    return best_rsum


if __name__ == "__main__":
    main()

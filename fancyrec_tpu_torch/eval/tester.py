"""The evaluation CLI, the port's `fancyrec-test`.

    python -m fancyrec_tpu_torch.eval.tester insCartest --rootpath ROOT \\
        --logger_name ROOT/model/runs_0 [--device cpu]

Port of fancyrec_tpu/eval/tester.py: loads a checkpoint (whose embedded
config is the source of truth for every train-time option, reference
tester.py:63-65), the port's own or a reference torch one, rebuilds the
test split's dataset from it, encodes the split, ranks the posts for every
brand with the cosine kernel, prints the eight metrics and writes them to
mean_metrics.json beside the results. Runs on CUDA unless --device cpu.

In a world of R ranks (`torchrun --nproc_per_node R -m
fancyrec_tpu_torch.eval.tester ... --mesh_shape R,1`), each rank encodes
its 1/R of every batch and scores its 1/R of the posts, and the metrics
are exact (`metrics.ranking_metrics_sharded`); the exits follow the
primary and only the primary writes mean_metrics.json. At --mesh_shape
R,M over R*M ranks the model ranks of a slot split the weights as the
trainer's do (one model code path: the checkpoint's whole tree cut to the
rank's shard), and the slots split the rows and posts as above. The
checkpoint's --seq_shard and --pp_stages apply where the model axis can
host them (the pipeline where it equals pp_stages, the sequence split
where it divides the padded lengths); elsewhere BERT runs in sequence and
the pools replicated, with the same metrics.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.data.dataset import PostDataset, load_info
from fancyrec_tpu_torch.data.loader import BatchLoader
from fancyrec_tpu_torch.data.tokenizer import WordPieceTokenizer
from fancyrec_tpu_torch.eval.evaluator import encode_data, test_post_ranking
from fancyrec_tpu_torch.io.bigfile import ImageBigFile
from fancyrec_tpu_torch.io.dictfile import read_dict
from fancyrec_tpu_torch.io.vocab import Bow2Vec, load_vocab
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.parallel import distributed
from fancyrec_tpu_torch.parallel.mesh import (
    build_mesh, process_batch_shard, require_divisible_batch)
from fancyrec_tpu_torch.train import checkpoints


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    d = Config()
    p.add_argument("testCollection", type=str)
    p.add_argument("--rootpath", type=str, default=d.rootpath)
    p.add_argument("--overwrite", type=int, default=0, choices=[0, 1])
    p.add_argument("--log_step", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--workers", type=int, default=0)
    p.add_argument("--logger_name", default="runs")
    p.add_argument("--checkpoint_name", default="model_best.pth.tar", type=str)
    # 1, not the reference's legacy 20: insCar has one caption a post
    p.add_argument("--n_caption", type=int, default=1)
    # parsed but unused, as in the reference: the encoder levels come from
    # the checkpoint's config
    p.add_argument("--level_vis", type=str, default="1+2+3")
    p.add_argument("--level_txt", type=str, default="1+2+3")
    p.add_argument("--bert_vocab", type=str, default="")
    # "" = every rank of the world on data; "R,M" for a world of R*M
    p.add_argument("--mesh_shape", type=str, default="")
    # the JAX package's XLA compile cache: refused unless empty
    p.add_argument("--compilation_cache_dir", type=str, default="")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    opt = parse_args(argv)
    if opt.compilation_cache_dir:
        raise NotImplementedError(
            "--compilation_cache_dir is not implemented by the PyTorch port "
            "(got %r): it is XLA's compile cache; the port runs eager"
            % opt.compilation_cache_dir)
    device = distributed.initialize_multihost(opt.device)
    print(json.dumps(vars(opt), indent=2))
    mesh = build_mesh(opt.mesh_shape)
    require_divisible_batch(mesh, opt.batch_size)
    if mesh.data * mesh.model > 1:
        print("mesh: data=%d, model=%d; rank %d (data %d, model %d) on %s"
              % (mesh.data, mesh.model, mesh.rank, mesh.data_rank,
                 mesh.model_rank, device))

    # the exits follow the primary, whose files are the truth: a rank that
    # exited alone would leave the others waiting in a collective
    resume = os.path.join(opt.logger_name, opt.checkpoint_name)
    if distributed.primary_decision(not os.path.exists(resume)):
        logging.info(resume + " not exists.")
        sys.exit(0)

    ckpt = checkpoints.load_any(resume)
    print("=> loaded!")
    cfg: Config = ckpt["config"]
    cfg.rootpath = opt.rootpath
    testCollection = opt.testCollection

    # output-dir derivation and overwrite guard (reference tester.py:69-75).
    # The skip marker is the reference's pred_errors_matrix.pth.tar path,
    # which, as there, is never written; mean_metrics.json is.
    output_dir = resume.replace(cfg.trainCollection, testCollection)
    output_dir = output_dir.replace("/%s/" % cfg.cv_name,
                                    "/results/%s/" % cfg.trainCollection)
    pred_error_matrix_file = os.path.join(output_dir,
                                          "pred_errors_matrix.pth.tar")
    if distributed.primary_decision(os.path.exists(pred_error_matrix_file)
                                    and not opt.overwrite):
        print("%s exists. skip" % pred_error_matrix_file)
        sys.exit(0)
    result_file = os.path.join(os.path.dirname(output_dir),
                               "mean_metrics.json")

    root = opt.rootpath
    feat_dir = os.path.join(root, testCollection, "FeatureData")
    video_feat = ImageBigFile(os.path.join(feat_dir, cfg.video_feature))
    img_feat = ImageBigFile(os.path.join(feat_dir, cfg.img_feature))
    if cfg.visual_feat_dim != video_feat.ndims:
        raise ValueError("the checkpoint's visual_feat_dim %d differs from "
                         "the %d-d features of %s" % (
                             cfg.visual_feat_dim, video_feat.ndims,
                             cfg.video_feature))
    video2frames = read_dict(os.path.join(feat_dir, cfg.video_feature,
                                          "video2frames.txt"))
    vocab_dir = os.path.join(root, cfg.trainCollection, "TextData",
                             "vocabulary")
    bow_vocab = load_vocab(os.path.join(vocab_dir, "bow", cfg.vocab + ".pkl"))
    rnn_vocab = load_vocab(os.path.join(vocab_dir, "rnn", cfg.vocab + ".pkl"))
    cfg.bow_vocab_size = len(bow_vocab)
    cfg.vocab_size = len(rnn_vocab)
    cfg.finalize()

    tokenizer = None
    if cfg.text_net == "transformers":
        tokenizer = WordPieceTokenizer(opt.bert_vocab or cfg.bert_vocab
                                       or os.path.join(root, "bert_vocab.txt"))

    img_info, cls_info = load_info(root)
    print("=> prepare dataloader..")
    dataset = PostDataset(
        os.path.join(root, testCollection, "TextData",
                     "%s.caption.txt" % testCollection),
        video_feat, img_feat, Bow2Vec(bow_vocab), text_net=cfg.text_net,
        rnn_vocab=rnn_vocab, tokenizer=tokenizer, video2frames=video2frames,
        img_info=img_info, cls_info=cls_info, max_frames=cfg.max_frames,
        max_tokens=cfg.max_tokens, max_words=cfg.max_words,
        # the reference tester's caption/visual consistency guard
        # (tester.py:97 -> data_provider.py:203-205)
        n_caption=opt.n_caption)
    # train-time buckets ride the checkpoint: length-sort the eval order so
    # they bite (encode_data scatters embeddings back by dataset index)
    bucketing = bool(cfg.token_buckets_list or cfg.frame_buckets_list)
    loader = BatchLoader(dataset, opt.batch_size, final_batch="pad",
                         grouped="sort" if bucketing else "off",
                         process_shard=process_batch_shard(
                             mesh, opt.batch_size))

    model = FancyRec(cfg, mesh)
    if cfg.pp_stages > 1 and not model.pp:
        print("the checkpoint's --pp_stages %d needs a model axis of %d; "
              "this mesh has %d, so BERT runs its layers in sequence (the "
              "same model)" % (cfg.pp_stages, cfg.pp_stages, mesh.model))
    model.load_full_state_dict(ckpt["state_dict"])
    model.to(device).eval()
    brands, post_embs = encode_data(model, loader, cfg.common_embedding_size,
                                    device,
                                    token_buckets=cfg.token_buckets_list,
                                    frame_buckets=cfg.frame_buckets_list)
    m = test_post_ranking(model, cfg.brand_num, post_embs, brands, device)

    print("AUC[0-1]:", m.auc)
    print("NDCG@10[0-1]:", m.ndcg10)
    print("NDCG@50[0-1]:", m.ndcg50)
    print("recall@1:", m.r1)
    print("recall@5:", m.r5)
    print("recall@10:", m.r10)
    print("MedR:", m.medr)
    print("MeanR:", m.meanr)
    if distributed.is_primary():
        os.makedirs(os.path.dirname(result_file) or ".", exist_ok=True)
        with open(result_file, "w") as f:
            f.write(json.dumps({k: float(v) for k, v in m._asdict().items()}))
    return m


if __name__ == "__main__":
    main()

"""Synthetic mini-insCar fixture: a complete, deterministic dataset tree.

Generates every artifact the training/eval stack consumes, in the exact
on-disk layout the reference expects (trainer.py:158-238, tester.py:77-95):

  root/
    img_info.txt                      {'idx2img': {int: 'Brand/img.jpg'}}
    cls.txt                           {"cls2idx": {...}, "idx2cls": {...}}
    bert_vocab.txt                    WordPiece vocab for the offline tokenizer
    <coll>/TextData/<coll>.caption.txt
    <coll>/FeatureData/<video_feature>/{feature.bin,id.txt,shape.txt,video2frames.txt}
    <coll>/FeatureData/<img_feature>/{feature.bin,id.txt,shape.txt}
    <train>/TextData/vocabulary/{bow,rnn}/word_vocab_5.pkl

Feature vectors are random but seeded with a per-brand mean shift so that
retrieval metrics are non-degenerate (a learnable signal exists).
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

import numpy as np

from fancyrec_tpu_torch.io.bigfile import BigFileWriter
from fancyrec_tpu_torch.io.dictfile import write_dict
from fancyrec_tpu_torch.io.vocab import build_vocab, save_vocab
from fancyrec_tpu_torch.data.tokenizer import write_minimal_bert_vocab

_WORDS = ["fast", "car", "drive", "road", "red", "blue", "engine", "wheel",
          "city", "night", "race", "luxury", "classic", "new", "power",
          "speed", "design", "sport", "family", "electric"]


def make_fixture(root: str, *, brand_num: int = 4, videos_per_brand: int = 3,
                 imgs_per_brand: int = 3, feat_dim: int = 32,
                 frames_per_video: int = 5, seed: int = 0,
                 collections: Dict[str, str] = None,
                 video_feature: str = "resnet152_dim_%d",
                 img_feature: str = "imgfeat_dim_%d") -> dict:
    collections = collections or {"train": "insCartrain", "val": "insCarval",
                                  "test": "insCartest"}
    video_feature = video_feature % feat_dim if "%d" in video_feature else video_feature
    img_feature = img_feature % feat_dim if "%d" in img_feature else img_feature
    rng = np.random.RandomState(seed)
    pyrng = random.Random(seed)
    brands = [f"brand{b}" for b in range(brand_num)]
    os.makedirs(root, exist_ok=True)

    # shared info files
    img_info = {"idx2img": {}, "img2idx": {}}
    cls_info = {"cls2idx": {b: i for i, b in enumerate(brands)},
                "idx2cls": {i: b for i, b in enumerate(brands)}}
    with open(os.path.join(root, "cls.txt"), "w") as f:
        f.write(json.dumps(cls_info))

    brand_means = rng.randn(brand_num, feat_dim) * 2.0
    all_captions: List[str] = []
    next_video_id, next_img_id = 1, 1

    per_coll_caps: Dict[str, List[str]] = {c: [] for c in collections}

    for coll_key, coll in collections.items():
        feat_dir = os.path.join(root, coll, "FeatureData")
        video2frames = {}
        with BigFileWriter(os.path.join(feat_dir, video_feature), feat_dim) as vw:
            for b in range(brand_num):
                for _ in range(videos_per_brand):
                    vid = "video%d" % next_video_id
                    next_video_id += 1
                    names = []
                    for k in range(frames_per_video):
                        fname = "%s_%d_cls%d" % (vid, k * 15, b)
                        vw.write(fname, brand_means[b] + rng.randn(feat_dim))
                        names.append(fname)
                    video2frames[vid] = names
                    cap = " ".join(pyrng.choices(_WORDS, k=pyrng.randint(3, 8)))
                    cap = cap + " " + brands[b]
                    per_coll_caps[coll_key].append("%s#enc#0 %s" % (vid, cap))
                    all_captions.append(cap)
        write_dict(os.path.join(feat_dir, video_feature, "video2frames.txt"),
                   video2frames)

        with BigFileWriter(os.path.join(feat_dir, img_feature), feat_dim) as iw:
            for b in range(brand_num):
                for _ in range(imgs_per_brand):
                    img_name = "%s/img_%06d.jpg" % (brands[b], next_img_id)
                    iw.write(img_name, brand_means[b] + rng.randn(feat_dim))
                    img_info["idx2img"][next_img_id] = img_name
                    img_info["img2idx"][img_name] = next_img_id
                    cap = " ".join(pyrng.choices(_WORDS, k=pyrng.randint(3, 8)))
                    cap = cap + " " + brands[b]
                    per_coll_caps[coll_key].append("img%d#enc#0 %s" % (next_img_id, cap))
                    all_captions.append(cap)
                    next_img_id += 1

        text_dir = os.path.join(root, coll, "TextData")
        os.makedirs(text_dir, exist_ok=True)
        with open(os.path.join(text_dir, "%s.caption.txt" % coll), "w") as f:
            f.write("\n".join(per_coll_caps[coll_key]) + "\n")

    write_dict(os.path.join(root, "img_info.txt"), img_info)

    # vocabularies over the train captions (threshold 1: tiny corpus)
    train_coll = collections["train"]
    vdir = os.path.join(root, train_coll, "TextData", "vocabulary")
    for style in ("bow", "rnn"):
        vocab, _ = build_vocab(all_captions, style, threshold=1)
        save_vocab(vocab, os.path.join(vdir, style, "word_vocab_5.pkl"))

    write_minimal_bert_vocab(os.path.join(root, "bert_vocab.txt"),
                             _WORDS + brands)
    return {
        "root": root, "collections": collections, "feat_dim": feat_dim,
        "brand_num": brand_num, "video_feature": video_feature,
        "img_feature": img_feature,
        "bert_vocab": os.path.join(root, "bert_vocab.txt"),
    }


def main():
    import argparse
    p = argparse.ArgumentParser(description="generate a synthetic mini-insCar tree")
    p.add_argument("root")
    p.add_argument("--brand_num", type=int, default=4)
    p.add_argument("--feat_dim", type=int, default=32)
    p.add_argument("--videos_per_brand", type=int, default=3)
    p.add_argument("--imgs_per_brand", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    info = make_fixture(args.root, brand_num=args.brand_num,
                        feat_dim=args.feat_dim,
                        videos_per_brand=args.videos_per_brand,
                        imgs_per_brand=args.imgs_per_brand, seed=args.seed)
    print(json.dumps({k: v for k, v in info.items() if k != "collections"},
                     indent=2))


if __name__ == "__main__":
    main()

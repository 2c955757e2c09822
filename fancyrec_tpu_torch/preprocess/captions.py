"""Caption extraction + train/val/test splits.

Mirrors reference preprocess/preprocess_captions.py: walk Instagram-scrape
JSON ('GraphImages' items), take the first edge_media_to_caption text,
build cls2idx/idx2cls, split 80/5/15 per brand with random.seed(brand_index)
(16/1/3 twentieths, exactly), and emit 'video{id}#enc#0 cleaned text' /
'img{id}#enc#0 ...' caption lines.
"""

from __future__ import annotations

import json
import os
import random
from typing import Dict, List

from fancyrec_tpu_torch.io.dictfile import read_dict
from fancyrec_tpu_torch.io.vocab import clean_str


def _sorted_brands(brand_path) -> List[str]:
    if isinstance(brand_path, str):
        brand_path = os.listdir(brand_path)
    return sorted(brand_path)


def _walk_items(root_path: str, cate: str):
    for f in sorted(os.listdir(os.path.join(root_path, cate))):
        if not f.endswith(".json"):
            continue
        with open(os.path.join(root_path, cate, f), encoding="utf-8") as fh:
            dic = json.load(fh)
        for item in dic.get("GraphImages", []):
            yield item


def extract_video_captions(root_path: str, brand_path, out_dir: str) -> dict:
    """-> writes video_captions.txt (JSON) + cls.txt; returns the caps map."""
    brands = _sorted_brands(brand_path)
    cls2idx = {b.split("/")[-1]: i for i, b in enumerate(brands)}
    idx2cls = {i: b.split("/")[-1] for i, b in enumerate(brands)}
    video2captions: Dict[str, dict] = {}
    for cate in brands:
        for item in _walk_items(root_path, cate):
            if item.get("__typename") == "GraphVideo" and item.get("is_video"):
                name = item["shortcode"]
                edges = item.get("edge_media_to_caption", {}).get("edges", [])
                if name in video2captions or not edges:
                    continue
                caps = edges[0]["node"]["text"]
                if caps is None:
                    continue
                video2captions[name] = {"caps": caps,
                                        "tags": item.get("tags")}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "cls.txt"), "w") as f:
        f.write(json.dumps({"cls2idx": cls2idx, "idx2cls": idx2cls}))
    with open(os.path.join(out_dir, "video_captions.txt"), "w") as f:
        f.write(json.dumps(video2captions))
    return video2captions


def extract_image_captions(root_path: str, brand_path, out_dir: str) -> dict:
    brands = _sorted_brands(brand_path)
    img2captions: Dict[str, dict] = {}
    for cate in brands:
        for item in _walk_items(root_path, cate):
            if item.get("__typename") == "GraphImage" or not item.get("is_video"):
                name = cate + "/" + item["shortcode"] + ".jpg"
                edges = item.get("edge_media_to_caption", {}).get("edges", [])
                if name in img2captions or not edges:
                    continue
                caps = edges[0]["node"]["text"]
                if caps is None:
                    continue
                img2captions[name] = {"caps": caps, "tags": item.get("tags")}
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "img_captions.txt"), "w") as f:
        f.write(json.dumps(img2captions))
    return img2captions


def _split_ids(per_brand_items: List[List[int]]) -> Dict[str, List[int]]:
    """Per-brand seeded 16/1/3-of-20 split (preprocess_captions.py:186-194)."""
    train, val, test = [], [], []
    for index, items in enumerate(per_brand_items):
        items = list(items)
        random.seed(index)
        random.shuffle(items)
        piece = len(items) // 20
        train.extend(items[: piece * 16])
        val.extend(items[piece * 16: piece * 17])
        test.extend(items[piece * 17:])
    return {"train": train, "val": val, "test": test}


def videos_split_train_val_test(source_root_path: str, out_dir: str,
                                prefix: str, brand_path) -> Dict[str, str]:
    """-> {'train': path, ...} caption files '<prefix><split>.caption.txt'."""
    with open(os.path.join(out_dir, "video_captions.txt")) as f:
        caps = json.loads(f.read())
    video_info = read_dict(os.path.join(out_dir, "video_info.txt"))
    video2id, id2video = video_info["video2idx"], video_info["idx2video"]

    brands = _sorted_brands(brand_path)
    per_brand = []
    for brand in brands:
        items = []
        for f in sorted(os.listdir(os.path.join(source_root_path, brand))):
            if f.endswith("mp4"):
                name = f[:-4]
                if name in video2id and video2id[name] in id2video:
                    items.append(video2id[name])
        per_brand.append(items)
    splits = _split_ids(per_brand)

    out = {}
    for x, ids in splits.items():
        path = os.path.join(out_dir, "%s%s.caption.txt" % (prefix, x))
        with open(path, "w") as w:
            for vid in ids:
                entry = caps.get(id2video[vid])
                if entry is None:
                    continue
                text = " ".join(clean_str(entry["caps"]))
                w.write("video%s#enc#0 %s\n" % (vid, text))
        out[x] = path
    return out


def imgs_split_train_val_test(source_root_path: str, out_dir: str,
                              prefix: str, brand_path,
                              threshold: int = -1) -> Dict[str, str]:
    with open(os.path.join(out_dir, "img_captions.txt")) as f:
        caps = json.loads(f.read())
    img_info = read_dict(os.path.join(out_dir, "img_info.txt"))
    img2id, id2img = img_info["img2idx"], img_info["idx2img"]

    brands = _sorted_brands(brand_path)
    per_brand = []
    for brand in brands:
        items, cnt = [], 0
        for f in sorted(os.listdir(os.path.join(source_root_path, brand))):
            if not f.endswith("jpg"):
                continue
            if threshold > 0:
                cnt += 1
                if cnt == threshold:
                    break
            img = brand + "/" + f
            if img in img2id and img2id[img] in id2img:
                items.append(img2id[img])
        per_brand.append(items)
    splits = _split_ids(per_brand)

    out = {}
    for x, ids in splits.items():
        path = os.path.join(out_dir, "%s%s.img_caption.txt" % (prefix, x))
        with open(path, "w") as w:
            for iid in ids:
                entry = caps.get(id2img[iid])
                if entry is None:
                    continue
                text = " ".join(clean_str(entry["caps"]))
                w.write("img%s#enc#0 %s\n" % (iid, text))
        out[x] = path
    return out


def merge_captions(out_dir: str, prefix: str) -> None:
    """Append '<split>.img_caption.txt' into '<split>.caption.txt'."""
    for x in ("train", "val", "test"):
        src = os.path.join(out_dir, "%s%s.img_caption.txt" % (prefix, x))
        dst = os.path.join(out_dir, "%s%s.caption.txt" % (prefix, x))
        with open(src) as s, open(dst, "a") as d:
            d.writelines(s.readlines())

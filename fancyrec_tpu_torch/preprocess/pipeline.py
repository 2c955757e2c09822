"""Offline preprocessing orchestrator (reference preprocess_data.py:32-161).

Nine steps, each skippable and resumable:
  1. sample video frames            (videos.iter_sampled_frames / dump)
  2. extract frame features         (ResNet-152 on the card, fused w/ step 1)
  3. pack features + frame info     (BigFileWriter + frameinfo)
  4. collect brand images
  5. extract + pack image features, img<->idx maps
  6. extract captions from Instagram-scrape JSON
  7. split train/val/test 80/5/15 per brand, merge video+img captions
  8. build bow/rnn vocabularies
  9. lay out the collection directory tree

Unlike the reference (which shells out to generated bash and round-trips
frames through jpg files), everything here is in-process and the
decode->ResNet->BigFile path is fused and double-buffered.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Dict

from fancyrec_tpu_torch.io.dictfile import write_dict
from fancyrec_tpu_torch.preprocess import captions as C
from fancyrec_tpu_torch.preprocess import features as F
from fancyrec_tpu_torch.preprocess import videos as V
from fancyrec_tpu_torch.preprocess.frameinfo import get_frame_info
from fancyrec_tpu_torch.preprocess import vocab_cli


def img2idx_and_idx2img(root_path: str, brand_path, out_path: str) -> dict:
    """image name <-> running id maps (reference preprocess_images.py)."""
    brands = C._sorted_brands(brand_path)
    img2idx, idx2img = {}, {}
    img_id = 0
    for cate in brands:
        for f in sorted(os.listdir(os.path.join(root_path, cate))):
            if not f.endswith("jpg"):
                continue
            img_id += 1
            name = cate + "/" + f
            if name not in img2idx:
                img2idx[name] = img_id
                idx2img[img_id] = name
    info = {"img2idx": img2idx, "idx2img": idx2img}
    if out_path:
        write_dict(out_path, info)
    return info


def iter_brand_images(root_path: str, brand_path, resize=(224, 224)):
    """(brand/name.jpg stripped to 'brand/name', image) over all brand dirs.

    Image features are keyed by 'brand/filename.jpg' in the reference
    (preprocess_images.py) -- keep the .jpg suffix in the stored name."""
    from PIL import Image
    import numpy as np

    for cate in C._sorted_brands(brand_path):
        d = os.path.join(root_path, cate)
        for f in sorted(os.listdir(d)):
            if not f.endswith("jpg"):
                continue
            try:
                img = Image.open(os.path.join(d, f)).convert("RGB").resize(resize)
            except Exception:
                continue
            yield cate + "/" + f, np.asarray(img, np.uint8)


def run(source_root: str, target_root: str, dataset_name: str = "insCar",
        feat_dim_name: str = "resnet152_dim_2048",
        img_feat_name: str = "imgfeat_dim_2048",
        params=None, batch_size: int = 128, vocab_threshold: int = 5,
        brands=None, extract_fn=None, decode_workers: int = 1,
        decode_backend: str = "process", device=None) -> Dict[str, str]:
    """Full pipeline: source scrape tree -> ready-to-train collection tree.

    Without `extract_fn` the ResNet-152 of `params` (random from seed 0
    when None) runs on `device`, the card unless the caller asks for the
    CPU; without a card that raises before anything is written."""
    if extract_fn is None:
        from fancyrec_tpu_torch.device import resolve_device
        device = resolve_device(device)
    out_dir = os.path.join(target_root, dataset_name)
    os.makedirs(out_dir, exist_ok=True)
    brands = brands if brands is not None else sorted(os.listdir(source_root))

    # 1+2+3: videos -> frame features (fused) -> BigFile + video2frames
    video_feat_dir = os.path.join(out_dir, "video_features")
    if not os.path.exists(os.path.join(video_feat_dir, "shape.txt")):
        if decode_workers > 1:
            stream = V.iter_sampled_frames_parallel(source_root, brands,
                                                    workers=decode_workers,
                                                    backend=decode_backend)
        else:
            stream = V.iter_sampled_frames(source_root, brands)
        n = F.extract_features(stream, video_feat_dir, batch_size=batch_size,
                               params=params, extract_fn=extract_fn,
                               device=device)
        print("frame features:", n)
    get_frame_info(video_feat_dir, overwrite=0)
    V.video2idx_and_idx2video(source_root, brands,
                              os.path.join(out_dir, "video_info.txt"))

    # 4+5: images -> features + id maps
    img_feat_dir = os.path.join(out_dir, "img_features")
    if not os.path.exists(os.path.join(img_feat_dir, "shape.txt")):
        stream = iter_brand_images(source_root, brands)
        n = F.extract_features(stream, img_feat_dir, batch_size=batch_size,
                               params=params, extract_fn=extract_fn,
                               device=device)
        print("image features:", n)
    img2idx_and_idx2img(source_root, brands,
                        os.path.join(out_dir, "img_info.txt"))

    # 6: captions from scrape JSON
    C.extract_video_captions(source_root, brands, out_dir)
    C.extract_image_captions(source_root, brands, out_dir)

    # 7: splits + merge
    C.videos_split_train_val_test(source_root, out_dir, dataset_name, brands)
    C.imgs_split_train_val_test(source_root, out_dir, dataset_name, brands)
    C.merge_captions(out_dir, dataset_name)

    # 9: collection layout (reference template_construct_dir.sh)
    collections = {s: "%s%s" % (dataset_name, s) for s in ("train", "val", "test")}
    for split, coll in collections.items():
        fd = os.path.join(out_dir, coll, "FeatureData")
        td = os.path.join(out_dir, coll, "TextData")
        os.makedirs(td, exist_ok=True)
        for src, name in ((video_feat_dir, feat_dim_name),
                          (img_feat_dir, img_feat_name)):
            dst = os.path.join(fd, name)
            if not os.path.exists(dst):
                os.makedirs(fd, exist_ok=True)
                shutil.copytree(src, dst)
        cap_src = os.path.join(out_dir, "%s%s.caption.txt" % (dataset_name, split))
        shutil.copyfile(cap_src, os.path.join(td, "%s.caption.txt" % coll))
    # img_info.txt and cls.txt already sit at out_dir, which doubles as the
    # training rootpath (data_provider reads them from rootpath)

    # 8: vocabularies over the train collection
    for style in ("bow", "rnn"):
        vocab_cli.build(out_dir, collections["train"], vocab_threshold, style,
                        overwrite=0)

    return {"out_dir": out_dir, **collections}


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description="offline preprocessing pipeline")
    p.add_argument("source_root", help="scrape tree: <brand>/{*.mp4,*.jpg,*.json}")
    p.add_argument("target_root")
    p.add_argument("--dataset_name", default="insCar")
    p.add_argument("--batch_size", type=int, default=128)
    p.add_argument("--vocab_threshold", type=int, default=5)
    p.add_argument("--decode_workers", type=int, default=1,
                   help="parallel video decode workers (frame output order "
                        "stays deterministic; >1 pays on multi-core hosts)")
    p.add_argument("--decode_backend", default="process",
                   choices=("process", "thread"),
                   help="decode worker pool kind: spawn processes (scale "
                        "past the GIL on multi-core hosts) or threads")
    p.add_argument("--device", default="cuda",
                   help="where the extractor runs: cuda (the default; "
                        "raises without a GPU) or cpu")
    a = p.parse_args(argv)
    out = run(a.source_root, a.target_root, a.dataset_name,
              batch_size=a.batch_size, vocab_threshold=a.vocab_threshold,
              decode_workers=a.decode_workers,
              decode_backend=a.decode_backend, device=a.device)
    print(json.dumps(out, indent=2))


if __name__ == "__main__":
    main()

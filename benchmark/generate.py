"""The one traffic generator: posts and frames from a traffic file's
parameters and the seed.

Every seed gets the same set of sizes (lengths and counts),
dealt out in another order, so that the seed changes which posts are
where, not how much work a run holds. Sizes are spread evenly over each
range given in the traffic file.
"""

from __future__ import annotations

import string
from typing import Dict, List

import numpy as np
import torch


def spread(lo: int, hi: int, n: int) -> np.ndarray:
    """n whole numbers spread evenly over [lo, hi]."""
    if n <= 0:
        return np.zeros(0, np.int64)
    return np.rint(np.linspace(lo, hi, n)).astype(np.int64)


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of its own for each use of the seed."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, stream])


def vocabulary(n: int) -> List[str]:
    """n distinct lower-case words, the same for every seed: whole
    WordPiece tokens of the benchmark's vocabulary file."""
    letters = string.ascii_lowercase
    words = []
    for i in range(n):
        s, k = "", i
        for _ in range(4):
            s = letters[k % 26] + s
            k //= 26
        words.append("w" + s)
    return words


class Vocabulary:
    """A word list as the FancyRec vocabulary pickles hold it (the
    attributes the program reads; it loads the class by name)."""

    def __init__(self, words, style, specials=()):
        self.word2idx, self.idx2word = {}, {}
        for i, w in enumerate(list(specials) + list(words)):
            self.word2idx[w] = i
            self.idx2word[i] = w
        self.idx = len(self.word2idx)
        self.text_style = style


def posts(traffic: dict, brand_num: int, caption_words: int,
          seed: int) -> Dict[str, object]:
    """A train collection's posts: which are videos, frames a post, brand,
    caption word ids (over the first `caption_words` words of
    `vocabulary`). A caption's length is in WordPiece tokens with [CLS]
    and [SEP] ("tokens") or in words ("words")."""
    n = int(traffic["posts"])
    r = rng_for(seed, 1)
    n_vid = int(round(n * traffic["video_share"]))
    is_video = np.zeros(n, bool)
    is_video[r.permutation(n)[:n_vid]] = True
    frames = np.ones(n, np.int64)
    lo, hi = traffic["video_frames"]
    frames[is_video] = r.permutation(spread(lo, hi, n_vid))
    brands = r.permutation(np.arange(n) % brand_num).astype(np.int64)
    lo, hi = traffic["caption_length"]
    lengths = r.permutation(spread(lo, hi, n))
    n_words = lengths - 2 if traffic["caption_unit"] == "tokens" else lengths
    words = [r.integers(0, caption_words, int(k)) for k in n_words]
    return {"n": n, "is_video": is_video, "frames": frames, "brands": brands,
            "words": words}


def frame_features(p: dict, feat_dim: int, brand_num: int, seed: int,
                   device) -> torch.Tensor:
    """(total frames, feat_dim) float32 features on `device`, post after
    post: a normal draw, shifted by a direction of the post's brand so
    that brands differ."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 7 + 3)
    total = int(p["frames"].sum())
    feats = torch.randn(total, feat_dim, generator=g, device=device)
    shift = torch.randn(brand_num, feat_dim, generator=g, device=device)
    owner = torch.from_numpy(np.repeat(p["brands"], p["frames"])).to(device)
    return feats.add_(shift[owner], alpha=0.5)


def frame_pool(n: int, size: int, seed: int, device,
               chunk: int = 256) -> torch.Tensor:
    """(n, size, size, 3) uint8 frames, drawn on `device`: a smooth random
    scene (an 8 x 8 colour field, upsampled) under pixel noise, so that
    frames differ as wholes and not only pixel by pixel."""
    g = torch.Generator(device=device).manual_seed(int(seed) * 5 + 1)
    out = []
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        scene = torch.nn.functional.interpolate(
            torch.randn(m, 3, 8, 8, generator=g, device=device),
            size=(size, size), mode="bilinear", align_corners=False)
        noise = torch.randn(m, 3, size, size, generator=g, device=device)
        x = 128.0 + 60.0 * scene + 20.0 * noise
        out.append(x.clamp_(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
                   .contiguous())
    return torch.cat(out)

"""The traffic generator: the same seed gives the same traffic, another
seed another order of the same sizes."""

import numpy as np
import torch

import generate
from portbench_tiny import SHAPES

TRAIN = {"posts": 64, "video_share": 0.5, "video_frames": [8, 64],
         "caption_length": [8, 128], "caption_unit": "tokens"}


def _posts(seed):
    return generate.posts(TRAIN, 51, 1000, seed)


def test_posts_deterministic_and_seeded():
    a, b, c = _posts(3), _posts(3), _posts(2 ** 31 + 7)
    for k in ("is_video", "frames", "brands"):
        assert np.array_equal(a[k], b[k])
    assert all(np.array_equal(x, y) for x, y in zip(a["words"], b["words"]))
    assert not np.array_equal(a["frames"], c["frames"])
    # the same sizes, in another order
    assert sorted(a["frames"]) == sorted(c["frames"])
    assert sorted(map(len, a["words"])) == sorted(map(len, c["words"]))
    assert a["is_video"].sum() == 32 and a["frames"][~a["is_video"]].max() == 1


def test_features_and_frames_deterministic_and_seeded():
    p = _posts(5)
    f1 = generate.frame_features(p, 16, 51, 5, "cpu")
    f2 = generate.frame_features(p, 16, 51, 5, "cpu")
    f3 = generate.frame_features(p, 16, 51, 6, "cpu")
    assert torch.equal(f1, f2) and not torch.equal(f1, f3)
    assert f1.shape == (int(p["frames"].sum()), 16)
    g1 = generate.frame_pool(4, 8, 9, "cpu")
    assert torch.equal(g1, generate.frame_pool(4, 8, 9, "cpu"))
    assert not torch.equal(g1, generate.frame_pool(4, 8, 10, "cpu"))
    assert g1.dtype == torch.uint8 and g1.shape == (4, 8, 8, 3)


def test_vocabulary_words_are_whole_lowercase_tokens():
    words = generate.vocabulary(1000)
    assert len(set(words)) == 1000
    assert all(w.isalpha() and w.islower() for w in words)
    assert SHAPES["bert3.train"]["config"]["data"]["bow_vocab_size"] <= 1000

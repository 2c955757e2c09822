"""The training batches of a collection, worked out from the benchmark's
posts: which posts an epoch's batches hold and in what order, and their
padded arrays.

The collection's semantics (the reference FancyRec data provider's): an
epoch shuffles the posts with numpy's RandomState(seed + epoch), cuts
batches of B in that order, drops the last partial batch, and sorts each
batch by caption length, longest first (the length of the cleaned
caption in characters for the BERT tower, its word count plus two for the
bi-GRU one), ties kept in order. Frames are padded to max_frames; the
mean frame averages every frame of the post. The BERT tower reads
[CLS] words [SEP] over the WordPiece vocabulary (five special tokens,
then the words in order); the bi-GRU tower reads <start> words <end> over
its vocabulary (four special tokens, then the words); the bag of words
counts each word of the bag vocabulary (the first words, in order).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

BERT_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
RNN_SPECIALS = ("<pad>", "<start>", "<end>", "<unk>")


def sort_keys(posts: dict, words: List[str], text_net: str) -> np.ndarray:
    if text_net == "transformers":
        return np.array([len(" ".join(words[i] for i in ws))
                         for ws in posts["words"]], np.int64)
    return np.array([len(ws) + 2 for ws in posts["words"]], np.int64)


def epoch_batches(n: int, batch: int, seed: int, epoch: int,
                  keys: np.ndarray) -> List[List[int]]:
    order = np.arange(n)
    np.random.RandomState(seed + epoch).shuffle(order)
    out = []
    for s in range(0, (n // batch) * batch, batch):
        idx = list(order[s:s + batch])
        idx.sort(key=lambda i: int(keys[i]), reverse=True)
        out.append(idx)
    return out


def tensors(posts: dict, feats: torch.Tensor, idx: List[int], data: dict,
            text_net: str) -> Dict[str, torch.Tensor]:
    """One batch's arrays on feats' device. feats: every frame of every
    post, post after post."""
    dev = feats.device
    b, t_max, d = len(idx), data["max_frames"], feats.shape[1]
    starts = np.concatenate([[0], np.cumsum(posts["frames"])])
    frames = torch.zeros(b, t_max, d, device=dev)
    origin = torch.zeros(b, d, device=dev)
    vmask = torch.zeros(b, t_max, device=dev)
    n_tok = data["max_tokens"] if text_net == "transformers" \
        else data["max_words"]
    tokens = torch.zeros(b, n_tok, dtype=torch.int64)
    tmask = torch.zeros(b, n_tok)
    bows = torch.zeros(b, data["bow_vocab_size"])
    for r, i in enumerate(idx):
        rows = feats[starts[i]:starts[i + 1]]
        k = min(rows.shape[0], t_max)
        frames[r, :k] = rows[:k]
        origin[r] = rows.mean(dim=0)
        vmask[r, :k] = 1.0
        ws = [int(w) for w in posts["words"][i]]
        if text_net == "transformers":
            ids = [2] + [len(BERT_SPECIALS) + w for w in ws][:n_tok - 2] + [3]
        else:
            rnn = data["rnn_vocab_size"] - len(RNN_SPECIALS)
            ids = ([1] + [len(RNN_SPECIALS) + w if w < rnn else 3
                          for w in ws] + [2])[:n_tok]
        tokens[r, :len(ids)] = torch.tensor(ids)
        tmask[r, :len(ids)] = 1.0
        for w in ws:
            if w < data["bow_vocab_size"]:
                bows[r, w] += 1.0
    return {"brand_ids": torch.from_numpy(posts["brands"][idx]).to(dev),
            "frames": frames, "origin": origin, "vmask": vmask,
            "bows": bows.to(dev), "tokens": tokens.to(dev),
            "type_ids": torch.zeros_like(tokens).to(dev),
            "tmask": tmask.to(dev)}

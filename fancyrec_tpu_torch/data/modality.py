"""Standalone single-modality datasets: visual-only and text-only encoding.

Port of fancyrec_tpu/data/modality.py (numpy datasets; the encode loop on
one torch device). The reference ships VisDataSet4DualEncoding /
TxtDataSet4DualEncoding + collate_frame/collate_text
(data_provider.py:275-346,119-163) for encoding one modality without the
fusion path, but its visual dataset is broken on py3 (it indexes a
dict_keys view, data_provider.py:288) and neither is reachable from any
entry point. Here both are real and fixed-shape, and feed the modality encoders
(eval.evaluator.encode_vis / encode_txt) through the same BatchLoader as
the main path.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from fancyrec_tpu_torch.data.dataset import CaptionSet
from fancyrec_tpu_torch.data.tokenizer import WordPieceTokenizer
from fancyrec_tpu_torch.io.bigfile import BigFileReader
from fancyrec_tpu_torch.io.vocab import Bow2Vec, Vocabulary, clean_str


class VisDataset:
    """Visual items only: every video in video2frames plus (optionally)
    every image in an image store. gather_batch -> the VisualBatch arrays
    (frames/origin/vmask) with the same static-shape semantics as
    PostDataset (mean-frame over ALL frames, cap at max_frames)."""

    def __init__(self, video_feat: Optional[BigFileReader] = None,
                 video2frames: Optional[dict] = None,
                 img_feat: Optional[BigFileReader] = None,
                 max_frames: int = 64):
        self.max_frames = max_frames
        self.names: List[str] = []
        self._stores: List[BigFileReader] = []
        self._rows: List[np.ndarray] = []
        if video2frames:
            # sorted for a deterministic item order (the reference iterated
            # raw dict order)
            for vid in sorted(video2frames):
                frames = video2frames[vid]
                if not frames:
                    raise ValueError(
                        "video %r has no frames (a zero-frame entry would "
                        "silently produce NaN mean-frame embeddings)" % vid)
                self.names.append(vid)
                self._stores.append(video_feat)
                self._rows.append(np.array(
                    [video_feat.name2index[f] for f in frames], np.int64))
        if img_feat is not None:
            for name in img_feat.names:
                self.names.append(name)
                self._stores.append(img_feat)
                self._rows.append(
                    np.array([img_feat.name2index[name]], np.int64))
        if not self.names:
            raise ValueError("no visual items (need video2frames or img_feat)")
        self.ndims = (video_feat or img_feat).ndims

    def __len__(self):
        return len(self.names)

    def gather_batch(self, indices: Sequence[int],
                     pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        indices = list(indices)
        n_valid = len(indices)
        if pad_to is not None and len(indices) < pad_to:
            indices = indices + [indices[-1]] * (pad_to - len(indices))
        b = len(indices)
        frames = np.zeros((b, self.max_frames, self.ndims), np.float32)
        origin = np.zeros((b, self.ndims), np.float32)
        vmask = np.zeros((b, self.max_frames), np.float32)
        for bi, i in enumerate(indices):
            rows = self._stores[i].read_rows(self._rows[i])
            end = min(len(rows), self.max_frames)
            frames[bi, :end] = rows[:end]
            origin[bi] = rows.mean(axis=0)
            vmask[bi, :end] = 1.0
        return {"frames": frames, "origin": origin, "vmask": vmask,
                "idxs": np.array(indices, np.int64), "n_valid": n_valid}


class TxtDataset:
    """Caption items only (reference TxtDataSet4DualEncoding): BoW + token
    arrays per caption, same grammar and caches as PostDataset."""

    def __init__(self, cap_file: str, bow2vec: Optional[Bow2Vec],
                 text_net: str = "transformers",
                 rnn_vocab: Optional[Vocabulary] = None,
                 tokenizer: Optional[WordPieceTokenizer] = None,
                 max_tokens: int = 128, max_words: int = 64):
        self.caps = CaptionSet(cap_file)
        self.text_net = text_net
        self._bow_dim = bow2vec.ndims if bow2vec else 0
        n = len(self.caps)
        width = max_tokens if text_net == "transformers" else max_words
        self._bows = np.zeros((n, self._bow_dim), np.float32)
        self._tokens = np.zeros((n, width), np.int32)
        self._tmask = np.zeros((n, width), np.int32)
        for i, cap_id in enumerate(self.caps.cap_ids):
            cap = self.caps.captions[cap_id]
            if bow2vec is not None:
                vec = bow2vec.mapping(cap)
                if vec is not None:
                    self._bows[i] = vec
            toks = clean_str(cap)
            if text_net == "transformers":
                ids = tokenizer.encode(" ".join(toks), max_length=max_tokens)
            else:
                ids = ([rnn_vocab("<start>")] + [rnn_vocab(t) for t in toks]
                       + [rnn_vocab("<end>")])[:max_words]
            self._tokens[i, : len(ids)] = ids
            self._tmask[i, : len(ids)] = 1

    @property
    def names(self) -> List[str]:
        return self.caps.cap_ids

    def __len__(self):
        return len(self.caps)

    def gather_batch(self, indices: Sequence[int],
                     pad_to: Optional[int] = None) -> Dict[str, np.ndarray]:
        indices = list(indices)
        n_valid = len(indices)
        if pad_to is not None and len(indices) < pad_to:
            indices = indices + [indices[-1]] * (pad_to - len(indices))
        sel = np.array(indices)
        return {"bows": self._bows[sel], "tokens": self._tokens[sel],
                "type_ids": np.zeros_like(self._tokens[sel]),
                "tmask": self._tmask[sel],
                "idxs": np.array(indices, np.int64), "n_valid": n_valid}


@torch.no_grad()
def encode_modality(model, loader, common_dim: int, encode_fn,
                    device: torch.device) -> np.ndarray:
    """Encode a VisDataset/TxtDataset loader with a modality encoder
    (eval.evaluator.encode_vis / encode_txt) on `device`, scattered by
    dataset index. `model` is in evaluation mode on `device`."""
    n = len(loader.dataset)
    out = np.zeros((n, common_dim), np.float32)
    for batch in loader:
        dev = {k: torch.from_numpy(v).to(device) for k, v in batch.items()
               if k not in ("idxs", "n_valid")}
        out[batch["idxs"]] = encode_fn(model, dev).float().cpu().numpy()
    return out

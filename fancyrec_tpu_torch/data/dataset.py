"""Dataset: caption-indexed posts over BigFile feature stores.

Port of fancyrec_tpu/data/dataset.py (numpy only). Replaces the
reference's per-frame seek/read DataLoader path
(data_provider.py:166-272, one `read_one` syscall pair per frame per
sample) with precomputed row indices and one vectorized memory-map gather
per batch per store. Batches come out as fixed-shape numpy dicts ready for
device transfer -- shapes never depend on batch composition, so jit never
recompiles.

Semantics kept from the reference collates (data_provider.py:24-116):
  * batches sorted by caption length descending (char length of the cleaned
    caption for the transformers path, token count for the rnn path);
  * frames capped at max_frames (VIDEO_MAX_LEN=64) but the mean-frame
    vector averages *all* frames of the clip;
  * BoW vector zero when no vocab word matches;
  * rnn token stream is <start> tokens <end> over the rnn vocab.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from fancyrec_tpu_torch.io.bigfile import BigFileReader
from fancyrec_tpu_torch.io.dictfile import get_visual_id, read_dict
from fancyrec_tpu_torch.io.vocab import Bow2Vec, Vocabulary, clean_str
from fancyrec_tpu_torch.data.tokenizer import WordPieceTokenizer


class CaptionSet:
    """Parsed caption file: 'capid caption...' lines (reference grammar)."""

    def __init__(self, cap_file: str):
        self.cap_ids: List[str] = []
        self.captions: Dict[str, str] = {}
        self.visual_ids: List[str] = []
        with open(cap_file, encoding="utf-8") as f:
            for line in f:
                parts = line.strip().split(" ", 1)
                if len(parts) != 2:
                    # the reference also skips malformed/empty-caption
                    # lines silently (try/except-continue,
                    # data_provider.py:185-189) -- e.g. posts whose
                    # caption cleans to nothing (emoji/CJK-only)
                    continue
                cap_id, caption = parts
                self.cap_ids.append(cap_id)
                self.captions[cap_id] = caption
                self.visual_ids.append(get_visual_id(cap_id))

    def __len__(self):
        return len(self.cap_ids)


def load_info(rootpath: str):
    """img_info.txt (python-literal) + cls.txt (JSON) (data_provider.py:16-21)."""
    img_info = read_dict(os.path.join(rootpath, "img_info.txt"))
    with open(os.path.join(rootpath, "cls.txt")) as f:
        cls_info = json.loads(f.read())
    return img_info, cls_info


def _brand_from_img_name(img_name: str, cls_info: dict) -> int:
    parts = img_name.split("/")
    if len(parts) == 2:       # insCar layout (data_provider.py:234-238)
        return int(cls_info["cls2idx"][parts[0]])
    return int(cls_info["cls2idx"][parts[-2]])


class PostDataset:
    """Caption-indexed dataset resolving each post to feature-store rows."""

    def __init__(self, cap_file: str, video_feat: Optional[BigFileReader],
                 img_feat: Optional[BigFileReader],
                 bow2vec: Optional[Bow2Vec],
                 text_net: str = "transformers",
                 rnn_vocab: Optional[Vocabulary] = None,
                 tokenizer: Optional[WordPieceTokenizer] = None,
                 video2frames: Optional[dict] = None,
                 img_info: Optional[dict] = None,
                 cls_info: Optional[dict] = None,
                 max_frames: int = 64, max_tokens: int = 128,
                 max_words: int = 64, n_caption: Optional[int] = None):
        self.caps = CaptionSet(cap_file)
        self.video_feat = video_feat
        self.img_feat = img_feat
        self.bow2vec = bow2vec
        self.text_net = text_net
        self.rnn_vocab = rnn_vocab
        self.tokenizer = tokenizer
        self.max_frames = max_frames
        self.max_tokens = max_tokens
        self.max_words = max_words

        if n_caption is not None:
            n_vis = len(set(self.caps.visual_ids))
            assert n_vis * n_caption == len(self.caps), \
                "%d != %d" % (n_vis * n_caption, len(self.caps))

        # Resolve every item to (store, row-indices, brand) once, up front.
        self.item_rows: List[np.ndarray] = []   # row indices into its store
        self.item_is_video: List[bool] = []
        self.brand_ids = np.zeros(len(self.caps), np.int32)
        for i, vid in enumerate(self.caps.visual_ids):
            if vid.startswith("video"):
                frames = video2frames[vid]
                if not frames:
                    raise ValueError(
                        "video %r has no frames in video2frames (would "
                        "silently yield NaN mean-frame features)" % vid)
                self.brand_ids[i] = int(frames[0].split("_")[-1][3:])
                rows = np.array([video_feat.name2index[f] for f in frames],
                                dtype=np.int64)
                self.item_is_video.append(True)
            else:
                img_name = img_info["idx2img"][int(vid[3:])]
                self.brand_ids[i] = _brand_from_img_name(img_name, cls_info)
                rows = np.array([img_feat.name2index[img_name]], dtype=np.int64)
                self.item_is_video.append(False)
            self.item_rows.append(rows)

        self.ndims = (video_feat or img_feat).ndims

        # Precompute all text features once: captions are immutable, so the
        # per-batch cost collapses to pure array gathers (the per-item
        # Python BoW/tokenize work was the host-side bottleneck -- 1 CPU
        # core vs a TPU that steps in ~60 ms).
        n = len(self.caps)
        self._sort_keys = np.zeros(n, np.int64)
        # BoW stored sparsely (a dense cache would be n x vocab ~ GBs at
        # insCar scale); densified per batch with one np.add.at scatter
        self._bow_dim = self.bow2vec.ndims if self.bow2vec else 0
        self._bow_idx: List[np.ndarray] = []
        self._bow_val: List[np.ndarray] = []
        if self.text_net == "transformers":
            self._tok_cache = np.zeros((n, max_tokens), np.int32)
            self._tmask_cache = np.zeros((n, max_tokens), np.int32)
        else:
            self._tok_cache = np.zeros((n, max_words), np.int32)
            self._tmask_cache = np.zeros((n, max_words), np.int32)
        for i, cap_id in enumerate(self.caps.cap_ids):
            cap = self.caps.captions[cap_id]
            toks = clean_str(cap)
            if self.bow2vec is not None:
                vec = self.bow2vec.mapping(cap)
                if vec is not None:
                    nz = np.nonzero(vec)[0]
                    self._bow_idx.append(nz.astype(np.int32))
                    self._bow_val.append(vec[nz].astype(np.float32))
                else:
                    self._bow_idx.append(np.zeros(0, np.int32))
                    self._bow_val.append(np.zeros(0, np.float32))
            else:
                self._bow_idx.append(np.zeros(0, np.int32))
                self._bow_val.append(np.zeros(0, np.float32))
            if self.text_net == "transformers":
                # collate_frame_transformers_fn sorts by len of the cleaned
                # caption string handed to the tokenizer
                # (data_provider.py:28-29,267-269)
                cleaned = " ".join(toks)
                self._sort_keys[i] = len(cleaned)
                ids = self.tokenizer.encode(cleaned, max_length=max_tokens)
                self._tok_cache[i, : len(ids)] = ids
                self._tmask_cache[i, : len(ids)] = 1
            else:
                v = self.rnn_vocab
                ids = ([v("<start>")] + [v(t) for t in toks]
                       + [v("<end>")])[: max_words]
                self._sort_keys[i] = len(toks) + 2
                self._tok_cache[i, : len(ids)] = ids
                self._tmask_cache[i, : len(ids)] = 1

    def __len__(self):
        return len(self.caps)

    # ------------------------------------------------------------------

    def _caption_sort_key(self, idx: int) -> int:
        return int(self._sort_keys[idx])

    def length_keys(self) -> np.ndarray:
        """Per-item key for length-grouped batching: items with similar
        (frame count, token count) land in the same batch so bucketed
        padding (data/loader.bucket_batch) actually shrinks the shapes --
        insCar is ~90% single-frame image posts that otherwise pad to
        max_frames alongside any video in the batch. Memoized: the inputs
        are immutable after construction, and grouped loaders call this
        every epoch (a python loop over every item at collection scale)."""
        if getattr(self, "_length_keys_cache", None) is None:
            frame_lens = np.array([min(len(r), self.max_frames)
                                   for r in self.item_rows], np.int64)
            token_lens = self._tmask_cache.sum(axis=1).astype(np.int64)
            cap = self._tmask_cache.shape[1] + 1
            self._length_keys_cache = frame_lens * cap + token_lens
        return self._length_keys_cache

    def collate_order(self, indices: Sequence[int],
                      pad_to: Optional[int] = None) -> list:
        """The in-batch index order gather_batch would produce: right-pad by
        repeating the last item, then the reference collate's stable
        caption-length-descending sort. A process-sharded loader computes
        this GLOBAL order (the sort keys are precomputed) and gathers only
        its rank's slice of it."""
        indices = list(indices)
        if pad_to is not None and len(indices) < pad_to:
            indices = indices + [indices[-1]] * (pad_to - len(indices))
        indices.sort(key=self._caption_sort_key, reverse=True)
        return indices

    def length_maxima(self, indices: Sequence[int]) -> Dict[str, int]:
        """Max valid (frame, token) lengths over `indices`, from the
        precomputed caches, with no feature IO: the GLOBAL batch maxima
        that every rank of a world slices its bucket shapes by and hands
        the model as the batch-max lengths."""
        sel = np.asarray(list(indices))
        flen = max(int(min(len(self.item_rows[i]), self.max_frames))
                   for i in sel)
        tlen = int(self._tmask_cache[sel].sum(axis=1).max())
        return {"flen_max": flen, "tlen_max": tlen}

    def gather_batch(self, indices: Sequence[int],
                     pad_to: Optional[int] = None,
                     presort: bool = True) -> Dict[str, np.ndarray]:
        """Assemble one fixed-shape batch. Optionally right-pad the batch to
        `pad_to` rows by repeating the last item (padding rows are excluded
        via 'n_valid'). presort=False keeps the caller's order (a slice of
        collate_order's, on a process-sharded loader)."""
        indices = list(indices)
        n_valid = len(indices)
        if presort:
            indices = self.collate_order(indices, pad_to)
        b = len(indices)

        # ---- visual: one vectorized gather per store ----
        vid_rows = np.concatenate(
            [self.item_rows[i] for i in indices if self.item_is_video[i]]
        ) if any(self.item_is_video[i] for i in indices) else np.zeros(0, np.int64)
        img_rows = np.concatenate(
            [self.item_rows[i] for i in indices if not self.item_is_video[i]]
        ) if any(not self.item_is_video[i] for i in indices) else np.zeros(0, np.int64)
        vid_mat = self.video_feat.read_rows(vid_rows) if len(vid_rows) else None
        img_mat = self.img_feat.read_rows(img_rows) if len(img_rows) else None

        frames = np.zeros((b, self.max_frames, self.ndims), np.float32)
        origin = np.zeros((b, self.ndims), np.float32)
        vmask = np.zeros((b, self.max_frames), np.float32)
        vo, io = 0, 0
        for bi, i in enumerate(indices):
            k = len(self.item_rows[i])
            if self.item_is_video[i]:
                rows = vid_mat[vo: vo + k]
                vo += k
            else:
                rows = img_mat[io: io + k]
                io += k
            end = min(k, self.max_frames)
            frames[bi, :end] = rows[:end]
            origin[bi] = rows.mean(axis=0)  # mean over ALL frames (uncapped)
            vmask[bi, :end] = 1.0

        # ---- text: pure gathers from the init-time caches ----
        sel = np.array(indices)
        bows = np.zeros((b, self._bow_dim), np.float32)
        if self._bow_dim:
            rows = np.concatenate([np.full(len(self._bow_idx[i]), bi, np.int32)
                                   for bi, i in enumerate(indices)])
            cols = np.concatenate([self._bow_idx[i] for i in indices])
            vals = np.concatenate([self._bow_val[i] for i in indices])
            bows[rows, cols] = vals
        tokens = self._tok_cache[sel]
        tmask = self._tmask_cache[sel]
        type_ids = np.zeros_like(tokens)

        return {
            "brand_ids": self.brand_ids[np.array(indices)],
            "frames": frames, "origin": origin, "vmask": vmask,
            "bows": bows, "tokens": tokens, "type_ids": type_ids,
            "tmask": tmask,
            "idxs": np.array(indices, np.int64),
            "n_valid": n_valid,
        }

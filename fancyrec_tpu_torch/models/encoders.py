"""Dual-branch multi-level encoders (visual / text), evaluation mode.

Port of fancyrec_tpu/models/encoders.py without its mesh branches
(sequence sharding, the pipelined BERT stack). Dropout is identity in
evaluation, which is all the serving path runs.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import torch
from torch import nn

from fancyrec_tpu_torch.models.bert import BertConfig, BertEncoder
from fancyrec_tpu_torch.models.gru import BiGRU
from fancyrec_tpu_torch.models.layers import (
    MFC, AttentionPool, ConvBank, batch_max_len, l2norm, masked_mean)


class VisualBatch(NamedTuple):
    frames: torch.Tensor       # (B, T, D) zero-padded frame features
    mean_origin: torch.Tensor  # (B, D) mean over *all* frames of the clip
    mask: torch.Tensor         # (B, T) 0/1 valid-frame mask


class TextBatch(NamedTuple):
    bows: torch.Tensor         # (B, V) bag-of-words counts
    tokens: torch.Tensor       # (B, T) word ids (rnn) or WordPiece ids (bert)
    type_ids: torch.Tensor     # (B, T) segment ids (bert path; zeros for rnn)
    mask: torch.Tensor         # (B, T) 0/1 valid-token mask


def _select_levels(level: str, full: list, parts: dict):
    """The 'reduced' ablations: concatenate the named levels."""
    chosen = parts.get(level)
    return torch.cat(chosen if chosen is not None else full, dim=1)


class VisualEncoder(nn.Module):
    """level 1: mean of raw frames + attention-pooled frames;
    level 2: unpacked bi-GRU, per-sample masked mean;
    level 3: conv bank over the masked GRU outputs, global max-pool."""

    def __init__(self, rnn_size: int, feat_dim: int, kernel_num: int,
                 kernel_sizes: Sequence[int], mapping_in: int,
                 mapping_out: int, concate: str = "full",
                 level: str = "1+2+3", norm: bool = False):
        super().__init__()
        self.concate, self.level, self.norm = concate, level, norm
        self.atten = AttentionPool(feat_dim, feat_dim // 4, heads=3)
        self.rnn = BiGRU(feat_dim, rnn_size, packed=False)
        self.convs = ConvBank(2 * rnn_size, kernel_num, kernel_sizes)
        self.visual_mapping = MFC(mapping_in, mapping_out)

    def forward(self, v: VisualBatch):
        mask = v.mask.float()
        bl = batch_max_len(mask)
        org_out = v.mean_origin
        attn_out = self.atten(v.frames, mask)
        gru_seq = self.rnn(v.frames, batch_len=bl)
        gru_out = masked_mean(gru_seq, mask)
        con_out = self.convs(gru_seq * mask[..., None], bl)
        full = [gru_out, con_out, org_out, attn_out]
        if self.concate == "full":
            features = torch.cat(full, dim=1)
        else:
            features = _select_levels(self.level, full, {
                "1+2": [gru_out, org_out, attn_out],
                "1+3": [con_out, org_out, attn_out],
                "2+3": [gru_out, con_out],
                "1": [org_out, attn_out], "2": [gru_out], "3": [con_out]})
        features = self.visual_mapping(features)
        return l2norm(features) if self.norm else features


class TextGruEncoder(nn.Module):
    """bi-gru text tower. level 1: BoW; level 2: packed bi-GRU masked mean;
    level 3: conv bank."""

    def __init__(self, vocab_size: int, word_dim: int, rnn_size: int,
                 kernel_num: int, kernel_sizes: Sequence[int],
                 mapping_in: int, mapping_out: int, concate: str = "full",
                 norm: bool = False):
        super().__init__()
        self.concate, self.norm = concate, norm
        self.embed = nn.Parameter(torch.empty(vocab_size, word_dim))
        self.rnn = BiGRU(word_dim, rnn_size, packed=True)
        self.convs = ConvBank(2 * rnn_size, kernel_num, kernel_sizes)
        self.text_mapping = MFC(mapping_in, mapping_out)

    def forward(self, t: TextBatch):
        mask = t.mask.float()
        lengths = t.mask.sum(dim=1).to(torch.int64)
        bl = batch_max_len(mask)
        gru_seq = self.rnn(self.embed[t.tokens], lengths=lengths)
        gru_out = masked_mean(gru_seq, mask)
        con_out = self.convs(gru_seq, bl)
        if self.concate == "full":
            features = torch.cat([t.bows, gru_out, con_out], dim=1)
        else:
            features = torch.cat([gru_out, con_out], dim=1)
        features = self.text_mapping(features)
        return l2norm(features) if self.norm else features


class TextTransformersEncoder(nn.Module):
    """Transformer text tower (the recipe). level 1: BoW; level 2: masked
    mean of BERT's last hidden states; level 3: conv bank over the last
    hidden states, zeroed only beyond the batch-max token count (the
    reference convolves pad-token outputs inside the batch max)."""

    def __init__(self, bert: BertConfig, kernel_num: int,
                 kernel_sizes: Sequence[int], mapping_in: int,
                 mapping_out: int, concate: str = "full",
                 level: str = "1+2+3", norm: bool = False):
        super().__init__()
        self.concate, self.level, self.norm = concate, level, norm
        self.bert = BertEncoder(bert)
        self.convs = ConvBank(bert.hidden_size, kernel_num, kernel_sizes)
        self.text_mapping = MFC(mapping_in, mapping_out)

    def forward(self, t: TextBatch):
        mask = t.mask
        bl = batch_max_len(mask)
        last_hidden = self.bert(t.tokens, t.type_ids, mask)
        tf_out = masked_mean(last_hidden, mask.to(last_hidden.dtype))
        pos_valid = torch.arange(mask.shape[1], device=mask.device)[None, :] < bl
        conv_in = torch.where(pos_valid[..., None], last_hidden,
                              torch.zeros_like(last_hidden))
        con_out = self.convs(conv_in, bl)
        full = [t.bows, tf_out, con_out]
        if self.concate == "full":
            features = torch.cat(full, dim=1)
        else:
            features = _select_levels(self.level, full, {
                "1+2": [t.bows, tf_out], "1+3": [t.bows, con_out],
                "2+3": [tf_out, con_out], "1": [t.bows], "2": [tf_out],
                "3": [con_out]})
        features = self.text_mapping(features)
        return l2norm(features) if self.norm else features

"""Dual-branch multi-level encoders (visual / text).

Port of fancyrec_tpu/models/encoders.py. With `attn_fusion` (the
'attn' fusion head) a tower has no mapping MFC and returns its unmapped,
unnormalized level concat, as in the JAX package. Training mode
(`module.train()`) turns on the JAX package's dropouts: after the pooled
GRU output and the conv bank of each tower, in the mapping MFC, and in
BERT.

`dtype` is the JAX towers' compute dtype: the attention pool, the conv
banks, the mapping MFC and BERT's matmuls run in it. The bi-GRUs take the
dtype of their input, which is float32 in both towers (the frames, and
the rows of the float32 word table), as in the JAX package, whose
`BiGRU.dtype` is never read; so under bfloat16 the level concat is
float32 and a mapped tower's output bfloat16.

Tensor parallelism: `mapping_shard` is this model rank's part of the
mapping MFC's input features (row-parallel fc1), `ffn_shard` its part of
BERT's FFN width; None keeps them whole. The GRUs, the attention pool and
the conv banks are replicated.

Sequence parallelism (`seq_shard`, the JAX `constrain_seq_sharding` at
the same two places): the visual bi-GRU's output and BERT's last hidden
states enter the masked mean and the conv bank with their time axis split
over the model group (`layers.seq_shard_pool`), where the model group has
more than one rank and its size divides the padded length; elsewhere, and
in the bi-GRU text tower, as before. The numbers are the same.

Pipeline parallelism (`pp`): BERT's layer stack runs as a GPipe schedule
over the model group (`parallel.pipeline.bert_pipeline_forward`), its
ranks the stages; `FancyRec` sets it where the model axis equals
--pp_stages, as the JAX `_pp_mesh` requires. Without it the same layers
run in sequence.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from fancyrec_tpu_torch.models.bert import BertConfig, BertEncoder
from fancyrec_tpu_torch.models.gru import BiGRU
from fancyrec_tpu_torch.models.layers import (
    MFC, AttentionPool, ConvBank, Dropout, batch_max_len, l2norm,
    masked_mean, seq_shard_pool, seq_shardable)
from fancyrec_tpu_torch.parallel.pipeline import bert_pipeline_forward


class VisualBatch(NamedTuple):
    frames: torch.Tensor       # (B, T, D) zero-padded frame features
    mean_origin: torch.Tensor  # (B, D) mean over *all* frames of the clip
    mask: torch.Tensor         # (B, T) 0/1 valid-frame mask
    # 0-d batch-max valid length; None: from `mask`. A rank of a world
    # holds a slice of the batch and passes the GLOBAL batch's maximum, as
    # the JAX package's reductions over the sharded logical batch see it
    max_len: Optional[torch.Tensor] = None


class TextBatch(NamedTuple):
    bows: torch.Tensor         # (B, V) bag-of-words counts
    tokens: torch.Tensor       # (B, T) word ids (rnn) or WordPiece ids (bert)
    type_ids: torch.Tensor     # (B, T) segment ids (bert path; zeros for rnn)
    mask: torch.Tensor         # (B, T) 0/1 valid-token mask
    max_len: Optional[torch.Tensor] = None   # as VisualBatch.max_len


def _batch_len(mask: torch.Tensor, max_len: Optional[torch.Tensor]):
    return batch_max_len(mask) if max_len is None else max_len


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
                 level: str = "1+2+3", norm: bool = False,
                 dropout: float = 0.2, attn_fusion: bool = False,
                 dtype: torch.dtype = torch.float32, mapping_shard=None,
                 seq_shard: bool = False):
        super().__init__()
        self.concate, self.level, self.norm = concate, level, norm
        self.dtype = dtype
        self.seq_shard = seq_shard
        self.atten = AttentionPool(feat_dim, feat_dim // 4, heads=3,
                                   dtype=dtype)
        self.rnn = BiGRU(feat_dim, rnn_size, packed=False)
        self.convs = ConvBank(2 * rnn_size, kernel_num, kernel_sizes, dtype)
        self.visual_mapping = (None if attn_fusion else MFC(
            mapping_in, mapping_out, dropout, dtype, mapping_shard))
        self.gru_drop = Dropout(dropout)
        self.con_drop = Dropout(dropout)

    def forward(self, v: VisualBatch):
        mask = v.mask.to(self.dtype)
        bl = _batch_len(mask, v.max_len)
        org_out = v.mean_origin
        attn_out = self.atten(v.frames, mask, bl)
        gru_seq = self.rnn(v.frames, batch_len=bl)
        if self.seq_shard and seq_shardable(gru_seq):
            gru_mean, con = seq_shard_pool(gru_seq, mask, self.convs, bl,
                                           mask > 0)
        else:
            gru_mean = masked_mean(gru_seq, mask)
            con = self.convs(gru_seq * mask[..., None], bl)
        gru_out = self.gru_drop(gru_mean)
        con_out = self.con_drop(con)
        full = [gru_out, con_out, org_out, attn_out]
        if self.concate == "full":
            features = torch.cat(full, dim=1)
        else:
            features = _select_levels(self.level, full, {
                "1+2": [gru_out, org_out, attn_out],
                "1+3": [con_out, org_out, attn_out],
                "2+3": [gru_out, con_out],
                "1": [org_out, attn_out], "2": [gru_out], "3": [con_out]})
        if self.visual_mapping is None:
            return features
        features = self.visual_mapping(features)
        return l2norm(features) if self.norm else features


class TextGruEncoder(nn.Module):
    """bi-gru text tower. level 1: BoW; level 2: packed bi-GRU masked mean;
    level 3: conv bank."""

    def __init__(self, vocab_size: int, word_dim: int, rnn_size: int,
                 kernel_num: int, kernel_sizes: Sequence[int],
                 mapping_in: int, mapping_out: int, concate: str = "full",
                 norm: bool = False, dropout: float = 0.2,
                 attn_fusion: bool = False,
                 dtype: torch.dtype = torch.float32, mapping_shard=None):
        super().__init__()
        self.concate, self.norm = concate, norm
        self.dtype = dtype
        self.embed = nn.Parameter(torch.empty(vocab_size, word_dim))
        self.rnn = BiGRU(word_dim, rnn_size, packed=True)
        self.convs = ConvBank(2 * rnn_size, kernel_num, kernel_sizes, dtype)
        self.text_mapping = (None if attn_fusion else MFC(
            mapping_in, mapping_out, dropout, dtype, mapping_shard))
        self.gru_drop = Dropout(dropout)
        self.con_drop = Dropout(dropout)

    def forward(self, t: TextBatch):
        mask = t.mask.to(self.dtype)
        lengths = t.mask.sum(dim=1).to(torch.int64)
        bl = _batch_len(mask, t.max_len)
        gru_seq = self.rnn(self.embed[t.tokens], lengths=lengths)
        gru_out = self.gru_drop(masked_mean(gru_seq, mask))
        con_out = self.con_drop(self.convs(gru_seq, bl))
        if self.concate == "full":
            features = torch.cat([t.bows, gru_out, con_out], dim=1)
        else:
            features = torch.cat([gru_out, con_out], dim=1)
        if self.text_mapping is None:
            return features
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
                 level: str = "1+2+3", norm: bool = False,
                 dropout: float = 0.2, attn_fusion: bool = False,
                 dtype: torch.dtype = torch.float32, mapping_shard=None,
                 ffn_shard=None, seq_shard: bool = False,
                 pp: bool = False):
        super().__init__()
        self.concate, self.level, self.norm = concate, level, norm
        self.seq_shard, self.pp = seq_shard, pp
        self.bert = BertEncoder(bert, ffn_shard)
        self.convs = ConvBank(bert.hidden_size, kernel_num, kernel_sizes,
                              dtype)
        self.text_mapping = (None if attn_fusion else MFC(
            mapping_in, mapping_out, dropout, dtype, mapping_shard))
        self.con_drop = Dropout(dropout)

    def forward(self, t: TextBatch):
        mask = t.mask
        bl = _batch_len(mask, t.max_len)
        if self.pp:
            last_hidden = bert_pipeline_forward(self.bert, t.tokens,
                                                t.type_ids, mask)
        else:
            last_hidden = self.bert(t.tokens, t.type_ids, mask)
        pos_valid = torch.arange(mask.shape[1], device=mask.device)[None, :] < bl
        if self.seq_shard and seq_shardable(last_hidden):
            tf_out, con = seq_shard_pool(last_hidden, mask, self.convs, bl,
                                         pos_valid)
        else:
            tf_out = masked_mean(last_hidden, mask.to(last_hidden.dtype))
            conv_in = torch.where(pos_valid[..., None], last_hidden,
                                  torch.zeros_like(last_hidden))
            con = self.convs(conv_in, bl)
        con_out = self.con_drop(con)
        full = [t.bows, tf_out, con_out]
        if self.concate == "full":
            features = torch.cat(full, dim=1)
        else:
            features = _select_levels(self.level, full, {
                "1+2": [t.bows, tf_out], "1+3": [t.bows, con_out],
                "2+3": [tf_out, con_out], "1": [t.bows], "2": [tf_out],
                "3": [con_out]})
        if self.text_mapping is None:
            return features
        features = self.text_mapping(features)
        return l2norm(features) if self.norm else features

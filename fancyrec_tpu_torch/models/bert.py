"""BERT encoder in plain PyTorch.

Port of fancyrec_tpu/models/bert.py: the reference text tower is a
HuggingFace BertModel truncated to 3 layers. erf-GELU, post-LayerNorm
(eps 1e-12), an additive attention mask of float32-min on padded keys,
scores scaled by 1/sqrt(head_dim), softmax in float32; in training mode,
dropout on the embeddings, the attention probabilities and both residual
branches. The JAX package has no kernel here, so neither does the port. Submodule names follow the JAX
parameter tree (layer_0.attention.query, ..., output_ln).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn

from fancyrec_tpu_torch.models.layers import Dropout


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 3
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    layer_norm_eps: float = 1e-12


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.probs_drop = Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, hidden, attn_bias):
        b, t, d = hidden.shape
        h = self.heads
        dh = d // h
        q = self.query(hidden).view(b, t, h, dh)
        k = self.key(hidden).view(b, t, h, dh)
        v = self.value(hidden).view(b, t, h, dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
        scores = scores / math.sqrt(dh) + attn_bias
        probs = self.probs_drop(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
        return ctx.reshape(b, t, d)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.attention = BertSelfAttention(cfg)
        self.attention_output = nn.Linear(d, d)
        self.attention_ln = nn.LayerNorm(d, eps=eps)
        self.intermediate = nn.Linear(d, cfg.intermediate_size)
        self.output = nn.Linear(cfg.intermediate_size, d)
        self.output_ln = nn.LayerNorm(d, eps=eps)
        self.attention_drop = Dropout(cfg.hidden_dropout_prob)
        self.output_drop = Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden, attn_bias):
        ctx = self.attention(hidden, attn_bias)
        hidden = self.attention_ln(
            hidden + self.attention_drop(self.attention_output(ctx)))
        inter = F.gelu(self.intermediate(hidden), approximate="none")
        return self.output_ln(hidden + self.output_drop(self.output(inter)))


class BertEncoder(nn.Module):
    """input_ids, token_type_ids, attention_mask -> last_hidden (B, T, H)."""

    def __init__(self, cfg: BertConfig = BertConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.word_embeddings = nn.Parameter(torch.empty(cfg.vocab_size, d))
        self.position_embeddings = nn.Parameter(
            torch.empty(cfg.max_position_embeddings, d))
        self.token_type_embeddings = nn.Parameter(
            torch.empty(cfg.type_vocab_size, d))
        self.embeddings_ln = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.embeddings_drop = Dropout(cfg.hidden_dropout_prob)
        for i in range(cfg.num_hidden_layers):
            setattr(self, "layer_%d" % i, BertLayer(cfg))

    def forward(self, input_ids, token_type_ids, attention_mask):
        t = input_ids.shape[1]
        pos = torch.arange(t, device=input_ids.device)
        hidden = (self.word_embeddings[input_ids]
                  + self.position_embeddings[pos][None]
                  + self.token_type_embeddings[token_type_ids])
        hidden = self.embeddings_drop(self.embeddings_ln(hidden))
        mask = attention_mask.float()
        attn_bias = ((1.0 - mask)[:, None, None, :]
                     * torch.finfo(torch.float32).min)
        for i in range(self.cfg.num_hidden_layers):
            hidden = getattr(self, "layer_%d" % i)(hidden, attn_bias)
        return hidden

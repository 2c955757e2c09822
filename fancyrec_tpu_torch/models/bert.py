"""BERT encoder in plain PyTorch.

Port of fancyrec_tpu/models/bert.py: the reference text tower is a
HuggingFace BertModel truncated to 3 layers. erf-GELU, post-LayerNorm
(eps 1e-12), an additive attention mask of float32-min on padded keys,
scores scaled by 1/sqrt(head_dim), softmax in float32; in training mode,
dropout on the embeddings, the attention probabilities and both residual
branches. The JAX package has no kernel here, so neither does the port.
Submodule names follow the JAX parameter tree (layer_0.attention.query,
..., output_ln).

`compute_dtype` "bfloat16" is the JAX package's mixed precision: the
Dense layers and the residual stream entering the first layer in
bfloat16; the attention scores and context accumulated in float32 from
bfloat16 operands; softmax, the mask and the LayerNorms (whose float32
scale promotes their output) in float32. `remat` recomputes each layer in
the backward pass (torch.utils.checkpoint), replaying the dropout
generators' draws (`_remat_layer`).

Tensor parallelism (`ffn_shard`: this model rank's (offset, size) of the
intermediate width): Megatron's FFN, as the JAX package's rules split it.
`intermediate` holds the shard's output rows (column-parallel, its bias
split too) and takes its input through `collectives.model_copy`;
`output` holds the same columns of its weight (row-parallel,
`layers.row_parallel`: partial products summed over the model group, then
its replicated bias). Under `remat` the recompute issues the same
collectives again, in the same order on every rank.

Pipeline parallelism (`--pp_stages`): `parallel.pipeline.
bert_pipeline_forward` runs the same module, its embeddings replicated
and its layer stack as a GPipe schedule over the model group; the layers
are then whole (no `ffn_shard`).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from fancyrec_tpu_torch.models.layers import Dropout, dense, row_parallel
from fancyrec_tpu_torch.parallel import collectives


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
    remat: bool = False            # recompute each layer in the backward
    compute_dtype: str = "float32"   # "float32" or "bfloat16"

    @property
    def dt(self) -> torch.dtype:
        return (torch.bfloat16 if self.compute_dtype == "bfloat16"
                else torch.float32)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_attention_heads
        self.dt = cfg.dt
        self.query = nn.Linear(d, d)
        self.key = nn.Linear(d, d)
        self.value = nn.Linear(d, d)
        self.probs_drop = Dropout(cfg.attention_probs_dropout_prob)

    def forward(self, hidden, attn_bias):
        b, t, d = hidden.shape
        h = self.heads
        dh = d // h
        q = dense(self.query, hidden, self.dt).view(b, t, h, dh)
        k = dense(self.key, hidden, self.dt).view(b, t, h, dh)
        v = dense(self.value, hidden, self.dt).view(b, t, h, dh)
        # float32 accumulation of the compute-dtype operands (the JAX
        # package's preferred_element_type=float32); their products are
        # exact in float32
        scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
        scores = scores / math.sqrt(dh) + attn_bias
        probs = self.probs_drop(torch.softmax(scores, dim=-1))
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs.to(self.dt).float(),
                           v.float())
        return ctx.reshape(b, t, d)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, ffn_shard=None):
        super().__init__()
        d, eps = cfg.hidden_size, cfg.layer_norm_eps
        self.dt = cfg.dt
        self.ffn_shard = ffn_shard
        ffn = cfg.intermediate_size if ffn_shard is None else ffn_shard[1]
        self.attention = BertSelfAttention(cfg)
        self.attention_output = nn.Linear(d, d)
        self.attention_ln = nn.LayerNorm(d, eps=eps)
        self.intermediate = nn.Linear(d, ffn)
        self.output = nn.Linear(ffn, d)
        self.output_ln = nn.LayerNorm(d, eps=eps)
        self.attention_drop = Dropout(cfg.hidden_dropout_prob)
        self.output_drop = Dropout(cfg.hidden_dropout_prob)

    def forward(self, hidden, attn_bias):
        ctx = self.attention(hidden, attn_bias)
        attn_out = self.attention_drop(
            dense(self.attention_output, ctx, self.dt))
        hidden = self.attention_ln((hidden + attn_out).float())
        if self.ffn_shard is None:
            inter = F.gelu(dense(self.intermediate, hidden, self.dt),
                           approximate="none")
            out = dense(self.output, inter, self.dt)
        else:
            inter = F.gelu(dense(self.intermediate, collectives.model_copy(
                hidden), self.dt), approximate="none")
            out = row_parallel(self.output, inter, self.dt)
        return self.output_ln((hidden + self.output_drop(out)).float())


def _remat_layer(layer: BertLayer, hidden, attn_bias):
    """`layer` under torch.utils.checkpoint, its recompute drawing the
    same dropout masks as its forward: the dropouts draw from explicit
    generators, which checkpoint's preserve_rng_state does not cover, so
    the generator each dropout holds at the forward and their states are
    saved before it, bound and set for the recompute (a caller may have
    bound other generators since, as the pipeline's per-microbatch ones
    are unbound after its forward) and put back after it."""
    drops = [m for m in layer.modules() if isinstance(m, Dropout)]
    bound = [m.generator for m in drops]
    gens = []
    for g in bound:
        if g is not None and all(g is not h for h in gens):
            gens.append(g)
    saved = [g.get_state() for g in gens]
    ran = [False]

    def run(h, bias):
        if not ran[0]:
            ran[0] = True
            return layer(h, bias)
        now_bound = [m.generator for m in drops]
        now = [g.get_state() for g in gens]
        for m, g in zip(drops, bound):
            m.generator = g
        for g, s in zip(gens, saved):
            g.set_state(s)
        try:
            return layer(h, bias)
        finally:
            for m, g in zip(drops, now_bound):
                m.generator = g
            for g, s in zip(gens, now):
                g.set_state(s)

    return checkpoint(run, hidden, attn_bias, use_reentrant=False,
                      preserve_rng_state=False)


class BertEncoder(nn.Module):
    """input_ids, token_type_ids, attention_mask -> last_hidden (B, T, H).
    ffn_shard: this model rank's part of every layer's FFN (`BertLayer`)."""

    def __init__(self, cfg: BertConfig = BertConfig(), ffn_shard=None):
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
            setattr(self, "layer_%d" % i, BertLayer(cfg, ffn_shard))

    def embed(self, input_ids, token_type_ids):
        """The embeddings, their LayerNorm and dropout -> float32 (B, T, H),
        before the cast to the residual stream's dtype."""
        t = input_ids.shape[1]
        pos = torch.arange(t, device=input_ids.device)
        hidden = (self.word_embeddings[input_ids]
                  + self.position_embeddings[pos][None]
                  + self.token_type_embeddings[token_type_ids])
        return self.embeddings_drop(self.embeddings_ln(hidden))

    @staticmethod
    def attention_bias(attention_mask):
        """(B, T) 0/1 -> the additive (B, 1, 1, T) float32 key mask."""
        mask = attention_mask.float()
        return (1.0 - mask)[:, None, None, :] * torch.finfo(torch.float32).min

    def remat(self) -> bool:
        """Does a layer call recompute in the backward (`_remat_layer`)?"""
        return self.cfg.remat and self.training and torch.is_grad_enabled()

    def forward(self, input_ids, token_type_ids, attention_mask):
        # the residual stream's dtype
        hidden = self.embed(input_ids, token_type_ids).to(self.cfg.dt)
        attn_bias = self.attention_bias(attention_mask)
        remat = self.remat()
        for i in range(self.cfg.num_hidden_layers):
            layer = getattr(self, "layer_%d" % i)
            hidden = (_remat_layer(layer, hidden, attn_bias) if remat
                      else layer(hidden, attn_bias))
        return hidden

"""DeepSeek-V2's decoder blocks as a caption tower: MLA and DeepSeekMoE.

Written from DeepSeek-V2's published configuration and modeling code
(deepseek-ai/DeepSeek-V2-Lite, `modeling_deepseek.py`), in float32:

- RMSNorm in float32 (eps `rms_norm_eps`), weight after the normalization.
- Multi-head latent attention without a query LoRA: q = q_proj(x) split
  into a nope part (`qk_nope_head_dim`) and a rope part
  (`qk_rope_head_dim`); kv_a_proj_with_mqa(x) split into the latent
  (`kv_lora_rank`, RMSNorm'd, then kv_b_proj to each head's k_nope and v)
  and one k_pe shared by every head. RoPE over the rope dims as the
  published code applies it: the pairs (2i, 2i + 1) taken apart
  (`view(.., d/2, 2).transpose`) and rotated by `rotate_half` at frequency
  i. YaRN frequencies (`rope_scaling`): the extrapolated and the
  interpolated (/ factor) inverse frequencies blended by the linear ramp
  between floor(correction dim of beta_fast) and ceil(correction dim of
  beta_slow); cos and sin scaled by mscale(factor, mscale) /
  mscale(factor, mscale_all_dim). Scores scaled by q_head_dim^-0.5
  mscale(factor, mscale_all_dim)^2, causal, padded keys masked with
  float32-min, softmax in float32.
- The first `first_k_dense_replace` layers' MLP: down(silu(gate x) up x).
- The MoE layers: float32 softmax scores over the routed experts, greedy
  top-k; the weights are the top-k scores (`norm_topk_prob` false), times
  `routed_scaling_factor`; out = sum of weights times expert(x), plus the
  shared experts (one SwiGLU of n_shared x the expert width).
- The sequence-level balance loss (`seq_aux`), in training: per caption,
  ce_e = (picks of e) / (valid tokens x k / E), aux = alpha x the mean
  over captions of sum_e ce_e x (mean score of e over the valid tokens),
  summed over the MoE layers (`DeepseekV2Tower.aux_loss`).
- The final RMSNorm's states are the tower's output.

Departure, for padded captions: pad tokens are not routed (their slots
sort past the last expert and K5 skips them), add nothing to the balance
loss, and the text encoder zeroes their states (`models/encoders.py`).

The routed experts run on K5 (`ops/moe.py`), with no host sync: the
whole training update stays one CUDA graph. Each MoE layer keeps a
routing counter, a device buffer of its rows per expert and its pad slots
(E + 1), added to in place by every training forward; `routing_counts`
reads them.

No query LoRA, no group-limited routing, no other scoring function:
`DeepseekV2Config.from_dict` refuses them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fancyrec_tpu_torch.ops.moe import combine, dispatch, moe_experts, route
from fancyrec_tpu_torch.utils.profiling import span

FMIN = torch.finfo(torch.float32).min

# DeepSeek-V2-Lite's published config.json, the keys of the layers' shapes
# and mathematics (https://huggingface.co/deepseek-ai/DeepSeek-V2-Lite)
_YARN = {"type": "yarn", "factor": 40, "original_max_position_embeddings":
         4096, "beta_fast": 32, "beta_slow": 1, "mscale": 0.707,
         "mscale_all_dim": 0.707}


@dataclasses.dataclass
class DeepseekV2Config:
    vocab_size: int = 102400
    hidden_size: int = 2048
    intermediate_size: int = 10944
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_routed_experts: int = 64
    n_shared_experts: int = 2
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    rope_scaling: Optional[dict] = dataclasses.field(
        default_factory=lambda: dict(_YARN))
    routed_scaling_factor: float = 1.0
    norm_topk_prob: bool = False
    scoring_func: str = "softmax"
    topk_method: str = "greedy"
    n_group: int = 1
    topk_group: int = 1
    seq_aux: bool = True
    aux_loss_alpha: float = 0.001
    hidden_act: str = "silu"
    attention_bias: bool = False

    @property
    def q_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    def is_moe(self, i: int) -> bool:
        return (self.n_routed_experts > 0 and i >= self.first_k_dense_replace
                and i % self.moe_layer_freq == 0)

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "DeepseekV2Config":
        """A published config.json's keys (others, such as model_type or
        max_position_embeddings, are ignored) over DeepSeek-V2-Lite's.
        Raises NotImplementedError for what the tower does not compute."""
        known = {f.name for f in dataclasses.fields(cls)}
        cfg = cls(**{k: v for k, v in (d or {}).items() if k in known})
        unsupported = {
            "q_lora_rank": (cfg.q_lora_rank is None, "a query LoRA"),
            "scoring_func": (cfg.scoring_func == "softmax",
                             "a scoring function other than softmax"),
            "topk_method": (cfg.topk_method == "greedy",
                            "routing other than greedy top-k"),
            "n_group": (cfg.n_group == 1 and cfg.topk_group == 1,
                        "group-limited routing"),
            "hidden_act": (cfg.hidden_act == "silu", "an activation but "
                           "SiLU"),
            "attention_bias": (not cfg.attention_bias, "attention biases"),
            "rope_scaling": (cfg.rope_scaling is None
                             or cfg.rope_scaling.get("type") == "yarn",
                             "RoPE scaling other than YaRN"),
        }
        for key, (ok, what) in unsupported.items():
            if not ok:
                raise NotImplementedError(
                    "the deepseek_v2 text tower does not compute %s (%s=%r)"
                    % (what, key, getattr(cfg, key)))
        return cfg


def yarn_mscale(scale: float, mscale: float) -> float:
    return 1.0 if scale <= 1 else 0.1 * mscale * math.log(scale) + 1.0


def yarn_correction_dim(rotations: float, dim: int, base: float,
                        max_pos: int) -> float:
    return (dim * math.log(max_pos / (rotations * 2 * math.pi))
            / (2 * math.log(base)))


def yarn_ramp_bounds(cfg: DeepseekV2Config):
    """(low, high): the frequency pairs between which the YaRN ramp runs."""
    rs, dim = cfg.rope_scaling, cfg.qk_rope_head_dim
    m = rs["original_max_position_embeddings"]
    low = math.floor(yarn_correction_dim(rs["beta_fast"], dim,
                                         cfg.rope_theta, m))
    high = math.ceil(yarn_correction_dim(rs["beta_slow"], dim,
                                         cfg.rope_theta, m))
    return max(low, 0), min(high, dim - 1)


def softmax_scale(cfg: DeepseekV2Config) -> float:
    scale = cfg.q_head_dim ** -0.5
    rs = cfg.rope_scaling
    if rs is not None:
        m = yarn_mscale(rs["factor"], rs["mscale_all_dim"])
        scale = scale * m * m
    return scale


def rope_cos_sin(cfg: DeepseekV2Config, t: int, device):
    """(T, rope dim) cos and sin of positions 0..T-1 (float32), each the
    frequencies twice over, as `rotate_half` pairs them."""
    dim, base = cfg.qk_rope_head_dim, cfg.rope_theta
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    inv_freq = 1.0 / (base ** exps)
    scale = 1.0
    rs = cfg.rope_scaling
    if rs is not None:
        factor = rs["factor"]
        inter = 1.0 / (factor * base ** exps)
        low, high = yarn_ramp_bounds(cfg)
        if low == high:
            high += 0.001
        ramp = ((torch.arange(dim // 2, dtype=torch.float32, device=device)
                 - low) / (high - low)).clamp(0, 1)
        keep = 1.0 - ramp
        inv_freq = inter * (1 - keep) + inv_freq * keep
        scale = (yarn_mscale(factor, rs["mscale"])
                 / yarn_mscale(factor, rs["mscale_all_dim"]))
    freqs = torch.outer(torch.arange(t, dtype=torch.float32, device=device),
                        inv_freq)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos() * scale, emb.sin() * scale


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x (B, T, h, d): the published layout change, then rotate_half."""
    b, t, h, d = x.shape
    x = x.view(b, t, h, d // 2, 2).transpose(4, 3).reshape(b, t, h, d)
    half = torch.cat([-x[..., d // 2:], x[..., :d // 2]], dim=-1)
    return x * cos[None, :, None, :] + half * sin[None, :, None, :]


class RMSNorm(nn.Module):
    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.eps = eps

    def forward(self, x):
        x32 = x.float()
        var = x32.pow(2).mean(-1, keepdim=True)
        return self.weight * (x32 * torch.rsqrt(var + self.eps)).to(x.dtype)


def _linear(n_in: int, n_out: int) -> nn.Linear:
    return nn.Linear(n_in, n_out, bias=False)


class MLAttention(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        h, d = cfg.num_attention_heads, cfg.hidden_size
        self.q_proj = _linear(d, h * cfg.q_head_dim)
        self.kv_a_proj_with_mqa = _linear(d, cfg.kv_lora_rank
                                          + cfg.qk_rope_head_dim)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = _linear(cfg.kv_lora_rank, h * (cfg.qk_nope_head_dim
                                                       + cfg.v_head_dim))
        self.o_proj = _linear(h * cfg.v_head_dim, d)
        self.scale = softmax_scale(cfg)

    def forward(self, x, bias, cos, sin):
        cfg = self.cfg
        b, t, _ = x.shape
        h, nope, rope = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                         cfg.qk_rope_head_dim)
        q = self.q_proj(x).view(b, t, h, nope + rope)
        q_nope, q_pe = q.split([nope, rope], dim=-1)
        c, k_pe = self.kv_a_proj_with_mqa(x).split([cfg.kv_lora_rank, rope],
                                                   dim=-1)
        kv = self.kv_b_proj(self.kv_a_layernorm(c)).view(
            b, t, h, nope + cfg.v_head_dim)
        k_nope, v = kv.split([nope, cfg.v_head_dim], dim=-1)
        q_pe = apply_rope(q_pe, cos, sin)
        k_pe = apply_rope(k_pe.view(b, t, 1, rope), cos, sin)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(b, t, h, rope)], dim=-1)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale + bias
        probs = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v)
        return self.o_proj(ctx.reshape(b, t, h * cfg.v_head_dim))


class SwiGLU(nn.Module):
    def __init__(self, d: int, width: int):
        super().__init__()
        self.gate_proj = _linear(d, width)
        self.up_proj = _linear(d, width)
        self.down_proj = _linear(width, d)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class RoutedExperts(nn.Module):
    """The routed experts' weights, stacked: w13 (E, 2F, D) each expert's
    gate_proj rows then its up_proj rows, w2 (E, D, F) its down_proj."""

    def __init__(self, n: int, d: int, width: int):
        super().__init__()
        self.w13 = nn.Parameter(torch.empty(n, 2 * width, d))
        self.w2 = nn.Parameter(torch.empty(n, d, width))


class MoE(nn.Module):
    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        d, e = cfg.hidden_size, cfg.n_routed_experts
        self.gate = nn.Linear(d, e, bias=False)
        self.experts = RoutedExperts(e, d, cfg.moe_intermediate_size)
        self.shared_experts = (SwiGLU(d, cfg.moe_intermediate_size
                                      * cfg.n_shared_experts)
                               if cfg.n_shared_experts else None)
        # rows per expert and pad slots, summed over training forwards
        self.register_buffer("routed", torch.zeros(e + 1, dtype=torch.int64),
                             persistent=False)

    def forward(self, x, valid):
        """x (B, T, D), valid (B, T) bool -> (out, aux or None)."""
        cfg = self.cfg
        b, t, d = x.shape
        e, k = cfg.n_routed_experts, cfg.num_experts_per_tok
        flat = x.reshape(b * t, d)
        with span("text.moe.route"):
            scores = torch.softmax(F.linear(flat, self.gate.weight).float(),
                                   dim=-1)
            weight, idx = torch.topk(scores, k, dim=-1)
            weight = weight * cfg.routed_scaling_factor
            r = route(idx, valid.reshape(-1), e)
            if self.training:
                self.routed.add_(r.counts)
        with span("text.moe.experts"):
            ys = moe_experts(dispatch(flat, r), r.offsets, self.experts.w13,
                             self.experts.w2)
            out = combine(ys, weight, r)
        if self.shared_experts is not None:
            out = out + self.shared_experts(flat)
        aux = None
        if self.training and cfg.seq_aux and cfg.aux_loss_alpha > 0:
            vm = valid.to(scores.dtype)                              # (B, T)
            n_valid = vm.sum(dim=1).clamp(min=1.0)                   # (B,)
            picks = (F.one_hot(idx.view(b, t, k), e).sum(dim=2)
                     .to(scores.dtype) * vm[..., None]).sum(dim=1)   # (B, E)
            ce = picks / (n_valid[:, None] * k / e)
            mean_score = ((scores.view(b, t, e) * vm[..., None]).sum(dim=1)
                          / n_valid[:, None])
            aux = (ce * mean_score).sum(dim=1).mean() * cfg.aux_loss_alpha
        return out.view(b, t, d), aux


class DecoderLayer(nn.Module):
    def __init__(self, cfg: DeepseekV2Config, i: int):
        super().__init__()
        d = cfg.hidden_size
        self.self_attn = MLAttention(cfg)
        self.mlp = MoE(cfg) if cfg.is_moe(i) else SwiGLU(
            d, cfg.intermediate_size)
        self.input_layernorm = RMSNorm(d, cfg.rms_norm_eps)
        self.post_attention_layernorm = RMSNorm(d, cfg.rms_norm_eps)

    def forward(self, h, bias, cos, sin, valid):
        h = h + self.self_attn(self.input_layernorm(h), bias, cos, sin)
        x = self.post_attention_layernorm(h)
        if isinstance(self.mlp, MoE):
            out, aux = self.mlp(x, valid)
        else:
            out, aux = self.mlp(x), None
        return h + out, aux


class DeepseekV2Tower(nn.Module):
    """tokens (B, T), mask (B, T) 0/1, captions padded on the right ->
    the final RMSNorm's states (B, T, D). In training mode the summed
    balance loss of the MoE layers is left in `aux_loss` (None else)."""

    def __init__(self, cfg: DeepseekV2Config):
        super().__init__()
        self.cfg = cfg
        self.embed_tokens = nn.Parameter(torch.empty(cfg.vocab_size,
                                                     cfg.hidden_size))
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.aux_loss: Optional[torch.Tensor] = None
        self._rope: Dict[tuple, tuple] = {}

    def rope(self, t: int, device):
        key = (t, str(device))
        if key not in self._rope:
            self._rope[key] = rope_cos_sin(self.cfg, t, device)
        return self._rope[key]

    def forward(self, tokens: torch.Tensor, mask: torch.Tensor):
        b, t = tokens.shape
        valid = mask > 0
        cos, sin = self.rope(t, tokens.device)
        pos = torch.arange(t, device=tokens.device)
        allowed = (pos[None, :] <= pos[:, None])[None] & valid[:, None, :]
        bias = torch.where(allowed, 0.0, FMIN)[:, None]          # (B,1,T,T)
        h = self.embed_tokens[tokens]
        aux = None
        for layer in self.layers:
            h, a = layer(h, bias, cos, sin, valid)
            if a is not None:
                aux = a if aux is None else aux + a
        self.aux_loss = aux
        return self.norm(h)

    def moe_layers(self):
        return [m for m in self.modules() if isinstance(m, MoE)]

    def routing_counts(self) -> torch.Tensor:
        """(MoE layers, E + 1): each layer's rows per expert and its pad
        slots, summed over the training forwards since the last
        `reset_routing`. Stays on the device."""
        return torch.stack([m.routed for m in self.moe_layers()])

    def reset_routing(self) -> None:
        for m in self.moe_layers():
            m.routed.zero_()

"""A plain FancyRec training step with DeepSeek-V2's blocks as the caption
tower: forward, the queue-contrastive loss plus the MoE layers'
sequence-level balance loss, gradients summed over the microbatches, the
global-norm clip and Adam.

Written from DeepSeek-V2's published description (deepseek-ai/
DeepSeek-V2-Lite's config.json and modeling code) in float32 PyTorch
operations, with TF32 off, no kernel, no cache, no permutation of the
routed rows: each expert takes its tokens by ordinary indexing, in a
loop over the experts. The visual and brand towers, the fusion head, the
contrastive loss, the random draws and Adam are `fancyrec_ref`'s.

The tower, as published: embedding; per layer a pre-RMSNorm (float32)
multi-head latent attention (no query LoRA; the 512-d latent RMSNorm'd
and expanded to each head's k_nope and v; a 64-d k_pe shared by the
heads; RoPE over the rope dims, each pair (2i, 2i + 1) rotated by
frequency i, YaRN-scaled; scores times q_head_dim^-0.5 mscale^2, causal,
padded keys masked) and a pre-RMSNorm MLP: SwiGLU in the first
`first_k_dense_replace` layers, then the routed experts (softmax scores,
greedy top-k, weights the unrenormalized scores) plus the shared experts;
a final RMSNorm. Padded captions: pad tokens are not routed, add nothing
to the balance loss, and their states are zeroed before the conv bank and
the masked mean (the program's stated departure). Parameters are a
dictionary of tensors in the program's state-dict names (a layer's
experts stacked: `w13` (E, 2F, D) each expert's gate rows then up rows,
`w2` (E, D, F)).
"""

from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from reference.fancyrec_ref import (
    FMIN, Adam, Draws, brand_tower, contrastive, conv_bank, fusion, l2norm,
    mapping, masked_mean, visual_tower)

PRE = "text_encoding.deepseek."


def rms_norm(x, w, eps):
    x32 = x.float()
    return w * (x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps))


def yarn_rope(tc: dict, t: int, device):
    """(T, rope dim / 2) cos and sin: frequency i of pair (2i, 2i + 1)."""
    dim, base = tc["qk_rope_head_dim"], float(tc["rope_theta"])
    rs = tc["rope_scaling"]
    i = torch.arange(dim // 2, dtype=torch.float32, device=device)
    extra = 1.0 / base ** (2 * i / dim)
    inter = extra / rs["factor"]

    def corr(rot):
        return (dim * math.log(rs["original_max_position_embeddings"]
                               / (rot * 2 * math.pi))
                / (2 * math.log(base)))

    low = max(math.floor(corr(rs["beta_fast"])), 0)
    high = min(math.ceil(corr(rs["beta_slow"])), dim - 1)
    ramp = ((i - low) / (high - low)).clamp(0, 1)
    inv = inter * ramp + extra * (1 - ramp)

    def mscale(m):
        return 0.1 * m * math.log(rs["factor"]) + 1.0

    scale = mscale(rs["mscale"]) / mscale(rs["mscale_all_dim"])
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv
    return ang.cos() * scale, ang.sin() * scale


def rotate_pairs(x, cos, sin):
    """x (B, T, h, d): each pair (2i, 2i + 1) rotated by angle i."""
    a, b = x[..., 0::2], x[..., 1::2]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return torch.stack([a * c - b * s, b * c + a * s], dim=-1).flatten(-2)


def attention(P, pre, tc, x, valid, cos, sin):
    b, t, _ = x.shape
    h = tc["num_attention_heads"]
    nope, rope, vd = (tc["qk_nope_head_dim"], tc["qk_rope_head_dim"],
                      tc["v_head_dim"])
    rank, eps = tc["kv_lora_rank"], tc["rms_norm_eps"]
    q = (x @ P[pre + "q_proj.weight"].t()).view(b, t, h, nope + rope)
    ckv = x @ P[pre + "kv_a_proj_with_mqa.weight"].t()
    latent = rms_norm(ckv[..., :rank], P[pre + "kv_a_layernorm.weight"], eps)
    kv = (latent @ P[pre + "kv_b_proj.weight"].t()).view(b, t, h, nope + vd)
    q_pe = rotate_pairs(q[..., nope:], cos, sin)
    k_pe = rotate_pairs(ckv[..., rank:].reshape(b, t, 1, rope), cos, sin)
    scale = (nope + rope) ** -0.5
    rs = tc["rope_scaling"]
    m = 0.1 * rs["mscale_all_dim"] * math.log(rs["factor"]) + 1.0
    scale *= m * m
    scores = (torch.einsum("bqhd,bkhd->bhqk", q[..., :nope], kv[..., :nope])
              + torch.einsum("bqhd,bkhd->bhqk", q_pe,
                             k_pe.expand(b, t, h, rope))) * scale
    pos = torch.arange(t, device=x.device)
    allowed = (pos[None, :] <= pos[:, None])[None] & valid[:, None, :]
    scores = scores + torch.where(allowed, 0.0, FMIN)[:, None]
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("bhqk,bkhd->bqhd", probs, kv[..., nope:])
    return ctx.reshape(b, t, h * vd) @ P[pre + "o_proj.weight"].t()


def swiglu(x, w_gate, w_up, w_down):
    return (F.silu(x @ w_gate.t()) * (x @ w_up.t())) @ w_down.t()


def moe(P, pre, tc, x, valid):
    """-> (out (B, T, D), balance loss): each expert over the tokens that
    picked it, by indexing, in a loop."""
    b, t, d = x.shape
    e, k = tc["n_routed_experts"], tc["num_experts_per_tok"]
    f = tc["moe_intermediate_size"]
    flat = x.reshape(b * t, d)
    scores = torch.softmax(flat @ P[pre + "gate.weight"].t(), dim=-1)
    weight, idx = torch.topk(scores, k, dim=-1)
    weight = weight * tc["routed_scaling_factor"]
    vflat = valid.reshape(-1)
    w13, w2 = P[pre + "experts.w13"], P[pre + "experts.w2"]
    out = torch.zeros_like(flat)
    for j in range(e):
        tok, slot = torch.nonzero((idx == j) & vflat[:, None], as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(flat[tok], w13[j, :f], w13[j, f:], w2[j])
        out = out.index_add(0, tok, y * weight[tok, slot][:, None])
    if tc.get("n_shared_experts"):
        out = out + swiglu(flat, P[pre + "shared_experts.gate_proj.weight"],
                           P[pre + "shared_experts.up_proj.weight"],
                           P[pre + "shared_experts.down_proj.weight"])
    aux = []
    for r in range(b):
        v = valid[r]
        n = int(v.sum())
        picks = torch.bincount(idx.view(b, t, k)[r][v].reshape(-1),
                               minlength=e).float()
        ce = picks / (n * k / e)
        aux.append((ce * scores.view(b, t, e)[r][v].mean(dim=0)).sum())
    return out.view(b, t, d), torch.stack(aux).mean() * tc["aux_loss_alpha"]


def tower(P, tc, tokens, valid):
    """-> (final RMSNorm's states (B, T, D), summed balance loss)."""
    eps = tc["rms_norm_eps"]
    cos, sin = yarn_rope(tc, tokens.shape[1], tokens.device)
    h = P[PRE + "embed_tokens"][tokens]
    aux = 0.0
    for i in range(tc["num_hidden_layers"]):
        lay = "%slayers.%d." % (PRE, i)
        h = h + attention(P, lay + "self_attn.", tc, rms_norm(
            h, P[lay + "input_layernorm.weight"], eps), valid, cos, sin)
        x = rms_norm(h, P[lay + "post_attention_layernorm.weight"], eps)
        if i < tc["first_k_dense_replace"]:
            h = h + swiglu(x, P[lay + "mlp.gate_proj.weight"],
                           P[lay + "mlp.up_proj.weight"],
                           P[lay + "mlp.down_proj.weight"])
        else:
            out, a = moe(P, lay + "mlp.", tc, x, valid)
            h, aux = h + out, aux + a
    return rms_norm(h, P[PRE + "norm.weight"], eps), aux


def text_tower(P, cfg, batch, draws):
    pre = "text_encoding."
    mask = batch["tmask"].float()
    bl = int(mask.sum(dim=1).max())
    hidden, aux = tower(P, cfg["tower"], batch["tokens"].long(), mask > 0)
    hidden = hidden * mask[..., None]
    mid = masked_mean(hidden, mask)
    con = conv_bank(P, pre + "convs", hidden, cfg["text_kernels"], bl)
    con_out = draws.dropout(con, cfg["dropout"])
    feats = torch.cat([batch["bows"], mid, con_out], dim=1)
    return l2norm(mapping(P, pre + "text_mapping", feats, draws,
                          cfg["dropout"])), aux


def forward(P, cfg, batch, draws):
    brand = brand_tower(P, cfg, batch["brand_ids"].long(), draws)
    vis = visual_tower(P, cfg, batch, draws)
    txt, aux = text_tower(P, cfg, batch, draws)
    return brand, fusion(P, vis, txt), aux


def train(weights: Dict[str, torch.Tensor], cfg: dict, updates, seed: int,
          device) -> dict:
    """`fancyrec_ref.train`'s outputs for this tower: each update's mean
    microbatch loss (the contrastive loss plus the balance loss), the
    first update's clipped gradient norm of each leaf and each leaf's
    distance from `weights` after the last update. `weights` may lie on
    the host: each leaf is copied to `device` as it is needed, and the
    clip scales the gradients in place, so that the device holds one copy
    of the parameters, their gradients and Adam's two moments."""
    P = {k: v.detach().to(device).clone().requires_grad_(True)
         for k, v in weights.items() if k not in cfg["buffers"]}
    draws = Draws(seed, device)
    opt = Adam(P, cfg["learning_rate"])
    queue = torch.zeros(cfg["queue_size"], cfg["common_embedding_size"],
                        device=device)
    ptr = 0
    out = {"losses": []}
    for u, micro in enumerate(updates):
        for p in P.values():
            p.grad = None
        losses = []
        for mb in micro:
            brand, post, aux = forward(P, cfg, mb, draws)
            loss, queue, ptr = contrastive(brand, post, queue, ptr)
            loss = loss + aux
            loss.backward()
            losses.append(float(loss.detach()))
        out["losses"].append(sum(losses) / len(losses))
        for p in P.values():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = {k: p.grad for k, p in P.items()}
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if float(norm) >= cfg["grad_clip"]:
                for g in grads.values():
                    g.div_(norm).mul_(cfg["grad_clip"])
        if u == 0:
            out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(P, grads)
    with torch.no_grad():
        out["change_norms"] = {k: float((p - weights[k].to(device)).norm())
                               for k, p in P.items()}
    return out

"""A plain FancyRec training step: forward, the queue-contrastive loss,
gradients summed over the microbatches, the global-norm clip and Adam.

Written from the model's description (the recipe of bin/instance.sh in
pinskyrobin/FancyRec: BERT-base widths at 3 layers or a bi-GRU text
tower, a bi-GRU visual tower over frame features, conv banks, mapping
layers, a projection-head fusion and a brand-aspect tower) in float32
PyTorch operations, with no kernel, cache or fused path. Parameters are a
dictionary of tensors named as the benchmark's weights name them.

Random draws. Every tower dropout draws its mask with `bernoulli_` from
one generator on the device, in the order the layers run; the brand
dropout takes two 32-bit seed words a call from a host generator and
keeps the elements that Philox4x32-10 keeps (`philox.keep_mask`). Both
generators are seeded from the run's seed, so the reference draws what a
program seeded alike draws, without reading any of the program's state.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from reference.philox import keep_mask

FMIN = torch.finfo(torch.float32).min


class Draws:
    """The training forward's random draws, seeded from `seed`."""

    def __init__(self, seed: int, device):
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.host = torch.Generator().manual_seed(seed + 1)

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if p == 0.0:
            return x
        keep = 1.0 - p
        mask = torch.empty_like(x).bernoulli_(keep, generator=self.gen)
        return x * mask / keep

    def seed_words(self) -> List[int]:
        return torch.randint(0, 2 ** 32, (2,), generator=self.host,
                             dtype=torch.int64).tolist()


def l2norm(x):
    return x / torch.sqrt((x * x).sum(dim=-1, keepdim=True))


def masked_mean(x, mask):
    s = torch.einsum("btd,bt->bd", x, mask)
    return s / torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)


def linear(P, name, x, bias=True):
    y = x @ P[name + ".weight"].t()
    return y + P[name + ".bias"] if bias else y


def layer_norm(P, name, x, eps):
    return F.layer_norm(x, x.shape[-1:], P[name + ".weight"],
                        P[name + ".bias"], eps)


def gru_direction(xw, w_hh, b_hh, steps):
    """torch.nn.GRU's cell (gates r, z, n) over the first `steps` steps of
    the input contributions xw (T, B, 3H), from h = 0 -> (steps, B, H)."""
    hidden = w_hh.shape[1]
    h = xw.new_zeros(xw.shape[1], hidden)
    out = []
    for t in range(steps):
        hw = h @ w_hh.t() + b_hh
        x = xw[t]
        r = torch.sigmoid(x[:, :hidden] + hw[:, :hidden])
        z = torch.sigmoid(x[:, hidden:2 * hidden] + hw[:, hidden:2 * hidden])
        n = torch.tanh(x[:, 2 * hidden:] + r * hw[:, 2 * hidden:])
        h = (1.0 - z) * n + z * h
        out.append(h)
    return torch.stack(out)


def reverse_within(x, lengths):
    """Each row of x (B, T, D) reversed within its length; later rows
    stay where they are."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    lengths = lengths[:, None]
    idx = torch.where(pos < lengths, lengths - 1 - pos, pos)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def bigru(P, name, x, lengths, steps):
    """A bidirectional GRU over x (B, T, D) -> (B, T, 2H). The backward
    direction starts at each row's `lengths` entry; rows past `steps` are
    zero (no output there is read)."""
    b, t, _ = x.shape
    outs = []
    for d in ("fwd", "bwd"):
        src = x if d == "fwd" else reverse_within(x, lengths)
        xw = (src @ P["%s.w_ih_%s" % (name, d)].t()
              + P["%s.b_ih_%s" % (name, d)]).transpose(0, 1)
        h = gru_direction(xw, P["%s.w_hh_%s" % (name, d)],
                          P["%s.b_hh_%s" % (name, d)], steps).transpose(0, 1)
        h = F.pad(h, (0, 0, 0, t - steps))
        outs.append(h if d == "fwd" else reverse_within(h, lengths))
    return torch.cat(outs, dim=-1)


def conv_bank(P, name, x, sizes, batch_len):
    """Convolutions over time (zero padding ws - 1 a side), ReLU and the
    max over the batch_len + ws - 1 positions that see the batch."""
    xt = x.transpose(1, 2)
    outs = []
    for ws in sizes:
        y = F.relu(F.conv1d(xt, P["%s.conv_w%d.weight" % (name, ws)],
                            P["%s.conv_w%d.bias" % (name, ws)],
                            padding=ws - 1))
        valid = torch.arange(y.shape[2], device=x.device) < batch_len + ws - 1
        y = torch.where(valid[None, None, :], y, torch.full_like(y, FMIN))
        outs.append(y.amax(dim=2))
    return torch.cat(outs, dim=1)


def mapping(P, name, x, draws, p):
    return draws.dropout(F.relu(linear(P, name + ".fc1", x)), p)


def visual_tower(P, cfg, batch, draws):
    frames, mask = batch["frames"], batch["vmask"]
    bl = int(mask.sum(dim=1).max())
    pre = "vid_encoding."
    a = torch.tanh(linear(P, pre + "atten.w_1", frames, bias=False))
    score = linear(P, pre + "atten.w_2", a, bias=False).mean(dim=-1)
    valid = mask > 0
    score = torch.where(valid, score, torch.full_like(score, FMIN))
    weight = torch.where(valid, torch.softmax(score, dim=1),
                         torch.zeros_like(score))
    attn = (weight[..., None] * frames).sum(dim=1) / max(bl, 1)
    lengths = torch.full((frames.shape[0],), bl, device=frames.device)
    seq = bigru(P, pre + "rnn", frames, lengths, bl)
    gru_out = draws.dropout(masked_mean(seq, mask), cfg["dropout"])
    con = conv_bank(P, pre + "convs", seq * mask[..., None],
                    cfg["visual_kernels"], bl)
    con_out = draws.dropout(con, cfg["dropout"])
    feats = torch.cat([gru_out, con_out, batch["origin"], attn], dim=1)
    return l2norm(mapping(P, pre + "visual_mapping", feats, draws,
                          cfg["dropout"]))


def bert(P, cfg, tokens, type_ids, mask, draws):
    b = "text_encoding.bert."
    t = tokens.shape[1]
    eps, p = 1e-12, cfg["bert_dropout"]
    heads = cfg["bert_num_heads"]
    h = (P[b + "word_embeddings"][tokens] + P[b + "position_embeddings"][:t]
         + P[b + "token_type_embeddings"][type_ids])
    h = draws.dropout(layer_norm(P, b + "embeddings_ln", h, eps), p)
    bias = (1.0 - mask)[:, None, None, :] * FMIN
    n, _, d = h.shape
    dh = d // heads
    for i in range(cfg["bert_num_layers"]):
        lay = "%slayer_%d." % (b, i)
        q, k, v = (linear(P, lay + "attention." + part, h).view(n, t, heads,
                                                                  dh)
                   for part in ("query", "key", "value"))
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(dh) + bias
        probs = draws.dropout(torch.softmax(scores, dim=-1), p)
        ctx = torch.einsum("bhqk,bkhd->bqhd", probs, v).reshape(n, t, d)
        attn = draws.dropout(linear(P, lay + "attention_output", ctx), p)
        h = layer_norm(P, lay + "attention_ln", h + attn, eps)
        inter = F.gelu(linear(P, lay + "intermediate", h))
        out = draws.dropout(linear(P, lay + "output", inter), p)
        h = layer_norm(P, lay + "output_ln", h + out, eps)
    return h


def text_tower(P, cfg, batch, draws):
    pre = "text_encoding."
    mask = batch["tmask"].float()
    bl = int(mask.sum(dim=1).max())
    tokens = batch["tokens"].long()
    if cfg["text_net"] == "transformers":
        hidden = bert(P, cfg, tokens, batch["type_ids"].long(), mask, draws)
        mid = masked_mean(hidden, mask)
        keep = torch.arange(hidden.shape[1], device=mask.device) < bl
        con = conv_bank(P, pre + "convs",
                        hidden * keep[None, :, None].float(),
                        cfg["text_kernels"], bl)
    else:
        lengths = mask.sum(dim=1).long()
        seq = bigru(P, pre + "rnn", P[pre + "embed"][tokens], lengths, bl)
        seq = seq * mask[..., None]
        mid = draws.dropout(masked_mean(seq, mask), cfg["dropout"])
        con = conv_bank(P, pre + "convs", seq, cfg["text_kernels"], bl)
    con_out = draws.dropout(con, cfg["dropout"])
    feats = torch.cat([batch["bows"], mid, con_out], dim=1)
    return l2norm(mapping(P, pre + "text_mapping", feats, draws,
                          cfg["dropout"]))


class _L1Pull(torch.autograd.Function):
    """Identity; its backward adds 1e-4 sign(x), an L1 pull on the gathered
    brand weights."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g + 1e-4 * torch.sign(x)


def brand_tower(P, cfg, brand_ids, draws, chunk=250):
    """The mean over aspects of the brand's weighted aspect vectors, each
    product element dropped with probability 0.5 (Philox mask)."""
    w = _L1Pull.apply(P["brand_encoding.brand_embeddings"][brand_ids])
    asp = P["brand_encoding.aspects_embeddings"]
    b, a = w.shape
    c = asp.shape[1]
    keep = 0.5
    seed = draws.seed_words()
    out = 0.0
    for lo in range(0, a, chunk):
        hi = min(lo + chunk, a)
        m = keep_mask(seed, keep, b, a, c, lo, hi, w.device).float()
        out = out + torch.einsum("bac,ba,ac->bc", m, w[:, lo:hi], asp[lo:hi])
    return out / (a * keep)


def fusion(P, vis, txt):
    x = linear(P, "fusion_encoding.fc1", torch.cat([vis, txt], dim=1),
               bias=False)
    mean = x.mean(dim=0)
    var = ((x - mean) ** 2).mean(dim=0)
    y = (x - mean) * torch.rsqrt(var + 1e-5)
    y = y * P["fusion_encoding.bn.weight"] + P["fusion_encoding.bn.bias"]
    return linear(P, "fusion_encoding.fc2", F.relu(y))


def rank_weights(scores):
    b = scores.shape[0]
    order = torch.argsort(-scores, dim=1, stable=True)
    pos = torch.argsort(order, dim=1, stable=True)
    rank = torch.diagonal(pos).float() + 1.0
    return 1.0 / (b - rank + 1.0) + 1.0


def contrastive(brand, post, queue, ptr, temperature=0.03,
                negative_weight=0.8):
    """The recipe's queue-contrastive loss (mean cost) -> (loss, queue,
    pointer). The posts enter the queue before their logits are taken; the
    positive mask walks from the advanced pointer."""
    scores = post @ brand.t()
    weight = rank_weights(scores.detach())
    b = brand.shape[0]
    bn, pn = l2norm(brand), l2norm(post)
    k = queue.shape[0]
    rows = torch.arange(b, device=brand.device)
    queue = queue.index_copy(0, (ptr + rows) % k, pn.detach())
    ptr = (ptr + b) % k
    pos_mask = torch.ones(b, k, device=brand.device)
    pos_mask[rows, (ptr + rows) % k] = 0.0
    inter = bn @ pn.t() / temperature
    intra = (pn @ queue.t()) * pos_mask / temperature
    exp_inter = torch.exp(inter)
    exp_sum = (exp_inter.sum(dim=1)
               + negative_weight * torch.exp(intra).sum(dim=1))
    loss = (-torch.log(torch.diagonal(exp_inter) / exp_sum) * weight).mean()
    return loss, queue, ptr


def forward(P, cfg, batch, draws):
    brand = brand_tower(P, cfg, batch["brand_ids"].long(), draws)
    vis = visual_tower(P, cfg, batch, draws)
    txt = text_tower(P, cfg, batch, draws)
    return brand, fusion(P, vis, txt)


class Adam:
    """torch.optim.Adam's update (betas 0.9, 0.999, eps 1e-8), written out."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float):
        self.lr, self.t = lr, 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, params, grads):
        self.t += 1
        bc1, bc2 = 1.0 - 0.9 ** self.t, 1.0 - 0.999 ** self.t
        for k, p in params.items():
            g = grads[k]
            self.m[k].mul_(0.9).add_(g, alpha=0.1)
            self.v[k].mul_(0.999).addcmul_(g, g, value=0.001)
            denom = self.v[k].sqrt() / math.sqrt(bc2) + 1e-8
            p.addcdiv_(self.m[k], denom, value=-self.lr / bc1)


def train(weights: Dict[str, torch.Tensor], cfg: dict, updates, seed: int,
          device) -> dict:
    """Run the updates (each a list of microbatch dicts) from `weights`
    -> {"losses": each update's mean microbatch loss, "grad_norms": the
    first update's clipped grad norm of each leaf, "change_norms": each
    leaf's distance from `weights` after the last update}."""
    P = {k: v.detach().clone().requires_grad_(True)
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
            brand, post = forward(P, cfg, mb, draws)
            loss, queue, ptr = contrastive(brand, post, queue, ptr)
            loss.backward()
            losses.append(float(loss.detach()))
        out["losses"].append(sum(losses) / len(losses))
        grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
                 for k, p in P.items()}
        with torch.no_grad():
            norm = torch.sqrt(sum((g * g).sum() for g in grads.values()))
            if float(norm) >= cfg["grad_clip"]:
                grads = {k: g / norm * cfg["grad_clip"]
                         for k, g in grads.items()}
        if u == 0:
            out["grad_norms"] = {k: float(g.norm()) for k, g in grads.items()}
        opt.step(P, grads)
    with torch.no_grad():
        out["change_norms"] = {k: float((p - weights[k]).norm())
                               for k, p in P.items()}
    return out

"""Training losses: rank-weighted triplet, CrossCLR, queue-contrastive, lab.

Port of fancyrec_tpu/losses/losses.py. The contrastive memory queue is
explicit state, as in the JAX package: `contrastive_loss` takes a
`ContrastiveQueueState` and returns the next one, and the caller threads it
through the microbatches. Semantics kept from the JAX package:
  * scores[i, j] = brand[j] . post[i] on unnormalized embeddings;
  * rank weights w = 1/(B - rank + 1) + 1 by a stable double argsort;
  * post embeddings are enqueued, detached, before the logits are taken,
    and the positive mask walks from the advanced pointer;
  * only direction='all' exists for the triplet loss.
Embeddings may come in bfloat16 (the post tower under --dtype bfloat16)
beside float32 (the brand tower). Products follow the JAX package's
dots: the raw scores and the cosine accumulate in float32 from their
operands (preferred_element_type=float32); every other product takes the
promoted dtype of its operands (`_mm`), so float32 as soon as one is; the
normalization of a bfloat16 embedding stays in bfloat16.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch


def _l2norm_rows(x: torch.Tensor) -> torch.Tensor:
    return x / torch.sqrt((x * x).sum(dim=1, keepdim=True))


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in the promoted dtype of the two (jnp.dot's promotion)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b accumulated in float32 (preferred_element_type=float32): the
    products of bfloat16 operands are exact in float32."""
    return a.float() @ b.float()


def cosine_sim(im: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return _mm_f32(_l2norm_rows(im), _l2norm_rows(s).T)


def _raw_scores(brand: torch.Tensor, post: torch.Tensor) -> torch.Tensor:
    """scores[i, j] = brand[j] . post[i], in float32."""
    return _mm_f32(post, brand.T)


def rank_weights(scores: torch.Tensor, axis: int) -> torch.Tensor:
    """w = 1/(B - rank + 1) + 1 where rank is the 1-based descending position
    of the diagonal element in its row (axis=1) or column (axis=0). Both
    argsorts are stable, as jnp.argsort is, so ties rank by index."""
    b = scores.shape[0]
    order = torch.argsort(-scores, dim=axis, stable=True)
    pos = torch.argsort(order, dim=axis, stable=True)
    rank = torch.diagonal(pos).to(torch.float32) + 1.0
    return 1.0 / (b - rank + 1.0) + 1.0


def lab_loss(brand_embs: torch.Tensor) -> torch.Tensor:
    s = cosine_sim(brand_embs, brand_embs)
    b = s.shape[0]
    s = torch.where(torch.eye(b, dtype=torch.bool, device=s.device),
                    torch.zeros_like(s), s)
    return (torch.exp(s).sum() - b) / b


def triplet_loss(brand_ids: torch.Tensor, brand_emb: torch.Tensor,
                 post_emb: torch.Tensor, *, margin: float = 0.2,
                 cost_style: str = "sum", direction: str = "all"
                 ) -> torch.Tensor:
    if direction != "all":
        raise NotImplementedError(
            "the triplet loss exists only with direction='all'")
    scores = _raw_scores(brand_emb, post_emb)
    rank_p = rank_weights(scores, axis=1)
    rank_b = rank_weights(scores, axis=0)
    diagonal = torch.diagonal(scores)[:, None]           # (B, 1)
    d1 = diagonal.expand_as(scores)                      # row-constant
    d2 = diagonal.T.expand_as(scores)                    # column-constant
    same_brand = brand_ids[:, None] == brand_ids[None, :]
    zero = torch.zeros_like(scores)
    cost_p = torch.where(same_brand, zero,
                         torch.clamp(margin + scores - d1, min=0.0))
    cost_b = torch.where(same_brand, zero,
                         torch.clamp(margin + scores - d2, min=0.0))
    # a (B,) weight times a (B, B) cost scales column j by w[j]
    cost_p = rank_p[None, :] * cost_p
    cost_b = rank_b[None, :] * cost_b
    if cost_style == "sum":
        return cost_b.sum() + cost_p.sum()
    return cost_b.mean() + cost_p.mean()


def crossclr_loss(brand: torch.Tensor, post: torch.Tensor, *,
                  temperature: float = 0.03, negative_weight: float = 0.8,
                  cost_style: str = "sum") -> torch.Tensor:
    scores = _raw_scores(brand, post)
    rank_p = rank_weights(scores, axis=1)
    rank_b = rank_weights(scores, axis=0)
    b = brand.shape[0]
    brand_n = _l2norm_rows(brand)
    post_n = _l2norm_rows(post)
    logits_per_brand = _mm(brand_n, post_n.T) / temperature
    logits_per_post = _mm(post_n, brand_n.T) / temperature
    logits_clstr_brand = brand_n @ brand_n.T / temperature
    logits_clstr_post = post_n @ post_n.T / temperature
    eye = torch.eye(b, device=brand.device)
    off_diag = 1.0 - eye
    brand_logits = torch.cat(
        [logits_per_brand, negative_weight * (logits_clstr_brand * off_diag)],
        dim=1)
    post_logits = torch.cat(
        [logits_per_post, negative_weight * (logits_clstr_post * off_diag)],
        dim=1)
    mask = torch.cat([eye, torch.zeros_like(eye)], dim=1)

    def compute(logits):
        return -torch.log((torch.softmax(logits, dim=1) * mask).sum(dim=1))

    loss_b = rank_b * compute(brand_logits)
    loss_p = rank_p * compute(post_logits)
    if cost_style == "sum":
        return (loss_b.sum() + loss_p.sum()) / 2.0
    return (loss_b.mean() + loss_p.mean()) / 2.0


class ContrastiveQueueState(NamedTuple):
    queue: torch.Tensor   # (K, C) past normalized post embeddings
    # insertion pointer: an int, or a 0-d int64 tensor on the queue's
    # device (the CUDA-graphed train step's, which the device advances)
    ptr: Union[int, torch.Tensor]


def init_queue_state(queue_size: int, embedding_size: int,
                     device=None) -> ContrastiveQueueState:
    return ContrastiveQueueState(
        queue=torch.zeros((queue_size, embedding_size), dtype=torch.float32,
                          device=device),
        ptr=0)


def contrastive_loss(brand: torch.Tensor, post: torch.Tensor,
                     state: ContrastiveQueueState, *,
                     temperature: float = 0.03, negative_weight: float = 0.8,
                     cost_style: str = "mean", no_queue: bool = False,
                     no_intra: bool = False
                     ) -> Tuple[torch.Tensor, ContrastiveQueueState]:
    """The recipe's 'cl' loss -> (loss, next queue state). The state's
    queue is never written in place. An int pointer gives an int next
    pointer, a tensor one a tensor: the same indices either way."""
    scores = _raw_scores(brand, post)
    weight = rank_weights(scores, axis=1)
    b = brand.shape[0]
    brand_n = _l2norm_rows(brand)
    post_n = _l2norm_rows(post)
    rows = torch.arange(b, device=brand.device)

    if no_queue or no_intra:
        ori_logits = post_n @ post_n.T
        cols = (state.ptr + rows) % ori_logits.shape[1]   # nothing enqueued
        new_state = state
    else:
        k = state.queue.shape[0]
        idx = (state.ptr + rows) % k
        queue = state.queue.index_copy(
            0, idx, post_n.detach().to(state.queue.dtype))
        new_ptr = (state.ptr + b) % k
        ori_logits = _mm(post_n, queue.T)                   # (B, K)
        cols = (new_ptr + rows) % k       # masks from the advanced pointer
        new_state = ContrastiveQueueState(queue=queue, ptr=new_ptr)
    # 0 at (i, cols[i]), 1 elsewhere: a comparison, not an indexed store
    # of a host scalar, which a CUDA graph capture refuses
    pos_mask = (cols[:, None] != torch.arange(
        ori_logits.shape[1], device=cols.device)[None, :]).to(ori_logits.dtype)

    inter = _mm(brand_n, post_n.T) / temperature
    intra = ori_logits * pos_mask / temperature
    if no_intra:
        intra = torch.zeros_like(intra)
    exp_inter = torch.exp(inter)
    exp_intra = torch.exp(intra)
    exp_sum = exp_inter.sum(dim=1) + negative_weight * exp_intra.sum(dim=1)
    logits = torch.diagonal(exp_inter) / exp_sum
    loss_vec = -torch.log(logits) * weight
    loss = loss_vec.sum() if cost_style == "sum" else loss_vec.mean()
    return loss, new_state

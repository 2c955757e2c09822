"""Retrieval metrics: AUC, NDCG@10/50, MedR, MeanR, R@1/5/10.

Port of fancyrec_tpu/eval/metrics.py on one device. Two implementations
with the same semantics:
  * ranking_metrics_oracle: plain numpy, the reference evaluator's loop;
  * ranking_metrics: batched over brands in torch on the scores' device
    (one stable sort a brand row for AUC, one for NDCG), the final scalars
    assembled in float64 on the host, as the JAX package's sharded variant
    does.

Semantics kept: AUC counts strict "negative < positive" pairs; brands with
no positive post are skipped for MedR/MeanR/AUC/NDCG but keep rank 0,
which counts as an R@K hit; NDCG's discount is [1, 1, 1/log2(3), ...];
ties rank by lower post index (a stable descending sort); posts labelled
< 0 are padding, excluded from positives and negatives.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RankingMetrics(NamedTuple):
    medr: float
    meanr: float
    auc: float
    ndcg10: float
    ndcg50: float
    r1: float
    r5: float
    r10: float


def composite_score(m: RankingMetrics) -> float:
    """The reference's model-selection score."""
    return (m.auc + m.ndcg10 + m.ndcg50) * 100.0 + m.r1 + m.r5 + m.r10


def cosine_sim_matrix(brand_embs: torch.Tensor, post_embs: torch.Tensor
                      ) -> torch.Tensor:
    """L2-normalize the rows of both and multiply -> (brands, posts)."""
    b = brand_embs / torch.linalg.norm(brand_embs, dim=1, keepdim=True)
    p = post_embs / torch.linalg.norm(post_embs, dim=1, keepdim=True)
    return b @ p.T


# ---------------------------------------------------------------------------
# numpy oracle
# ---------------------------------------------------------------------------

def _dcg_at_k(r: np.ndarray, k: int) -> float:
    r = np.asarray(r, dtype=np.float64)[:k]
    if r.size:
        return r[0] + np.sum(r[1:] / np.log2(np.arange(2, r.size + 1)))
    return 0.0


def _ndcg_at_k(r, k: int) -> float:
    dcg_max = _dcg_at_k(np.sort(r)[::-1], k)
    if not dcg_max:
        return 0.0
    return _dcg_at_k(np.asarray(r), k) / dcg_max


def ranking_metrics_oracle(scores: np.ndarray, brands: np.ndarray,
                           brand_num: int) -> RankingMetrics:
    """scores: (brand_num, n_posts); brands: (n_posts,) brand label a post."""
    scores = np.asarray(scores)
    brands = np.asarray(brands)
    queries = []
    ranks = np.zeros(scores.shape[0])
    for b in range(scores.shape[0]):
        s = scores[b]
        order = np.argsort(-s, kind="stable")
        sorted_brands = brands[order]
        sorted_scores = s[order]
        pos = sorted_scores[sorted_brands == b]
        neg = sorted_scores[sorted_brands != b]
        if len(pos) == 0:
            continue
        auc_num = np.sum([np.sum(neg < e) for e in pos])
        rel = (sorted_brands == b).astype(np.float64)
        rank_of_first_pos = int(np.argmax(rel))
        queries.append((
            rank_of_first_pos,
            float(auc_num) / (len(pos) * len(neg)),
            _ndcg_at_k(rel, 10),
            _ndcg_at_k(rel, 50),
        ))
        ranks[b] = rank_of_first_pos
    r1 = 100.0 * len(np.where(ranks < 1)[0]) / len(ranks)
    r5 = 100.0 * len(np.where(ranks < 5)[0]) / len(ranks)
    r10 = 100.0 * len(np.where(ranks < 10)[0]) / len(ranks)
    cols = list(zip(*queries))
    return RankingMetrics(
        medr=float(np.floor(np.median(cols[0]))),
        meanr=float(np.floor(np.mean(cols[0]))),
        auc=float(np.average(cols[1])),
        ndcg10=float(np.average(cols[2])),
        ndcg50=float(np.average(cols[3])),
        r1=r1, r5=r5, r10=r10,
    )


# ---------------------------------------------------------------------------
# batched torch version
# ---------------------------------------------------------------------------

_NDCG_KMAX = 50


def _dcg_weights(k: int) -> np.ndarray:
    w = np.ones(k, dtype=np.float64)
    if k > 1:
        w[1:] = 1.0 / np.log2(np.arange(2, k + 1))
    return w


def _per_brand_stats(s: torch.Tensor, brands: torch.Tensor):
    """Per-brand-row statistics of s (B, N) against post labels (N,) ->
    (valid, rank_first, auc, ndcg10, ndcg50), each (B,)."""
    nb, n = s.shape
    dev = s.device
    pad = (brands < 0)[None, :]
    s = torch.where(pad, torch.full_like(s, -torch.inf), s)
    pos = brands[None, :] == torch.arange(nb, device=dev)[:, None]
    p_cnt = pos.sum(dim=1)
    n_cnt = n - p_cnt - pad.sum()

    # AUC: co-sort ascending; negatives strictly below each tie group
    isneg = (~pos & ~pad).to(torch.int64)
    vals, order = torch.sort(s, dim=1, stable=True)
    isneg_s = torch.gather(isneg, 1, order)
    neg_prefix = torch.cumsum(isneg_s, dim=1) - isneg_s
    idx = torch.arange(n, device=dev).expand(nb, n)
    changed = torch.ones_like(isneg_s, dtype=torch.bool)
    changed[:, 1:] = vals[:, 1:] != vals[:, :-1]
    first_occ = torch.cummax(torch.where(changed, idx, torch.zeros_like(idx)),
                             dim=1).values
    below = torch.gather(neg_prefix, 1, first_occ).to(torch.float64)
    ratio = below / torch.clamp(n_cnt, min=1).to(torch.float64)[:, None]
    auc = (torch.where(isneg_s == 0, ratio, torch.zeros_like(ratio)).sum(1)
           / torch.clamp(p_cnt, min=1).to(torch.float64))

    # NDCG@10/50 from a stable descending order (ties: lower index first)
    k = min(_NDCG_KMAX, n)
    top = torch.sort(s, dim=1, descending=True, stable=True).indices[:, :k]
    rel = torch.gather(pos, 1, top).to(torch.float64)
    w50 = torch.from_numpy(_dcg_weights(_NDCG_KMAX)).to(dev)
    dcg10 = (rel[:, :10] * w50[:min(10, k)]).sum(1)
    dcg50 = (rel * w50[:k]).sum(1)
    c50 = torch.cumsum(w50, 0)
    idcg10 = c50[torch.clamp(p_cnt, 1, 10) - 1]
    idcg50 = c50[torch.clamp(p_cnt, 1, _NDCG_KMAX) - 1]
    valid = p_cnt > 0
    zero = torch.zeros_like(dcg10)
    ndcg10 = torch.where(valid, dcg10 / idcg10, zero)
    ndcg50 = torch.where(valid, dcg50 / idcg50, zero)

    # first-positive rank by counting: entries above the best positive,
    # plus equal scores at a lower index than its first occurrence
    masked = torch.where(pos, s, torch.full_like(s, -torch.inf))
    p_star = masked.max(dim=1, keepdim=True).values
    idx_star = masked.argmax(dim=1, keepdim=True)
    rank_first = ((s > p_star).sum(1)
                  + ((s == p_star) & (idx < idx_star)).sum(1))
    return valid, rank_first, auc, ndcg10, ndcg50


def ranking_metrics(scores: torch.Tensor, brands, brand_num: int
                    ) -> RankingMetrics:
    """The batched equivalent of ranking_metrics_oracle on the scores'
    device; scalars assembled in float64 on the host."""
    scores = torch.as_tensor(scores, dtype=torch.float32)
    brands = torch.as_tensor(brands, device=scores.device).to(torch.int64)
    stats = _per_brand_stats(scores[:brand_num], brands)
    valid, rank_first, auc, ndcg10, ndcg50 = [x.cpu().numpy() for x in stats]
    return _assemble_metrics(valid, rank_first, auc, ndcg10, ndcg50,
                             brand_num)


def _assemble_metrics(valid, rank_first, auc, ndcg10, ndcg50,
                      brand_num: int) -> RankingMetrics:
    """Per-brand numpy statistics -> RankingMetrics in float64."""
    vcnt = max(int(valid.sum()), 1)
    ranks = np.where(valid, rank_first, 0)   # invalid brands keep rank 0
    mean = lambda x: float(np.sum(np.where(valid, x.astype(np.float64),  # noqa: E731
                                           0.0)) / vcnt)
    return RankingMetrics(
        medr=float(np.floor(np.median(rank_first[valid]))
                   if valid.any() else 0.0),
        meanr=float(np.floor(np.sum(rank_first[valid]) / vcnt)),
        auc=mean(auc), ndcg10=mean(ndcg10), ndcg50=mean(ndcg50),
        r1=100.0 * int((ranks < 1).sum()) / brand_num,
        r5=100.0 * int((ranks < 5).sum()) / brand_num,
        r10=100.0 * int((ranks < 10).sum()) / brand_num,
    )

"""Retrieval metrics: AUC, NDCG@10/50, MedR, MeanR, R@1/5/10.

Port of fancyrec_tpu/eval/metrics.py. Three implementations with the
same semantics:
  * ranking_metrics_oracle: plain numpy, the reference evaluator's loop;
  * ranking_metrics: batched over brands in torch on the scores' device
    (one stable sort a brand row for AUC, one for NDCG), the final scalars
    assembled in float64 on the host, as the JAX package's sharded variant
    does;
  * ranking_metrics_sharded: each data slot of a world holds a
    contiguous shard of the posts' columns, and only the posts' own-brand
    scores, each shard's top-50 a brand and summed count vectors cross the
    data group -- never the (brands, posts) matrix. Its counts are integers and its
    assembly repeats the oracle's float64 arithmetic, so it equals the
    oracle exactly.

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

from fancyrec_tpu_torch.parallel import collectives


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
    """Per-brand numpy statistics -> RankingMetrics in float64; means over
    the valid brands in brand order, as the oracle's np.average."""
    vcnt = max(int(valid.sum()), 1)
    ranks = np.where(valid, rank_first, 0)   # invalid brands keep rank 0
    mean = lambda x: (float(np.mean(x[valid].astype(np.float64)))  # noqa: E731
                      if valid.any() else 0.0)
    return RankingMetrics(
        medr=float(np.floor(np.median(rank_first[valid]))
                   if valid.any() else 0.0),
        meanr=float(np.floor(np.sum(rank_first[valid]) / vcnt)),
        auc=mean(auc), ndcg10=mean(ndcg10), ndcg50=mean(ndcg50),
        r1=100.0 * int((ranks < 1).sum()) / brand_num,
        r5=100.0 * int((ranks < 5).sum()) / brand_num,
        r10=100.0 * int((ranks < 10).sum()) / brand_num,
    )


# ---------------------------------------------------------------------------
# sharded: exact metrics over a world's post shards
# ---------------------------------------------------------------------------

def _searchsorted_rows(sorted_rows: torch.Tensor, row_ids: torch.Tensor,
                       queries: torch.Tensor) -> torch.Tensor:
    """For each query i: the count of entries < queries[i] in
    sorted_rows[row_ids[i]] (a bisect_left with a row a query), as
    ceil(log2(n + 1)) rounds of vectorized gathers, never an (N, n)
    comparison."""
    n = sorted_rows.shape[1]
    flat = sorted_rows.reshape(-1)
    base = row_ids.to(torch.int64) * n
    lo = torch.zeros_like(base)
    hi = torch.full_like(base, n)
    for _ in range(max(1, n.bit_length())):
        active = lo < hi
        mid = (lo + hi) // 2
        right = flat[base + torch.clamp(mid, max=n - 1)] < queries
        lo = torch.where(active & right, mid + 1, lo)
        hi = torch.where(active & ~right, mid, hi)
    return lo


def _same_label_strictly_below(labels: torch.Tensor, vals: torch.Tensor
                               ) -> torch.Tensor:
    """For each i: the count of j with labels[j] == labels[i] and vals[j] <
    vals[i], from one (label, value) ordering and segment arithmetic."""
    n = vals.shape[0]
    idx = torch.arange(n, device=vals.device)
    by_val = torch.sort(vals, stable=True).indices
    order = by_val[torch.sort(labels[by_val], stable=True).indices]
    lab_s, val_s = labels[order], vals[order]
    first = torch.ones(1, dtype=torch.bool, device=vals.device)
    seg_start = torch.cat([first, lab_s[1:] != lab_s[:-1]])
    pair_change = seg_start | torch.cat([first, val_s[1:] != val_s[:-1]])
    zero = torch.zeros_like(idx)
    seg_first = torch.cummax(torch.where(seg_start, idx, zero), 0).values
    pair_first = torch.cummax(torch.where(pair_change, idx, zero), 0).values
    out = torch.empty_like(idx)
    out[order] = pair_first - seg_first
    return out


def _sharded_brand_stats(scores_l: torch.Tensor, brands_l: torch.Tensor,
                         brand_num: int):
    """This rank's (B, n_l) score shard and its posts' labels -> the
    global per-brand integer statistics (pos_cnt, neg_cnt, auc_num,
    rank_first) and the merged top-50 relevance (B, <= 50), the same on
    every rank.

    The only scores that can be a brand's POSITIVE are the N own-brand
    entries score[brands[i], i], one a post: gathering those (N floats)
    replaces gathering the matrix. A positive's count of strictly lower
    negatives in its brand's row is the count of all strictly lower
    entries there (a binary search in each shard's sorted rows, summed
    over ranks) less the same-label ones (from the gathered own-brand
    scores)."""
    dev = scores_l.device
    n_l = scores_l.shape[1]
    pad_l = brands_l < 0
    inf = torch.tensor(torch.inf, device=dev)
    diag_l = scores_l[brands_l.clamp(0, brand_num - 1),
                      torch.arange(n_l, device=dev)]
    d_g = collectives.all_gather(torch.where(pad_l, -inf, diag_l))    # (N,)
    l_g = collectives.all_gather(brands_l)                            # (N,)
    n_total = d_g.shape[0]
    valid_g = l_g >= 0
    lab_g = l_g.clamp(0, brand_num - 1)
    pos_cnt = torch.zeros(brand_num, dtype=torch.int64, device=dev
                          ).index_add_(0, lab_g, valid_g.to(torch.int64))
    neg_cnt = valid_g.sum() - pos_cnt

    # AUC: strictly lower negatives of each positive, as integers
    s_sorted = torch.sort(torch.where(pad_l[None, :], inf, scores_l),
                          dim=1).values
    below = collectives.all_reduce_sum_(
        _searchsorted_rows(s_sorted, lab_g, d_g))
    neg_below = torch.where(valid_g, below - _same_label_strictly_below(
        l_g, d_g), torch.zeros_like(below))
    auc_num = torch.zeros(brand_num, dtype=torch.int64, device=dev
                          ).index_add_(0, lab_g, neg_below)

    # first-positive rank: entries above the best positive (a higher score,
    # or the same score at a lower global index: stable descending order)
    p_star = torch.full((brand_num,), -torch.inf, device=dev).scatter_reduce(
        0, lab_g, torch.where(valid_g, d_g, -inf), "amax")
    gidx_g = torch.arange(n_total, device=dev)
    is_star = valid_g & (d_g == p_star[lab_g])
    idx_star = torch.full((brand_num,), n_total, device=dev).scatter_reduce(
        0, lab_g, torch.where(is_star, gidx_g, n_total), "amin")
    gidx = collectives.data_rank() * n_l + torch.arange(n_l, device=dev)
    live = ~pad_l[None, :]
    ahead = (((scores_l > p_star[:, None]) & live).sum(1)
             + ((scores_l == p_star[:, None]) & live
                & (gidx[None, :] < idx_star[:, None])).sum(1))
    rank_first = collectives.all_reduce_sum_(ahead)

    # NDCG: each shard's top-50 a brand (stable: lower index first), merged
    # shard-major, which is global-index order among equal scores
    k = min(_NDCG_KMAX, n_l)
    top = torch.sort(torch.where(pad_l[None, :], -inf, scores_l), dim=1,
                     descending=True, stable=True)
    top_v, top_i = top.values[:, :k], top.indices[:, :k]
    top_rel = (brands_l[top_i] == torch.arange(
        brand_num, device=dev)[:, None]).to(torch.int64)
    vals_m = collectives.all_gather(top_v[None]).permute(1, 0, 2).reshape(
        brand_num, -1)
    rel_m = collectives.all_gather(top_rel[None]).permute(1, 0, 2).reshape(
        brand_num, -1)
    merged = torch.sort(vals_m, dim=1, descending=True, stable=True).indices
    rel50 = torch.gather(rel_m, 1, merged[:, :_NDCG_KMAX])
    return [x.cpu().numpy() for x in
            (pos_cnt, neg_cnt, auc_num, rank_first, rel50)]


def ranking_metrics_sharded(scores_l: torch.Tensor, brands_l,
                            brand_num: int) -> RankingMetrics:
    """Exact ranking metrics over the post shards of a world.

    scores_l: this rank's (brands, n_l) block of the score matrix, its
    posts a contiguous shard in data-slot order (the model ranks of a slot
    hold the same block; every slot's n_l the same; pad
    posts labelled -1 in brands_l). Every rank gets the oracle's metrics
    for the live posts of all shards. The final assembly runs in float64
    on the host with the oracle's own arithmetic (AUC as an integer pair
    count over |pos| x |neg|, NDCG from the 0/1 relevance of the top
    entries), so the result equals the oracle's exactly."""
    scores_l = torch.as_tensor(scores_l, dtype=torch.float32)[:brand_num]
    brands_l = torch.as_tensor(brands_l, device=scores_l.device).to(
        torch.int64)
    pos_cnt, neg_cnt, auc_num, rank_first, rel50 = _sharded_brand_stats(
        scores_l, brands_l, brand_num)
    n_live = int(pos_cnt.sum())            # every live post has one brand
    valid = pos_cnt > 0
    auc = np.zeros(brand_num)
    ndcg10, ndcg50 = np.zeros(brand_num), np.zeros(brand_num)
    kk = min(_NDCG_KMAX, n_live)
    for b in np.nonzero(valid)[0]:
        if neg_cnt[b]:
            auc[b] = float(auc_num[b]) / (int(pos_cnt[b]) * int(neg_cnt[b]))
        rel = rel50[b, :kk].astype(np.float64)
        ideal = np.zeros(kk)
        ideal[:min(int(pos_cnt[b]), kk)] = 1.0
        for out, k in ((ndcg10, 10), (ndcg50, 50)):
            dcg_max = _dcg_at_k(ideal, k)
            out[b] = _dcg_at_k(rel, k) / dcg_max if dcg_max else 0.0
    return _assemble_metrics(valid, rank_first, auc, ndcg10, ndcg50,
                             brand_num)

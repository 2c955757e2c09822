"""Int8 row quantization, retrieval top-k, and the fused int8 score+top-k.

Port of fancyrec_tpu/ops/similarity.py. The fused kernel
(`retrieval_topk_fused_int8` there) is `csrc/topk_int8.cu` here, with its
plain PyTorch version `topk_int8_ref` beside it.

Selection everywhere orders by (score descending, index ascending), the
tie rule of lax.top_k, so the port returns the JAX package's indices.
`torch.topk` promises no order among ties; the plain paths select with a
stable descending sort instead.

Int8 cosine scoring: rows quantize with a per-row max-abs scale that
cancels in the cosine, so only the inverse L2 norm of the quantized row
survives as an f32 column scale. Scores are exact integer dots times
that scale.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from fancyrec_tpu_torch.ops import _build

# |int8 dot| <= 127^2 * D; below 2^24 a float32 matmul of int8 values sums
# integers exactly in any order (D <= 1040). Wider rows score in float64.
_F32_EXACT_DIM = (1 << 24) // (127 * 127)
# 'auto' scores the whole (B, N) matrix when it fits this many bytes
_MATRIX_LIMIT_BYTES = 512 * 2 ** 20


def quantize_rows_int8(rows: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) float -> (q int8 (N, D), inv_norms f32 (N,)), on rows' device.

    inv_norms = 1/||q_j|| (0 for all-zero rows, which then score 0
    everywhere). Same order of operations as the JAX version (127/amax,
    multiply, round half to even, clip), so q is bit-identical."""
    rows = rows.float()
    amax = rows.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, 127.0 / amax, torch.zeros_like(amax))
    q = torch.clamp(torch.round(rows * scale), -127, 127).to(torch.int8)
    sq = q.float().square().sum(dim=1)
    inv = torch.where(sq > 0, torch.rsqrt(torch.clamp(sq, min=1.0)),
                      torch.zeros_like(sq))
    return q, inv


def quantize_rows_int8_np(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side mirror of quantize_rows_int8: quantizing before the copy
    to the device ships 1 byte/elem instead of 4."""
    rows = np.asarray(rows, np.float32)
    amax = np.max(np.abs(rows), axis=1, keepdims=True)
    scale = np.divide(np.float32(127.0), amax, where=amax > 0,
                      out=np.zeros_like(amax))
    q = np.clip(np.round(rows * scale), -127, 127).astype(np.int8)
    sq = np.sum(np.square(q.astype(np.float32)), axis=1)
    inv = np.where(sq > 0, 1.0 / np.sqrt(np.maximum(sq, 1.0)), 0.0)
    return q, inv.astype(np.float32)


def _int_dots(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """(B, D) int8 x (T, D) int8 -> exact integer dots as float32 (B, T)."""
    dt = torch.float32 if qa.shape[1] <= _F32_EXACT_DIM else torch.float64
    return (qa.to(dt) @ qb.to(dt).T).float()


def _topk_desc(scores: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k of each row by (value desc, index asc); k > width pads with
    -inf at index 0, as the JAX matrix path does."""
    vals, idxs = torch.sort(scores, dim=1, descending=True, stable=True)
    kk = min(k, scores.shape[1])
    vals, idxs = vals[:, :kk], idxs[:, :kk]
    if kk < k:
        pad = k - kk
        vals = torch.cat([vals, vals.new_full((vals.shape[0], pad),
                                              float("-inf"))], 1)
        idxs = torch.cat([idxs, idxs.new_zeros((idxs.shape[0], pad))], 1)
    return vals, idxs.to(torch.int32)


def _post_inv(posts: torch.Tensor) -> torch.Tensor:
    sq = posts.float().square().sum(dim=1)
    return torch.where(sq > 0, torch.rsqrt(torch.clamp(sq, min=1.0)),
                       torch.zeros_like(sq))


def retrieval_topk(brands: torch.Tensor, posts: torch.Tensor, k: int,
                   block: int = 4096, n_valid: Optional[int] = None,
                   strategy: str = "auto",
                   posts_inv: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k posts per brand by cosine, descending: (values (B, k) f32,
    indices (B, k) int32).

    'matrix' scores the whole (B, N) matrix with the column norms applied
    after the dot, then selects once; 'scan' walks post blocks keeping a
    running (B, k) candidate set. 'auto' picks matrix when the score
    matrix fits 512 MiB. int8 posts (quantize_rows_int8) score
    exact integer dots times the 1/||q_j|| sidecar `posts_inv` (computed
    when omitted). Rows >= n_valid never rank.
    """
    b, d = brands.shape
    n = posts.shape[0]
    quantized = posts.dtype == torch.int8
    if quantized:
        qb, b_inv = quantize_rows_int8(brands)
        if posts_inv is None:
            posts_inv = _post_inv(posts)
    else:
        brands_n = brands / torch.linalg.norm(brands, dim=1, keepdim=True)
        sq = (posts * posts).sum(dim=1)
        posts_inv = torch.where(sq > 0,
                                torch.rsqrt(torch.clamp(sq, min=1e-30)),
                                torch.zeros_like(sq))

    def score(lo: int, hi: int) -> torch.Tensor:
        if quantized:
            raw = _int_dots(qb, posts[lo:hi])
            return raw * b_inv[:, None] * posts_inv[None, lo:hi]
        return (brands_n @ posts[lo:hi].T) * posts_inv[None, lo:hi]

    if strategy == "auto":
        strategy = "matrix" if b * n * 4 <= _MATRIX_LIMIT_BYTES else "scan"
    if strategy == "matrix":
        scores = score(0, n)
        if n_valid is not None:
            ok = torch.arange(n, device=scores.device) < n_valid
            scores = torch.where(ok[None, :], scores,
                                 torch.full_like(scores, float("-inf")))
        return _topk_desc(scores, k)
    if strategy != "scan":
        raise ValueError("strategy must be 'auto', 'matrix' or 'scan'")
    vals = torch.full((b, k), float("-inf"), device=brands.device)
    idxs = torch.zeros((b, k), dtype=torch.int64, device=brands.device)
    limit = n if n_valid is None else min(n, n_valid)
    for lo in range(0, n, block):
        hi = min(lo + block, n)
        s = score(lo, hi)
        gid = torch.arange(lo, hi, device=s.device)
        s = torch.where((gid < limit)[None, :], s,
                        torch.full_like(s, float("-inf")))
        # running entries hold smaller indices than this block's, so a
        # stable sort keeps the smaller index first on ties
        cand_v = torch.cat([vals, s], dim=1)
        cand_i = torch.cat([idxs, gid[None, :].expand(b, -1)], dim=1)
        vals, sel = _topk_desc(cand_v, k)
        idxs = torch.gather(cand_i, 1, sel.long())
    return vals, idxs.to(torch.int32)


def topk_int8_ref(brands: torch.Tensor, posts_q: torch.Tensor,
                  posts_inv: torch.Tensor, k: int,
                  n_valid: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the fused kernel: the full (B, N) score
    matrix, a stable descending sort, the brand scale after selection."""
    n = posts_q.shape[0]
    n_valid = n if n_valid is None else n_valid
    qb, b_inv = quantize_rows_int8(brands)
    scores = _int_dots(qb, posts_q) * posts_inv.float()[None, :]
    ok = torch.arange(n, device=scores.device) < n_valid
    scores = torch.where(ok[None, :], scores,
                         torch.full_like(scores, float("-inf")))
    vals, idxs = _topk_desc(scores, k)
    vals = vals * b_inv[:, None]
    idxs = torch.where(torch.isneginf(vals), torch.zeros_like(idxs), idxs)
    return vals, idxs


def topk_int8_cuda(brands: torch.Tensor, posts_q: torch.Tensor,
                   posts_inv: torch.Tensor, k: int,
                   n_valid: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/topk_int8.cu` (two passes) on the current stream."""
    if brands.device.type != "cuda":
        raise ValueError("topk_int8_cuda needs CUDA tensors, got %s"
                         % brands.device)
    if brands.dim() != 2 or posts_q.dim() != 2 \
            or brands.shape[1] != posts_q.shape[1]:
        raise ValueError("brands (B, D) and posts_q (N, D) must share D, "
                         "got %s and %s" % (tuple(brands.shape),
                                            tuple(posts_q.shape)))
    if posts_q.dtype != torch.int8 or posts_inv.dtype != torch.float32:
        raise ValueError("posts_q must be int8 and posts_inv float32")
    if posts_q.device != brands.device or posts_inv.device != brands.device:
        raise ValueError("brands, posts_q and posts_inv must be on one device")
    b, d = brands.shape
    n = posts_q.shape[0]
    if tuple(posts_inv.shape) != (n,):
        raise ValueError("posts_inv must be (N,) = (%d,)" % n)
    if b == 0 or d % 4:
        raise ValueError("need B >= 1 and D % 4 == 0, got B=%d D=%d" % (b, d))
    if not 1 <= k <= 128:
        raise ValueError("fused top-k supports 1 <= k <= 128, got %d" % k)
    n_valid = n if n_valid is None else int(n_valid)
    if not 0 <= n_valid <= n:
        raise ValueError("n_valid must lie in [0, %d], got %d" % (n, n_valid))
    posts_q = posts_q.contiguous()
    posts_inv = posts_inv.contiguous()
    qb, b_inv = quantize_rows_int8(brands)
    qb = qb.contiguous()
    for t in (qb, posts_q):
        if t.data_ptr() % 4:
            raise ValueError("int8 rows must be 4-byte aligned")
    sms = torch.cuda.get_device_properties(brands.device).multi_processor_count
    # blocks along the post axis: one wave at two blocks an SM (each holds
    # ~100 KB of shared memory), and few candidates for the merge pass
    grid = max(1, min(-(-n_valid // 64), 2 * sms))
    cand = torch.empty((b, grid, k), dtype=torch.int64, device=brands.device)
    vals = torch.empty((b, k), dtype=torch.float32, device=brands.device)
    idxs = torch.empty((b, k), dtype=torch.int32, device=brands.device)
    lib = _build.load("topk_int8")
    fn = lib.topk_int8_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(brands.device):
        stream = torch.cuda.current_stream(brands.device).cuda_stream
        err = fn(qb.data_ptr(), posts_q.data_ptr(), posts_inv.data_ptr(),
                 cand.data_ptr(), vals.data_ptr(), idxs.data_ptr(),
                 b, d, n_valid, k, grid, stream)
    if err:
        raise RuntimeError("topk_int8 kernel launch failed: CUDA error %d"
                           % err)
    topk_int8_cuda.launches += 1
    vals = vals * b_inv[:, None]
    idxs = torch.where(torch.isneginf(vals), torch.zeros_like(idxs), idxs)
    return vals, idxs


topk_int8_cuda.launches = 0


def topk_int8(brands: torch.Tensor, posts_q: torch.Tensor,
              posts_inv: torch.Tensor, k: int,
              n_valid: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused int8 scoring + top-k, k <= 128: (values (B, k) f32, indices
    (B, k) int32), best first; -inf / index 0 past n_valid candidates.
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors."""
    if k > 128:
        raise ValueError("fused top-k supports k <= 128")
    if brands.device.type == "cpu":
        return topk_int8_ref(brands, posts_q, posts_inv, k, n_valid)
    return topk_int8_cuda(brands, posts_q, posts_inv, k, n_valid)

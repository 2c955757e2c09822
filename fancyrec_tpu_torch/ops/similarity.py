"""Cosine scores, int8 row quantization, retrieval top-k, and the fused
int8 score+top-k.

Port of fancyrec_tpu/ops/similarity.py. Its two Pallas kernels are CUDA
here, each with its plain PyTorch version beside it:
`cosine_scores_pallas` is `csrc/cosine_scores.cu` (`cosine_scores_ref`),
the evaluation's brands x posts cosine; `retrieval_topk_fused_int8` is
`csrc/topk_int8.cu` (`topk_int8_ref`), the int8 serving query, which
`distributed_retrieval_topk` (one process, shards on its devices) and
`ranked_retrieval_topk` (a shard a data slot of a world) run once a post
shard.

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

import contextlib
import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from fancyrec_tpu_torch.ops import _build
from fancyrec_tpu_torch.parallel import collectives

# |int8 dot| <= 127^2 * D; below 2^24 a float32 matmul of int8 values sums
# integers exactly in any order (D <= 1040). Wider rows score in float64.
_F32_EXACT_DIM = (1 << 24) // (127 * 127)
# 'auto' scores the whole (B, N) matrix when it fits this many bytes
_MATRIX_LIMIT_BYTES = 512 * 2 ** 20


def cosine_scores_ref(brands: torch.Tensor, posts: torch.Tensor
                      ) -> torch.Tensor:
    """Plain PyTorch version of the cosine kernel: (B, D), (N, D) ->
    (B, N) float32, brands divided by their norms, posts scaled by the
    rsqrt of their sums of squares. An all-zero row gives NaN (0/0 for a
    brand, 0 * inf for a post), as both JAX functions give."""
    brands_n = brands / torch.linalg.norm(brands, dim=1, keepdim=True)
    inv = torch.rsqrt((posts * posts).sum(dim=1, keepdim=True))
    return brands_n @ (posts * inv).T


# K4's tiles (csrc/cosine_scores.cu): posts and brands a block, D values a
# stage
_K4_POSTS, _K4_BRANDS, _K4_STAGE = 128, 64, 32


def cosine_slices(b: int, n: int, d: int, sms: int) -> int:
    """The number S of D slices K4 runs in for a (b, n, d) call on a card of
    `sms` SMs: 1 (the single pass) when its tiles make two blocks an SM;
    else the fewest slices of whole D stages that, times the tiles, reach
    two blocks an SM, up to one stage a slice. Slices hold ceil(stages / S)
    stages, the last one the rest."""
    tiles = -(-n // _K4_POSTS) * -(-b // _K4_BRANDS)
    stages = -(-d // _K4_STAGE)
    if tiles >= 2 * sms:
        return 1
    per = -(-stages // min(stages, -(-2 * sms // tiles)))
    return -(-stages // per)


def cosine_scratch_len(b: int, n: int, slices: int) -> int:
    """Float32 values of K4's scratch: none for the single pass; for a split
    the partial dots (S, B, N) and the partial sums of squares (S, N)."""
    return slices * (b + 1) * n if slices > 1 else 0


def _cosine_fn():
    fn = _build.load("cosine_scores").cosine_scores_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def cosine_scores_cuda(brands: torch.Tensor, posts: torch.Tensor
                       ) -> torch.Tensor:
    """Launch `csrc/cosine_scores.cu` on the current stream: one pass on
    the brands normalized here, or with few posts a D-split pass on the raw
    brands and a pass that adds the slices and divides by the brands' norms
    (`cosine_slices`). The posts are normalized inside the kernel. The split
    call is kept to two allocations and one foreign call: at the test
    split's size the host's part of a call is larger than the card's."""
    if brands.device.type != "cuda":
        raise ValueError("cosine_scores_cuda needs CUDA tensors, got %s"
                         % brands.device)
    if brands.dim() != 2 or posts.dim() != 2 \
            or brands.shape[1] != posts.shape[1]:
        raise ValueError("brands (B, D) and posts (N, D) must share D, got "
                         "%s and %s" % (tuple(brands.shape),
                                        tuple(posts.shape)))
    if brands.dtype != torch.float32 or posts.dtype != torch.float32:
        raise ValueError("cosine_scores_cuda takes float32, got %s and %s"
                         % (brands.dtype, posts.dtype))
    dev = brands.device
    if posts.device != dev:
        raise ValueError("brands and posts must be on one device")
    b, d = brands.shape
    n = posts.shape[0]
    if b == 0 or n == 0 or d == 0:
        raise ValueError("need B, N, D >= 1, got B=%d N=%d D=%d" % (b, n, d))
    brands = brands.contiguous()
    posts = posts.contiguous()
    slices = cosine_slices(b, n, d, _build.sm_count(dev))
    if slices == 1:
        brands = brands / torch.linalg.norm(brands, dim=1, keepdim=True)
    out = torch.empty((b, n), dtype=torch.float32, device=dev)
    scratch = (torch.empty(cosine_scratch_len(b, n, slices),
                           dtype=torch.float32, device=dev)
               if slices > 1 else None)
    # kernels launch on the current device: switch only when it differs
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        err = _cosine_fn()(brands.data_ptr(), posts.data_ptr(),
                           out.data_ptr(),
                           None if scratch is None else scratch.data_ptr(),
                           b, n, d, slices,
                           torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError("cosine_scores kernel launch failed: CUDA error %d"
                           % err)
    cosine_scores_cuda.launches += 1
    return out


cosine_scores_cuda.launches = 0


def cosine_scores(brands: torch.Tensor, posts: torch.Tensor) -> torch.Tensor:
    """(B, D), (N, D) -> (B, N) float32 cosine scores, posts normalized on
    the fly. The CUDA kernel for CUDA tensors, the plain version for CPU
    tensors."""
    if brands.device.type == "cpu":
        return cosine_scores_ref(brands, posts)
    if brands.device.type == "cuda":
        return cosine_scores_cuda(brands, posts)
    raise ValueError("cosine_scores runs on cuda or cpu tensors, got %s"
                     % brands.device)


def quantize_rows_int8(rows: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, D) float -> (q int8 (N, D), inv_norms f32 (N,)), on rows' device.

    inv_norms = 1/||q_j|| (0 for all-zero rows, which then score 0
    everywhere). Same order of operations as the JAX version (127/amax,
    multiply, round half to even, clip), so q is bit-identical."""
    rows = rows.float()
    amax = rows.abs().amax(dim=1, keepdim=True)
    # one IEEE division, as jnp and numpy divide: `127.0 / amax` on a tensor
    # is 127 times the reciprocal, which rounds twice
    scale = torch.where(amax > 0, torch.full_like(amax, 127.0) / amax,
                        torch.zeros_like(amax))
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


# K3's shapes (csrc/topk_int8.cu): brands a block, posts a tile, the pad
# after each shared row, an H100 block's dynamic shared memory, the ring's
# stage counts, and its stages' bytes of D with the brands in shared memory
# (the widest that fits first) and with them in the ring
_K3_BRANDS, _K3_POSTS, _K3_PAD, _K3_SMEM = 64, 128, 16, 232448
_K3_MIN_STAGES, _K3_MAX_STAGES = 4, 8
_K3_STAGE_BYTES, _K3_RING_STAGE_BYTES = (256, 128), 128


class TopkPlan(NamedTuple):
    """K3's launch: blocks a brand tile, bytes of D a ring stage, ring
    stages, whether the brands come through the ring beside the posts (rows
    too wide for shared memory), the bytes of scratch and the offsets of its
    parts (quantized brands, their scales, their first thresholds, each
    block's best key of each brand, the blocks' candidate lists)."""
    grid: int
    ks: int
    stages: int
    ring_brands: bool
    scratch_bytes: int
    parts: Tuple[int, int, int, int, int]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _k3_smem(d: int, k: int, ks: int, stages: int, ring_brands: bool) -> int:
    """Dynamic shared memory of K3's partial kernel (the C source's
    `partial_smem`, which the C entry checks against the block's limit):
    the ring's barriers, the brands' top-k lists, thresholds and locks, the
    64 brand rows unless they come through the ring, and the ring."""
    v16 = d % 16 == 0      # tensor-map copies: unpadded, 1024-aligned
    row = ks if v16 else ks + _K3_PAD
    rows = _K3_POSTS + (_K3_BRANDS if ring_brands else 0)
    return (16 * _K3_MAX_STAGES + _K3_BRANDS * (8 * k + 12)
            + (0 if ring_brands else
               _K3_BRANDS * (_round_up(d, ks) + _K3_PAD))
            + (1024 if v16 else 0) + stages * rows * row)


def topk_int8_plan(b: int, n: int, d: int, k: int, sms: int) -> TopkPlan:
    """K3's launch for b brands over n valid posts of width d on a card of
    `sms` SMs: one block an SM, shared out among the 64-brand tiles (no more
    than the 128-post tiles); the widest stage (256 or 128 bytes of D) that
    leaves room for 4 ring stages beside the 64 brand rows, else the brands
    through the ring in stages of 128 bytes; as many stages as fit up to 8."""
    if not (1 <= k <= 128 and d % 4 == 0 and d >= 4):
        raise ValueError("K3 takes 1 <= k <= 128 and D %% 4 == 0, got k=%d "
                         "D=%d" % (k, d))
    brand_tiles = -(-b // _K3_BRANDS)
    grid = max(1, min(-(-n // _K3_POSTS), -(-sms // brand_tiles)))

    def fit(ks, ring_brands):
        room = _K3_SMEM - _k3_smem(d, k, ks, 0, ring_brands)
        return min(_K3_MAX_STAGES,
                   room // (_k3_smem(d, k, ks, 1, ring_brands)
                            - _k3_smem(d, k, ks, 0, ring_brands)))

    for ks, ring_brands in ([(x, False) for x in _K3_STAGE_BYTES]
                            + [(_K3_RING_STAGE_BYTES, True)]):
        stages = fit(ks, ring_brands)
        if stages >= _K3_MIN_STAGES:
            break
    sizes = (b * _round_up(d, 256), 4 * b, 8 * b, 8 * b * grid,
             8 * b * grid * k)
    parts, off = [], 0
    for size in sizes:
        parts.append(off)
        off += _round_up(size, 16)
    return TopkPlan(grid, ks, stages, ring_brands, off, tuple(parts))


def _topk_fn():
    fn = _build.load("topk_int8").topk_int8_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_size_t]
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def topk_int8_args(brands, posts_q, posts_inv, scratch, vals, idxs, k,
                   n_valid, plan):
    """The arguments of K3's C entry `topk_int8_fwd` for contiguous CUDA
    tensors and a plan, on the current stream of the brands' card."""
    b, d = brands.shape
    return (brands.data_ptr(), posts_q.data_ptr(), posts_inv.data_ptr(),
            scratch.data_ptr(), plan.scratch_bytes,
            (ctypes.c_longlong * 5)(*plan.parts), vals.data_ptr(),
            idxs.data_ptr(), b, d, n_valid, k, plan.grid, plan.ks,
            plan.stages, int(plan.ring_brands),
            torch.cuda.current_stream(brands.device).cuda_stream)


def topk_int8_cuda(brands: torch.Tensor, posts_q: torch.Tensor,
                   posts_inv: torch.Tensor, k: int,
                   n_valid: Optional[int] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch `csrc/topk_int8.cu` on the current stream: the brands'
    quantization, the partial top-k lists and their merge, with the brand
    scale applied, all inside the C entry; the call makes no PyTorch op
    besides the allocations of its outputs and scratch."""
    if brands.device.type != "cuda":
        raise ValueError("topk_int8_cuda needs CUDA tensors, got %s"
                         % brands.device)
    if brands.dim() != 2 or posts_q.dim() != 2 \
            or brands.shape[1] != posts_q.shape[1]:
        raise ValueError("brands (B, D) and posts_q (N, D) must share D, "
                         "got %s and %s" % (tuple(brands.shape),
                                            tuple(posts_q.shape)))
    if brands.dtype != torch.float32 or posts_q.dtype != torch.int8 \
            or posts_inv.dtype != torch.float32:
        raise ValueError("brands must be float32, posts_q int8 and posts_inv "
                         "float32")
    dev = brands.device
    if posts_q.device != dev or posts_inv.device != dev:
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
    brands = brands.contiguous()
    posts_q = posts_q.contiguous()
    posts_inv = posts_inv.contiguous()
    # whole 16-byte copies where rows are whole 16 bytes, else 4-byte ones
    if posts_q.data_ptr() % (16 if d % 16 == 0 else 4):
        raise ValueError("int8 post rows of D=%d must start %d-byte aligned"
                         % (d, 16 if d % 16 == 0 else 4))
    plan = topk_int8_plan(b, n_valid, d, k, _build.sm_count(dev))
    scratch = torch.empty(plan.scratch_bytes, dtype=torch.uint8, device=dev)
    vals = torch.empty((b, k), dtype=torch.float32, device=dev)
    idxs = torch.empty((b, k), dtype=torch.int32, device=dev)
    with (torch.cuda.device(dev) if dev.index != torch.cuda.current_device()
          else contextlib.nullcontext()):
        err = _topk_fn()(*topk_int8_args(brands, posts_q, posts_inv, scratch,
                                         vals, idxs, k, n_valid, plan))
    if err:
        raise RuntimeError("topk_int8 kernel launch failed: CUDA error %d"
                           % err)
    topk_int8_cuda.launches += 1
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


def shard_topk(brands: torch.Tensor, posts: torch.Tensor, k: int, *,
               shard: int, shard_size: int, n_valid: int,
               posts_inv: Optional[torch.Tensor] = None, fused: bool = False,
               block: int = 4096) -> Tuple[torch.Tensor, torch.Tensor]:
    """The local step of a sharded top-k: post shard `shard` holds global
    rows [shard * shard_size, (shard + 1) * shard_size) and ranks its first
    clip(n_valid - shard * shard_size, 0, shard_size) of them, with
    `topk_int8` when fused (the CUDA kernel on a card; posts_inv its
    inverse norms), else `retrieval_topk`. -> its candidates (values (B, k)
    f32, global indices (B, k) int32) on the shard's device. A slot with
    no valid candidate holds -inf at the global index of the shard's
    filler (shard * shard_size for the fused path: its filler is local row
    0)."""
    local = min(max(n_valid - shard * shard_size, 0), shard_size)
    q = brands.to(posts.device, non_blocking=True)
    if fused:
        v, i = topk_int8(q, posts, posts_inv, k, n_valid=local)
    else:
        v, i = retrieval_topk(q, posts, k, block=block, n_valid=local,
                              posts_inv=posts_inv)
    return v, i + shard * shard_size


def merge_shard_topk(vals: torch.Tensor, idxs: torch.Tensor, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shards' candidates, shard-major along dim 1 ((B, S * k) values
    and global indices) -> the top k by (value desc, index asc): a stable
    sort keeps the lower global row first among equal values, as
    `lax.top_k` over JAX's tiled all-gather keeps the lower position, so
    the answer is the single-device one."""
    v, sel = _topk_desc(vals, k)
    return v, torch.gather(idxs, 1, sel.long())


def _check_fused(fused: bool, shards, posts_inv) -> None:
    if fused and (posts_inv is None
                  or any(p.dtype != torch.int8 for p in shards)):
        raise ValueError("fused=True needs an int8 index + posts_inv")


def distributed_retrieval_topk(brands: torch.Tensor,
                               post_shards: Sequence[torch.Tensor], k: int,
                               *, n_valid: Optional[int] = None,
                               shard_size: Optional[int] = None,
                               posts_inv: Optional[Sequence[torch.Tensor]]
                               = None, fused: bool = False,
                               block: int = 4096
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k over posts split into shards, each on its own device: the JAX
    package's `distributed_retrieval_topk` from one process.

    Shard s runs `shard_topk` (posts_inv: one inverse-norm vector a shard,
    required when fused). Every shard is launched before anything waits on
    a device. The shards' candidates go to the first shard's device in
    shard order and `merge_shard_topk` merges them.
    -> (values (B, k) f32, indices (B, k) int32) on the first shard's
    device."""
    shards = list(post_shards)
    if not shards:
        raise ValueError("distributed_retrieval_topk needs a post shard")
    shard_size = shards[0].shape[0] if shard_size is None else shard_size
    if any(p.shape[0] != shard_size for p in shards):
        raise ValueError("every post shard must hold shard_size = %d rows, "
                         "got %s" % (shard_size,
                                     [p.shape[0] for p in shards]))
    invs = [None] * len(shards) if posts_inv is None else list(posts_inv)
    if len(invs) != len(shards):
        raise ValueError("posts_inv needs one vector a shard")
    _check_fused(fused, shards, posts_inv)
    n_valid = shard_size * len(shards) if n_valid is None else int(n_valid)
    home = shards[0].device
    vals, idxs = [], []
    for s, (posts, inv) in enumerate(zip(shards, invs)):
        v, i = shard_topk(brands, posts, k, shard=s, shard_size=shard_size,
                          n_valid=n_valid, posts_inv=inv, fused=fused,
                          block=block)
        vals.append(v.to(home, non_blocking=True))
        idxs.append(i.to(home, non_blocking=True))
    return merge_shard_topk(torch.cat(vals, 1), torch.cat(idxs, 1), k)


def ranked_retrieval_topk(brands: torch.Tensor, posts: torch.Tensor, k: int,
                          *, n_valid: int, posts_inv: Optional[torch.Tensor]
                          = None, fused: bool = False, block: int = 4096
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`distributed_retrieval_topk` over the ranks of a world: this rank
    holds post shard d (its data slot; every model rank of the slot holds
    the same shard, as the JAX mesh replicates a data shard over its model
    row), all shards of one size. It runs `shard_topk` on its own shard,
    the shards' candidates are gathered over the data group in slot order
    (`collectives.all_gather`; through host memory under gloo), and
    `merge_shard_topk` merges them. Every rank returns the same answer,
    the one-process answer over the same shards. A collective: every rank
    of the world calls it with the same brands and k."""
    _check_fused(fused, [posts], posts_inv)
    v, i = shard_topk(brands, posts, k, shard=collectives.data_rank(),
                      shard_size=posts.shape[0], n_valid=n_valid,
                      posts_inv=posts_inv, fused=fused, block=block)
    b = v.shape[0]
    # (S, B, k) in slot order -> (B, S * k), shard-major along the rows
    vals = collectives.all_gather(v[None]).permute(1, 0, 2).reshape(b, -1)
    idxs = collectives.all_gather(i[None]).permute(1, 0, 2).reshape(b, -1)
    return merge_shard_topk(vals, idxs, k)

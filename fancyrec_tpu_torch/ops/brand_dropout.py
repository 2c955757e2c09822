"""Fused brand-aspect dropout + mean: CUDA kernels + plain versions.

Port of the JAX package's Pallas kernels `aspect_dropout_mean` and its
backward `_adm_bwd` (fancyrec_tpu/ops/brand_pallas.py). The kernels are
`csrc/aspect_dropout.cu`; this module builds and binds them, keeps the
plain PyTorch version of each beside it, and joins the two passes in the
autograd function `aspect_dropout_mean`.

    out[b, c] = sum_a m[b, a, c] w[b, a] asp[a, c] / (A keep)

The keep mask m is Philox4x32-10 keyed by two seed words, element
(b, a, c) taking word e & 3 of the block at counter e >> 2, where
e = (b A + a) C + c, and m = (word <= thr). The plain versions draw the
same words with 32-bit arithmetic written in int64 16-bit limbs, so the
kernels and the plain versions drop the same elements bit for bit. The
TPU's hardware generator has no counterpart, so the masks differ from the
JAX package's (same distribution); tests hold the two at keep = 1.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from fancyrec_tpu_torch.ops import _build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Random123's Philox4x32 constants
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_CHUNK = 64                                 # aspects a plain-version pass


def _mulhilo(m: int, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) 32-bit halves of m * x for x in [0, 2^32) held in int64:
    16-bit limbs, so no product leaves int64's range."""
    m_lo, m_hi = m & 0xFFFF, m >> 16
    x_lo, x_hi = x & 0xFFFF, x >> 16
    ll, lh = x_lo * m_lo, x_lo * m_hi
    hl, hh = x_hi * m_lo, x_hi * m_hi
    mid = (ll >> 16) + (lh & 0xFFFF) + (hl & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (ll & 0xFFFF)
    hi = hh + (lh >> 16) + (hl >> 16) + (mid >> 16)
    return hi, lo


def philox4x32_10(counter: Sequence[torch.Tensor], key: Sequence[int]
                  ) -> Tuple[torch.Tensor, ...]:
    """Philox4x32-10 on int64 tensors holding 32-bit words: counter is 4
    broadcastable tensors, key 2 ints -> the 4 output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = int(key[0]) & _U32, int(key[1]) & _U32
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _U32, (k1 + _W1) & _U32
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(num_aspects: int, keep: float) -> Tuple[int, float]:
    """-> (thr, scale) as the TPU kernel's `_prep` computes them."""
    if not 0.0 < keep <= 1.0:
        raise ValueError("keep must lie in (0, 1], got %r" % (keep,))
    return min(int(keep * 2 ** 32) - 1, _U32), 1.0 / (num_aspects * keep)


def dropout_mask(seed: Sequence[int], thr: int, b: int, a: int, c: int,
                 a_lo: int, a_hi: int, device) -> torch.Tensor:
    """The keep mask of aspects [a_lo, a_hi) for all b rows and c columns:
    bool (b, a_hi - a_lo, c)."""
    rows = torch.arange(b, dtype=torch.int64, device=device)[:, None, None]
    asps = torch.arange(a_lo, a_hi, dtype=torch.int64,
                        device=device)[None, :, None]
    if c % 4 == 0:                    # one Philox block: 4 consecutive c
        groups = torch.arange(c // 4, dtype=torch.int64,
                              device=device)[None, None, :]
        q = (rows * a + asps) * (c // 4) + groups
        zero = torch.zeros_like(q)
        words = torch.stack(philox4x32_10(
            (q & _U32, q >> 32, zero, zero), seed), dim=-1)
        return (words <= thr).reshape(b, a_hi - a_lo, c)
    cols = torch.arange(c, dtype=torch.int64, device=device)[None, None, :]
    e = (rows * a + asps) * c + cols
    q = e >> 2
    zero = torch.zeros_like(q)
    words = torch.stack(philox4x32_10((q & _U32, q >> 32, zero, zero), seed),
                        dim=-1)
    return torch.gather(words, -1, (e & 3)[..., None])[..., 0] <= thr


def _check(w: torch.Tensor, asp: torch.Tensor, g: torch.Tensor = None):
    if w.dim() != 2 or asp.dim() != 2 or w.shape[1] != asp.shape[0]:
        raise ValueError("w must be (B, A) and asp (A, C), got %s and %s"
                         % (tuple(w.shape), tuple(asp.shape)))
    if g is not None and tuple(g.shape) != (w.shape[0], asp.shape[1]):
        raise ValueError("g must be (B, C) = %s, got %s"
                         % ((w.shape[0], asp.shape[1]), tuple(g.shape)))
    for x in (w, asp) + (() if g is None else (g,)):
        if x.dtype != torch.float32:
            raise ValueError("aspect dropout takes float32, got %s" % x.dtype)
        if x.device != w.device:
            raise ValueError("w, asp (and g) must be on one device")


def aspect_dropout_fwd_ref(w: torch.Tensor, asp: torch.Tensor,
                           seed: Sequence[int], keep: float) -> torch.Tensor:
    """Plain PyTorch version of the forward kernel: the mask materialised
    in chunks of aspects, never all at once."""
    _check(w, asp)
    b, a = w.shape
    c = asp.shape[1]
    thr, scale = keep_threshold(a, keep)
    out = torch.zeros((b, c), dtype=torch.float32, device=w.device)
    for lo in range(0, a, _CHUNK):
        hi = min(lo + _CHUNK, a)
        m = dropout_mask(seed, thr, b, a, c, lo, hi, w.device)
        prod = w[:, lo:hi, None] * asp[None, lo:hi]
        out = out + torch.where(m, prod, torch.zeros_like(prod)).sum(dim=1)
    return out * scale


def aspect_dropout_bwd_ref(w: torch.Tensor, asp: torch.Tensor,
                           g: torch.Tensor, seed: Sequence[int], keep: float
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward kernel -> (dw, dasp)."""
    _check(w, asp, g)
    b, a = w.shape
    c = asp.shape[1]
    thr, scale = keep_threshold(a, keep)
    dw = torch.empty_like(w)
    dasp = torch.empty_like(asp)
    for lo in range(0, a, _CHUNK):
        hi = min(lo + _CHUNK, a)
        m = dropout_mask(seed, thr, b, a, c, lo, hi, w.device)
        mg = torch.where(m, g[:, None, :], torch.zeros((), device=g.device))
        dw[:, lo:hi] = (mg * asp[None, lo:hi]).sum(dim=2) * scale
        dasp[lo:hi] = (mg * w[:, lo:hi, None]).sum(dim=0) * scale
    return dw, dasp


def _launch(name: str, args, w: torch.Tensor):
    lib = _build.load("aspect_dropout")
    fn = getattr(lib, name)
    n_ptr = len(args) - 7
    fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 3
                   + [ctypes.c_uint] * 3 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(w.device):
        stream = torch.cuda.current_stream(w.device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))


def _cuda_args(w: torch.Tensor, asp: torch.Tensor, seed, keep):
    if w.device.type != "cuda":
        raise ValueError("the aspect dropout kernels need CUDA tensors, got %s"
                         % w.device)
    b, a = w.shape
    c = asp.shape[1]
    thr, scale = keep_threshold(a, keep)
    return (b, a, c, int(seed[0]) & _U32, int(seed[1]) & _U32, thr, scale)


def aspect_dropout_fwd_cuda(w: torch.Tensor, asp: torch.Tensor,
                            seed: Sequence[int], keep: float) -> torch.Tensor:
    """Launch the forward kernel of `csrc/aspect_dropout.cu`."""
    _check(w, asp)
    shape = _cuda_args(w, asp, seed, keep)
    w, asp = w.contiguous(), asp.contiguous()
    out = torch.empty((w.shape[0], asp.shape[1]), dtype=torch.float32,
                      device=w.device)
    if out.numel() == 0 or w.shape[1] == 0:
        return out.zero_()
    _launch("aspect_dropout_fwd",
            (w.data_ptr(), asp.data_ptr(), out.data_ptr()) + shape, w)
    aspect_dropout_fwd_cuda.launches += 1
    return out


aspect_dropout_fwd_cuda.launches = 0


def aspect_dropout_bwd_cuda(w: torch.Tensor, asp: torch.Tensor,
                            g: torch.Tensor, seed: Sequence[int], keep: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel of `csrc/aspect_dropout.cu` -> (dw, dasp)."""
    _check(w, asp, g)
    shape = _cuda_args(w, asp, seed, keep)
    w, asp, g = w.contiguous(), asp.contiguous(), g.contiguous()
    dw = torch.empty_like(w)
    dasp = torch.empty_like(asp)
    if w.numel() == 0 or asp.numel() == 0:
        return dw.zero_(), dasp.zero_()
    _launch("aspect_dropout_bwd",
            (w.data_ptr(), asp.data_ptr(), g.data_ptr(), dw.data_ptr(),
             dasp.data_ptr()) + shape, w)
    aspect_dropout_bwd_cuda.launches += 1
    return dw, dasp


aspect_dropout_bwd_cuda.launches = 0


class _AspectDropoutMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, asp, seed, keep):
        ctx.save_for_backward(w, asp)
        ctx.seed, ctx.keep = seed, keep
        fwd = (aspect_dropout_fwd_ref if w.device.type == "cpu"
               else aspect_dropout_fwd_cuda)
        return fwd(w, asp, seed, keep)

    @staticmethod
    def backward(ctx, g):
        w, asp = ctx.saved_tensors
        bwd = (aspect_dropout_bwd_ref if w.device.type == "cpu"
               else aspect_dropout_bwd_cuda)
        dw, dasp = bwd(w, asp, g.contiguous(), ctx.seed, ctx.keep)
        return dw, dasp, None, None


def aspect_dropout_mean(w: torch.Tensor, asp: torch.Tensor,
                        seed: Sequence[int], keep: float = 0.5
                        ) -> torch.Tensor:
    """Mean over aspects of dropout(w[:, :, None] * asp[None]), fused and
    differentiable in w and asp: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors.

    w: (B, A) aspect weights, asp: (A, C) aspect matrix, float32; seed: two
    32-bit key words; keep: the keep probability. -> (B, C) float32."""
    return _AspectDropoutMean.apply(w, asp, tuple(int(s) for s in seed), keep)

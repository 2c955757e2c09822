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

The forward also gives the mask as packed keep bits (`pack_keep_bits`),
which the autograd function saves and its backward reads: the backward
draws nothing. The plain versions do the same on the CPU.

An aspect shard. Under tensor parallelism a model rank holds aspects
[a_off, a_off + A_local) of a table of `a_total` aspects (w's columns and
asp's rows). Every entry point takes `a_total` and `a_off` (default: the
whole table): the scale is 1 / (a_total keep) and element (b, a, c) of the
shard draws the counter of global aspect a_off + a in a table of a_total,
so the keep masks of the shards are the slices of the whole table's mask
and their outputs sum to its output. The bits stay the shard's own.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

from fancyrec_tpu_torch.ops import _build

_M0, _M1 = 0xD2511F53, 0xCD9E8D57          # Random123's Philox4x32 constants
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_U32 = 0xFFFFFFFF
_CHUNK = 64                                 # aspects a plain-version pass
_F_COLS, _F_ROWS, _F_WARPS = 128, 8, 8      # the forward kernel's block
_F_MAX_SPAN = 256                           # aspects a split, at most
_B_ASP, _S_COLS = 4, 1024                   # the backward's group, and the
                                            # columns its streamed block takes


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


@functools.lru_cache(maxsize=256)
def keep_threshold(num_aspects: int, keep: float) -> Tuple[int, float]:
    """-> (thr, scale) as the TPU kernel's `_prep` computes them."""
    if not 0.0 < keep <= 1.0:
        raise ValueError("keep must lie in (0, 1], got %r" % (keep,))
    return min(int(keep * 2 ** 32) - 1, _U32), 1.0 / (num_aspects * keep)


def dropout_mask(seed: Sequence[int], thr: int, b: int, a: int, c: int,
                 a_lo: int, a_hi: int, device) -> torch.Tensor:
    """The keep mask of aspects [a_lo, a_hi) of a table of a aspects, for
    all b rows and c columns: bool (b, a_hi - a_lo, c). A shard's mask is
    the slice of its global aspects, with a the table's full A."""
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


def _span(w: torch.Tensor, a_total, a_off: int) -> Tuple[int, int]:
    """-> (a_total, a_off) with the defaults of the whole table filled in;
    raises for a shard outside its table."""
    a = w.shape[1]
    a_total = a if a_total is None else int(a_total)
    a_off = int(a_off)
    if a_off < 0 or a_off + a > a_total:
        raise ValueError("aspects [%d, %d) lie outside a table of %d"
                         % (a_off, a_off + a, a_total))
    return a_total, a_off


def _check(w: torch.Tensor, asp: torch.Tensor, g: torch.Tensor = None):
    ws, asps = w.shape, asp.shape
    if len(ws) != 2 or len(asps) != 2 or ws[1] != asps[0]:
        raise ValueError("w must be (B, A) and asp (A, C), got %s and %s"
                         % (tuple(ws), tuple(asps)))
    if g is not None and g.shape != (ws[0], asps[1]):
        raise ValueError("g must be (B, C) = %s, got %s"
                         % ((ws[0], asps[1]), tuple(g.shape)))
    f32, dev = torch.float32, w.get_device()
    for x in (w, asp) + (() if g is None else (g,)):
        if x.dtype is not f32:
            raise ValueError("aspect dropout takes float32, got %s" % x.dtype)
        if x.get_device() != dev:
            raise ValueError("w, asp (and g) must be on one device")


def pack_keep_bits(mask: torch.Tensor) -> torch.Tensor:
    """Bool (..., C) -> int32 (..., ceil(C / 32)): bit c & 31 of word c >> 5
    set where element c is kept, the tail bits past C zero."""
    c = mask.shape[-1]
    words = -(-c // 32)
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, 32 * words - c))
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) \
        << torch.arange(32, dtype=torch.int64, device=mask.device)
    packed = (m.reshape(*mask.shape[:-1], words, 32) * weights).sum(dim=-1)
    return (packed - ((packed >> 31) << 32)).to(torch.int32)


def unpack_keep_bits(bits: torch.Tensor, c: int) -> torch.Tensor:
    """The inverse of `pack_keep_bits`: int32 (..., W) -> bool (..., c)."""
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    m = (bits.to(torch.int64)[..., None] >> shifts) & 1
    return m.reshape(*bits.shape[:-1], -1)[..., :c].bool()


def aspect_dropout_fwd_ref(w: torch.Tensor, asp: torch.Tensor,
                           seed: Sequence[int], keep: float,
                           with_bits: bool = False, a_total: int = None,
                           a_off: int = 0):
    """Plain PyTorch version of the forward kernel: the mask materialised
    in chunks of aspects, never all at once. -> out, or (out, bits) with
    the packed keep bits (B, A, ceil(C / 32)) when `with_bits`. w and asp
    may hold aspects [a_off, a_off + A) of a table of a_total."""
    _check(w, asp)
    b, a = w.shape
    c = asp.shape[1]
    a_total, a_off = _span(w, a_total, a_off)
    thr, scale = keep_threshold(a_total, keep)
    out = torch.zeros((b, c), dtype=torch.float32, device=w.device)
    bits = (torch.empty((b, a, -(-c // 32)), dtype=torch.int32,
                        device=w.device) if with_bits else None)
    for lo in range(0, a, _CHUNK):
        hi = min(lo + _CHUNK, a)
        m = dropout_mask(seed, thr, b, a_total, c, a_off + lo, a_off + hi,
                         w.device)
        prod = w[:, lo:hi, None] * asp[None, lo:hi]
        out = out + torch.where(m, prod, torch.zeros_like(prod)).sum(dim=1)
        if with_bits:
            bits[:, lo:hi] = pack_keep_bits(m)
    return (out * scale, bits) if with_bits else out * scale


def _bwd_from_masks(w, asp, g, keep, a_total, mask_of):
    """(dw, dasp) with the keep mask of the local aspects [lo, hi) from
    mask_of(lo, hi): one sum order for both plain backwards."""
    a = w.shape[1]
    _, scale = keep_threshold(a_total, keep)
    dw = torch.empty_like(w)
    dasp = torch.empty_like(asp)
    for lo in range(0, a, _CHUNK):
        hi = min(lo + _CHUNK, a)
        m = mask_of(lo, hi)
        mg = torch.where(m, g[:, None, :], torch.zeros((), device=g.device))
        dw[:, lo:hi] = (mg * asp[None, lo:hi]).sum(dim=2) * scale
        dasp[lo:hi] = (mg * w[:, lo:hi, None]).sum(dim=0) * scale
    return dw, dasp


def aspect_dropout_bwd_ref(w: torch.Tensor, asp: torch.Tensor,
                           g: torch.Tensor, seed: Sequence[int], keep: float,
                           a_total: int = None, a_off: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain backward that redraws the mask from the seed -> (dw, dasp)."""
    _check(w, asp, g)
    b = w.shape[0]
    c = asp.shape[1]
    a_total, a_off = _span(w, a_total, a_off)
    thr, _ = keep_threshold(a_total, keep)
    return _bwd_from_masks(w, asp, g, keep, a_total, lambda lo, hi:
                           dropout_mask(seed, thr, b, a_total, c, a_off + lo,
                                        a_off + hi, w.device))


def _check_bits(w: torch.Tensor, asp: torch.Tensor, bits: torch.Tensor):
    want = (w.shape[0], w.shape[1], -(-asp.shape[1] // 32))
    if not isinstance(bits, torch.Tensor) or bits.shape != want \
            or bits.dtype is not torch.int32 \
            or bits.get_device() != w.get_device():
        raise ValueError("bits must be int32 %s on %s, got %s" % (
            want, w.device, (tuple(bits.shape), bits.dtype, bits.device)
            if isinstance(bits, torch.Tensor) else type(bits)))


def aspect_dropout_bwd_bits_ref(w: torch.Tensor, asp: torch.Tensor,
                                g: torch.Tensor, bits: torch.Tensor,
                                keep: float, a_total: int = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel: the mask from the forward's
    packed keep bits -> (dw, dasp), bit for bit those of
    `aspect_dropout_bwd_ref` on the seed that drew the bits. A shard's
    bits are its own; a_total gives the scale."""
    _check(w, asp, g)
    _check_bits(w, asp, bits)
    c = asp.shape[1]
    a_total, _ = _span(w, a_total, 0)
    return _bwd_from_masks(w, asp, g, keep, a_total, lambda lo, hi:
                           unpack_keep_bits(bits[:, lo:hi], c))


class AdmPlan(NamedTuple):
    """K2's launches. The forward: A in `splits` spans of `span` aspects
    (blocks along A), the splits' sums in `scratch_floats` floats of
    scratch, splits x B x (C rounded up to 128). The backward: `bwd_blocks`
    persistent blocks of the streamed kernel taking A's groups of 4 aspects
    in turn, or, where 0, a block a group."""
    splits: int
    span: int
    scratch_floats: int
    bwd_blocks: int


@functools.lru_cache(maxsize=256)
def aspect_dropout_plan(b: int, a: int, c: int, sms: int) -> AdmPlan:
    """The launches for B = b, A = a, C = c on a card of `sms` SMs. The
    forward: enough spans of A for one wave of two blocks an SM over the
    blocks' 128-column, 8-row tiles; a span a whole number of aspects a
    warp (8) and at most 256 aspects (the block's w tile in shared memory).
    The backward: streamed, two blocks an SM, where its block takes the
    shape (C % 4 == 0, C <= 1024, B <= 8), else a block a group."""
    tiles = -(-c // _F_COLS) * -(-b // _F_ROWS)
    want = max(1, -(-2 * sms // tiles))
    span = -(-max(1, -(-a // want)) // _F_WARPS) * _F_WARPS
    span = min(span, _F_MAX_SPAN)
    splits = -(-a // span)
    streamed = c % 4 == 0 and c <= _S_COLS and b <= _F_ROWS
    return AdmPlan(splits, span, splits * b * -(-c // _F_COLS) * _F_COLS,
                   min(-(-a // _B_ASP), 2 * sms) if streamed else 0)


def _fwd_fn():
    fn = _build.load("aspect_dropout").aspect_dropout_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7 + [ctypes.c_void_p, ctypes.c_uint]
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _bwd_fn():
    fn = _build.load("aspect_dropout").aspect_dropout_bwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def key_words(seed, device: torch.device) -> torch.Tensor:
    """The two seed words as the int64 (2,) tensor on `device` that K2's
    forward reads its key from: a contiguous int64 (2,) tensor already
    there as it is; ints, or a tensor elsewhere, through page-locked
    memory without waiting for the device (PyTorch's pinned-memory cache
    does not hand the block out again before the copy has run)."""
    if (isinstance(seed, torch.Tensor) and seed.device == device
            and seed.dtype is torch.int64 and seed.shape == (2,)
            and seed.is_contiguous()):
        return seed
    words = [int(s) & _U32 for s in seed]
    if len(words) != 2:
        raise ValueError("the seed is two key words, got %d" % len(words))
    return torch.tensor(words, dtype=torch.int64, pin_memory=True).to(
        device, non_blocking=True)


def aspect_dropout_fwd_args(w, asp, out, bits, scratch, key, keep, plan,
                            a_total=None, a_off=0):
    """The arguments of K2's forward C entry `aspect_dropout_fwd` for
    contiguous CUDA tensors and a plan, on the current stream of w's card;
    bits None writes no keep bits; key: the seed words on w's card
    (`key_words`), which the caller keeps alive while the arguments are in
    use. w and asp may hold aspects [a_off, a_off + A) of a table of
    a_total."""
    b, a = w.shape
    a_total, a_off = _span(w, a_total, a_off)
    thr, scale = keep_threshold(a_total, keep)
    return (w.data_ptr(), asp.data_ptr(), out.data_ptr(),
            None if bits is None else bits.data_ptr(), scratch.data_ptr(),
            plan.scratch_floats, b, a, asp.shape[1], a_total, a_off,
            plan.splits, plan.span, key.data_ptr(), thr, scale,
            _build.raw_stream(w.device))


def aspect_dropout_bwd_args(w, asp, g, bits, dw, dasp, keep, plan,
                            a_total=None):
    """The arguments of K2's backward C entry `aspect_dropout_bwd` for
    contiguous CUDA tensors and a plan, on the current stream of w's card.
    The backward reads the shard's own bits: of a shard it needs only the
    table's a_total, in the scale."""
    b, a = w.shape
    a_total, _ = _span(w, a_total, 0)
    return (w.data_ptr(), asp.data_ptr(), g.data_ptr(), bits.data_ptr(),
            dw.data_ptr(), dasp.data_ptr(), b, a, asp.shape[1],
            plan.bwd_blocks, keep_threshold(a_total, keep)[1],
            _build.raw_stream(w.device))


def _run(name: str, fn, args, dev: torch.device):
    err = _build.call_on(dev, fn, args)
    if err:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (name, err))


def _need_cuda(w: torch.Tensor):
    if not w.is_cuda:
        raise ValueError("the aspect dropout kernels need CUDA tensors, got %s"
                         % w.device)


def aspect_dropout_fwd_cuda(w: torch.Tensor, asp: torch.Tensor,
                            seed: Sequence[int], keep: float,
                            with_bits: bool = False, a_total: int = None,
                            a_off: int = 0):
    """Launch the forward kernel of `csrc/aspect_dropout.cu` (and the sum of
    its splits) -> out, or (out, bits) when `with_bits`, as
    `aspect_dropout_fwd_ref`."""
    _check(w, asp)
    _need_cuda(w)
    a_total, a_off = _span(w, a_total, a_off)
    b, a = w.shape
    c = asp.shape[1]
    w, asp = w.contiguous(), asp.contiguous()
    dev = w.device
    out = torch.empty((b, c), dtype=torch.float32, device=dev)
    bits = (torch.empty((b, a, -(-c // 32)), dtype=torch.int32, device=dev)
            if with_bits else None)
    if b == 0 or a == 0 or c == 0:
        keep_threshold(a_total, keep)           # refuses a keep out of range
        out.zero_()
        return (out, bits.zero_()) if with_bits else out
    plan = aspect_dropout_plan(b, a, c, _build.sm_count(dev))
    scratch = torch.empty(plan.scratch_floats, dtype=torch.float32,
                          device=dev)
    key = key_words(seed, dev)
    _run("aspect_dropout_fwd", _fwd_fn(), aspect_dropout_fwd_args(
        w, asp, out, bits, scratch, key, keep, plan, a_total, a_off), dev)
    aspect_dropout_fwd_cuda.launches += 1
    return (out, bits) if with_bits else out


aspect_dropout_fwd_cuda.launches = 0


def aspect_dropout_bwd_cuda(w: torch.Tensor, asp: torch.Tensor,
                            g: torch.Tensor, bits: torch.Tensor, keep: float,
                            a_total: int = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel of `csrc/aspect_dropout.cu` on the keep
    bits the forward wrote -> (dw, dasp); a_total as in
    `aspect_dropout_bwd_bits_ref`."""
    _check(w, asp, g)
    _need_cuda(w)
    _check_bits(w, asp, bits)
    a_total, _ = _span(w, a_total, 0)
    b, a = w.shape
    c = asp.shape[1]
    w, asp, g = w.contiguous(), asp.contiguous(), g.contiguous()
    bits = bits.contiguous()
    dw = torch.empty_like(w)
    dasp = torch.empty_like(asp)
    if b == 0 or a == 0 or c == 0:
        keep_threshold(a_total, keep)
        return dw.zero_(), dasp.zero_()
    dev = w.device
    plan = aspect_dropout_plan(b, a, c, _build.sm_count(dev))
    _run("aspect_dropout_bwd", _bwd_fn(), aspect_dropout_bwd_args(
        w, asp, g, bits, dw, dasp, keep, plan, a_total), dev)
    aspect_dropout_bwd_cuda.launches += 1
    return dw, dasp


aspect_dropout_bwd_cuda.launches = 0


def _fwd_of(w: torch.Tensor):
    return (aspect_dropout_fwd_ref if w.device.type == "cpu"
            else aspect_dropout_fwd_cuda)


class _AspectDropoutMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, asp, seed, keep, a_total, a_off):
        out, bits = _fwd_of(w)(w, asp, seed, keep, with_bits=True,
                               a_total=a_total, a_off=a_off)
        ctx.save_for_backward(w, asp, bits)
        ctx.keep, ctx.a_total = keep, a_total
        return out

    @staticmethod
    def backward(ctx, g):
        w, asp, bits = ctx.saved_tensors
        bwd = (aspect_dropout_bwd_bits_ref if w.device.type == "cpu"
               else aspect_dropout_bwd_cuda)
        args = (w, asp, g.contiguous(), bits, ctx.keep)
        # a shard's scale is its table's
        dw, dasp = (bwd(*args) if ctx.a_total == w.shape[1]
                    else bwd(*args, a_total=ctx.a_total))
        return dw, dasp, None, None, None, None


def aspect_dropout_mean(w: torch.Tensor, asp: torch.Tensor,
                        seed: Sequence[int], keep: float = 0.5,
                        a_total: int = None, a_off: int = 0
                        ) -> torch.Tensor:
    """Mean over aspects of dropout(w[:, :, None] * asp[None]), fused and
    differentiable in w and asp: the CUDA kernels for CUDA tensors, the
    plain versions for CPU tensors.

    w: (B, A) aspect weights, asp: (A, C) aspect matrix, float32; seed: two
    32-bit key words, as ints or an int64 tensor of two (on the card, one
    on w's device is read there: a CUDA graph's replay takes the words its
    caller wrote into it); keep: the keep probability. -> (B, C) float32.
    On an aspect shard (aspects [a_off, a_off + A) of a_total), this
    shard's share of the whole table's output: the shards' outputs sum to
    it."""
    if not isinstance(seed, torch.Tensor):
        seed = tuple(int(s) for s in seed)
    a_total, a_off = _span(w, a_total, a_off)
    if torch.is_grad_enabled() and (w.requires_grad or asp.requires_grad):
        return _AspectDropoutMean.apply(w, asp, seed, keep, a_total, a_off)
    return _fwd_of(w)(w, asp, seed, keep, a_total=a_total, a_off=a_off)

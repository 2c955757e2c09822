"""K5: the routed experts of a MoE layer, over rows sorted by expert.

The JAX package has no routed layer, so K5 replaces no TPU kernel; it
was added for the DeepSeek-V2 caption tower (models/deepseek_v2.py). The
kernels are `csrc/moe_gemm.cu`; this module builds and binds them, keeps
the plain PyTorch version of each beside it, and joins them in the
autograd function `moe_experts`. Around them, with no host sync anywhere
(the training update is one CUDA graph, `train/step.py`):

    route(topk_idx, valid, E)  the (token, slot) pairs sorted by expert on
        the device, pad tokens' slots keyed past the last expert; segment
        offsets by `searchsorted`, the inverse permutation by a scatter of
        unique indices.
    dispatch(x, r)    the sorted rows x[token of row]; its backward sums a
        token's k rows in slot order by a gather (no atomics).
    combine(y, w, r)  each token's k rows weighted and summed in slot
        order, gathered through the inverse permutation; its backward
        gathers too.
    moe_experts(xs, off, w13, w2)  down(silu(gate xs) * up xs) per segment,
        w13 (E, 2F, D) the experts' gate rows then up rows, w2 (E, D, F).
        Its backward writes dX and adds dW into w13.grad and w2.grad in
        place, because the update sums its microbatches' gradients there;
        it returns no gradient for them.

The plain versions read the offsets on the host; the wrappers take them
only for CPU tensors and launch the kernels, or raise, for CUDA tensors.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from fancyrec_tpu_torch.ops import _build

NT_STORE, NT_SWIGLU, NN_STORE, NN_DSWIGLU = 0, 1, 2, 3


class Routing(NamedTuple):
    slot_of_row: torch.Tensor   # (R,) int64: the flat (token, slot) of row r
    inv: torch.Tensor           # (R,) int64: the row of flat slot s
    offsets: torch.Tensor       # (E + 1,) int64: expert e's rows start here;
                                # offsets[E] is where the pad slots start
    counts: torch.Tensor        # (E + 1,) int64: rows of each expert, pads last
    k: int                      # slots a token


def route(topk_idx: torch.Tensor, valid: torch.Tensor, n_experts: int
          ) -> Routing:
    """topk_idx (N, k) int64, valid (N,) bool -> the rows sorted by expert,
    stably (a token's slots in order, tokens in order within an expert),
    the slots of invalid tokens last."""
    n, k = topk_idx.shape
    keys = torch.where(valid[:, None], topk_idx,
                       torch.full_like(topk_idx, n_experts)).reshape(-1)
    sorted_keys, slot_of_row = torch.sort(keys, stable=True)
    bounds = torch.arange(n_experts + 1, device=keys.device,
                          dtype=sorted_keys.dtype)
    offsets = torch.searchsorted(sorted_keys, bounds)
    total = torch.full((1,), n * k, dtype=offsets.dtype, device=keys.device)
    counts = torch.diff(offsets, append=total)
    rows = torch.arange(n * k, device=keys.device)
    inv = torch.empty_like(slot_of_row).scatter_(0, slot_of_row, rows)
    return Routing(slot_of_row, inv, offsets, counts, k)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, token_of_row, inv, k):
        ctx.save_for_backward(inv)
        ctx.k = k
        return x.index_select(0, token_of_row)

    @staticmethod
    def backward(ctx, dxs):
        (inv,) = ctx.saved_tensors
        d = dxs.shape[1]
        return (dxs.index_select(0, inv).view(-1, ctx.k, d).sum(dim=1),
                None, None, None)


def dispatch(x: torch.Tensor, r: Routing) -> torch.Tensor:
    """x (N, D) -> the sorted rows (N k, D): row i is x[slot_of_row[i] // k]."""
    return _Dispatch.apply(x, torch.div(r.slot_of_row, r.k,
                                        rounding_mode="floor"), r.inv, r.k)


class _Combine(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ys, w, inv, slot_of_row):
        n, k = w.shape
        yk = ys.index_select(0, inv).view(n, k, ys.shape[1])
        ctx.save_for_backward(yk, w, slot_of_row)
        return (yk * w[..., None]).sum(dim=1)

    @staticmethod
    def backward(ctx, g):
        yk, w, slot_of_row = ctx.saved_tensors
        n, k, d = yk.shape
        dys = (g[:, None, :] * w[..., None]).reshape(n * k, d).index_select(
            0, slot_of_row)
        dw = (yk * g[:, None, :]).sum(dim=-1)
        return dys, dw, None, None


def combine(ys: torch.Tensor, w: torch.Tensor, r: Routing) -> torch.Tensor:
    """ys (N k, D) sorted rows, w (N, k) -> (N, D): sum over s of
    w[t, s] ys[inv[t k + s]], in slot order."""
    return _Combine.apply(ys, w, r.inv, r.slot_of_row)


# -- the plain versions ------------------------------------------------------

def _segments(off: torch.Tensor):
    o = off.tolist()
    return [(e, o[e], o[e + 1]) for e in range(len(o) - 1)]


def moe_rows_ref(a: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                 mode: int, gu: torch.Tensor = None):
    """Plain version of `moe_rows_cuda`: a loop over the experts. -> C, or
    (gu, act) for NT_SWIGLU; the pad rows are zero."""
    r = a.shape[0]
    n_w = w.shape[1] if mode in (NT_STORE, NT_SWIGLU) else w.shape[2]
    width = n_w if mode != NN_DSWIGLU else 2 * n_w
    out = a.new_zeros((r, width))
    act = a.new_zeros((r, n_w // 2)) if mode == NT_SWIGLU else None
    for e, lo, hi in _segments(off):
        if hi <= lo:
            continue
        y = a[lo:hi] @ (w[e].t() if mode in (NT_STORE, NT_SWIGLU) else w[e])
        if mode == NT_SWIGLU:
            f = n_w // 2
            act[lo:hi] = F.silu(y[:, :f]) * y[:, f:]
        elif mode == NN_DSWIGLU:
            g, u = gu[lo:hi, :n_w], gu[lo:hi, n_w:]
            s = torch.sigmoid(g)
            y = torch.cat([y * u * (s * (1.0 + g * (1.0 - s))), y * (g * s)],
                          dim=1)
        out[lo:hi] = y
    return (out, act) if mode == NT_SWIGLU else out


def moe_wgrad_ref(g: torch.Tensor, x: torch.Tensor, off: torch.Tensor,
                  dw: torch.Tensor) -> None:
    """Plain version of `moe_wgrad_cuda`: dw[e] += g[seg]^T x[seg]."""
    for e, lo, hi in _segments(off):
        if hi > lo:
            dw[e] += g[lo:hi].t() @ x[lo:hi]


# -- the kernels -------------------------------------------------------------

def _check_f32(where: str, **tensors) -> None:
    dev = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError("%s needs CUDA tensors, got %s on %s"
                             % (where, name, t.device))
        if t.dtype != (torch.int64 if name == "off" else torch.float32):
            raise ValueError("%s: %s must be %s, got %s" % (
                where, name, "int64" if name == "off" else "float32",
                t.dtype))
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("%s: %s must be contiguous and 16-byte "
                             "aligned" % (where, name))
        if dev is not None and t.device != dev:
            raise ValueError("%s: the inputs must be on one device" % where)
        dev = t.device


def moe_rows_cuda(a: torch.Tensor, w: torch.Tensor, off: torch.Tensor,
                  mode: int, gu: torch.Tensor = None):
    """Launch `moe_rows` of `csrc/moe_gemm.cu` on the current stream: one
    launch -> as `moe_rows_ref`."""
    _check_f32("moe_rows_cuda", a=a, w=w, off=off,
               **({"gu": gu} if mode == NN_DSWIGLU else {}))
    e, r, k = w.shape[0], a.shape[0], a.shape[1]
    if mode in (NT_STORE, NT_SWIGLU):
        n = w.shape[1] // 2 if mode == NT_SWIGLU else w.shape[1]
        if tuple(w.shape[1:]) != ((2 * n if mode == NT_SWIGLU else n), k):
            raise ValueError("moe_rows_cuda: w must be (E, N, K) for a of "
                             "(R, %d), got %s" % (k, tuple(w.shape)))
    else:
        n = w.shape[2]
        if w.shape[1] != k:
            raise ValueError("moe_rows_cuda: w must be (E, K, N) for a of "
                             "(R, %d), got %s" % (k, tuple(w.shape)))
    if tuple(off.shape) != (e + 1,):
        raise ValueError("moe_rows_cuda: off must be (E + 1,) = (%d,), got %s"
                         % (e + 1, tuple(off.shape)))
    if n % 4 or k % 4:
        raise ValueError("moe_rows_cuda: N=%d and K=%d must be multiples of "
                         "4" % (n, k))
    if mode == NN_DSWIGLU and tuple(gu.shape) != (r, 2 * n):
        raise ValueError("moe_rows_cuda: gu must be (R, 2N) = %s, got %s"
                         % ((r, 2 * n), tuple(gu.shape)))
    wide = mode in (NT_SWIGLU, NN_DSWIGLU)
    out = torch.empty((r, 2 * n if wide else n), dtype=torch.float32,
                      device=a.device)
    act = (torch.empty((r, n), dtype=torch.float32, device=a.device)
           if mode == NT_SWIGLU else None)
    lib = _build.load("moe_gemm")
    fn = lib.moe_rows
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
    fn.restype = ctypes.c_int
    err = _build.call_on(a.device, fn, (
        a.data_ptr(), w.data_ptr(), off.data_ptr(), e, r, n, k, mode,
        out.data_ptr(), act.data_ptr() if act is not None else None,
        gu.data_ptr() if mode == NN_DSWIGLU else None,
        _build.raw_stream(a.device)))
    if err:
        raise RuntimeError("moe_rows kernel launch failed: CUDA error %d"
                           % err)
    moe_rows_cuda.launches += 1
    return (out, act) if mode == NT_SWIGLU else out


moe_rows_cuda.launches = 0


def moe_wgrad_cuda(g: torch.Tensor, x: torch.Tensor, off: torch.Tensor,
                   dw: torch.Tensor) -> None:
    """Launch `moe_wgrad` of `csrc/moe_gemm.cu`: dw[e] += g[seg]^T x[seg]
    in place, one launch."""
    _check_f32("moe_wgrad_cuda", g=g, x=x, off=off, dw=dw)
    e, n, kw = dw.shape
    if (g.shape[0] != x.shape[0] or g.shape[1] != n or x.shape[1] != kw
            or tuple(off.shape) != (e + 1,)):
        raise ValueError("moe_wgrad_cuda: g (R, N), x (R, Kw), off (E + 1,) "
                         "for dw (E, N, Kw) = %s; got %s, %s, %s"
                         % (tuple(dw.shape), tuple(g.shape), tuple(x.shape),
                            tuple(off.shape)))
    if n % 4 or kw % 4:
        raise ValueError("moe_wgrad_cuda: N=%d and Kw=%d must be multiples "
                         "of 4" % (n, kw))
    lib = _build.load("moe_gemm")
    fn = lib.moe_wgrad
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                   + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    err = _build.call_on(g.device, fn, (
        g.data_ptr(), x.data_ptr(), off.data_ptr(), e, n, kw, dw.data_ptr(),
        _build.raw_stream(g.device)))
    if err:
        raise RuntimeError("moe_wgrad kernel launch failed: CUDA error %d"
                           % err)
    moe_wgrad_cuda.launches += 1


moe_wgrad_cuda.launches = 0


def moe_rows(a, w, off, mode, gu=None):
    """The kernel for CUDA tensors, the plain version for CPU tensors."""
    if a.device.type == "cpu":
        return moe_rows_ref(a, w, off, mode, gu)
    return moe_rows_cuda(a, w, off, mode, gu)


def moe_wgrad(g, x, off, dw):
    if g.device.type == "cpu":
        return moe_wgrad_ref(g, x, off, dw)
    return moe_wgrad_cuda(g, x, off, dw)


def _grad_of(p: torch.Tensor) -> torch.Tensor:
    """p.grad, made (zeros) where the update has none yet."""
    if p.grad is None:
        p.grad = torch.zeros_like(p)
    return p.grad


class _Experts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, xs, off, w13, w2):
        gu, act = moe_rows(xs, w13, off, NT_SWIGLU)
        ys = moe_rows(act, w2, off, NT_STORE)
        ctx.save_for_backward(xs, off, gu, act)
        ctx.weights = (w13, w2)
        return ys

    @staticmethod
    def backward(ctx, dys):
        xs, off, gu, act = ctx.saved_tensors
        w13, w2 = ctx.weights
        dys = dys.contiguous()
        dgu = moe_rows(dys, w2, off, NN_DSWIGLU, gu)
        dxs = moe_rows(dgu, w13, off, NN_STORE) \
            if ctx.needs_input_grad[0] else None
        if w2.requires_grad:
            moe_wgrad(dys, act, off, _grad_of(w2))
        if w13.requires_grad:
            moe_wgrad(dgu, xs, off, _grad_of(w13))
        return dxs, None, None, None


def moe_experts(xs: torch.Tensor, off: torch.Tensor, w13: torch.Tensor,
                w2: torch.Tensor) -> torch.Tensor:
    """xs (R, D) rows sorted by expert, off (E + 1,) -> (R, D): row r of
    expert e is w2[e] (silu(g) * u), [g; u] = w13[e] xs[r]; pad rows zero.
    Differentiable in xs; the weights' gradients are added into their
    .grad in place (see the module's docstring)."""
    return _Experts.apply(xs, off, w13, w2)

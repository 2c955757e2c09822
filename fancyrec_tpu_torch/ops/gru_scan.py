"""The bi-GRU recurrence (both directions, h0 = 0): CUDA kernels + plain versions.

Port of the JAX package's Pallas kernel `gru_scan_pallas` and its backward
`_gru_bwd` (fancyrec_tpu/ops/gru_scan.py). The kernels are
`csrc/gru_scan.cu`; this module builds and binds them, keeps the plain
PyTorch version of each beside it, and joins the two passes in the
autograd function `gru_scan`.

    xw   (T, 2, B, 3H)  input projections (+ b_ih), float32 or bfloat16
    w_hh (2, 3H, H)     cast to xw's dtype
    b_hh (2, 3H)        kept in float32
    ->   (T, 2, B, H)   in xw's dtype

Gate math is torch.nn.GRU's (see fancyrec_tpu_torch/models/gru.py) with the
dot products and gates in float32 and h stored in the activation dtype,
as the TPU kernel does.
"""

from __future__ import annotations

import ctypes

import torch

from fancyrec_tpu_torch.ops import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def gru_scan_ref(xw: torch.Tensor, w_hh: torch.Tensor,
                 b_hh: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: a loop over T of the batched gate math."""
    t, _, b, g3 = xw.shape
    hidden = g3 // 3
    dt = xw.dtype
    w = w_hh.to(dt).float()                          # (2, 3H, H)
    bias = b_hh.float()[:, None, :]                  # (2, 1, 3H)
    h = torch.zeros((2, b, hidden), dtype=dt, device=xw.device)
    out = torch.empty((t, 2, b, hidden), dtype=dt, device=xw.device)
    for s in range(t):
        h32 = h.float()
        hw = torch.einsum("dbh,dgh->dbg", h32, w) + bias
        x = xw[s].float()
        r = torch.sigmoid(x[..., :hidden] + hw[..., :hidden])
        z = torch.sigmoid(x[..., hidden:2 * hidden] + hw[..., hidden:2 * hidden])
        n = torch.tanh(x[..., 2 * hidden:] + r * hw[..., 2 * hidden:])
        h = ((1.0 - z) * n + z * h32).to(dt)
        out[s] = h
    return out


def gru_scan_cuda(xw: torch.Tensor, w_hh: torch.Tensor,
                  b_hh: torch.Tensor) -> torch.Tensor:
    """Launch `csrc/gru_scan.cu` (T step launches) on the current stream."""
    if xw.device.type != "cuda":
        raise ValueError("gru_scan_cuda needs CUDA tensors, got %s"
                         % xw.device)
    if xw.dtype not in _DTYPES:
        raise ValueError("xw must be float32 or bfloat16, got %s" % xw.dtype)
    if xw.dim() != 4 or xw.shape[1] != 2 or xw.shape[3] % 3:
        raise ValueError("xw must be (T, 2, B, 3H), got %s"
                         % (tuple(xw.shape),))
    t, _, b, g3 = xw.shape
    hidden = g3 // 3
    if tuple(w_hh.shape) != (2, g3, hidden) or tuple(b_hh.shape) != (2, g3):
        raise ValueError("w_hh must be (2, 3H, H) and b_hh (2, 3H) for "
                         "H=%d, got %s and %s" % (hidden, tuple(w_hh.shape),
                                                  tuple(b_hh.shape)))
    if w_hh.device != xw.device or b_hh.device != xw.device:
        raise ValueError("xw, w_hh and b_hh must be on one device")
    xw = xw.contiguous()
    w = w_hh.to(xw.dtype).contiguous()
    bias = b_hh.float().contiguous()
    out = torch.empty((t, 2, b, hidden), dtype=xw.dtype, device=xw.device)
    if out.numel() == 0:
        return out
    lib = _build.load("gru_scan")
    fn = lib.gru_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = fn(xw.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
                 t, b, hidden, _DTYPES[xw.dtype], stream)
    if err:
        raise RuntimeError("gru_scan kernel launch failed: CUDA error %d" % err)
    gru_scan_cuda.launches += 1
    return out


gru_scan_cuda.launches = 0


def gru_scan_bwd_ref(xw: torch.Tensor, h_prev: torch.Tensor,
                     dout: torch.Tensor, w_hh: torch.Tensor,
                     b_hh: torch.Tensor):
    """Plain PyTorch version of the backward kernel: `_bwd_kernel`'s math in
    a loop over reverse T. h_prev is (T, 2, B, H), [0, out[:-1]].

    -> (dxw (T, 2, B, 3H), danp (T, 2, B, H)), both in xw's dtype; the
    n-slot of dxw holds da_n, danp = da_n * r."""
    t, _, b, g3 = xw.shape
    hidden = g3 // 3
    dt = xw.dtype
    w = w_hh.to(dt).float()                          # (2, 3H, H)
    bias = b_hh.float()[:, None, :]                  # (2, 1, 3H)
    dxw = torch.empty_like(xw)
    danp = torch.empty((t, 2, b, hidden), dtype=dt, device=xw.device)
    carry = torch.zeros((2, b, hidden), dtype=dt, device=xw.device)
    for s in range(t - 1, -1, -1):
        h32 = h_prev[s].float()
        hw = torch.einsum("dbh,dgh->dbg", h32, w) + bias
        x = xw[s].float()
        r = torch.sigmoid(x[..., :hidden] + hw[..., :hidden])
        z = torch.sigmoid(x[..., hidden:2 * hidden] + hw[..., hidden:2 * hidden])
        npre = hw[..., 2 * hidden:]
        n = torch.tanh(x[..., 2 * hidden:] + r * npre)
        dh = dout[s].float() + carry.float()
        dn = dh * (1.0 - z)
        dz = dh * (h32 - n)
        da_n = dn * (1.0 - n * n)
        da_z = dz * z * (1.0 - z)
        dr = da_n * npre
        da_r = dr * r * (1.0 - r)
        da_np = da_n * r
        da_cat = torch.cat([da_r, da_z, da_np], dim=-1).to(dt)
        carry = (dh * z + torch.einsum("dbg,dgh->dbh", da_cat.float(), w)
                 ).to(dt)
        dxw[s] = torch.cat([da_cat[..., :2 * hidden], da_n.to(dt)], dim=-1)
        danp[s] = da_cat[..., 2 * hidden:]
    return dxw, danp


def bwd_scratch(b: int, hidden: int, device: torch.device):
    """The float32 scratch of the backward's C entries: carry, the carried
    grad of h (dh z, then the carry kernel's partial products), in as many
    (2, B, H) slots as the library's `gru_scan_bwd_carry_slots` says; and
    da (2, ceil(B/8), 3H, 8), the gate grads of one step laid out [3H][8
    rows] for each group of 8 batch rows."""
    slots = _build.load("gru_scan").gru_scan_bwd_carry_slots()
    carry = torch.empty((slots, 2, b, hidden), dtype=torch.float32,
                        device=device)
    da = torch.empty((2, -(-b // 8), 3 * hidden, 8), dtype=torch.float32,
                     device=device)
    return carry, da


def gru_scan_bwd_cuda(xw: torch.Tensor, h_prev: torch.Tensor,
                      dout: torch.Tensor, w_hh: torch.Tensor,
                      b_hh: torch.Tensor):
    """Launch the backward kernels of `csrc/gru_scan.cu` (2T - 1 launches)
    on the current stream -> (dxw, danp), as `gru_scan_bwd_ref`."""
    if xw.device.type != "cuda":
        raise ValueError("gru_scan_bwd_cuda needs CUDA tensors, got %s"
                         % xw.device)
    if xw.dtype not in _DTYPES:
        raise ValueError("xw must be float32 or bfloat16, got %s" % xw.dtype)
    if xw.dim() != 4 or xw.shape[1] != 2 or xw.shape[3] % 3:
        raise ValueError("xw must be (T, 2, B, 3H), got %s"
                         % (tuple(xw.shape),))
    t, _, b, g3 = xw.shape
    hidden = g3 // 3
    for name, arr in (("h_prev", h_prev), ("dout", dout)):
        if tuple(arr.shape) != (t, 2, b, hidden):
            raise ValueError("%s must be (T, 2, B, H) = %s, got %s"
                             % (name, (t, 2, b, hidden), tuple(arr.shape)))
    if tuple(w_hh.shape) != (2, g3, hidden) or tuple(b_hh.shape) != (2, g3):
        raise ValueError("w_hh must be (2, 3H, H) and b_hh (2, 3H) for "
                         "H=%d, got %s and %s" % (hidden, tuple(w_hh.shape),
                                                  tuple(b_hh.shape)))
    if any(x.device != xw.device for x in (h_prev, dout, w_hh, b_hh)):
        raise ValueError("all inputs of gru_scan_bwd_cuda must be on one "
                         "device")
    dt = xw.dtype
    xw = xw.contiguous()
    h_prev = h_prev.to(dt).contiguous()
    dout = dout.to(dt).contiguous()
    w = w_hh.to(dt).contiguous()
    bias = b_hh.float().contiguous()
    dxw = torch.empty_like(xw)
    danp = torch.empty((t, 2, b, hidden), dtype=dt, device=xw.device)
    if danp.numel() == 0:
        return dxw, danp
    carry, da = bwd_scratch(b, hidden, xw.device)
    lib = _build.load("gru_scan")
    fn = lib.gru_scan_bwd
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    with torch.cuda.device(xw.device):
        stream = torch.cuda.current_stream(xw.device).cuda_stream
        err = fn(xw.data_ptr(), h_prev.data_ptr(), dout.data_ptr(),
                 w.data_ptr(), bias.data_ptr(), dxw.data_ptr(),
                 danp.data_ptr(), carry.data_ptr(), da.data_ptr(),
                 t, b, hidden, _DTYPES[dt], stream)
    if err:
        raise RuntimeError("gru_scan backward kernel launch failed: CUDA "
                           "error %d" % err)
    gru_scan_bwd_cuda.launches += 1
    return dxw, danp


gru_scan_bwd_cuda.launches = 0


@torch.library.custom_op("fancyrec::gru_scan_fwd", mutates_args=(),
                         device_types="cpu")
def gru_scan(xw: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """The recurrence on xw's device, differentiable in all three inputs:
    the CUDA kernels for CUDA tensors, the plain versions for CPU tensors.
    One operator, so that `torch.export` captures it as one node of a graph
    (`serving/export.py`)."""
    return gru_scan_ref(xw, w_hh, b_hh)


@gru_scan.register_kernel("cuda")
def _gru_scan_cuda_op(xw, w_hh, b_hh):
    return gru_scan_cuda(xw, w_hh, b_hh)


@gru_scan.register_fake
def _gru_scan_fake(xw, w_hh, b_hh):
    t, _, b, g3 = xw.shape
    return xw.new_empty((t, 2, b, g3 // 3))


def _gru_scan_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs, output)


def _gru_scan_backward(ctx, dout):
    """The reverse-time kernel for dxw and danp, then dW_hh and db_hh as one
    einsum and one sum outside it, as `_gru_bwd` forms them
    (fancyrec_tpu/ops/gru_scan.py:264-272)."""
    xw, w_hh, b_hh, out = ctx.saved_tensors
    hidden = out.shape[-1]
    h_prev = torch.cat([torch.zeros_like(out[:1]), out[:-1]], dim=0)
    bwd = gru_scan_bwd_ref if xw.device.type == "cpu" else gru_scan_bwd_cuda
    dxw, danp = bwd(xw, h_prev, dout.to(xw.dtype), w_hh, b_hh)
    da_gates = torch.cat([dxw[..., :2 * hidden], danp], dim=-1).float()
    dw_hh = torch.einsum("tdbg,tdbh->dgh", da_gates,
                         h_prev.float()).to(w_hh.dtype)
    db_hh = da_gates.sum(dim=(0, 2)).to(b_hh.dtype)
    return dxw, dw_hh, db_hh


gru_scan.register_autograd(_gru_scan_backward, setup_context=_gru_scan_setup)

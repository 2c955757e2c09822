"""The bi-GRU recurrence (both directions, h0 = 0): CUDA kernel + plain version.

Port of the JAX package's Pallas kernel `gru_scan_pallas`
(fancyrec_tpu/ops/gru_scan.py). The kernel is `csrc/gru_scan.cu`; this
module builds and binds it, and keeps the plain PyTorch version beside it.

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


def gru_scan(xw: torch.Tensor, w_hh: torch.Tensor,
             b_hh: torch.Tensor) -> torch.Tensor:
    """The recurrence on xw's device: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if xw.device.type == "cpu":
        return gru_scan_ref(xw, w_hh, b_hh)
    return gru_scan_cuda(xw, w_hh, b_hh)

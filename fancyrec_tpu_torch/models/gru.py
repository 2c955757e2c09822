"""Bidirectional GRU with torch-compatible gate math.

Port of fancyrec_tpu/models/gru.py. Two modes, as the reference uses
torch.nn.GRU:
  * unpacked (visual branch): the backward direction runs from the
    batch-max length backwards, across each sample's padding;
  * packed (text bi-gru branch): the backward direction starts at each
    sample's own last valid token, and outputs past a sample's length are
    zero (what pad_packed_sequence emits).

The input projection of all steps is one batched matmul outside the
recurrence; the recurrence itself is `ops.gru_scan` (the CUDA kernel on
the card, its plain version on the CPU). Both compute in the input's
dtype, as the JAX module does: bfloat16 input gives a bfloat16 projection
and a bfloat16 recurrence (its gates in float32, h stored in bfloat16);
the towers hand it float32 under any compute dtype. Parameters are stored in torch's
GRU layout (w_ih (3H, D), w_hh (3H, H), b_ih, b_hh (3H,)) under the JAX
package's names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fancyrec_tpu_torch.ops.gru_scan import gru_scan


def _input_proj(x_fwd, x_bwd, fwd, bwd):
    """(T, 2, B, 3H) input contributions for both directions."""
    w_ih = torch.stack([fwd["w_ih"], bwd["w_ih"]]).to(x_fwd.dtype)
    b_ih = torch.stack([fwd["b_ih"], bwd["b_ih"]]).to(x_fwd.dtype)
    x2 = torch.stack([x_fwd, x_bwd], dim=1)                 # (T, 2, B, D)
    return torch.einsum("tdbi,dgi->tdbg", x2, w_ih) + b_ih[:, None, :]


def _bigru_recurrence(x_fwd, x_bwd, fwd, bwd):
    """Both directions of the recurrence (h0 = 0) -> pair of (T, B, H)."""
    xw = _input_proj(x_fwd, x_bwd, fwd, bwd)
    w_hh = torch.stack([fwd["w_hh"], bwd["w_hh"]])
    b_hh = torch.stack([fwd["b_hh"], bwd["b_hh"]])
    out = gru_scan(xw, w_hh, b_hh)
    return out[:, 0], out[:, 1]


def _reverse_by_length(x, lengths):
    """Reverse each (T, D) sequence of x (B, T, D) within its valid length.

    lengths may be (B,) per-sample lengths or a 0-d batch-max scalar.
    Positions beyond the length map to themselves (masked downstream)."""
    b, t = x.shape[0], x.shape[1]
    pos = torch.arange(t, device=x.device)[None, :]
    lengths = torch.as_tensor(lengths, device=x.device)
    if lengths.dim() == 0:
        lengths = lengths.expand(b)
    lengths = lengths[:, None]
    idx = torch.where(pos < lengths, lengths - 1 - pos, pos)
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


class BiGRU(nn.Module):
    """Bidirectional single-layer GRU. Input (B, T, D) -> (B, T, 2H)."""

    def __init__(self, in_dim: int, hidden: int, packed: bool = False):
        super().__init__()
        self.hidden = hidden
        self.packed = packed
        for d in ("fwd", "bwd"):
            self.register_parameter("w_ih_" + d, nn.Parameter(
                torch.empty(3 * hidden, in_dim)))
            self.register_parameter("w_hh_" + d, nn.Parameter(
                torch.empty(3 * hidden, hidden)))
            self.register_parameter("b_ih_" + d, nn.Parameter(
                torch.empty(3 * hidden)))
            self.register_parameter("b_hh_" + d, nn.Parameter(
                torch.empty(3 * hidden)))

    def _params(self, d):
        return {k: getattr(self, "%s_%s" % (k, d))
                for k in ("w_ih", "w_hh", "b_ih", "b_hh")}

    def forward(self, x, lengths: Optional[torch.Tensor] = None,
                batch_len: Optional[torch.Tensor] = None):
        """lengths: (B,) valid lengths (packed mode). batch_len: 0-d
        batch-max length (unpacked mode), where the backward direction
        starts; defaults to the static T."""
        t = x.shape[1]
        if self.packed:
            if lengths is None:
                raise ValueError("packed BiGRU requires lengths")
            rev = lengths
        else:
            rev = t if batch_len is None else batch_len
        xr = _reverse_by_length(x, rev)
        out_f, out_b = _bigru_recurrence(
            x.transpose(0, 1), xr.transpose(0, 1),
            self._params("fwd"), self._params("bwd"))
        out_f = out_f.transpose(0, 1)
        out_b = _reverse_by_length(out_b.transpose(0, 1), rev)
        out = torch.cat([out_f, out_b], dim=-1)
        if self.packed:
            keep = torch.arange(t, device=x.device)[None, :] < lengths[:, None]
            out = torch.where(keep[..., None], out, torch.zeros_like(out))
        return out

"""Multi-modal fusion heads.

Port of FusionFC, FusionProjectionHead and FusionAttnReduction from
fancyrec_tpu/models/fusion.py. `dtype` is the compute dtype of their
Linear layers (`layers.dense`); the projection head's BatchNorm promotes
to float32 through its float32 scale, and the 'attn' head's attention map
stays in its inputs' dtype, as in the JAX package.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fancyrec_tpu_torch.models.layers import BatchNorm1dTorch, dense


class FusionFC(nn.Module):
    """Single-FC fusion over the concatenated visual and text embeddings."""

    def __init__(self, in_dim: int, common_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.fc = nn.Linear(in_dim, common_dim)

    def forward(self, visual_embs, text_embs):
        return dense(self.fc, torch.cat([visual_embs, text_embs], dim=1),
                     self.dtype)


class FusionProjectionHead(nn.Module):
    """SimCLR-style projection head -- the recipe's 'ph'.

    concat -> Linear(512, no bias) -> BatchNorm (running stats) -> ReLU ->
    Linear(common). With prj_head_output=True the pre-head concat is
    returned (the reference's quirk, kept by the JAX package)."""

    def __init__(self, in_dim: int, common_dim: int,
                 prj_head_output: bool = False, hidden: int = 512,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.prj_head_output = prj_head_output
        self.dtype = dtype
        self.fc1 = nn.Linear(in_dim, hidden, bias=False)
        self.bn = BatchNorm1dTorch(hidden)
        self.fc2 = nn.Linear(hidden, common_dim)

    def forward(self, visual_embs, text_embs):
        x = torch.cat([visual_embs, text_embs], dim=1)
        if self.prj_head_output:
            return x
        x = F.relu(self.bn(dense(self.fc1, x, self.dtype)))
        return dense(self.fc2, x, self.dtype)


class FusionAttnReduction(nn.Module):
    """Bilinear cross-modal attention fusion -- the recipe's 'attn'.

    Consumes the unmapped level-concat vectors (the towers skip their
    mapping when fusion_style is 'attn'). alpha[b, t, v] =
    softmax over t of tanh(visual[b, v] w_vis[t] + text[b, t] w_txt[v]
    + b[v]); the visual score sum_v alpha visual and the text score
    sum_t alpha text each pass a Linear, and the fused embedding is the
    ReLU of their sum. The attention map is (B, text width, visual width).
    """

    def __init__(self, visual_size: int, text_size: int, common_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        # the reference's Linear(1, N, bias=False) weights, flattened
        self.vis_linear = nn.Parameter(torch.empty(text_size))
        self.text_linear = nn.Parameter(torch.empty(visual_size))
        self.b = nn.Parameter(torch.zeros(visual_size))
        self.fusion_visual_linear = nn.Linear(text_size, common_dim)
        self.fusion_text_linear = nn.Linear(visual_size, common_dim)

    def forward(self, visual_embs, text_embs):
        vis_attn = visual_embs[:, None, :] * self.vis_linear[None, :, None]
        txt_attn = text_embs[:, :, None] * self.text_linear[None, None, :]
        alpha = torch.softmax(torch.tanh(vis_attn + txt_attn + self.b), dim=1)
        visual_score = torch.einsum("btv,bv->bt", alpha, visual_embs)
        text_score = torch.einsum("btv,bt->bv", alpha, text_embs)
        return F.relu(
            dense(self.fusion_visual_linear, visual_score, self.dtype)
            + dense(self.fusion_text_linear, text_score, self.dtype))

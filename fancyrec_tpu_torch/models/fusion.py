"""Multi-modal fusion heads, evaluation mode.

Port of FusionFC and FusionProjectionHead from fancyrec_tpu/models/fusion.py.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from fancyrec_tpu_torch.models.layers import BatchNorm1dTorch


class FusionFC(nn.Module):
    """Single-FC fusion over the concatenated visual and text embeddings."""

    def __init__(self, in_dim: int, common_dim: int):
        super().__init__()
        self.fc = nn.Linear(in_dim, common_dim)

    def forward(self, visual_embs, text_embs):
        return self.fc(torch.cat([visual_embs, text_embs], dim=1))


class FusionProjectionHead(nn.Module):
    """SimCLR-style projection head -- the recipe's 'ph'.

    concat -> Linear(512, no bias) -> BatchNorm (running stats) -> ReLU ->
    Linear(common). With prj_head_output=True the pre-head concat is
    returned (the reference's quirk, kept by the JAX package)."""

    def __init__(self, in_dim: int, common_dim: int,
                 prj_head_output: bool = False, hidden: int = 512):
        super().__init__()
        self.prj_head_output = prj_head_output
        self.fc1 = nn.Linear(in_dim, hidden, bias=False)
        self.bn = BatchNorm1dTorch(hidden)
        self.fc2 = nn.Linear(hidden, common_dim)

    def forward(self, visual_embs, text_embs):
        x = torch.cat([visual_embs, text_embs], dim=1)
        if self.prj_head_output:
            return x
        return self.fc2(F.relu(self.bn(self.fc1(x))))

"""Brand tower: learned aspect mixtures, evaluation mode.

Port of the deterministic path of fancyrec_tpu/models/brand.py: a
(brand_num+1, num_aspects) table of per-brand aspect weights scales a
shared (num_aspects, common_dim) aspect matrix, and the brand embedding is
the mean over the aspect axis, computed as one (B, A) @ (A, C) product / A
without the (B, A, C) intermediate.
"""

from __future__ import annotations

import torch
from torch import nn


class BrandAspects(nn.Module):
    def __init__(self, brand_num: int, num_aspects: int, common_dim: int):
        super().__init__()
        self.num_aspects = num_aspects
        self.brand_embeddings = nn.Parameter(
            torch.empty(brand_num + 1, num_aspects))
        self.aspects_embeddings = nn.Parameter(
            torch.empty(num_aspects, common_dim))

    def forward(self, brand_ids: torch.Tensor) -> torch.Tensor:
        weights = self.brand_embeddings[brand_ids]              # (B, A)
        return (weights @ self.aspects_embeddings) / self.num_aspects

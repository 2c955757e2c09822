"""The FancyRec composite model, evaluation mode.

Port of fancyrec_tpu/models/fancyrec.py: a brand-aspects tower beside a
visual and a text tower joined by a fusion head. Submodule names follow
the JAX parameter tree (brand_encoding, vid_encoding, text_encoding,
fusion_encoding), so `fancyrec_tpu_torch.interop` carries JAX weights
across by name. The port is float32 end to end.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.models.bert import BertConfig
from fancyrec_tpu_torch.models.brand import BrandAspects
from fancyrec_tpu_torch.models.encoders import (
    TextBatch, TextGruEncoder, TextTransformersEncoder, VisualBatch,
    VisualEncoder)
from fancyrec_tpu_torch.models.fusion import FusionFC, FusionProjectionHead


class FancyRec(nn.Module):
    """brand ids + visual batch + text batch -> (brand_embs, post_embs)."""

    def __init__(self, cfg: Config):
        super().__init__()
        if cfg.dtype not in ("", "float32"):
            raise NotImplementedError(
                "the port computes in float32 only, got dtype=%r" % cfg.dtype)
        if cfg.fusion_style not in ("fc", "ph"):
            raise NotImplementedError(
                "fusion_style %r is not ported (fc, ph)" % cfg.fusion_style)
        self.cfg = cfg
        self.brand_encoding = BrandAspects(
            cfg.brand_num, cfg.brand_aspect, cfg.common_embedding_size)
        if not cfg.single_modal_text:
            self.vid_encoding = VisualEncoder(
                rnn_size=cfg.visual_rnn_size, feat_dim=cfg.visual_feat_dim,
                kernel_num=cfg.visual_kernel_num,
                kernel_sizes=cfg.visual_kernel_sizes_list,
                mapping_in=cfg.visual_mapping_in,
                mapping_out=cfg.visual_mapping_size, concate=cfg.concate,
                level=cfg.level_vis, norm=cfg.visual_norm)
        if not cfg.single_modal_visual:
            if cfg.text_net == "bi-gru":
                self.text_encoding = TextGruEncoder(
                    vocab_size=cfg.vocab_size, word_dim=cfg.word_dim,
                    rnn_size=cfg.text_rnn_size,
                    kernel_num=cfg.text_kernel_num,
                    kernel_sizes=cfg.text_kernel_sizes_list,
                    mapping_in=cfg.text_mapping_in,
                    mapping_out=cfg.text_mapping_size, concate=cfg.concate,
                    norm=cfg.text_norm)
            elif cfg.text_net == "transformers":
                self.text_encoding = TextTransformersEncoder(
                    bert=BertConfig(
                        vocab_size=cfg.bert_vocab_size,
                        hidden_size=cfg.text_transformers_hidden_size,
                        num_hidden_layers=cfg.bert_num_layers,
                        num_attention_heads=cfg.bert_num_heads,
                        intermediate_size=cfg.bert_intermediate_size,
                        max_position_embeddings=cfg.bert_max_position,
                        type_vocab_size=cfg.bert_type_vocab),
                    kernel_num=cfg.text_kernel_num,
                    kernel_sizes=cfg.text_kernel_sizes_list,
                    mapping_in=cfg.text_mapping_in,
                    mapping_out=cfg.text_mapping_size, concate=cfg.concate,
                    level=cfg.level_txt, norm=cfg.text_norm)
            else:
                raise ValueError("unknown text_net: %s" % cfg.text_net)
        if not (cfg.single_modal_visual or cfg.single_modal_text):
            fused_in = cfg.visual_mapping_size + cfg.text_mapping_size
            if cfg.fusion_style == "fc":
                self.fusion_encoding = FusionFC(
                    fused_in, cfg.common_embedding_size)
            else:
                self.fusion_encoding = FusionProjectionHead(
                    fused_in, cfg.common_embedding_size,
                    prj_head_output=cfg.prj_head_output)

    def embed_brand(self, brand_ids: torch.Tensor) -> torch.Tensor:
        """Mean over the aspect axis of the brand's weighted aspects."""
        return self.brand_encoding(brand_ids)

    def embed_vis(self, v: VisualBatch) -> torch.Tensor:
        return self.vid_encoding(v)

    def embed_txt(self, t: TextBatch) -> torch.Tensor:
        return self.text_encoding(t)

    def embed_post(self, videos: Optional[VisualBatch],
                   captions: Optional[TextBatch]) -> torch.Tensor:
        """Fused post embedding, without the brand tower (the serving
        encode)."""
        if self.cfg.single_modal_visual:
            return self.embed_vis(videos)
        if self.cfg.single_modal_text:
            return self.embed_txt(captions)
        return self.fusion_encoding(self.embed_vis(videos),
                                    self.embed_txt(captions))

    def forward(self, brand_ids, videos: Optional[VisualBatch],
                captions: Optional[TextBatch]):
        return self.embed_brand(brand_ids), self.embed_post(videos, captions)


def init_fancyrec(model: FancyRec, generator: torch.Generator) -> FancyRec:
    """Random weights drawn from `generator`, with the JAX package's
    initializers: xavier-uniform mappings, fusion and attention pool;
    normal(0.02) BERT; normal(1) brand tables; U(+-1/sqrt(H)) GRU;
    lecun-normal conv kernels; U(+-0.1) word embeddings; zero biases,
    unit norms. The numbers differ from the JAX package's for one seed."""
    g = generator
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name.startswith("brand_encoding."):
                p.normal_(0.0, 1.0, generator=g)
            elif ".rnn." in name:                  # every shape is (3H, ...)
                bound = 1.0 / math.sqrt(p.shape[0] // 3)
                p.uniform_(-bound, bound, generator=g)
            elif leaf == "embed":
                p.uniform_(-0.1, 0.1, generator=g)
            elif name.endswith("_ln.weight") or name.endswith("bn.weight"):
                p.fill_(1.0)
            elif leaf == "bias":
                p.zero_()
            elif ".bert." in name:
                p.normal_(0.0, 0.02, generator=g)
            elif ".convs." in name:
                fan_in = p.shape[1] * p.shape[2]
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=g)
            else:                                   # Linear weights
                fan_out, fan_in = p.shape
                bound = math.sqrt(6.0 / (fan_in + fan_out))
                p.uniform_(-bound, bound, generator=g)
    return model

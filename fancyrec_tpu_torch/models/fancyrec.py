"""The FancyRec composite model.

Port of fancyrec_tpu/models/fancyrec.py: a brand-aspects tower beside a
visual and a text tower joined by a fusion head. Submodule names follow
the JAX parameter tree (brand_encoding, vid_encoding, text_encoding,
fusion_encoding), so `fancyrec_tpu_torch.interop` carries JAX weights
across by name. cfg.dtype "bfloat16" is the JAX package's bf16 towers:
parameters stay float32; the visual and text towers, BERT and the fusion
head compute in bfloat16 where the JAX modules do (see models.layers),
the brand tower in float32; the post embedding comes out in bfloat16,
the brand embedding in float32. `model.eval()` is the JAX
package's deterministic=True; `model.train()` turns on the dropouts and
the projection head's batch statistics, after `seed_dropout` has given
the dropouts their generators.

`mesh` (a `parallel.mesh.Mesh` with a model axis above 1) builds this
model rank's part of the model: each module at its local widths, split as
the JAX package's `_PARAM_RULES` split the parameters (the brand tables'
aspects, the mapping MFCs' input features, BERT's FFN width), with the
model group's collectives in its forward. Its state dict is the shard of
the full one (`parallel.mesh.shard_state_dict`); `split_dims` names the
split tensors. Where cfg.pp_stages equals the model axis (`pp`), the
model ranks are the stages of BERT's pipeline and BERT stays whole on
each of them (the JAX `skip_bert`); a cfg.pp_stages the mesh cannot host
(a tester on another model axis) runs BERT in sequence.
cfg.seq_shard splits the time axes of the towers' pools over the model
group (`models.encoders`).
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.models.bert import BertConfig
from fancyrec_tpu_torch.models.brand import BrandAspects
from fancyrec_tpu_torch.models.encoders import (
    TextBatch, TextGruEncoder, TextTransformersEncoder, VisualBatch,
    VisualEncoder)
from fancyrec_tpu_torch.models.fusion import (
    FusionAttnReduction, FusionFC, FusionProjectionHead)
from fancyrec_tpu_torch.models.layers import Dropout
from fancyrec_tpu_torch.parallel.mesh import (
    Mesh, gather_state_dict, param_shardings, shard_state_dict)


class FancyRec(nn.Module):
    """brand ids + visual batch + text batch -> (brand_embs, post_embs)."""

    def __init__(self, cfg: Config, mesh: Optional[Mesh] = None):
        super().__init__()
        if cfg.fusion_style not in ("fc", "ph", "attn"):
            raise ValueError("unknown fusion_style: %s" % cfg.fusion_style)
        self.cfg = cfg
        self.mesh = mesh if mesh is not None and mesh.model > 1 else None
        self._split = None
        part = self.mesh.part if self.mesh else (lambda n: None)
        transformers = (cfg.text_net == "transformers"
                        and not cfg.single_modal_visual)
        self.pp = bool(transformers and cfg.pp_stages > 1 and self.mesh
                       and self.mesh.model == cfg.pp_stages)
        dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32
        attn_fusion = cfg.fusion_style == "attn"
        self.brand_encoding = BrandAspects(
            cfg.brand_num, cfg.brand_aspect, cfg.common_embedding_size,
            part(cfg.brand_aspect))
        if not cfg.single_modal_text:
            self.vid_encoding = VisualEncoder(
                rnn_size=cfg.visual_rnn_size, feat_dim=cfg.visual_feat_dim,
                kernel_num=cfg.visual_kernel_num,
                kernel_sizes=cfg.visual_kernel_sizes_list,
                mapping_in=cfg.visual_mapping_in,
                mapping_out=cfg.visual_mapping_size, concate=cfg.concate,
                level=cfg.level_vis, norm=cfg.visual_norm,
                dropout=cfg.dropout, attn_fusion=attn_fusion, dtype=dtype,
                mapping_shard=part(cfg.visual_mapping_in),
                seq_shard=cfg.seq_shard)
        if not cfg.single_modal_visual:
            if cfg.text_net == "bi-gru":
                self.text_encoding = TextGruEncoder(
                    vocab_size=cfg.vocab_size, word_dim=cfg.word_dim,
                    rnn_size=cfg.text_rnn_size,
                    kernel_num=cfg.text_kernel_num,
                    kernel_sizes=cfg.text_kernel_sizes_list,
                    mapping_in=cfg.text_mapping_in,
                    mapping_out=cfg.text_mapping_size, concate=cfg.concate,
                    norm=cfg.text_norm, dropout=cfg.dropout,
                    attn_fusion=attn_fusion, dtype=dtype,
                    mapping_shard=part(cfg.text_mapping_in))
            elif cfg.text_net == "transformers":
                self.text_encoding = TextTransformersEncoder(
                    bert=BertConfig(
                        vocab_size=cfg.bert_vocab_size,
                        hidden_size=cfg.text_transformers_hidden_size,
                        num_hidden_layers=cfg.bert_num_layers,
                        num_attention_heads=cfg.bert_num_heads,
                        intermediate_size=cfg.bert_intermediate_size,
                        max_position_embeddings=cfg.bert_max_position,
                        type_vocab_size=cfg.bert_type_vocab,
                        hidden_dropout_prob=cfg.bert_dropout,
                        attention_probs_dropout_prob=cfg.bert_dropout,
                        remat=bool(cfg.bert_remat),
                        compute_dtype=cfg.dtype or "float32"),
                    kernel_num=cfg.text_kernel_num,
                    kernel_sizes=cfg.text_kernel_sizes_list,
                    mapping_in=cfg.text_mapping_in,
                    mapping_out=cfg.text_mapping_size, concate=cfg.concate,
                    level=cfg.level_txt, norm=cfg.text_norm,
                    dropout=cfg.dropout, attn_fusion=attn_fusion,
                    dtype=dtype, mapping_shard=part(cfg.text_mapping_in),
                    ffn_shard=(None if self.pp
                               else part(cfg.bert_intermediate_size)),
                    seq_shard=cfg.seq_shard,
                    pp=self.pp)
            else:
                raise ValueError("unknown text_net: %s" % cfg.text_net)
        if not (cfg.single_modal_visual or cfg.single_modal_text):
            fused_in = cfg.visual_mapping_size + cfg.text_mapping_size
            if cfg.fusion_style == "fc":
                self.fusion_encoding = FusionFC(
                    fused_in, cfg.common_embedding_size, dtype)
            elif attn_fusion:
                self.fusion_encoding = FusionAttnReduction(
                    cfg.visual_mapping_in, cfg.text_mapping_in,
                    cfg.common_embedding_size, dtype)
            else:
                self.fusion_encoding = FusionProjectionHead(
                    fused_in, cfg.common_embedding_size,
                    prj_head_output=cfg.prj_head_output, dtype=dtype)

    def split_dims(self) -> Dict[str, Optional[int]]:
        """{state-dict name: the dim of the full tensor that the model axis
        splits, or None}: `parallel.mesh.param_shardings` of the full
        model's shapes (built on the meta device, no memory)."""
        if self._split is None:
            if self.mesh is None:
                self._split = {k: None for k in self.state_dict()}
            else:
                with torch.device("meta"):
                    full = FancyRec(self.cfg)
                self._split = param_shardings(self.mesh, full.state_dict(),
                                              self.pp)
        return self._split

    def load_full_state_dict(self, full) -> None:
        """Load a whole model's state dict (a checkpoint's, one process's):
        this model rank's shard of it."""
        self.load_state_dict(full if self.mesh is None
                             else shard_state_dict(full, self.mesh, self.pp))

    def full_state_dict(self) -> Dict[str, torch.Tensor]:
        """The whole model's state dict, the split tensors gathered over
        the model group: a collective, which every model rank calls."""
        state = self.state_dict()
        if self.mesh is None:
            return state
        return gather_state_dict(state, self.split_dims())

    def seed_dropout(self, seed: int) -> "FancyRec":
        """Seed the training-mode randomness: every tower dropout draws from
        one generator on the model's device, the brand dropout's seed words
        from one on the host (so drawing them never waits for the device).
        Call after moving the model to its device."""
        dev = next(self.parameters()).device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for m in self.modules():
            if isinstance(m, Dropout):
                m.generator = gen
        self.brand_encoding.seed_generator = torch.Generator().manual_seed(
            seed + 1)
        return self

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
    unit norms. The 'attn' fusion keeps the reference's torch defaults:
    U(-1, 1) attention vectors (a Linear of fan-in 1), a zero bias b, and
    U(+-1/sqrt(fan_in)) weights and biases in its two Linears. The numbers
    differ from the JAX package's for one seed."""
    g = generator
    attn = model.cfg.fusion_style == "attn"
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if attn and name.startswith("fusion_encoding."):
                if leaf in ("vis_linear", "text_linear"):
                    bound = 1.0
                elif leaf == "b":
                    bound = 0.0
                else:                              # a Linear's weight or bias
                    bound = 1.0 / math.sqrt(getattr(
                        model.fusion_encoding, name.split(".")[1]).in_features)
                p.uniform_(-bound, bound, generator=g)
            elif name.startswith("brand_encoding."):
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

"""A tiny FancyRec configuration and ragged batches for the port's tests,
with no JAX import, so that the tests that need a CUDA card (which runs
no JAX) can use them too."""

import numpy as np


# a DeepSeek-V2 caption tower at tiny widths: 1 dense + 2 MoE layers, MLA
# with a latent of 16, 8 routed experts top-2 and one shared
TINY_TOWER = dict(
    vocab_size=64, hidden_size=64, intermediate_size=96,
    moe_intermediate_size=16, num_hidden_layers=3, num_attention_heads=4,
    n_routed_experts=8, n_shared_experts=1, num_experts_per_tok=2,
    first_k_dense_replace=1, kv_lora_rank=16, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16)


def tiny_cfg_kwargs(text_net="transformers", fusion_style="ph", norm=True):
    tower = {"text_tower": dict(TINY_TOWER)} if text_net == "deepseek_v2" \
        else {}
    return dict(**tower,
        brand_num=4, brand_aspect=8, common_embedding_size=16,
        visual_rnn_size=8, text_rnn_size=8, visual_kernel_num=4,
        text_kernel_num=4, visual_feat_dim=12, bow_vocab_size=20,
        vocab_size=32, word_dim=10, text_transformers_hidden_size=24,
        bert_vocab_size=64, bert_intermediate_size=32, bert_max_position=32,
        text_net=text_net, fusion_style=fusion_style, text_norm=norm,
        visual_norm=norm, text_mapping_size=16, visual_mapping_size=16,
        max_frames=6, max_tokens=10, max_words=8, batch_size=4,
        accumulation_step=1, queue_size=16)


def ragged_batch(cfg, b, seed):
    rng = np.random.RandomState(seed)
    wordpiece = cfg.text_net in ("transformers", "deepseek_v2")
    tok = cfg.max_tokens if wordpiece else cfg.max_words
    flen = rng.randint(1, cfg.max_frames, b)     # batch max below the pad
    tlen = rng.randint(1, tok, b)
    vmask = (np.arange(cfg.max_frames)[None] < flen[:, None]).astype(np.float32)
    tmask = (np.arange(tok)[None] < tlen[:, None]).astype(np.int32)
    if cfg.text_net == "deepseek_v2":
        hi = cfg.text_tower["vocab_size"]
    else:
        hi = cfg.bert_vocab_size if wordpiece else cfg.vocab_size
    return {
        "frames": (rng.randn(b, cfg.max_frames, cfg.visual_feat_dim)
                   * vmask[..., None]).astype(np.float32),
        "origin": rng.randn(b, cfg.visual_feat_dim).astype(np.float32),
        "vmask": vmask,
        "bows": rng.rand(b, cfg.bow_vocab_size).astype(np.float32),
        "tokens": (rng.randint(1, hi, (b, tok)) * tmask).astype(np.int32),
        "type_ids": np.zeros((b, tok), np.int32),
        "tmask": tmask,
    }

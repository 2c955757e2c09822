"""A tiny FancyRec configuration and ragged batches for the port's tests,
with no JAX import, so that the tests that need a CUDA card (which runs
no JAX) can use them too."""

import numpy as np


def tiny_cfg_kwargs(text_net="transformers", fusion_style="ph", norm=True):
    return dict(
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
    tok = cfg.max_tokens if cfg.text_net == "transformers" else cfg.max_words
    flen = rng.randint(1, cfg.max_frames, b)     # batch max below the pad
    tlen = rng.randint(1, tok, b)
    vmask = (np.arange(cfg.max_frames)[None] < flen[:, None]).astype(np.float32)
    tmask = (np.arange(tok)[None] < tlen[:, None]).astype(np.int32)
    hi = cfg.bert_vocab_size if cfg.text_net == "transformers" else cfg.vocab_size
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

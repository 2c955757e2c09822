"""The operation and byte counts of the per-layer metrics against values
worked out by hand at small shapes."""

import os

import harness
import peaks

LM = os.path.join(harness.BENCH, "layer_metrics")


def _metric(name):
    return harness.import_file(os.path.join(LM, name + ".py"),
                               "m_" + name.replace(".", "_"))


def test_resnet_flops_by_hand():
    m = _metric("extract_mfu")
    # 32 x 32, one block a stage: stem 7x7x3->64 at 16x16, pool to 8x8
    stem = 2 * 64 * 3 * 49 * 16 * 16
    s1 = (2 * 64 * 64 * 64 + 2 * 64 * 64 * 9 * 64 + 2 * 256 * 64 * 64
          + 2 * 256 * 64 * 64)                       # at 8x8, down 64->256
    s2 = (2 * 128 * 256 * 64 + 2 * 128 * 128 * 9 * 16 + 2 * 512 * 128 * 16
          + 2 * 512 * 256 * 16)                      # 8x8 in, 4x4 out
    s3 = (2 * 256 * 512 * 16 + 2 * 256 * 256 * 9 * 4 + 2 * 1024 * 256 * 4
          + 2 * 1024 * 512 * 4)
    s4 = (2 * 512 * 1024 * 4 + 2 * 512 * 512 * 9 * 1 + 2 * 2048 * 512 * 1
          + 2 * 2048 * 1024 * 1)
    assert m.resnet_flops((1, 1, 1, 1), 32) == stem + s1 + s2 + s3 + s4
    assert m.resnet_flops((3, 8, 36, 3)) == 23023157248


def test_k1_bound_by_hand():
    m = _metric("k1_roofline.train")
    b, t, h = 2, 3, 4
    ops = 2 * (2 * t * b * 3 * h * h)                       # 576
    fwd_bytes = 4 * (2 * 3 * h * h + 2 * t * b * 3 * h + 2 * t * b * h)
    bwd_bytes = 4 * (2 * 3 * h * h + 4 * t * b * 3 * h + 4 * t * b * h)
    assert fwd_bytes == 4 * (96 + 144 + 48)
    want = (max(fwd_bytes / 3.35e12, ops / 67e12)
            + max(bwd_bytes / 3.35e12, 2 * ops / 67e12))
    assert abs(m.k1_bound_s(b, t, h) - want) < 1e-18
    # the recipe's visual GRU at B = 8, T = 64: operations bound it
    assert abs(m.k1_bound_s(8, 64, 1024) - 3 * 6442450944 / 67e12) < 1e-12
    assert m.is_k1("void gru_step_kernel_rows<float, 8>(...)")
    assert m.is_k1("gru_bwd_carry_cols") and not m.is_k1("adm_fwd_kernel")


def test_train_ops_by_hand():
    m = _metric("train_mfu")
    model = {"visual_rnn_size": 2, "visual_kernel_sizes": "2",
             "text_kernel_sizes": "2", "visual_mapping_size": 3,
             "common_embedding_size": 2, "visual_kernel_num": 1,
             "text_kernel_num": 1, "text_net": "bi-gru", "word_dim": 2,
             "text_rnn_size": 1, "text_mapping_size": 3, "brand_aspect": 5,
             "queue_size": 7}
    data = {"feat_dim": 4, "bow_vocab_size": 3}
    L, T = 2, 3
    vis = (2 * L * 4 * 1 + 2 * L * 1 * 3              # attention pool
           + 2 * (2 * L * 4 * 6 + 2 * L * 2 * 6)      # bi-GRU, H = 2
           + 2 * (L + 1) * 2 * 4 * 1                  # conv ws = 2 over 4
           + 2 * (4 + 1 + 8) * 3)                     # mapping 13 -> 3
    txt = (2 * (2 * T * 2 * 3 + 2 * T * 1 * 3)        # bi-GRU, H = 1
           + 2 * (T + 1) * 2 * 2 * 1                  # conv ws = 2 over 2
           + 2 * (3 + 2 + 1) * 3)                     # mapping 6 -> 3
    rest = 2 * 6 * 512 + 2 * 512 * 2 + 2 * 5 * 2      # fusion, brand
    assert m.post_forward_ops(model, data, L, T) == vis + txt + rest
    one = vis + txt + rest
    assert m.batch_ops(model, data, [L], [T]) == 3 * (one + 2 * 7 * 2
                                                       + 3 * 2 * 2)


def test_peaks():
    assert peaks.bound_s(3.35e12, 0, 1.0) == 1.0
    assert peaks.bound_s(0, 67e12, peaks.FLOAT32_FLOPS) == 1.0

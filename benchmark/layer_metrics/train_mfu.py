"""train_mfu: the model's operations over the traced window, divided by
the window's length times the float32 peak (the recipe computes in
float32 with TF32 off), in %.

Operations are counted from the shapes: every matrix product and
convolution of the forward at each post's own lengths (frames, tokens),
none of the padding, and the backward as twice the forward. Reads the
valid lengths of every batch the window's updates took."""

import peaks


def post_forward_ops(model: dict, data: dict, frames: int,
                     tokens: int) -> float:
    f, hv = data["feat_dim"], model["visual_rnn_size"]
    vk = [int(x) for x in model["visual_kernel_sizes"].split("-")]
    tk = [int(x) for x in model["text_kernel_sizes"].split("-")]
    m, c = model["visual_mapping_size"], model["common_embedding_size"]
    n_vk, n_tk = model["visual_kernel_num"], model["text_kernel_num"]
    L = frames
    ops = 2 * L * f * (f // 4) + 2 * L * (f // 4) * 3           # attention pool
    ops += 2 * (2 * L * f * 3 * hv + 2 * L * hv * 3 * hv)       # bi-GRU
    ops += sum(2 * (L + ws - 1) * ws * 2 * hv * n_vk for ws in vk)
    vis_in = 2 * hv + n_vk * len(vk) + 2 * f
    ops += 2 * vis_in * m
    T = tokens
    if model["text_net"] == "transformers":
        d, ffn = (model["text_transformers_hidden_size"],
                  model["bert_intermediate_size"])
        ops += model["bert_num_layers"] * (
            4 * 2 * T * d * d + 2 * 2 * T * d * ffn + 2 * 2 * T * T * d)
        ops += sum(2 * (T + ws - 1) * ws * d * n_tk for ws in tk)
        txt_in = data["bow_vocab_size"] + d + n_tk * len(tk)
    else:
        w, ht = model["word_dim"], model["text_rnn_size"]
        ops += 2 * (2 * T * w * 3 * ht + 2 * T * ht * 3 * ht)
        ops += sum(2 * (T + ws - 1) * ws * 2 * ht * n_tk for ws in tk)
        txt_in = data["bow_vocab_size"] + 2 * ht + n_tk * len(tk)
    ops += 2 * txt_in * model["text_mapping_size"]
    ops += 2 * (m + model["text_mapping_size"]) * 512 + 2 * 512 * c  # fusion
    ops += 2 * model["brand_aspect"] * c                        # brand tower
    return float(ops)


def batch_ops(model: dict, data: dict, vlens, tlens) -> float:
    """Forward and backward of one microbatch, its loss's products too
    (the queue's logits and the batch's scores)."""
    b, c = len(vlens), model["common_embedding_size"]
    fwd = sum(post_forward_ops(model, data, int(v), int(t))
              for v, t in zip(vlens, tlens))
    fwd += 2 * b * model["queue_size"] * c + 3 * 2 * b * b * c
    return 3.0 * fwd


def read(obs):
    window = obs["window"]
    if not window.ops or not obs.get("batches"):
        return None
    conf = obs["config"]
    ops = sum(batch_ops(conf["model"], conf["data"], v, t)
              for v, t in obs["batches"])
    return 100.0 * ops / (window.seconds * peaks.FLOAT32_FLOPS)

"""train_mfu.dsv2: the model's operations over the traced window, divided
by the window's length times the float32 peak, in %, for a recipe whose
caption tower is DeepSeek-V2's.

Operations at each post's own lengths, none of the padding, the backward
as twice the forward: the recipe's trunk as `train_mfu` counts it (the
brand and visual towers, the text conv bank over the tower's hidden
states, the mappings, the fusion head and the loss), and the tower: per
token and layer, MLA's projections (q, the latent and k_pe, the latent's
expansion to k_nope and v, the output), its scores and weighted values
over the caption's tokens, and the MLP: the dense SwiGLU in the leading
layers, and in the MoE layers the router and the k routed and the shared
experts' SwiGLUs (the routed experts counted at k a token)."""

import os

import harness

train_mfu = harness.import_file(
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "train_mfu.py"),
    "metric_train_mfu")


def tower_forward_ops(conf: dict, t: int) -> float:
    d, h = conf["hidden_size"], conf["num_attention_heads"]
    nope, rope, vd = (conf["qk_nope_head_dim"], conf["qk_rope_head_dim"],
                      conf["v_head_dim"])
    rank = conf["kv_lora_rank"]
    attn = 2 * t * (d * h * (nope + rope) + d * (rank + rope)
                    + rank * h * (nope + vd) + h * vd * d)
    attn += 2 * t * t * h * (nope + rope) + 2 * t * t * h * vd
    dense = 3 * 2 * t * d * conf["intermediate_size"]
    f = conf["moe_intermediate_size"]
    moe = 2 * t * d * conf["n_routed_experts"]
    moe += (conf["num_experts_per_tok"] + conf["n_shared_experts"]) \
        * 3 * 2 * t * d * f
    n_dense = conf["first_k_dense_replace"]
    layers = conf["num_hidden_layers"]
    return float(layers * attn + n_dense * dense + (layers - n_dense) * moe)


def read(obs):
    window = obs["window"]
    conf = obs["config"]
    if not window.ops or not obs.get("batches") or "hidden_size" not in conf:
        return None
    trunk = dict(conf["model"], text_net="transformers", bert_num_layers=0,
                 text_transformers_hidden_size=conf["hidden_size"],
                 bert_intermediate_size=0)
    ops = 0.0
    for vlens, tlens in obs["batches"]:
        ops += train_mfu.batch_ops(trunk, conf["data"], vlens, tlens)
        ops += 3.0 * sum(tower_forward_ops(conf, int(t)) for t in tlens)
    return 100.0 * ops / (window.seconds * train_mfu.peaks.FLOAT32_FLOPS)

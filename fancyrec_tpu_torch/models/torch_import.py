"""Import reference (torch) FancyRec checkpoints into the port.

The port's copy of fancyrec_tpu/models/torch_import.py. The reference saves
a *list-form* state dict [vid_encoding, text_encoding, brand_encoding,
fusion_encoding] (reference model.py:637-649) inside {'epoch', 'model',
'best_rsum', 'opt', 'Eiters'} (trainer.py:294-301). These converters map
each tower's torch parameter names onto the JAX package's nested parameter
tree (numpy leaves, flax layouts), which `fancyrec_tpu_torch.interop`
carries into the port's state dict by name, so a GPU-trained reference
checkpoint evaluates in the port unchanged.

All inputs may be torch tensors or numpy arrays; outputs are numpy.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np


def _a(x) -> np.ndarray:
    try:
        return x.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(x)


def _lin(sd: Dict[str, Any], name: str, bias: bool = True) -> dict:
    out = {"kernel": _a(sd[name + ".weight"]).T}
    if bias:
        out["bias"] = _a(sd[name + ".bias"])
    return out


def _ln(sd: Dict[str, Any], name: str) -> dict:
    return {"scale": _a(sd[name + ".weight"]), "bias": _a(sd[name + ".bias"])}


def _conv_bank(sd: Dict[str, Any], prefix: str,
               kernel_sizes: Sequence[int]) -> dict:
    """torch Conv2d(1, K, (ws, D)) weights -> flax Conv (ws, D, K) kernels."""
    params = {}
    for i, ws in enumerate(kernel_sizes):
        w = _a(sd["%s.%d.weight" % (prefix, i)])  # (K, 1, ws, D)
        params["conv_w%d" % ws] = {
            "kernel": np.transpose(w[:, 0], (1, 2, 0)),
            "bias": _a(sd["%s.%d.bias" % (prefix, i)]),
        }
    return params


def _gru(sd: Dict[str, Any], prefix: str) -> dict:
    return {
        "w_ih_fwd": _a(sd[prefix + ".weight_ih_l0"]),
        "w_hh_fwd": _a(sd[prefix + ".weight_hh_l0"]),
        "b_ih_fwd": _a(sd[prefix + ".bias_ih_l0"]),
        "b_hh_fwd": _a(sd[prefix + ".bias_hh_l0"]),
        "w_ih_bwd": _a(sd[prefix + ".weight_ih_l0_reverse"]),
        "w_hh_bwd": _a(sd[prefix + ".weight_hh_l0_reverse"]),
        "b_ih_bwd": _a(sd[prefix + ".bias_ih_l0_reverse"]),
        "b_hh_bwd": _a(sd[prefix + ".bias_hh_l0_reverse"]),
    }


def bert_params(sd: Dict[str, Any], num_layers: int) -> dict:
    """A HF BertModel state dict -> the BERT tree; only the first
    `num_layers` layers are taken, as the reference's
    BertConfig(num_hidden_layers=3) over bert-base weights takes them."""
    params = {
        "word_embeddings": _a(sd["embeddings.word_embeddings.weight"]),
        "position_embeddings": _a(sd["embeddings.position_embeddings.weight"]),
        "token_type_embeddings": _a(
            sd["embeddings.token_type_embeddings.weight"]),
        "embeddings_ln": _ln(sd, "embeddings.LayerNorm"),
    }
    for i in range(num_layers):
        p = "encoder.layer.%d." % i
        params["layer_%d" % i] = {
            "attention": {
                "query": _lin(sd, p + "attention.self.query"),
                "key": _lin(sd, p + "attention.self.key"),
                "value": _lin(sd, p + "attention.self.value"),
            },
            "attention_output": _lin(sd, p + "attention.output.dense"),
            "attention_ln": _ln(sd, p + "attention.output.LayerNorm"),
            "intermediate": _lin(sd, p + "intermediate.dense"),
            "output": _lin(sd, p + "output.dense"),
            "output_ln": _ln(sd, p + "output.LayerNorm"),
        }
    return params


def visual_encoder_params(sd: Dict[str, Any], kernel_sizes: Sequence[int],
                          has_mapping: bool = True) -> dict:
    params = {
        "rnn": _gru(sd, "rnn"),
        "atten": {
            "w_1": {"kernel": _a(sd["atten.w_1.weight"]).T},
            "w_2": {"kernel": _a(sd["atten.w_2.weight"]).T},
        },
        "convs": _conv_bank(sd, "convs1", kernel_sizes),
    }
    if has_mapping and "visual_mapping.fc1.weight" in sd:
        params["visual_mapping"] = {"fc1": _lin(sd, "visual_mapping.fc1")}
    return params


def text_gru_encoder_params(sd: Dict[str, Any], kernel_sizes: Sequence[int],
                            has_mapping: bool = True) -> dict:
    params = {
        "embed": _a(sd["embed.weight"]),
        "rnn": _gru(sd, "rnn"),
        "convs": _conv_bank(sd, "convs1", kernel_sizes),
    }
    if has_mapping and "text_mapping.fc1.weight" in sd:
        params["text_mapping"] = {"fc1": _lin(sd, "text_mapping.fc1")}
    return params


def text_transformers_encoder_params(sd: Dict[str, Any],
                                     kernel_sizes: Sequence[int],
                                     num_layers: int = 3,
                                     has_mapping: bool = True) -> dict:
    bert_sd = {k[len("model."):]: v for k, v in sd.items()
               if k.startswith("model.")}
    params = {
        "bert": bert_params(bert_sd, num_layers),
        "convs": _conv_bank(sd, "convs1", kernel_sizes),
    }
    if has_mapping and "text_mapping.fc1.weight" in sd:
        params["text_mapping"] = {"fc1": _lin(sd, "text_mapping.fc1")}
    return params


def brand_aspects_params(sd: Dict[str, Any]) -> dict:
    return {
        "brand_embeddings": _a(sd["brand_embeddings.weight"]),
        "aspects_embeddings": _a(sd["aspects_embeddings"]),
    }


def fusion_params(sd: Dict[str, Any], fusion_style: str):
    """Returns (params, batch_stats) for the fusion tower."""
    if fusion_style == "fc":
        return {"fc": _lin(sd, "fc")}, {}
    if fusion_style == "ph":
        params = {
            "fc1": _lin(sd, "fc1", bias=False),
            "fc2": _lin(sd, "fc2"),
            "bn": {"scale": _a(sd["projection_head.1.weight"]),
                   "bias": _a(sd["projection_head.1.bias"])},
        }
        stats = {"bn": {"mean": _a(sd["projection_head.1.running_mean"]),
                        "var": _a(sd["projection_head.1.running_var"])}}
        return params, stats
    if fusion_style == "attn":
        params = {
            "vis_linear": _a(sd["vis_linear.weight"]).reshape(-1),
            "text_linear": _a(sd["text_linear.weight"]).reshape(-1),
            "b": _a(sd["b"]),
            "fusion_visual_linear": _lin(sd, "fusion_visual_linear"),
            "fusion_text_linear": _lin(sd, "fusion_text_linear"),
        }
        return params, {}
    raise ValueError(fusion_style)


def infer_bert_dims(text_sd: Dict[str, Any], cfg) -> None:
    """Set cfg's BERT shape knobs from a text-tower state dict."""
    key = "model.embeddings.word_embeddings.weight"
    if key in text_sd:
        cfg.bert_vocab_size = _a(text_sd[key]).shape[0]
        cfg.bert_max_position = _a(
            text_sd["model.embeddings.position_embeddings.weight"]).shape[0]
        cfg.bert_type_vocab = _a(
            text_sd["model.embeddings.token_type_embeddings.weight"]).shape[0]
        cfg.bert_intermediate_size = _a(
            text_sd["model.encoder.layer.0.intermediate.dense.weight"]).shape[0]
        n = 0
        while "model.encoder.layer.%d.intermediate.dense.weight" % n in text_sd:
            n += 1
        cfg.bert_num_layers = min(n, cfg.bert_num_layers) or cfg.bert_num_layers


def fancyrec_variables_from_reference(state_list, cfg) -> dict:
    """list-form reference state dict -> {'params': ..., 'batch_stats': ...}
    in the JAX package's tree, for `interop.load_jax_variables`. Sets cfg's
    BERT dimensions from the text tower's weights.

    state_list: [vid_sd, text_sd, brand_sd, fusion_sd] as saved by the
    reference FancyRec.state_dict (model.py:637-643).
    """
    vid_sd, text_sd, brand_sd, fusion_sd = state_list
    has_mapping = cfg.fusion_style != "attn"
    params: dict = {"brand_encoding": brand_aspects_params(brand_sd)}
    if not cfg.single_modal_text:
        params["vid_encoding"] = visual_encoder_params(
            vid_sd, cfg.visual_kernel_sizes_list, has_mapping)
    if not cfg.single_modal_visual:
        if cfg.text_net == "bi-gru":
            params["text_encoding"] = text_gru_encoder_params(
                text_sd, cfg.text_kernel_sizes_list, has_mapping)
        else:
            infer_bert_dims(text_sd, cfg)
            params["text_encoding"] = text_transformers_encoder_params(
                text_sd, cfg.text_kernel_sizes_list, cfg.bert_num_layers,
                has_mapping)
    fp, stats = fusion_params(fusion_sd, cfg.fusion_style)
    params["fusion_encoding"] = fp
    variables = {"params": params}
    if stats:
        variables["batch_stats"] = {"fusion_encoding": stats}
    return variables

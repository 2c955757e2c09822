"""Weights made from the seed, on the device, in a few large calls.

The benchmark, not the program, makes every weight: both the program and
the plain reference read the same dictionary of tensors. Names follow the
program's state dict, so the program loads it by name; the reference
reads it by the same names. One normal draw and one uniform draw cover
every parameter, cut into leaves and scaled leaf by leaf.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

# (name, shape, kind, scale): kind "normal" (std), "uniform" (bound),
# "zeros", "ones"
Spec = List[Tuple[str, Tuple[int, ...], str, float]]


def _linear(spec: Spec, name: str, n_in: int, n_out: int, bias=True,
            init: str = "xavier") -> None:
    if init == "xavier":
        spec.append((name + ".weight", (n_out, n_in), "uniform",
                     math.sqrt(6.0 / (n_in + n_out))))
    else:                                        # BERT's normal(0.02)
        spec.append((name + ".weight", (n_out, n_in), "normal", 0.02))
    if bias:
        spec.append((name + ".bias", (n_out,), "zeros", 0.0))


def _gru(spec: Spec, name: str, n_in: int, hidden: int) -> None:
    bound = 1.0 / math.sqrt(hidden)
    for d in ("fwd", "bwd"):
        spec.append(("%s.w_ih_%s" % (name, d), (3 * hidden, n_in), "uniform",
                     bound))
        spec.append(("%s.w_hh_%s" % (name, d), (3 * hidden, hidden),
                     "uniform", bound))
        spec.append(("%s.b_ih_%s" % (name, d), (3 * hidden,), "uniform",
                     bound))
        spec.append(("%s.b_hh_%s" % (name, d), (3 * hidden,), "uniform",
                     bound))


def _convs(spec: Spec, name: str, n_in: int, kernels: int, sizes) -> None:
    for ws in sizes:
        spec.append(("%s.conv_w%d.weight" % (name, ws), (kernels, n_in, ws),
                     "normal", 1.0 / math.sqrt(n_in * ws)))
        spec.append(("%s.conv_w%d.bias" % (name, ws), (kernels,), "zeros",
                     0.0))


def _ln(spec: Spec, name: str, n: int) -> None:
    spec.append((name + ".weight", (n,), "ones", 1.0))
    spec.append((name + ".bias", (n,), "zeros", 0.0))


def sizes(model: dict, data: dict) -> dict:
    """The widths the model's layers take, from the configuration file."""
    vk = [int(x) for x in model["visual_kernel_sizes"].split("-")]
    tk = [int(x) for x in model["text_kernel_sizes"].split("-")]
    feat = data["feat_dim"]
    vis_in = (2 * model["visual_rnn_size"] + model["visual_kernel_num"]
              * len(vk) + 2 * feat)
    if model["text_net"] == "transformers":
        txt_in = (data["bow_vocab_size"]
                  + model["text_transformers_hidden_size"]
                  + model["text_kernel_num"] * len(tk))
    else:
        txt_in = (data["bow_vocab_size"] + 2 * model["text_rnn_size"]
                  + model["text_kernel_num"] * len(tk))
    return {"visual_kernels": vk, "text_kernels": tk, "feat_dim": feat,
            "visual_mapping_in": vis_in, "text_mapping_in": txt_in}


def fancyrec_spec(model: dict, data: dict) -> Spec:
    """Every parameter and buffer of the recipe model, in the program's
    state-dict names, with its initializer."""
    s = sizes(model, data)
    c = model["common_embedding_size"]
    spec: Spec = []
    spec.append(("brand_encoding.brand_embeddings",
                 (model["brand_num"] + 1, model["brand_aspect"]), "normal",
                 1.0))
    spec.append(("brand_encoding.aspects_embeddings",
                 (model["brand_aspect"], c), "normal", 1.0))
    feat, hv = s["feat_dim"], model["visual_rnn_size"]
    _linear(spec, "vid_encoding.atten.w_1", feat, feat // 4, bias=False)
    _linear(spec, "vid_encoding.atten.w_2", feat // 4, 3, bias=False)
    _gru(spec, "vid_encoding.rnn", feat, hv)
    _convs(spec, "vid_encoding.convs", 2 * hv, model["visual_kernel_num"],
           s["visual_kernels"])
    _linear(spec, "vid_encoding.visual_mapping.fc1", s["visual_mapping_in"],
            model["visual_mapping_size"])
    if model["text_net"] == "transformers":
        d = model["text_transformers_hidden_size"]
        ffn = model["bert_intermediate_size"]
        b = "text_encoding.bert."
        spec.append((b + "word_embeddings", (model["bert_vocab_size"], d),
                     "normal", 0.02))
        spec.append((b + "position_embeddings",
                     (model["bert_max_position"], d), "normal", 0.02))
        spec.append((b + "token_type_embeddings",
                     (model["bert_type_vocab"], d), "normal", 0.02))
        _ln(spec, b + "embeddings_ln", d)
        for i in range(model["bert_num_layers"]):
            lay = "%slayer_%d." % (b, i)
            for part in ("query", "key", "value"):
                _linear(spec, lay + "attention." + part, d, d, init="bert")
            _linear(spec, lay + "attention_output", d, d, init="bert")
            _ln(spec, lay + "attention_ln", d)
            _linear(spec, lay + "intermediate", d, ffn, init="bert")
            _linear(spec, lay + "output", ffn, d, init="bert")
            _ln(spec, lay + "output_ln", d)
        _convs(spec, "text_encoding.convs", d, model["text_kernel_num"],
               s["text_kernels"])
    else:
        ht = model["text_rnn_size"]
        spec.append(("text_encoding.embed",
                     (data["rnn_vocab_size"], model["word_dim"]), "uniform",
                     0.1))
        _gru(spec, "text_encoding.rnn", model["word_dim"], ht)
        _convs(spec, "text_encoding.convs", 2 * ht, model["text_kernel_num"],
               s["text_kernels"])
    _linear(spec, "text_encoding.text_mapping.fc1", s["text_mapping_in"],
            model["text_mapping_size"])
    fused = model["visual_mapping_size"] + model["text_mapping_size"]
    _linear(spec, "fusion_encoding.fc1", fused, 512, bias=False)
    spec.append(("fusion_encoding.bn.weight", (512,), "ones", 1.0))
    spec.append(("fusion_encoding.bn.bias", (512,), "zeros", 0.0))
    spec.append(("fusion_encoding.bn.running_mean", (512,), "zeros", 0.0))
    spec.append(("fusion_encoding.bn.running_var", (512,), "ones", 1.0))
    _linear(spec, "fusion_encoding.fc2", 512, c)
    return spec


def resnet_spec(blocks) -> Spec:
    """ResNet-152's convolutions (LeCun normal, 1 / fan_in) and its
    inference batch norms (scale 1, bias 0), in the program's names."""
    spec: Spec = [("conv1.weight", (64, 3, 7, 7), "normal",
                   1.0 / math.sqrt(3 * 49))]
    spec += [("bn1.weight", (64,), "ones", 1.0), ("bn1.bias", (64,), "zeros",
                                                   0.0)]

    def conv(name, cin, cout, k):
        spec.append((name + ".weight", (cout, cin, k, k), "normal",
                     1.0 / math.sqrt(cin * k * k)))

    def bn(name, n):
        spec.append((name + ".weight", (n,), "ones", 1.0))
        spec.append((name + ".bias", (n,), "zeros", 0.0))

    cin, width = 64, 64
    for stage, n_blocks in enumerate(blocks):
        for b in range(n_blocks):
            name = "layer%d_%d" % (stage + 1, b)
            conv(name + ".conv1", cin, width, 1)
            bn(name + ".bn1", width)
            conv(name + ".conv2", width, width, 3)
            bn(name + ".bn2", width)
            conv(name + ".conv3", width, 4 * width, 1)
            bn(name + ".bn3", 4 * width)
            if b == 0:
                conv(name + ".down_conv", cin, 4 * width, 1)
                bn(name + ".down_bn", 4 * width)
            cin = 4 * width
        width *= 2
    return spec


def make(spec: Spec, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of `spec` from `seed`: one normal and one uniform draw
    on `device`, cut into float32 leaves."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_normal = sum(math.prod(sh) for _, sh, k, _ in spec if k == "normal")
    n_unif = sum(math.prod(sh) for _, sh, k, _ in spec if k == "uniform")
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, i_n, i_u = {}, 0, 0
    for name, shape, kind, scale in spec:
        n = math.prod(shape)
        if kind == "normal":
            t = normal[i_n:i_n + n].view(shape).mul_(scale)
            i_n += n
        elif kind == "uniform":
            t = unif[i_u:i_u + n].view(shape).mul_(scale)
            i_u += n
        elif kind == "zeros":
            t = torch.zeros(shape, device=device)
        else:
            t = torch.ones(shape, device=device)
        out[name] = t
    return out

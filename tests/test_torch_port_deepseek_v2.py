"""The DeepSeek-V2 caption tower (`--text_net deepseek_v2`) and K5's plain
path, on the CPU at tiny widths (hidden 64, 4 heads, latent 16, rope 8,
nope 16, 8 experts top-2, 1 shared, 1 dense + 2 MoE layers).

- the port's FancyRec loss (with the balance loss) and every gradient
  against the plain reference `benchmark/reference/deepseek_v2_ref.py`
  on seeded random weights, padded captions included;
- K5's plain path against a per-expert loop, forward and backward, its
  weight gradients added into .grad;
- the routing: k rows a valid token, none for pads, the combine's order;
- YaRN's constants at the published widths;
- the configuration's refusals.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from fancyrec_tpu_torch.config import (
    Config, build_train_parser, config_from_args)
from fancyrec_tpu_torch.losses import init_queue_state
from fancyrec_tpu_torch.models import deepseek_v2 as ds
from fancyrec_tpu_torch.ops import moe
from fancyrec_tpu_torch.train.state import init_state
from fancyrec_tpu_torch.train.step import micro_loss, stack_microbatches
from fancyrec_tpu_torch.train.step import train_step
from torch_port_tiny import TINY_TOWER, ragged_batch, tiny_cfg_kwargs

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark")
if BENCH not in sys.path:
    sys.path.insert(0, BENCH)
from reference import deepseek_v2_ref as ref  # noqa: E402

# float32 on one CPU, the same operations in another order (the experts
# by index_add in the reference, sorted rows here; RoPE on pairs there,
# rotate_half here)
LOSS_TOL = 1e-5
GRAD_TOL = 2e-5


def _cfg(**kw):
    cfg = Config(**tiny_cfg_kwargs("deepseek_v2"), loss_fun="cl",
                 cost_style="mean", **kw)
    return cfg.finalize()


def _batch(cfg, b, seed):
    x = ragged_batch(cfg, b, seed)
    x["brand_ids"] = np.arange(b, dtype=np.int64) % cfg.brand_num
    return {k: torch.from_numpy(np.asarray(v)) for k, v in x.items()}


def _ref_cfg(cfg):
    return dict(dropout=cfg.dropout,
                visual_kernels=cfg.visual_kernel_sizes_list,
                text_kernels=cfg.text_kernel_sizes_list,
                tower=dataclasses.asdict(cfg.tower_config()))


@pytest.mark.parametrize("seed, b", [(1, 4), (2, 3)])
def test_loss_and_every_grad_match_the_plain_reference(seed, b):
    """One training microbatch, dropouts on and drawn alike: the loss
    (contrastive plus balance), the balance loss alone and every
    parameter's gradient."""
    cfg = _cfg()
    model, _, _ = init_state(cfg, torch.device("cpu"), seed=seed)
    model.seed_dropout(seed + 10)
    mb = _batch(cfg, b, seed)
    assert (mb["tmask"].sum(1) < cfg.max_tokens).all()   # padded captions
    model.train()
    queue = init_queue_state(cfg.queue_size, cfg.common_embedding_size)
    loss, _ = micro_loss(model, cfg, queue, mb)
    loss.backward()
    tower = model.text_tower()
    P = {k: v.detach().clone().requires_grad_(True)
         for k, v in model.state_dict().items() if "running" not in k
         and "num_batches" not in k}
    brand, post, aux = ref.forward(P, _ref_cfg(cfg), mb,
                                   ref.Draws(seed + 10, "cpu"))
    rloss, _, _ = ref.contrastive(brand, post, torch.zeros_like(
        queue.queue), 0)
    total = rloss + aux
    total.backward()
    assert abs(loss.item() - total.item()) <= LOSS_TOL * abs(total.item())
    # the balance loss on its own: the eval-mode tower leaves none, the
    # training one the reference's
    model.seed_dropout(seed + 10)
    with torch.no_grad():
        model(mb["brand_ids"], *_towers(mb))
    assert abs(float(model.take_aux_loss()) - float(aux)) <= 1e-6
    assert float(aux) > 0 and model.take_aux_loss() is None
    model.eval()
    with torch.no_grad():
        model(mb["brand_ids"], *_towers(mb))
    assert tower.aux_loss is None
    for n, p in model.named_parameters():
        want = P[n].grad
        assert want is not None, n
        err = float((p.grad - want).abs().max() / want.abs().max())
        assert err <= GRAD_TOL, (n, err)


def _towers(mb):
    from fancyrec_tpu_torch.models.encoders import TextBatch, VisualBatch
    return (VisualBatch(frames=mb["frames"], mean_origin=mb["origin"],
                        mask=mb["vmask"]),
            TextBatch(bows=mb["bows"], tokens=mb["tokens"].long(),
                      type_ids=mb["type_ids"].long(), mask=mb["tmask"]))


def _expert_loop(x, idx, w, valid, w13, w2):
    """Per-expert loop over tokens: sum_s w[t, s] expert_idx[t, s](x[t])."""
    f = w2.shape[2]
    out = torch.zeros_like(x)
    for t in range(x.shape[0]):
        if not valid[t]:
            continue
        for s in range(idx.shape[1]):
            e = int(idx[t, s])
            h = w13[e] @ x[t]
            out[t] = out[t] + w[t, s] * (w2[e] @ (F.silu(h[:f]) * h[f:]))
    return out


@pytest.mark.parametrize("n_tok, k, n_exp", [(12, 2, 8), (9, 3, 4)])
def test_k5_plain_path_matches_a_per_expert_loop(n_tok, k, n_exp):
    """Forward, and backward twice: dX each time, and the experts'
    gradients summed over both in .grad (the update's accumulation)."""
    g = torch.Generator().manual_seed(n_tok)
    d, f = 8, 4
    x = torch.randn(n_tok, d, generator=g)
    valid = torch.rand(n_tok, generator=g) > 0.3
    idx = torch.stack([torch.randperm(n_exp, generator=g)[:k]
                       for _ in range(n_tok)])
    idx[0] = idx[1]                                # a shared pick
    w = torch.rand(n_tok, k, generator=g)
    w13 = torch.nn.Parameter(torch.randn(n_exp, 2 * f, d, generator=g))
    w2 = torch.nn.Parameter(torch.randn(n_exp, d, f, generator=g))
    grads = []
    for rep in range(2):
        xs = x.clone().requires_grad_(True)
        r = moe.route(idx, valid, n_exp)
        out = moe.combine(moe.moe_experts(moe.dispatch(xs, r), r.offsets,
                                          w13, w2), w, r)
        gout = torch.randn(n_tok, d, generator=g)
        (out * gout).sum().backward()
        xl = x.clone().requires_grad_(True)
        w13l = w13.detach().clone().requires_grad_(True)
        w2l = w2.detach().clone().requires_grad_(True)
        want = _expert_loop(xl, idx, w, valid, w13l, w2l)
        (want * gout).sum().backward()
        torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(xs.grad, xl.grad, atol=1e-5, rtol=1e-5)
        grads.append((w13l.grad, w2l.grad))
    torch.testing.assert_close(w13.grad, grads[0][0] + grads[1][0],
                               atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(w2.grad, grads[0][1] + grads[1][1],
                               atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("n_tok, k, n_exp", [(10, 6, 16), (7, 2, 3)])
def test_routing_rows_pads_and_combine_order(n_tok, k, n_exp):
    g = torch.Generator().manual_seed(k)
    scores = torch.rand(n_tok, n_exp, generator=g)
    _, idx = torch.topk(scores, k, dim=-1)
    valid = torch.arange(n_tok) < n_tok - 3          # the last 3 are pads
    r = moe.route(idx, valid, n_exp)
    n_rows = n_tok * k
    assert r.offsets.shape == (n_exp + 1,) and r.counts.shape == (n_exp + 1,)
    assert int(r.counts[:n_exp].sum()) == k * int(valid.sum())
    assert int(r.counts[n_exp]) == k * int((~valid).sum())
    assert int(r.counts.sum()) == n_rows
    for e in range(n_exp):
        want = int(((idx == e) & valid[:, None]).sum())
        assert int(r.counts[e]) == want
    token = r.slot_of_row // k
    # every valid token in k rows of k distinct experts, no pad routed
    seg = torch.bucketize(torch.arange(n_rows), r.offsets, right=True) - 1
    for t in range(n_tok):
        rows = (token == t).nonzero().flatten()
        assert rows.numel() == k
        experts = seg[rows]
        if valid[t]:
            assert sorted(experts.tolist()) == sorted(idx[t].tolist())
        else:
            assert (experts == n_exp).all()
    assert torch.equal(r.slot_of_row[r.inv], torch.arange(n_rows))
    # the combine sums a token's rows in slot order
    ys = torch.randn(n_rows, 5, generator=g)
    w = torch.rand(n_tok, k, generator=g)
    got = moe.combine(ys, w, r)
    want = torch.zeros(n_tok, 5)
    for t in range(n_tok):
        acc = ys[r.inv[t * k]] * w[t, 0]
        for s in range(1, k):
            acc = acc + ys[r.inv[t * k + s]] * w[t, s]
        want[t] = acc
    assert torch.allclose(got, want, atol=1e-6)


def test_routing_counter_counts_a_training_update():
    cfg = _cfg()
    cfg.accumulation_step = 2
    model, opt, state = init_state(cfg, torch.device("cpu"), seed=4)
    tower = model.text_tower()
    mbs = [ragged_batch(cfg, 4, s) for s in (3, 4)]
    for i, b in enumerate(mbs):
        b["brand_ids"] = np.arange(4) % cfg.brand_num
    sb = {k: torch.from_numpy(np.asarray(v))
          for k, v in stack_microbatches(mbs).items()}
    tower.reset_routing()
    train_step(model, opt, cfg, state, sb)
    counts = tower.routing_counts()
    k, e = TINY_TOWER["num_experts_per_tok"], TINY_TOWER["n_routed_experts"]
    valid = int(sum(b["tmask"].sum() for b in mbs))
    slots = 2 * 4 * cfg.max_tokens * k
    assert counts.shape == (2, e + 1)                  # 2 MoE layers
    assert (counts[:, :e].sum(1) == k * valid).all()
    assert (counts[:, e] == slots - k * valid).all()


def test_yarn_constants_at_the_published_widths():
    cfg = ds.DeepseekV2Config()              # DeepSeek-V2-Lite as published
    assert ds.yarn_ramp_bounds(cfg) == (10, 23)
    assert ds.softmax_scale(cfg) == pytest.approx(0.114721, abs=1e-6)
    assert ds.yarn_mscale(40, 0.707) == pytest.approx(1.26080, abs=1e-5)
    cos, sin = ds.rope_cos_sin(cfg, 4, "cpu")
    assert cos.shape == (4, 64)
    assert torch.equal(cos[0], torch.ones(64))        # mscale ratio 1
    # pair i turns at frequency i: the extrapolated one below the ramp,
    # the interpolated one (/ 40) above it
    step = torch.atan2(sin[1], cos[1])[:32]
    base = 1.0 / (10000 ** (torch.arange(0, 64, 2).float() / 64))
    assert torch.allclose(step[:10], base[:10])
    assert torch.allclose(step[24:], base[24:] / 40)
    # the published layout change then rotate_half = each pair rotated
    x = torch.randn(1, 4, 2, 64)
    got = ds.apply_rope(x, cos, sin)
    want = ref.rotate_pairs(x, cos[:, :32], sin[:, :32])
    perm = torch.cat([torch.arange(0, 64, 2), torch.arange(1, 64, 2)])
    assert torch.allclose(got, want[..., perm], atol=1e-6)


@pytest.mark.parametrize("extra, match", [
    (dict(pp_stages=2), "--pp_stages"),
    (dict(seq_shard=True), "--seq_shard"),
    (dict(mesh_shape="1,2"), "model axis"),
    (dict(dtype="bfloat16"), "--dtype bfloat16"),
    (dict(bert_remat=True), "--bert_remat"),
    (dict(text_tower=dict(TINY_TOWER, q_lora_rank=8)), "query LoRA"),
    (dict(text_tower=dict(TINY_TOWER, scoring_func="sigmoid")), "scoring"),
    (dict(text_tower=dict(TINY_TOWER, n_group=2)), "group-limited"),
])
def test_config_refuses_what_the_tower_does_not_run(extra, match):
    kw = dict(tiny_cfg_kwargs("deepseek_v2"), **extra)
    with pytest.raises(NotImplementedError, match=match):
        Config(**kw).finalize()


def test_text_tower_flag_and_json_round_trip(tmp_path):
    path = tmp_path / "tower.json"
    path.write_text(json.dumps(dict(TINY_TOWER, model_type="deepseek_v2")))
    base = ["a", "b", "c", "--text_net", "deepseek_v2"]
    for spec in (str(path), json.dumps(TINY_TOWER)):
        cfg = config_from_args(build_train_parser().parse_args(
            base + ["--text_tower", spec]))
        assert cfg.tower_config().hidden_size == 64
    lite = config_from_args(build_train_parser().parse_args(base))
    assert lite.text_tower == {} and lite.tower_config().hidden_size == 2048
    again = Config.from_json(cfg.to_json())
    assert again.text_tower == TINY_TOWER
    cfg = _cfg()
    assert cfg.text_mapping_in == (cfg.bow_vocab_size + 64
                                   + 3 * cfg.text_kernel_num)

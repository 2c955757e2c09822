"""The training update as one CUDA graph (`train/step.py` `UpdateGraphs`).

On the CPU: the pieces the graph needs, each against what it replaces —
K2 keyed by seed words in a tensor as by ints, the contrastive queue's
pointer as a tensor as an int, a tensor lr under `scale_lr` and
`current_lr`, the brand tower's stand-in seed rows — and the rule that
keeps every update off the card eager, with its phase spans.

On a card (marker `chip`; `python -m pytest --noconftest
tests/test_torch_port_train_graph.py` there, since this suite's conftest
imports JAX): six updates through the graph against six issued eagerly,
from the same weights, seeds and batches, across two super-batch
signatures, a fresh queue and an lr decay, for each text tower (the
DeepSeek-V2 one's routed experts on K5, their routing on the device).

No JAX import here: the card has none.
"""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fancyrec_tpu_torch.config import Config
from fancyrec_tpu_torch.losses import (
    ContrastiveQueueState, contrastive_loss, init_queue_state)
from fancyrec_tpu_torch.models import FancyRec, init_fancyrec
from fancyrec_tpu_torch.models.bert import BertConfig, BertEncoder
from fancyrec_tpu_torch.models.brand import BrandAspects
from fancyrec_tpu_torch.ops import kernel_wrappers
from fancyrec_tpu_torch.ops.brand_dropout import (
    aspect_dropout_fwd_ref, aspect_dropout_mean, key_words)
from fancyrec_tpu_torch.parallel import collectives
from fancyrec_tpu_torch.train import step as train_step_mod
from fancyrec_tpu_torch.train.state import (
    TrainState, current_lr, full_optimizer_state, make_capturable,
    make_optimizer, scale_lr)
from fancyrec_tpu_torch.train.step import (
    UpdateGraphs, graphable, stack_microbatches, train_step)
from fancyrec_tpu_torch.utils import profiling
from torch_port_tiny import ragged_batch, tiny_cfg_kwargs

CPU = torch.device("cpu")


# --- K2's seed words in a tensor --------------------------------------------

@pytest.mark.parametrize("b, a, c", [(3, 10, 8), (2, 7, 5)])
def test_k2_keyed_by_a_tensor_matches_ints(b, a, c):
    g = torch.Generator().manual_seed(b * a + c)
    w = torch.randn(b, a, generator=g)
    asp = torch.randn(a, c, generator=g)
    gout = torch.randn(b, c, generator=g)
    words = (0x89ABCDEF, 0x01234567)
    outs, grads = [], []
    for seed in (words, torch.tensor(words, dtype=torch.int64)):
        wl, al = w.clone().requires_grad_(), asp.clone().requires_grad_()
        out = aspect_dropout_mean(wl, al, seed, 0.5)
        (out * gout).sum().backward()
        outs.append(out.detach())
        grads.append((wl.grad, al.grad))
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    # the plain forward keeps what the int key keeps, and drops some
    assert torch.equal(aspect_dropout_fwd_ref(w, asp, words, 0.5),
                       aspect_dropout_fwd_ref(
                           w, asp, torch.tensor(words), 0.5))
    assert not torch.equal(outs[0], aspect_dropout_fwd_ref(w, asp, words,
                                                           1.0))


def test_key_words_keeps_a_tensor_already_in_place():
    key = torch.tensor([5, 7], dtype=torch.int64)
    assert key_words(key, CPU) is key


def test_brand_seed_rows_stand_in_for_the_draws():
    """With `seed_rows` set, each training call reads the next row and
    draws nothing; the output is the one those words key."""
    brand = BrandAspects(4, 8, 16)
    with torch.no_grad():
        brand.brand_embeddings.normal_()
        brand.aspects_embeddings.normal_()
    brand.seed_generator = torch.Generator().manual_seed(3)
    ids = torch.tensor([0, 2, 3])
    want = [brand.draw_seed() for _ in range(2)]
    brand.seed_generator.manual_seed(3)
    drawn = [brand(ids) for _ in range(2)]
    after = brand.seed_generator.get_state()
    brand.seed_rows = iter(torch.stack(want).unbind(0))
    given = [brand(ids) for _ in range(2)]
    assert torch.equal(brand.seed_generator.get_state(), after)
    assert next(brand.seed_rows, None) is None
    for x, y in zip(drawn, given):
        assert torch.equal(x, y)


# --- the queue's pointer as a tensor ----------------------------------------

@pytest.mark.parametrize("no_queue", [False, True])
def test_contrastive_loss_tensor_pointer_matches_int(no_queue):
    """K = 20, B = 8: six microbatches wrap the queue twice."""
    k, b, d = 20, 8, 6
    g = torch.Generator().manual_seed(11)
    s_int = init_queue_state(k, d)
    s_ten = ContrastiveQueueState(s_int.queue.clone(),
                                  torch.zeros((), dtype=torch.int64))
    for _ in range(6):
        brand = torch.randn(b, d, generator=g)
        post = torch.randn(b, d, generator=g)
        l_int, s_int = contrastive_loss(brand, post, s_int, no_queue=no_queue)
        l_ten, s_ten = contrastive_loss(brand, post, s_ten, no_queue=no_queue)
        assert isinstance(s_int.ptr, int)
        assert isinstance(s_ten.ptr, torch.Tensor) and s_ten.ptr.dim() == 0
        assert int(s_ten.ptr) == s_int.ptr
        assert torch.equal(l_int, l_ten)
        assert torch.equal(s_int.queue, s_ten.queue)
    assert s_int.ptr == (0 if no_queue else 6 * b % k)


# --- the lr as a tensor ------------------------------------------------------

def test_scale_lr_and_current_lr_with_a_tensor_lr():
    params = [torch.nn.Parameter(torch.ones(3))]
    opt = make_optimizer(Config(learning_rate=1e-3), params)
    make_capturable(opt, CPU)
    lr = opt.param_groups[0]["lr"]
    assert isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
    assert opt.param_groups[0]["capturable"]
    scale_lr(opt, 0.5)
    assert opt.param_groups[0]["lr"] is lr           # scaled in place
    assert current_lr(opt) == pytest.approx(5e-4)
    assert isinstance(current_lr(opt), float)
    # a checkpoint holds the plain form, which any optimizer loads
    saved = full_optimizer_state(opt, torch.nn.Module())
    (group,) = saved["param_groups"]
    assert group["lr"] == pytest.approx(5e-4) and not group["capturable"]
    fresh = make_optimizer(Config(learning_rate=1.0), params)
    fresh.load_state_dict(saved)
    assert fresh.param_groups[0]["lr"] == pytest.approx(5e-4)


def test_scale_lr_with_a_float_lr():
    opt = make_optimizer(Config(learning_rate=1e-3),
                         [torch.nn.Parameter(torch.ones(2))])
    scale_lr(opt, 0.5)
    assert opt.param_groups[0]["lr"] == 5e-4


# --- when the graph engages --------------------------------------------------

class _OnCard:
    """Stands in for a model on a card: `graphable` reads its first
    parameter's device, its mesh, its pipeline flag and its modules."""

    def __init__(self, mesh=None, pp=False, modules=()):
        self.mesh, self.pp, self._modules = mesh, pp, list(modules)

    def parameters(self):
        yield types.SimpleNamespace(is_cuda=True)

    def modules(self):
        return iter(self._modules)


def _bert(remat):
    return BertEncoder(BertConfig(
        vocab_size=8, hidden_size=8, num_hidden_layers=1,
        num_attention_heads=2, intermediate_size=8,
        max_position_embeddings=8, remat=remat))


@pytest.mark.parametrize("case, want", [
    ("one card", True), ("bert without remat", True),
    ("data world of two", False), ("model mesh", False),
    ("pipeline", False), ("bert remat", False)])
def test_the_graph_engages_only_on_one_card(case, want, monkeypatch):
    model = {"one card": _OnCard(),
             "bert without remat": _OnCard(modules=[_bert(False)]),
             "data world of two": _OnCard(),
             "model mesh": _OnCard(mesh=object()),
             "pipeline": _OnCard(pp=True),
             "bert remat": _OnCard(modules=[_bert(True)])}[case]
    if case == "data world of two":
        monkeypatch.setattr(collectives, "data_size", lambda: 2)
    assert graphable(model) is want


A = 2


def _cpu_step_setup():
    kw = dict(tiny_cfg_kwargs("transformers", "ph", True),
              accumulation_step=A, grad_clip=2.0)
    cfg = Config(**kw).finalize()
    torch.manual_seed(0)
    model = FancyRec(cfg)
    model.seed_dropout(0)
    opt = make_optimizer(cfg, model.parameters())
    sb = {k: torch.from_numpy(v) for k, v in stack_microbatches(
        [dict(ragged_batch(cfg, 4, seed=10 + i),
              brand_ids=np.arange(4, dtype=np.int32) % cfg.brand_num)
         for i in range(A)]).items()}
    state = TrainState(queue=init_queue_state(cfg.queue_size,
                                              cfg.common_embedding_size))
    return model, opt, cfg, state, sb


def test_the_cpu_step_stays_eager_with_its_phase_spans():
    model, opt, cfg, state, sb = _cpu_step_setup()
    assert not graphable(model)
    profiling.take_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(3):             # a graph would capture by the second
            state, _ = train_step(model, opt, cfg, state, sb)
    names = [s.name for s in profiling.take_spans()]
    assert names.count("train.step") == 3
    assert names.count("train.forward") == names.count("train.backward") \
        == 3 * A
    assert names.count("train.optimizer") == 3
    assert "train.replay" not in names
    assert UpdateGraphs.of(model, opt, cfg) is None
    assert not hasattr(opt, "_update_graphs")
    assert isinstance(state.queue.ptr, int)
    assert not opt.param_groups[0]["capturable"]


# --- on the card: the graph against the eager update -------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the update graph runs there")
    return torch.device("cuda", 0)


def _superbatches(cfg, dev, n, seed):
    """n super-batches of A microbatches of 8 rows, alternately at the
    config's padded lengths and cut to 4 frames and 5 tokens: two
    signatures, as two buckets give."""
    out = []
    for u in range(n):
        mbs = [dict(ragged_batch(cfg, 8, seed=seed + 10 * u + i),
                    brand_ids=(np.arange(8, dtype=np.int32) + u)
                    % cfg.brand_num) for i in range(cfg.accumulation_step)]
        sb = stack_microbatches(mbs)
        if SHAPES[u] == "short":
            for k in ("frames", "vmask"):
                sb[k] = np.ascontiguousarray(sb[k][:, :, :4])
            for k in ("tokens", "type_ids", "tmask"):
                sb[k] = np.ascontiguousarray(sb[k][:, :, :5])
        out.append({k: torch.from_numpy(v).to(dev) for k, v in sb.items()})
    return out


# long: eager, captured, replayed, replayed; short: eager, captured
SHAPES = ["long", "long", "short", "long", "short", "long"]
FRESH_QUEUE_AT, DECAY_AT = 3, 4


def _train(text_net, graphed, dev):
    # mappings of 64, not the tiny 16: at 16 a ReLU and dropout row can
    # come out all zero, and the row norm (no epsilon, as the reference's)
    # makes it NaN in the eager update and the graph alike
    kw = dict(tiny_cfg_kwargs(text_net, "ph", True), accumulation_step=3,
              grad_clip=2.0, queue_size=20, batch_size=8,
              text_mapping_size=64, visual_mapping_size=64)
    cfg = Config(**kw).finalize()
    model = init_fancyrec(FancyRec(cfg), torch.Generator().manual_seed(7))
    model.to(dev).seed_dropout(123)
    opt = make_optimizer(cfg, model.parameters())
    if not graphed:                    # the same Adam arithmetic
        make_capturable(opt, dev)
    sbs = _superbatches(cfg, dev, len(SHAPES), seed=40)
    state = TrainState(queue=init_queue_state(
        cfg.queue_size, cfg.common_embedding_size, device=dev))
    before = {n: f.launches for n, f in kernel_wrappers().items()}
    metrics = []
    for u, sb in enumerate(sbs):
        if u == FRESH_QUEUE_AT:
            state = TrainState(queue=init_queue_state(
                cfg.queue_size, cfg.common_embedding_size, device=dev),
                step=state.step)
        if u == DECAY_AT:
            scale_lr(opt, 0.5)
        step = train_step if graphed else train_step_mod._train_step
        state, m = step(model, opt, cfg, state, sb)
        metrics.append(m)              # read at the end, as train_epoch does
    torch.cuda.synchronize(dev)
    read = [[float(m[k]) for k in ("loss", "last_loss", "grad_norm")]
            for m in metrics]
    launches = {n: f.launches - before[n]
                for n, f in kernel_wrappers().items()}
    return model, opt, state, read, launches


def _rel(x, y):
    x, y = x.detach().double().cpu(), y.detach().double().cpu()
    return float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))


@pytest.mark.chip
@pytest.mark.parametrize("text_net", ["transformers", "bi-gru",
                                      "deepseek_v2"])
def test_graphed_updates_match_eager_ones(card, text_net):
    m_g, o_g, s_g, loss_g, launches_g = _train(text_net, True, card)
    m_e, o_e, s_e, loss_e, launches_e = _train(text_net, False, card)
    graphs = o_g._update_graphs
    assert graphs.replays == 4 and len(graphs.graphs) == 2
    # the wrappers count a replay's kernels, and not a capture's
    assert launches_g == launches_e and launches_e["aspect_dropout_fwd"] \
        == len(SHAPES) * 3
    if text_net == "deepseek_v2":
        # K5: 4 row launches and 2 weight-gradient launches a MoE layer a
        # microbatch; the routing counters the graph added to in place
        n = len(SHAPES) * 3 * len(m_g.text_tower().moe_layers())
        assert (launches_e["moe_rows"], launches_e["moe_wgrad"]) \
            == (4 * n, 2 * n)
        assert torch.equal(m_g.text_tower().routing_counts(),
                           m_e.text_tower().routing_counts())
    gaps = {}
    for (n, a), (_, b) in zip(m_g.state_dict().items(),
                              m_e.state_dict().items()):
        gaps["model " + n] = _rel(a, b)      # parameters and BN statistics
    for (n, p), (_, q) in zip(m_g.named_parameters(), m_e.named_parameters()):
        for k in ("exp_avg", "exp_avg_sq", "step"):
            gaps["adam %s %s" % (k, n)] = _rel(o_g.state[p][k],
                                               o_e.state[q][k])
    gaps["queue"] = _rel(s_g.queue.queue, s_e.queue.queue)
    gaps["losses"] = _rel(torch.tensor(loss_g), torch.tensor(loss_e))
    assert int(s_g.queue.ptr) == s_e.queue.ptr
    assert current_lr(o_g) == current_lr(o_e)
    # the same draws: both generators stand where the eager run left them
    drop_g = [m.generator for m in m_g.modules() if hasattr(m, "generator")
              and m.generator is not None][0]
    drop_e = [m.generator for m in m_e.modules() if hasattr(m, "generator")
              and m.generator is not None][0]
    assert torch.equal(drop_g.get_state(), drop_e.get_state())
    assert torch.equal(m_g.brand_encoding.seed_generator.get_state(),
                       m_e.brand_encoding.seed_generator.get_state())
    worst = max(gaps, key=gaps.get)
    equal = sum(v == 0.0 for v in gaps.values())
    print("graph vs eager, %s: %d of %d tensors bit-equal; worst %s %.3g; "
          "losses %s" % (text_net, equal, len(gaps), worst, gaps[worst],
                         loss_g))
    assert gaps[worst] <= 1e-6, (worst, gaps[worst])

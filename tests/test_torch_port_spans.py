"""The port's host spans (`utils/profiling.span`) on the CPU: the recorder
itself, and the spans of the training step, the trainer's epoch with its
prefetch queue, and the extraction loop, with a torch.profiler session
running and without one."""

import collections
import gzip
import os
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fancyrec_tpu_torch.config import (Config, build_train_parser,
                                       config_from_args)
from fancyrec_tpu_torch.data.loader import BatchLoader
from fancyrec_tpu_torch.losses import init_queue_state
from fancyrec_tpu_torch.models import FancyRec
from fancyrec_tpu_torch.models import resnet
from fancyrec_tpu_torch.preprocess import features
from fancyrec_tpu_torch.train.state import TrainState, make_optimizer
from fancyrec_tpu_torch.train.step import stack_microbatches, train_step
from fancyrec_tpu_torch.train.trainer import build_datasets, train_epoch
from fancyrec_tpu_torch.utils import profiling
from fancyrec_tpu_torch.utils.fixture import make_fixture
from tests.test_torch_port_model import ragged_batch, tiny_cfg_kwargs
from tests.test_torch_port_trainer import TINY

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def empty_buffer():
    profiling.take_spans()
    yield
    profiling.take_spans()


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def by_name(spans, name):
    return [s for s in spans if s.name == name]


def inside(child, parent):
    return parent.start <= child.start <= child.end <= parent.end


# --- the recorder ---------------------------------------------------------

def test_a_span_records_nothing_without_a_profiler():
    with profiling.span("outer"):
        with profiling.span("inner"):
            pass
    assert profiling.take_spans() == []


def test_a_span_with_totals_is_timed_without_a_profiler():
    totals = {}
    for _ in range(3):
        with profiling.span("leg", totals):
            pass
    assert set(totals) == {"leg"} and totals["leg"] >= 0.0
    assert profiling.take_spans() == []


def test_spans_record_times_and_the_parent_on_their_own_thread():
    def worker():
        with profiling.span("other"):
            pass

    with profiled():
        with profiling.span("outer"):
            with profiling.span("inner"):
                t = threading.Thread(target=worker)
                t.start()
                t.join()
        with profiling.span("after"):
            pass
    spans = profiling.take_spans()
    assert [s.name for s in spans] == ["other", "inner", "outer", "after"]
    got = {s.name: s for s in spans}
    assert got["inner"].parent == "outer"
    assert got["outer"].parent is None and got["after"].parent is None
    assert got["other"].parent is None        # opened on another thread
    assert inside(got["inner"], got["outer"])
    assert got["outer"].end <= got["after"].start
    assert profiling.take_spans() == []


def test_the_buffer_keeps_the_newest_spans(monkeypatch):
    monkeypatch.setattr(profiling, "_spans", collections.deque(maxlen=4))
    with profiled():
        for i in range(10):
            with profiling.span("s%d" % i):
                pass
    assert [s.name for s in profiling.take_spans()] == [
        "s6", "s7", "s8", "s9"]


def test_spans_open_profiler_ranges_only_inside_trace(tmp_path):
    with profiled() as prof:
        with profiling.span("plain.span"):
            torch.ones(4).sum()
    assert not [e for e in prof.events() if e.name == "plain.span"]
    assert by_name(profiling.take_spans(), "plain.span")

    with profiling.trace(str(tmp_path), CPU):
        with profiling.span("traced.span"):
            torch.ones(4).sum()
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".json.gz")]
    with gzip.open(os.path.join(tmp_path, path), "rt") as f:
        assert '"traced.span"' in f.read()
    assert profiling.take_spans() == []       # they went into the trace


# --- the program's spans --------------------------------------------------

A = 2


@pytest.fixture(scope="module")
def step_setup():
    kw = dict(tiny_cfg_kwargs("transformers", "ph", True),
              accumulation_step=A, grad_clip=2.0)
    cfg = Config(**kw).finalize()
    torch.manual_seed(0)
    model = FancyRec(cfg)
    model.seed_dropout(0)
    opt = make_optimizer(cfg, model.parameters())
    mbs = []
    for i in range(A):
        mb = ragged_batch(cfg, 4, seed=10 + i)
        mb["brand_ids"] = np.arange(4, dtype=np.int32) % cfg.brand_num
        mbs.append(mb)
    sb = {k: torch.from_numpy(v)
          for k, v in stack_microbatches(mbs).items()}
    state = TrainState(queue=init_queue_state(cfg.queue_size,
                                              cfg.common_embedding_size))
    return model, opt, cfg, state, sb


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("spans_tree"))
    # 24 train posts: 6 batches of 4, 3 updates of 2 microbatches an epoch
    make_fixture(root, brand_num=3, videos_per_brand=4, imgs_per_brand=4,
                 feat_dim=16, frames_per_video=4, seed=0)
    cfg = config_from_args(build_train_parser().parse_args(
        TINY + ["--rootpath", root, "--text_net", "transformers"]))
    datasets = build_datasets(cfg)
    cfg.finalize()
    torch.manual_seed(0)
    model = FancyRec(cfg)
    model.seed_dropout(0)
    opt = make_optimizer(cfg, model.parameters())
    loader = BatchLoader(datasets["train"], cfg.batch_size, shuffle=True,
                         seed=0, final_batch="drop")
    return model, opt, cfg, loader


def run_epochs(tree, n):
    model, opt, cfg, loader = tree
    state = TrainState(queue=init_queue_state(cfg.queue_size,
                                              cfg.common_embedding_size))
    updates = []
    for epoch in range(n):
        state, st = train_epoch(model, opt, cfg, state, loader, epoch, CPU)
        updates.append(len(st["losses"]))
    return updates


def extract(tmp_path, n, stats=None):
    torch.manual_seed(0)
    state = resnet.ResNetFeatures((1, 0, 0, 0)).state_dict()
    rng = np.random.RandomState(1)
    stream = [("f%d" % i, rng.randint(0, 256, (32, 32, 3), np.uint8))
              for i in range(n)]
    return features.extract_features(iter(stream), str(tmp_path / "f"),
                                     batch_size=4, params=state,
                                     stats=stats, device="cpu")


@pytest.mark.parametrize("path", ["train_step", "train_epoch",
                                  "extract_features"])
def test_no_span_is_recorded_without_a_profiler(path, step_setup, tree,
                                                tmp_path):
    if path == "train_step":
        train_step(*step_setup)
    elif path == "train_epoch":
        assert run_epochs(tree, 1) == [3]
    else:
        stats = {}
        assert extract(tmp_path, 7, stats) == 7
        assert stats["batches"] == 2
    assert profiling.take_spans() == []


def test_an_update_records_its_step_and_phases(step_setup):
    with profiled():
        train_step(*step_setup)
    spans = profiling.take_spans()
    (step,) = by_name(spans, "train.step")
    assert step.parent is None
    fwd, bwd = by_name(spans, "train.forward"), by_name(spans,
                                                         "train.backward")
    (optim,) = by_name(spans, "train.optimizer")
    assert len(fwd) == len(bwd) == A and len(spans) == 2 * A + 2
    for s in fwd + bwd + [optim]:
        assert s.parent == "train.step" and inside(s, step)
    for i in range(A):                 # forward, backward, next microbatch
        assert fwd[i].end <= bwd[i].start
        if i + 1 < A:
            assert bwd[i].end <= fwd[i + 1].start
    assert bwd[-1].end <= optim.start


def test_an_epoch_records_a_wait_a_batch_and_one_loss_read(tree):
    with profiled():
        updates = run_epochs(tree, 2)
    spans = profiling.take_spans()
    assert updates == [3, 3]
    steps = by_name(spans, "train.step")
    waits = by_name(spans, "data.wait")
    reads = by_name(spans, "train.loss_read")
    assert len(steps) == 6 and len(reads) == 2
    # one wait for each super-batch, and one for the end of each epoch
    assert len(waits) == 6 + 2
    for s in steps + waits + reads:
        assert s.parent is None
    for s in steps:
        assert sum(inside(w, s) for w in waits) == 0
    # each epoch: its waits and steps, then its loss read
    for epoch in range(2):
        read = reads[epoch]
        mine = [s for s in steps + waits
                if s.end <= read.start
                and (epoch == 0 or s.start >= reads[epoch - 1].end)]
        assert len(mine) == 3 + 4


@pytest.mark.parametrize("traced", [False, True])
def test_extract_stats_are_the_totals_of_its_spans(tmp_path, traced):
    stats = {}
    if traced:
        with profiled():
            n = extract(tmp_path, 10, stats)
    else:
        n = extract(tmp_path, 10, stats)
    assert n == 10
    assert set(stats) == {"wait_s", "compute_s", "write_s", "batches"}
    assert stats["batches"] == 3
    spans = profiling.take_spans()
    if not traced:
        assert spans == [] and min(stats.values()) >= 0.0
        return
    legs = {"extract.wait": "wait_s", "extract.forward": "compute_s",
            "extract.write": "write_s"}
    assert {s.name for s in spans} == set(legs) | {"data.wait"}
    for name, key in legs.items():
        mine = by_name(spans, name)
        assert all(s.parent is None for s in mine)
        assert stats[key] == pytest.approx(
            sum((s.end - s.start) / 1e9 for s in mine), rel=1e-12, abs=0)
    # a wait for each batch and one for the end of the stream, each around
    # the prefetch queue's own
    assert len(by_name(spans, "extract.wait")) == 4
    assert len(by_name(spans, "extract.forward")) == 3
    assert all(s.parent == "extract.wait"
               for s in by_name(spans, "data.wait"))

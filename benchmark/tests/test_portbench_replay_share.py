"""replay_share.train on windows with hand-placed device operations and
program spans: the share of whole `train.step` spans holding a
`train.replay` span, and nothing where the program records no replay."""

import os

import pytest
import torch

import harness
import program_spans
from fancyrec_tpu_torch.utils import profiling

T0 = 1_700_000_000_000_000_000            # the window's 0 s, in Unix ns
READER = harness.import_file(
    os.path.join(harness.BENCH, "layer_metrics", "replay_share.train.py"),
    "m_replay_share_train")


@pytest.fixture
def read(monkeypatch):
    """The reader on a 10 s window busy from 0.5 s to 9.5 s, handed these
    (name, start s, end s, parent) spans as the program would hand them."""
    def run(spans):
        w = harness.Window(False, torch.device("cpu"))
        w.t0, w.t1, w._trace_ns = 0.0, 10.0, T0
        w.ops = [("op", 0.5, 9.5)]
        monkeypatch.setattr(program_spans, "_take", lambda window: [
            profiling.Span(n, T0 + int(s * 1e9), T0 + int(e * 1e9), p)
            for n, s, e, p in spans])
        return READER.read({"window": w})
    return run


def step(t, replay=True):
    out = [("train.step", t, t + 0.5, None)]
    if replay:
        out.append(("train.replay", t + 0.1, t + 0.2, "train.step"))
    return out


def test_every_step_a_replay_reads_100(read):
    assert read(step(1.0) + step(2.0) + step(3.0)) == pytest.approx(100.0)


def test_an_eager_step_counts_against_the_share(read):
    assert read(step(1.0) + step(2.0, replay=False) + step(3.0)
                + step(4.0)) == pytest.approx(75.0)


def test_steps_cut_by_the_window_are_left_out(read):
    # the first starts before the window, the last ends after it
    assert read([("train.step", -0.2, 0.3, None)] + step(2.0)
                + [("train.step", 9.8, 10.4, None)]) == pytest.approx(100.0)


def test_nothing_without_replay_spans_or_steps(read):
    assert read(step(1.0, replay=False) + step(2.0, replay=False)) is None
    assert read([]) is None

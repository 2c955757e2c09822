"""The readers of the program's spans (`program_spans.py` and the
metrics built on it) on windows with hand-placed device operations and
spans; on the card, the clock the spans share with the device trace, and
no span recorded in an untraced run."""

import os
import statistics
import sys
import types

import pytest
import torch

import harness
import program_spans
from fancyrec_tpu_torch.utils import profiling

LM = os.path.join(harness.BENCH, "layer_metrics")
T0 = 1_700_000_000_000_000_000            # the window's 0 s, in Unix ns
NEW = {"data_wait_idle.train": "data.wait", "step_idle.train": "train.step",
       "forward_idle.extract": "extract.forward",
       "write_idle.extract": "extract.write"}


def _metric(name):
    return harness.import_file(os.path.join(LM, name + ".py"),
                               "m_" + name.replace(".", "_"))


def window(ops, seconds=10.0):
    w = harness.Window(False, torch.device("cpu"))
    w.t0, w.t1, w._trace_ns = 0.0, seconds, T0
    w.ops = [("op%d" % i, s, e) for i, (s, e) in enumerate(ops)]
    return w


def sp(name, start, end, parent=None):
    """A span of the program, from window seconds to Unix ns."""
    return profiling.Span(name, T0 + int(start * 1e9), T0 + int(end * 1e9),
                          parent)


@pytest.fixture
def given(monkeypatch):
    """Hand the next reader these spans, as the program would."""
    def put(*spans):
        monkeypatch.setattr(program_spans, "_take", lambda w: list(spans))
    return put


# busy 1-2, 3-5 (two operations overlapping), 7-8: idle 0-1, 2-3, 5-7, 8-10
OPS = [(1.0, 2.0), (3.0, 4.5), (4.0, 5.0), (7.0, 8.0)]


def test_idle_is_the_window_less_the_device_operations():
    w = window(OPS)
    assert program_spans.idle(w) == [(0.0, 1.0), (2.0, 3.0), (5.0, 7.0),
                                     (8.0, 10.0)]
    assert sum(b - a for a, b in program_spans.idle(w)) == pytest.approx(
        10.0 - w.busy_s())


@pytest.mark.parametrize("spans, name, share", [
    # overlap: 0.5-2.5 holds 0.5 of idle before the op at 1 and 0.5 after
    ([sp("data.wait", 0.5, 2.5)], "data.wait", 10.0),
    # two spans of one name: their union, not a sum
    ([sp("train.step", 4.0, 6.0), sp("train.step", 5.5, 7.5)],
     "train.step", 20.0),
    # entirely under device work
    ([sp("extract.write", 3.2, 4.8)], "extract.write", 0.0),
    # crossing both edges of the window: clipped to 0 and 10 s
    ([sp("extract.forward", -3.0, 0.5), sp("extract.forward", 9.0, 12.0)],
     "extract.forward", 15.0),
])
def test_idle_share_in_hand_placed_spans(given, spans, name, share):
    given(*spans)
    assert program_spans.idle_share(window(OPS), name) == pytest.approx(
        share)


def test_nested_spans_count_once_under_their_top_level_span(given):
    given(sp("train.forward", 1.5, 2.5, "train.step"),
          sp("train.backward", 2.5, 3.5, "train.step"),
          sp("train.step", 1.5, 6.0),
          sp("data.wait", 8.5, 9.0))
    w = window(OPS)
    a = program_spans.attribution(w)
    assert a["by_span"] == pytest.approx({
        "train.forward": 0.5, "train.backward": 0.5, "train.step": 2.0,
        "data.wait": 0.5})
    assert a["top_level"] == pytest.approx(2.5)
    assert a["idle"] == pytest.approx(6.0)
    assert a["outside"] == pytest.approx(3.5)
    assert a["top_level"] + a["outside"] == pytest.approx(
        10.0 - w.busy_s())


def test_host_step_ms_is_the_median_step(given):
    given(*[sp("train.step", 0.1 * i, 0.1 * i + d)
            for i, d in enumerate((0.2, 0.25, 0.3))],
          sp("train.forward", 0.0, 0.1, "train.step"))
    assert _metric("host_step_ms.train").read(
        {"window": window(OPS)}) == pytest.approx(250.0)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_reader_reads_its_own_span(given, metric):
    given(sp(NEW[metric], 0.5, 2.5), sp("other.span", 5.0, 7.0))
    assert _metric(metric).read({"window": window(OPS)}) == pytest.approx(
        10.0)


@pytest.mark.parametrize("metric", sorted(NEW) + ["host_step_ms.train"])
def test_readers_give_none_without_a_trace_or_spans(given, monkeypatch,
                                                    metric):
    m = _metric(metric)
    name = NEW.get(metric, "train.step")
    given(sp(name, 0.5, 2.5))
    assert m.read({"window": window([])}) is None           # no trace
    given(sp("other.span", 0.5, 2.5))
    assert m.read({"window": window(OPS)}) is None          # not this span
    given()
    assert m.read({"window": window(OPS)}) is None          # no spans
    # a program that records none (one from before the spans)
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules,
                        "fancyrec_tpu_torch.utils.profiling",
                        types.ModuleType("profiling"))
    assert m.read({"window": window(OPS)}) is None


def test_spans_are_taken_from_the_program_once(monkeypatch):
    from torch.profiler import ProfilerActivity, profile
    profiling.take_spans()
    w = window([(1.0, 1e6)], seconds=1e6)
    w._trace_ns = profiling.time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("train.step"):
            with profiling.span("train.forward"):
                pass
    got = program_spans.spans(w)
    assert [(n, p) for n, _, _, p in got] == [
        ("train.forward", "train.step"), ("train.step", None)]
    assert all(0.0 <= s <= e < 60.0 for _, s, e, _ in got)
    assert program_spans.spans(w) is got and profiling.take_spans() == []


def test_sync_offsets(given):
    given(sp("train.loss_read", 1.5, 2.0005), sp("train.loss_read", 3.5,
                                                 4.2),
          sp("train.loss_read", 0.1, 0.2))
    got = program_spans.sync_offsets(window(OPS), "train.loss_read")
    assert [a for _, a in got] == [False, True]       # none before 0.2 s
    assert got[0][0] == pytest.approx(0.0005, abs=1e-6)


class _Event:
    """A trace event as torch.profiler's results give it."""

    def __init__(self, corr, on_device, start, end):
        self.corr, self.on_device = corr, on_device
        self.start, self.end = start, end

    def correlation_id(self):
        return self.corr

    def device_type(self):
        from torch.autograd import DeviceType
        return DeviceType.CUDA if self.on_device else DeviceType.CPU

    def start_ns(self):
        return self.start

    def duration_ns(self):
        return self.end - self.start


def traced_window(events, seconds=10.0):
    """A window whose trace holds `events` (launch calls on the host's
    clock, device operations on the device's), its operations placed as
    the harness places them."""
    w = window([], seconds)
    w._prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))
    w.ops = [("op%d" % e.corr, (e.start - T0) / 1e9, (e.end - T0) / 1e9)
             for e in events if e.on_device]
    return w


def launched(ops, ahead_s, lag_s):
    """Each (host launch s, device start s, device end s) as a launch
    call `ahead_s` long and its operation, the device's clock `lag_s`
    ahead of the host's."""
    out = []
    for i, (h, s, e) in enumerate(ops, 1):
        out.append(_Event(i, False, T0 + int(h * 1e9),
                          T0 + int((h + ahead_s) * 1e9)))
        out.append(_Event(i, True, T0 + int((s + lag_s) * 1e9),
                          T0 + int((e + lag_s) * 1e9)))
    return out


def test_only_operations_that_start_on_an_idle_card_read_the_clock():
    # the second is launched 0.1 ms after the first and waits behind it
    # for 100 ms; the third starts 5 us after the second ends
    w = traced_window(launched([(1.0, 1.000005, 1.1),
                                (1.0001, 1.100001, 1.2),
                                (1.3, 1.300007, 1.4),
                                (1.39, 1.400005, 1.5)], 5e-6, 2e-3))
    assert program_spans._launch_lags(w) == [
        (T0 + 10 ** 9, 2_005_000), (T0 + 1_300_000_000, 2_007_000)]


def test_device_clock_is_the_least_launch_lag_nearby():
    ns = int(1e9)
    assert program_spans.device_clock([])(123) == 123
    # a launch each ms over 2 s, 5 us to the device, 0-3 ms more while it
    # is busy; the device's clock 3 ms ahead from 1 s on
    lags = [(i * ns // 1000,
             5_000 + (i * 7919) % 3_000_000 * (i % 4 != 0)
             + (3_000_000 if i >= 1000 else 0)) for i in range(2000)]
    clock = program_spans.device_clock(lags)
    for t, ahead in ((0.1, 5_000), (0.9, 5_000), (1.2, 3_005_000),
                     (1.9, 3_005_000)):
        assert clock(int(t * ns)) - int(t * ns) == ahead
    # far from any launch: the nearest launches' reading
    assert clock(5 * ns) - 5 * ns == 3_005_000
    assert clock(-ns) == -ns + 5_000


def test_spans_are_moved_onto_the_device_clock(given):
    """The device's clock 2 ms ahead of the host's: by the host's clock
    each span that waits for the device would end inside the operation
    it waited for; moved, it ends after it, late by the launch's 10 us."""
    ops = []
    for k in range(20):
        t = 0.1 + 0.2 * k            # launched, run at once for 10 ms
        ops.append((t, t + 10e-6, t + 0.01))
    w = traced_window(launched(ops, 5e-6, 2e-3))
    given(*[sp("extract.forward", t, e + 50e-6) for t, _, e in ops])
    got = program_spans.sync_offsets(w, "extract.forward")
    assert len(got) == 20 and not any(a for _, a in got)
    assert [o for o, _ in got] == pytest.approx([60e-6] * 20, abs=1e-6)
    s = program_spans.spans(w)[0]
    assert s[1] == pytest.approx(0.1 + 2e-3 + 10e-6, abs=1e-6)


def test_spans_stay_on_the_hosts_clock_without_launch_calls(given):
    w = traced_window([_Event(1, True, T0 + 1, T0 + 10 ** 9)])
    given(sp("train.step", 0.5, 2.5))
    assert program_spans.spans(w) == [("train.step", 0.5, 2.5, None)]


# --- on the card -----------------------------------------------------------

def _run_cell(name, seed, seconds, trace):
    import run
    run._environment()
    cell = harness.Cell(harness.spec(), name)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx = dict(cell=cell, seed=seed, seconds=seconds, trace=trace,
               device=torch.device("cuda", 0), t_start=0.0,
               work=run.work_dir(name))
    return cell.driver().run(ctx)


@pytest.mark.chip
@pytest.mark.parametrize("cell, sync", [("bert3.train", "train.loss_read"),
                                        ("bert3.extract", "extract.forward")])
def test_spans_share_the_device_traces_clock(cell, sync):
    """In a traced run of the cell's own length, no device operation runs
    across the end of a span that ends in a wait for the device, and half
    of them end within 1 ms after the last operation before them; no
    operation is named after a span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the clock is the device trace's")
    profiling.take_spans()
    r = _run_cell(cell, 2 ** 31 + 77, harness.spec()["run_seconds"], True)
    w = r["observed"]["window"]
    assert w.ops and r["correct"]
    got = program_spans.spans(w)
    names = {s[0] for s in got}
    assert names and not any(n in names for n, _, _ in w.ops)
    clock = program_spans.device_clock(program_spans._launch_lags(w))
    ahead = sorted(clock(t) - t for t in (w._trace_ns + int(s * 1e9)
                                          for _, s, _, _ in got))
    sync_at = program_spans.sync_offsets(w, sync)
    offsets = sorted(o for o, _ in sync_at)
    print("clock %s: device clock ahead of the host's by %.1f us (median), "
          "%.1f to %.1f us; %d %s spans end %.1f us (median), %.1f to "
          "%.1f us after the last device operation, %d past 1 ms"
          % (cell, ahead[len(ahead) // 2] / 1e3, ahead[0] / 1e3,
             ahead[-1] / 1e3, len(offsets), sync,
             1e6 * statistics.median(offsets), 1e6 * offsets[0],
             1e6 * offsets[-1], sum(o > 1e-3 for o in offsets)))
    a = program_spans.attribution(w)
    print("idle %s: %.2f%% of the window; inside %s; outside every span "
          "%.2f%%" % (cell, 100 * a["idle"] / a["window"], ", ".join(
              "%s %.2f%%" % (n, 100 * v / a["window"])
              for n, v in sorted(a["by_span"].items())),
              100 * a["outside"] / a["window"]))
    assert len(offsets) >= 2 and not any(a for _, a in sync_at)
    assert statistics.median(offsets) <= 1e-3


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["bert3.train", "bigru.train",
                                  "bert3.extract"])
def test_an_untraced_run_records_no_span(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells run there")
    profiling.take_spans()
    r = _run_cell(cell, 2 ** 31 + 78, 4.0, False)
    assert r["correct"] and profiling.take_spans() == []

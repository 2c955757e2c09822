"""Host spans beside the device trace, and the trainer's --profile_dir.

`span(name)` marks a range of the host's work: the training step and its
phases, the wait on the prefetch queue, the extraction loop's legs. A span
records (name, start, end, parent) only while a torch.profiler session is
running (the trainer's --profile_dir, or any caller's own session), on any
thread, and otherwise costs one read of the profiler's flag. Its times are
`time.time_ns()`, the Unix clock in ns on which torch.profiler reports its
host events. The trace's device events can stray from that clock by
milliseconds; a reader that lines spans up with kernels moves them by the
lag it reads between launch calls and their kernels (the benchmark's
`program_spans.py` does). `parent` is the name of the span
that was open on the same thread when it started (None for a top-level
span). `take_spans()` returns what was recorded and empties the buffer,
which keeps the newest `SPAN_LIMIT` spans.

`trace(logdir)` is the trainer's --profile_dir: port of
fancyrec_tpu/utils/profiling.py's `trace`. Where the JAX package writes an
XProf trace, the port writes torch.profiler's Chrome trace (gzipped JSON,
which Perfetto and chrome://tracing open). Inside it each span also opens
a `torch.profiler.record_function` range of its name, so that the trace
shows the span above the kernels it launched. Only there: under another
session a span adds no event to the trace.
"""

from __future__ import annotations

import collections
import contextlib
import os
import threading
import time
from typing import List, NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

SPAN_LIMIT = 1 << 17


class Span(NamedTuple):
    name: str
    start: int                  # ns, time.time_ns()
    end: int
    parent: Optional[str]


_spans: "collections.deque[Span]" = collections.deque(maxlen=SPAN_LIMIT)
_local = threading.local()
_annotate = False               # set inside trace()


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    """A span that is recorded, or timed into `totals`, or both."""

    __slots__ = ("name", "totals", "recording", "parent", "start", "rf")

    def __init__(self, name: str, totals: Optional[dict], recording: bool):
        self.name, self.totals, self.recording = name, totals, recording
        self.parent = self.rf = None

    def __enter__(self):
        if self.recording:
            stack = _stack()
            self.parent = stack[-1] if stack else None
            stack.append(self.name)
            if _annotate:
                self.rf = torch.profiler.record_function(self.name)
                self.rf.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        if self.totals is not None:
            self.totals[self.name] = (self.totals.get(self.name, 0.0)
                                      + (end - self.start) / 1e9)
        if self.recording:
            if self.rf is not None:
                self.rf.__exit__(*exc)
            _stack().pop()
            _spans.append(Span(self.name, self.start, end, self.parent))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, totals: Optional[dict] = None):
    """A context manager marking the enclosed host work as `name`. With a
    `totals` dict it is always timed, and its seconds are added to
    totals[name], whether or not a profiler is running."""
    # torch.profiler's process-wide flag: the C state is the enabling
    # thread's own, and a span may run on another
    recording = _autograd_profiler._is_profiler_enabled
    if not recording and totals is None:
        return _OFF
    return _Span(name, totals, recording)


def take_spans() -> List[Span]:
    """The recorded spans in the order they ended; the buffer is left
    empty. Safe while other threads record."""
    out = []
    while True:
        try:
            out.append(_spans.popleft())
        except IndexError:
            return out


@contextlib.contextmanager
def trace(logdir: Optional[str], device: Optional[torch.device] = None):
    """Profile the enclosed work into `logdir`/trace_<pid>_<ms>.json.gz;
    a no-op when `logdir` is empty. On a CUDA device the trace also holds
    the device's kernels, and a trace without any raises: a profiler that
    cannot see the card is an error, not a quiet host-only trace. The
    spans of the enclosed work are in the trace as ranges of their names,
    and are not kept for `take_spans`."""
    global _annotate
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    on_cuda = device is not None and torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU]
    if on_cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        _annotate = True
        try:
            yield
            if on_cuda:
                torch.cuda.synchronize(device)
        finally:
            _annotate = False
    take_spans()
    path = os.path.join(logdir, "trace_%d_%d.json.gz"
                        % (os.getpid(), int(time.time() * 1e3)))
    prof.export_chrome_trace(path)
    if on_cuda and not any(
            e.device_type == torch.autograd.DeviceType.CUDA
            for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no device activity on "
                           "%s; the trace %s holds the host only"
                           % (device, path))
    print("profile trace written to %s" % path)

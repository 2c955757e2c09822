"""The program's own host spans in a traced window, and the device's idle
time inside them.

The program records its spans (`fancyrec_tpu_torch.utils.profiling`) while
a torch.profiler session runs, so in a `--trace 1` run they are the
window's. They are stamped in Unix ns, the clock torch.profiler reports
its host events on: `spans(window)` takes them from the program once,
places them on the window's clock as `harness.Window` places the device
operations, and clips them to the window. A program that keeps no spans
(one from before they existed) gives none, and every reader then returns
None.

The device operations' times can stray from the host's clock by
milliseconds for seconds at a time, while the host's own events (the
runtime calls in the trace, and the spans) keep to it. So each span is
moved by the device clock's reading at that moment. A device operation
that starts on an idle card starts a launch's latency (microseconds)
after the host call that launched it, which the trace links to it by
correlation id: its lag from that call reads the device clock's offset,
plus the latency. The least such lag among the launches within
`ANCHOR_S` of a moment is taken, so the spans land at most a latency
late. A trace without launch calls leaves the spans where the host's
clock puts them.

Idle time is the window less the union of its device operations; the
idle inside a set of spans is its intersection with their union.
"""

from __future__ import annotations

import bisect
import statistics
from typing import Callable, List, Optional, Tuple

Interval = Tuple[float, float]


def _base_ns(window) -> Optional[int]:
    """The trace's ns at the window's 0 s, as the harness placed the device
    operations: the window's own stamp, unless the first operation read
    before it and the harness moved the trace to start at 0."""
    if not window.ops:
        return None
    if min(s for _, s, _ in window.ops) > 0.0:
        return window._trace_ns
    from torch.autograd import DeviceType
    events = window._prof.profiler.kineto_results.events()
    return min(e.start_ns() for e in events
               if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)


ANCHOR_S = 0.01
IDLE_NS = 10_000


def _launch_lags(window) -> List[Tuple[int, int]]:
    """(host ns at which the launch call began, ns from it to the start
    the device operation reads) for each device operation that starts
    with none running in the `IDLE_NS` before it and whose launch call
    the trace holds, in host order; [] if there is none."""
    prof = getattr(window, "_prof", None)
    if prof is None:
        return []
    from torch.autograd import DeviceType
    cuda = DeviceType.CUDA
    calls, ops = {}, []
    for e in prof.profiler.kineto_results.events():
        c = e.correlation_id()
        if not c:
            continue
        if e.device_type() == cuda:
            d = e.duration_ns()
            if d > 0:                     # the operations the harness keeps
                s = e.start_ns()
                ops.append((s, s + d, c))
        else:
            t = e.start_ns()
            calls[c] = min(t, calls.get(c, t))
    lags, reach = [], None
    for s, end, c in sorted(ops):
        if (reach is None or s - reach >= IDLE_NS) and c in calls:
            lags.append((calls[c], s - calls[c]))
        reach = end if reach is None else max(reach, end)
    return sorted(lags)


def device_clock(lags: List[Tuple[int, int]]):
    """host ns -> the device trace's ns at that moment: the least launch
    lag among the launches within `ANCHOR_S` of it (the nearest launches'
    where none are that close); the host's own ns without launches."""
    if not lags:
        return lambda t: t
    width = int(ANCHOR_S * 1e9 / 2)
    least = {}
    for t, lag in lags:
        k = t // width
        if lag < least.get(k, lag + 1):
            least[k] = lag
    keys = sorted(least)

    def at(t: int) -> int:
        k = t // width
        near = [least[j] for j in range(k - 2, k + 3) if j in least]
        if not near:
            i = bisect.bisect_left(keys, k)
            near = [least[keys[j]] for j in (i - 1, i)
                    if 0 <= j < len(keys)]
        return t + min(near)
    return at


def _take(window) -> list:
    try:
        from fancyrec_tpu_torch.utils.profiling import take_spans
    except ImportError:
        return []
    return take_spans()


def spans(window) -> List[tuple]:
    """(name, start s, end s, parent) of every program span in the window,
    on its clock, clipped to [0, window.seconds]; taken from the program
    on the first call and kept on the window."""
    have = getattr(window, "program_spans", None)
    if have is not None:
        return have
    raw = _take(window)
    base = _base_ns(window) if raw else None
    out = []
    if base is not None:
        clock = device_clock(_launch_lags(window))
        for sp in raw:
            s = max(0.0, (clock(sp.start) - base) / 1e9)
            e = min(window.seconds, (clock(sp.end) - base) / 1e9)
            if e > s:
                out.append((sp.name, s, e, sp.parent))
    window.program_spans = out
    return out


def union(intervals) -> List[Interval]:
    out: List[list] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1]:
            out[-1][1] = max(out[-1][1], hi)
        else:
            out.append([lo, hi])
    return [(lo, hi) for lo, hi in out]


def busy(window) -> List[Interval]:
    """The union of the window's device operations, within it; kept on
    the window."""
    have = getattr(window, "program_busy", None)
    if have is None:
        have = window.program_busy = union(
            (max(0.0, s), min(window.seconds, e)) for _, s, e in window.ops)
    return have


def idle(window) -> List[Interval]:
    """The gaps between the window's device operations, within it."""
    gaps, reach = [], 0.0
    for lo, hi in busy(window):
        if lo > reach:
            gaps.append((reach, lo))
        reach = max(reach, hi)
    if window.seconds > reach:
        gaps.append((reach, window.seconds))
    return gaps


def overlap_s(a: List[Interval], b: List[Interval]) -> float:
    """The length of the intersection of two sorted, disjoint interval
    lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_s(window, keep: Callable[[tuple], bool]) -> float:
    """Seconds of the window with no device operation while the host is
    inside a span that `keep` selects."""
    return overlap_s(idle(window),
                     union(sp[1:3] for sp in spans(window) if keep(sp)))


def idle_share(window, name: str) -> Optional[float]:
    """The share of the window, in %, with no device operation while the
    host is inside a span `name`; None without device operations or
    without such spans."""
    if not window.ops or not any(sp[0] == name for sp in spans(window)):
        return None
    return 100.0 * idle_in_s(window, lambda sp: sp[0] == name) / \
        window.seconds


def median_ms(window, name: str) -> Optional[float]:
    """The median length of the spans `name`, in ms; None without device
    operations or without such spans."""
    if not window.ops:
        return None
    lengths = [e - s for n, s, e, _ in spans(window) if n == name]
    return 1e3 * statistics.median(lengths) if lengths else None


def attribution(window) -> dict:
    """Idle seconds by span name (a span's idle counts for each name open
    around it), the idle inside the top-level spans, the idle outside
    every span, and the whole idle time, with the window's seconds."""
    names = sorted({sp[0] for sp in spans(window)})
    out = {"by_span": {n: idle_in_s(window, lambda sp, n=n: sp[0] == n)
                       for n in names},
           "top_level": idle_in_s(window, lambda sp: sp[3] is None),
           "idle": sum(hi - lo for lo, hi in idle(window)),
           "window": window.seconds}
    out["outside"] = out["idle"] - idle_in_s(window, lambda sp: True)
    return out


def sync_offsets(window, name: str) -> List[Tuple[float, bool]]:
    """For each span `name` that ends in a wait for the device: how long
    after the end of the last device operation that finished before it
    the span ends, in s, and whether a device operation runs across its
    end. On one clock the first is small and positive and the second
    never true."""
    ends = sorted(e for _, _, e in window.ops)
    on = busy(window)
    starts = [lo for lo, _ in on]
    out = []
    for n, _, end, _ in spans(window):
        i = bisect.bisect_right(ends, end)
        if n != name or i == 0:
            continue
        j = bisect.bisect_left(starts, end) - 1
        out.append((end - ends[i - 1], j >= 0 and on[j][1] > end))
    return out

"""Observability primitives: meters, log collection, progress.

Reference equivalents: AverageMeter/LogCollector (util/util.py:17-72) and
the Keras-style Progbar (util/util.py:99-253). The progress display here is
a single-line throughput readout rather than a redrawn bar (friendlier to
captured logs)."""

from __future__ import annotations

import sys
import time
from collections import OrderedDict


class AverageMeter:
    """Running mean/current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / (1e-4 + self.count)

    def __str__(self):
        if self.count == 0:
            return str(self.val)
        return "%.4f (%.4f)" % (self.val, self.avg)


class LogCollector:
    """Ordered dict of named AverageMeters."""

    def __init__(self):
        self.meters: "OrderedDict[str, AverageMeter]" = OrderedDict()

    def update(self, k, v, n=1):
        self.meters.setdefault(k, AverageMeter()).update(v, n)

    def __str__(self):
        return "  ".join("%s %s" % (k, v) for k, v in self.meters.items())


class Progress:
    """Lightweight progress reporter: items/sec + named values."""

    def __init__(self, total: int, label: str = "", interval: float = 5.0,
                 stream=None):
        self.total = total
        self.label = label
        self.interval = interval
        # None = resolve sys.stdout at WRITE time: a default bound at
        # definition/construction time outlives redirected streams (e.g.
        # pytest capture buffers closed by an earlier test)
        self.stream = stream
        self.seen = 0
        self.start = time.time()
        self._last = 0.0
        self.values = LogCollector()

    def add(self, n: int, values=None):
        self.seen += n
        for k, v in (values or []):
            self.values.update(k, v, n)
        now = time.time()
        if now - self._last >= self.interval or self.seen >= self.total:
            rate = self.seen / max(now - self.start, 1e-9)
            eta = (self.total - self.seen) / max(rate, 1e-9)
            stream = self.stream if self.stream is not None else sys.stdout
            stream.write(
                "%s %d/%d  %.1f/s  eta %ds  %s\n"
                % (self.label, self.seen, self.total, rate, int(eta),
                   self.values))
            stream.flush()
            self._last = now


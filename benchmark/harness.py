"""What every cell shares: the benchmark's files found by name, the
device's description, the traced window and what it read, the check for
JAX in the process, and the result line.

Nothing here imports the program. A cell's driver does, inside its run.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from typing import Dict, List, Tuple

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "fancyrec_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def spec(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def import_file(path: str, name: str):
    """A module from a file of the benchmark, by path: metric files are
    named after metrics, whose names hold dots."""
    mod_spec = importlib.util.spec_from_file_location(name, path)
    if mod_spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of `workloads`, with its configuration and traffic files,
    its driver, and the metrics it reports."""

    def __init__(self, bench: dict, name: str, root: str = ROOT):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError("no workload %r in BENCHMARK.json (have %s)"
                           % (name, ", ".join(sorted(cells))))
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        self.config = load_json(os.path.join(root,
                                             self.config_entry["file"]))
        self.traffic = load_json(os.path.join(
            BENCH, "traffic", self.entry["traffic"] + ".json"))
        self.driver_path = os.path.join(BENCH, "drivers",
                                        self.traffic["driver"] + ".py")
        self.chips = int(self.entry["chips"])

        def here(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if here(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def driver(self):
        return import_file(self.driver_path, "driver_" + self.traffic["driver"])

    def metric_reader(self, metric: dict):
        path = os.path.join(BENCH, "layer_metrics", metric["name"] + ".py")
        return import_file(path, "metric_" + metric["name"].replace(".", "_"))


def smi() -> Dict[str, str]:
    """The card's name and power limit as nvidia-smi reads them, or what
    went wrong."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        line = out.stdout.strip().splitlines()[0]
        name, limit = [s.strip() for s in line.split(",", 1)]
        return {"smi_name": name, "power_limit": limit}
    except (OSError, IndexError, ValueError, subprocess.SubprocessError) as e:
        return {"smi_name": "unread", "power_limit": "unread (%s)" % e}


def union_s(spans: List[Tuple[float, float]]) -> float:
    """The length of the union of (start, end) intervals, in their unit."""
    total, reach = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > reach:
            total += hi - max(lo, reach)
            reach = hi
    return total


class Window:
    """The measured window: its host times and, when traced, every device
    operation that ran in it (torch.profiler, device activity only), as
    (name, start s, end s) on the window's clock, and the benchmark's own
    spans around the calls into the program."""

    def __init__(self, trace: bool, device):
        self.trace = trace and device.type == "cuda"
        self.device = device
        self.ops: List[Tuple[str, float, float]] = []
        self.spans: List[Tuple[str, float, float]] = []
        self.t0 = self.t1 = None
        self._prof = None

    def span(self, name: str):
        """A host span of the benchmark's own, on the window's clock."""
        w = self

        @contextlib.contextmanager
        def cm():
            s = time.perf_counter()
            try:
                yield
            finally:
                w.spans.append((name, s - w.t0, time.perf_counter() - w.t0))
        return cm()

    def __enter__(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        self.t0 = time.perf_counter()
        self._trace_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        """End the window: the device drained, the clock read, the trace
        stopped (before its events are read)."""
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.t1 = time.perf_counter()
        if self._prof is not None:
            self._prof.__exit__(None, None, None)
            self._read_trace()
        return False

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    def _read_trace(self):
        from torch.autograd import DeviceType
        events = self._prof.profiler.kineto_results.events()
        raw = [(e.name(), e.start_ns(), e.end_ns()) for e in events
               if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0]
        if not raw:
            self.ops = []
            return
        # the window's clock: its first device operation cannot start
        # before the window, so place the trace's ns clock by the host's
        base = min(s for _, s, _ in raw)
        first = max(0.0, (base - self._trace_ns) / 1e9)
        self.ops = [(n, first + (s - base) / 1e9, first + (e - base) / 1e9)
                    for n, s, e in raw]

    def busy_s(self, match=None) -> float:
        spans = [(s, e) for n, s, e in self.ops
                 if match is None or match(n)]
        return union_s(spans)

    def breakdown(self) -> dict:
        """The ten device operations that took most time (summed by name),
        and the ten longest idle gaps, each named by the benchmark span the
        host was in."""
        by_name: Dict[str, float] = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps, reach = [], 0.0
        for _, s, e in sorted(self.ops, key=lambda o: o[1]):
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, e)
        if self.seconds > reach:
            gaps.append((reach, self.seconds))
        gaps.sort(key=lambda g: g[0] - g[1])

        def host_at(t):
            inside = [(e - s, n) for n, s, e in self.spans if s <= t <= e]
            return min(inside)[1] if inside else "outside the spans"

        idle = [["%s @%.4fs" % (host_at(0.5 * (a + b)), a), b - a]
                for a, b in gaps[:10]]
        return {"device_ops": [[n[:120], v] for n, v in top],
                "idle_gaps": idle}


def device_record(device, chips: int) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(chips))
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": chips, "memory_peak_bytes": int(peak)}


def forbidden_modules() -> List[str]:
    """Modules of JAX or of the JAX package loaded in this process, by
    whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in FORBIDDEN})


def emit(result: dict, checks: Dict[str, Tuple[float, float]],
         out=None) -> dict:
    """The checks as the last lines of standard error, then the result as
    the last line of standard output, its checks last."""
    # a number that cannot be read (a malformed answer) is past any limit;
    # the line stays strict JSON
    checks = {k: (v if math.isfinite(v) else 1e300, lim)
              for k, (v, lim) in checks.items()}
    for name, (value, limit) in checks.items():
        print("check %s %r limit %r" % (name, value, limit), file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    print(json.dumps(result), file=out or sys.stdout)
    (out or sys.stdout).flush()
    return result

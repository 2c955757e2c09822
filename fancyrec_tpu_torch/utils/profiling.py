"""The trainer's --profile_dir: a torch.profiler trace of one epoch.

Port of fancyrec_tpu/utils/profiling.py's `trace`: where the JAX package
writes an XProf trace, the port writes torch.profiler's Chrome trace
(gzipped JSON, which Perfetto and chrome://tracing open).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(logdir: Optional[str], device: Optional[torch.device] = None):
    """Profile the enclosed work into `logdir`/trace_<pid>_<ms>.json.gz;
    a no-op when `logdir` is empty. On a CUDA device the trace also holds
    the device's kernels, and a trace without any raises: a profiler that
    cannot see the card is an error, not a quiet host-only trace."""
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
        yield
        if on_cuda:
            torch.cuda.synchronize(device)
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

"""Build and load the port's CUDA kernels and its host library.

Each `csrc/<name>.cu` compiles with `nvcc` into `build/kernels/lib<name>.so`
(a plain C interface, no PyTorch headers, so a build takes seconds) and
loads through `ctypes`. The host library `csrc/<name>.cpp` (the row
gather of `io/native.py`) compiles with the host's `g++` into
`build/host/`. Builds happen at first use, from the repository's sources
only; a library older than its source is rebuilt. Nothing here runs at
import time: the CPU tests import every module on machines without
`nvcc`.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
HOST_BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "host")
HOST_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread", "-Wall"]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from csrc/ at first use")
    return found


def _paths(name: str):
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD_DIR, "lib%s.so" % name))


def _stale(name: str) -> bool:
    src, lib = _paths(name)
    return (not os.path.exists(lib)
            or os.path.getmtime(lib) < os.path.getmtime(src))


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile the named kernels, one `nvcc` per source, all at once.

    Returns {name: ptxas report}. Each library is written to a temporary
    file and renamed into place, so a concurrent reader never loads a
    half-written one. Raises with the compiler's output on failure."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in names:
        src, lib = _paths(name)
        tmp = "%s.%d.tmp" % (lib, os.getpid())
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append("%s (nvcc exit %d):\n%s"
                          % (name, proc.returncode, out))
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built if missing or stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(_paths(name)[1])
            _libs[name] = lib
        return lib


def host_compiler() -> Optional[str]:
    """The host's C++ compiler (g++), or None where it has none."""
    return shutil.which("g++")


def load_host(name: str) -> ctypes.CDLL:
    """The loaded host library for `csrc/<name>.cpp`, built with `g++` if
    missing or stale. Processes that build at once (test workers, the ranks
    of a world) take an exclusive file lock, so one compiles and the others
    load its result; the library is written to a temporary file and renamed
    into place. Raises if there is no compiler or the build fails."""
    with _lock:
        key = "host:" + name
        lib = _libs.get(key)
        if lib is not None:
            return lib
        src = os.path.join(CSRC, name + ".cpp")
        out = os.path.join(HOST_BUILD_DIR, "lib%s.so" % name)

        def stale():
            return (not os.path.exists(out)
                    or os.path.getmtime(out) < os.path.getmtime(src))

        if stale():
            os.makedirs(HOST_BUILD_DIR, exist_ok=True)
            with open(out + ".lock", "w") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
                if stale():
                    cxx = host_compiler()
                    if cxx is None:
                        raise RuntimeError("g++ not found: %s is built from "
                                           "source at first use" % src)
                    tmp = "%s.%d.tmp" % (out, os.getpid())
                    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, src],
                                          capture_output=True, text=True)
                    if proc.returncode != 0:
                        raise RuntimeError("host build of %s failed (g++ exit "
                                           "%d):\n%s" % (src, proc.returncode,
                                                          proc.stderr))
                    os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        _libs[key] = lib
        return lib


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def raw_stream(device: torch.device) -> int:
    """The cudaStream_t, as an int, of the current PyTorch stream of a CUDA
    device, for a C entry's `stream` parameter."""
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    get = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    return get(index) if get else torch.cuda.current_stream(index).cuda_stream


def call_on(device: torch.device, fn, args):
    """fn(*args) with `device` the current CUDA device, switched to only
    where it is not already."""
    if device.index is None or device.index == torch.cuda.current_device():
        return fn(*args)
    with torch.cuda.device(device):
        return fn(*args)

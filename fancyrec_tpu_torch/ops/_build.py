"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` into `build/kernels/lib<name>.so`
(a plain C interface, no PyTorch headers, so a build takes seconds) and
loads through `ctypes`. Builds happen at first use, from the repository's
sources only; a library older than its source is rebuilt. Nothing here runs
at import time: the CPU tests import every module on machines without
`nvcc`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import Dict, Iterable

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")
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

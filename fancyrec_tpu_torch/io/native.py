"""The native row gather: a ctypes binding of `csrc/fancyrec_io.cpp`.

Port of fancyrec_tpu/io/native.py. The library memory-maps a feature.bin
once and copies scattered float32 rows into one contiguous buffer (ctypes
releases the interpreter lock for the call, so the loader's prefetch
thread gathers while the main thread drives the card). Unlike the JAX
copy it spreads no gather over threads and has no prefetch hint: see the
head of csrc/fancyrec_io.cpp.

It is built with the host's g++ at first use into build/host/
(`ops._build.load_host`). Where the host has no C++ compiler, `load()`
logs that once and returns None, and `BigFileReader` gathers through its
numpy memmap instead (`reader.engine` names the one in use). A compiler
that fails to build the library raises.
"""

from __future__ import annotations

import ctypes
import logging
import threading
from typing import Optional

import numpy as np

from fancyrec_tpu_torch.ops import _build

log = logging.getLogger(__name__)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_no_compiler_logged = False


def load() -> Optional[ctypes.CDLL]:
    """The bound library, built on the first call; None (logged once)
    where the host has no C++ compiler."""
    global _lib, _no_compiler_logged
    with _lock:
        if _lib is not None:
            return _lib
        if _build.host_compiler() is None:
            if not _no_compiler_logged:
                _no_compiler_logged = True
                log.warning("no host C++ compiler (g++): BigFile rows are "
                            "gathered through numpy memmaps, not the native "
                            "gather")
            return None
        lib = _build.load_host("fancyrec_io")
        i64, ptr_i64 = ctypes.c_int64, ctypes.POINTER(ctypes.c_int64)
        lib.frio_open.restype = i64
        lib.frio_open.argtypes = [ctypes.c_char_p, i64, i64]
        lib.frio_gather.restype = ctypes.c_int
        lib.frio_gather.argtypes = [i64, ptr_i64, i64,
                                    ctypes.POINTER(ctypes.c_float)]
        lib.frio_close.restype = ctypes.c_int
        lib.frio_close.argtypes = [i64]
        _lib = lib
        return _lib


def available() -> bool:
    return load() is not None


class NativeGather:
    """The native mmap gather over one feature.bin of `rows` x `dim`
    float32. Raises where the library is not available."""

    def __init__(self, path: str, rows: int, dim: int):
        lib = load()
        if lib is None:
            raise RuntimeError("the native gather needs a host C++ compiler")
        self._lib = lib
        self.rows, self.dim = rows, dim
        handle = lib.frio_open(path.encode(), rows, dim)
        if handle < 0:
            raise OSError(-handle, "frio_open failed for %s" % path)
        self._handle = handle

    def gather(self, indices: np.ndarray, out: Optional[np.ndarray] = None
               ) -> np.ndarray:
        """Rows `indices` -> (n, dim) float32, written into `out` if given.
        An index outside [0, rows) raises IndexError."""
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(idx)
        if out is None:
            out = np.empty((n, self.dim), np.float32)
        elif (out.shape != (n, self.dim) or out.dtype != np.float32
              or not out.flags["C_CONTIGUOUS"]):
            raise ValueError("out must be C-contiguous float32 of shape "
                             "(%d, %d)" % (n, self.dim))
        rc = self._lib.frio_gather(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IndexError("frio_gather failed (an index out of range, or "
                             "the store closed)")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", -1) >= 0:
            self._lib.frio_close(self._handle)
            self._handle = -1

    def __del__(self):
        self.close()

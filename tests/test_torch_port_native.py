"""The port's native row gather (`fancyrec_tpu_torch/io/native.py` over its
own `csrc/fancyrec_io.cpp`) against the numpy memmap and the JAX package's
`BigFileReader.read_rows`, bit for bit. The six cases of
tests/test_native_io.py, plus the build's own guarantees: the library comes
from the port's source, builds once when processes race, and a host
without a compiler falls back to the memmap visibly."""

import ctypes
import logging
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from fancyrec_tpu.io.bigfile import ImageBigFile as JaxImageBigFile
from fancyrec_tpu_torch.io import bigfile, native
from fancyrec_tpu_torch.io.bigfile import BigFileWriter, ImageBigFile
from fancyrec_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("nat") / "feat")
    rng = np.random.RandomState(0)
    mat = rng.randn(500, 64).astype(np.float32)
    with BigFileWriter(d, ndims=64) as w:
        w.write_batch(["r%d" % i for i in range(500)], mat)
    return d, mat


def _memmap(d):
    return np.memmap(os.path.join(d, "feature.bin"), dtype=np.float32,
                     mode="r", shape=(500, 64))


def test_native_builds_and_gathers(store):
    d, mat = store
    assert native.available()            # g++ is on this host: no fallback
    g = native.NativeGather(d + "/feature.bin", 500, 64)
    idx = np.array([499, 0, 7, 7, 123], np.int64)
    out = g.gather(idx)
    np.testing.assert_array_equal(out, np.asarray(_memmap(d)[idx]))
    np.testing.assert_array_equal(out, JaxImageBigFile(d).read_rows(idx))
    np.testing.assert_array_equal(out, mat[idx])
    g.close()


def test_native_rejects_bad_index(store):
    d, _ = store
    g = native.NativeGather(d + "/feature.bin", 500, 64)
    for bad in ([500], [-1], [3, 500, 4]):
        with pytest.raises(IndexError):
            g.gather(np.array(bad, np.int64))
    with pytest.raises(ValueError, match="C-contiguous float32"):
        g.gather(np.array([1, 2], np.int64), out=np.empty((2, 64), np.float64))
    g.close()


def test_bigfile_uses_native_transparently(store):
    d, mat = store
    r = ImageBigFile(d)
    assert r.engine == "native" and r._native is not None
    idx = np.random.RandomState(1).randint(0, 500, 200)
    got = r.read_rows(idx)
    np.testing.assert_array_equal(got, np.asarray(_memmap(d)[idx]))
    np.testing.assert_array_equal(got, JaxImageBigFile(d).read_rows(idx))
    names = ["r%d" % i for i in (3, 1, 499)]
    np.testing.assert_array_equal(r.read_by_names(names), mat[[3, 1, 499]])
    assert JaxImageBigFile(d).read([0, 9, 4], isname=False) == r.read(
        [0, 9, 4], isname=False)


def test_large_gather_multithreaded_path(store):
    """The JAX package's multithreaded-gather case. The port copies on the
    caller's thread at every size; a 36 MB gather (the size of a
    fast-training frame batch) still equals the memmap bit for bit."""
    d, mat = store
    g = native.NativeGather(d + "/feature.bin", 500, 64)
    idx = np.random.RandomState(2).randint(0, 500, 140_000).astype(np.int64)
    out = g.gather(idx)
    np.testing.assert_array_equal(out, np.asarray(_memmap(d)[idx]))
    np.testing.assert_array_equal(out, JaxImageBigFile(d).read_rows(idx))
    small = idx[:5000]
    np.testing.assert_array_equal(g.gather(small), mat[small])
    g.close()


def test_stale_handle_after_slot_reuse_fails_cleanly(tmp_path, store):
    """After a close, a slot reused by another file rejects the old handle
    (the generation check) instead of serving the new file's rows."""
    d, mat = store
    other_dir = str(tmp_path / "other")
    other = np.arange(500 * 64, dtype=np.float32).reshape(500, 64)
    with BigFileWriter(other_dir, ndims=64) as w:
        w.write_batch(["o%d" % i for i in range(500)], other)
    g1 = native.NativeGather(d + "/feature.bin", 500, 64)
    lib, h1 = g1._lib, g1._handle
    lib.frio_close(h1)                     # closed behind the wrapper's back
    g2 = native.NativeGather(other_dir + "/feature.bin", 500, 64)
    try:
        idx = np.zeros(1, np.int64)
        out = np.empty((1, 64), np.float32)
        rc = lib.frio_gather(
            h1, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), 1,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        assert rc == -1
        np.testing.assert_array_equal(g2.gather(np.array([0], np.int64)),
                                      other[[0]])
    finally:
        g1._handle = -1
        g2.close()


def test_concurrent_close_does_not_corrupt_gathers(store):
    """Gathers on threads racing a close each return the right rows or a
    clean error, never a torn copy or a read of unmapped memory."""
    d, mat = store
    # 36 MB a gather, so that the close lands while the copies run
    idx = np.random.RandomState(3).randint(0, 500, 140_000).astype(np.int64)
    expected = mat[idx]
    for _ in range(5):
        g = native.NativeGather(d + "/feature.bin", 500, 64)
        results = []

        def reader():
            try:
                results.append(np.array_equal(g.gather(idx), expected))
            except IndexError:
                results.append(True)       # a clean error after the close
        threads = [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        g.close()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(results) == 3 and all(results), "torn gather under close"


def test_library_is_built_from_the_ports_own_source():
    """The port compiles csrc/fancyrec_io.cpp into build/host/, never the
    JAX package's native/ tree."""
    lib = native.load()
    path = os.path.join(_build.HOST_BUILD_DIR, "libfancyrec_io.so")
    assert lib._name == path and os.path.exists(path)
    src = os.path.join(_build.CSRC, "fancyrec_io.cpp")
    assert os.path.exists(src)
    assert os.path.getmtime(path) >= os.path.getmtime(src)
    assert os.path.commonpath([_build.HOST_BUILD_DIR, ROOT]) == ROOT
    assert "native" not in os.path.relpath(path, ROOT).split(os.sep)


_RACE = """
import sys
sys.path.insert(0, sys.argv[1])
from fancyrec_tpu_torch.ops import _build
_build.HOST_BUILD_DIR = sys.argv[2]
_build.load_host("fancyrec_io")
print("built")
"""


def test_processes_building_at_once_compile_it_once(tmp_path):
    """Four processes that find no library at once: the file lock lets one
    compile and the others load its result; no temporary file is left."""
    out = str(tmp_path / "host")
    procs = [subprocess.Popen([sys.executable, "-c", _RACE, ROOT, out],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for _ in range(4)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert sorted(os.listdir(out)) == ["libfancyrec_io.so",
                                       "libfancyrec_io.so.lock"]
    lib = ctypes.CDLL(os.path.join(out, "libfancyrec_io.so"))
    assert lib.frio_close(12345) == -1     # an unknown handle: a clean error


def test_no_compiler_falls_back_to_the_memmap_and_says_so(
        store, monkeypatch, caplog):
    """Where the host has no C++ compiler the reader gathers through its
    memmap, names that engine and logs it once."""
    d, mat = store
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_no_compiler_logged", False)
    monkeypatch.setattr(_build, "host_compiler", lambda: None)
    with caplog.at_level(logging.WARNING, logger=native.__name__):
        readers = [bigfile.ImageBigFile(d) for _ in range(3)]
    assert [r.engine for r in readers] == ["memmap"] * 3
    assert sum("no host C++ compiler" in m for m in caplog.messages) == 1
    idx = np.array([4, 400, 4], np.int64)
    np.testing.assert_array_equal(readers[0].read_rows(idx), mat[idx])

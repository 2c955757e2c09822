"""Guards of the port: it never reaches into the JAX package, and its entry
points refuse to run when asked for a GPU that is not there."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "fancyrec_tpu")


def _port_sources():
    files = sorted((ROOT / "fancyrec_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", getattr(node.func, "attr", ""))
              in ("__import__", "import_module") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def test_port_imports_nothing_of_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 20 and all(f.exists() for f in files)
    bad = ["%s:%d imports %s" % (f.relative_to(ROOT), line, mod)
           for f in files for line, mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_cuda_without_a_gpu(no_cuda, tmp_path):
    from fancyrec_tpu_torch.device import resolve_device
    from fancyrec_tpu_torch.serving import index, server

    for dev in (None, "cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            resolve_device(dev)
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index.build_index("ckpt", str(tmp_path), "coll", str(tmp_path / "o"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index.PostIndex(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.FancyRecService(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index.main(["query", str(tmp_path), "--brands", "0"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        server.main([str(tmp_path), "--port", "0"])


def test_kernel_wrappers_refuse_cpu_tensors():
    from fancyrec_tpu_torch.ops.gru_scan import gru_scan_cuda
    from fancyrec_tpu_torch.ops.similarity import topk_int8_cuda

    with pytest.raises(ValueError, match="CUDA"):
        gru_scan_cuda(torch.zeros(2, 2, 1, 6), torch.zeros(2, 6, 2),
                      torch.zeros(2, 6))
    with pytest.raises(ValueError, match="CUDA"):
        topk_int8_cuda(torch.zeros(1, 4), torch.zeros(3, 4, dtype=torch.int8),
                       torch.zeros(3), 2)

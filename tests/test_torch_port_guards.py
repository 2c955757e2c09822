"""Guards of the port: it never reaches into the JAX package, and its entry
points refuse to run when asked for a GPU that is not there."""

import ast
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
             "ml_dtypes", "fancyrec_tpu")


def _port_sources():
    files = sorted((ROOT / "fancyrec_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files.append(ROOT / "kernel_ab.py")
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
    scanned = {str(f.relative_to(ROOT)) for f in files}
    assert {"fancyrec_tpu_torch/losses/losses.py",
            "fancyrec_tpu_torch/ops/brand_dropout.py",
            "fancyrec_tpu_torch/train/trainer.py",
            "fancyrec_tpu_torch/train/step.py",
            "fancyrec_tpu_torch/eval/metrics.py",
            "fancyrec_tpu_torch/eval/tester.py",
            "fancyrec_tpu_torch/eval/scorers.py",
            "fancyrec_tpu_torch/data/modality.py",
            "fancyrec_tpu_torch/io/word2vec.py",
            "fancyrec_tpu_torch/io/msgpack.py",
            "fancyrec_tpu_torch/utils/profiling.py",
            "fancyrec_tpu_torch/models/torch_import.py",
            "fancyrec_tpu_torch/serving/ivf.py",
            "fancyrec_tpu_torch/serving/export.py",
            "fancyrec_tpu_torch/utils/tb_events.py",
            "fancyrec_tpu_torch/utils/meters.py",
            "fancyrec_tpu_torch/models/resnet.py",
            "fancyrec_tpu_torch/io/format_check.py",
            "fancyrec_tpu_torch/preprocess/features.py",
            "fancyrec_tpu_torch/preprocess/txt2bin.py",
            "fancyrec_tpu_torch/preprocess/frameinfo.py",
            "fancyrec_tpu_torch/preprocess/captions.py",
            "fancyrec_tpu_torch/preprocess/videos.py",
            "fancyrec_tpu_torch/preprocess/vocab_cli.py",
            "fancyrec_tpu_torch/preprocess/pipeline.py"} <= scanned
    bad = ["%s:%d imports %s" % (f.relative_to(ROOT), line, mod)
           for f in files for line, mod in _imported_modules(f)
           if mod.split(".")[0] in FORBIDDEN]
    assert not bad, bad


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_refuse_cuda_without_a_gpu(no_cuda, tmp_path):
    from fancyrec_tpu_torch.device import resolve_device
    from fancyrec_tpu_torch.eval import tester
    from fancyrec_tpu_torch.models import resnet
    from fancyrec_tpu_torch.preprocess import features, pipeline
    from fancyrec_tpu_torch.serving import export, index, ivf, server
    from fancyrec_tpu_torch.train import trainer

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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index.build_ivf_sidecar(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        index.main(["ivf-build", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ivf.IVFIndex.build(torch.zeros(4, 2).numpy())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ivf.IVFIndex.load(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.export_model("ckpt", str(tmp_path / "art"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.ExportedModel(str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.main([str(tmp_path / "art"), "--checkpoint", "ckpt"])
    for dev in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer.main(["train", "val", "test", "--rootpath",
                          str(tmp_path)] + dev)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tester.main(["test", "--rootpath", str(tmp_path),
                         "--logger_name", str(tmp_path)] + dev)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resnet.make_extractor({})
    frames = iter([("video1_0_cls0", torch.zeros(8, 8, 3).numpy())])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        features.extract_features(frames, str(tmp_path / "feats"))
    (tmp_path / "scrape" / "audi").mkdir(parents=True)
    for dev in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pipeline.main([str(tmp_path / "scrape"), str(tmp_path / "pp")]
                          + dev)
    assert not (tmp_path / "model").exists()      # refused before any write
    assert not (tmp_path / "feats").exists()
    assert not (tmp_path / "pp").exists()


def test_kernel_wrappers_refuse_cpu_tensors():
    from fancyrec_tpu_torch.ops.brand_dropout import (
        aspect_dropout_bwd_cuda, aspect_dropout_fwd_cuda)
    from fancyrec_tpu_torch.ops.gru_scan import (
        gru_scan_bwd_cuda, gru_scan_cuda)
    from fancyrec_tpu_torch.ops.similarity import (
        cosine_scores_cuda, topk_int8_cuda)

    with pytest.raises(ValueError, match="CUDA"):
        gru_scan_cuda(torch.zeros(2, 2, 1, 6), torch.zeros(2, 6, 2),
                      torch.zeros(2, 6))
    with pytest.raises(ValueError, match="CUDA"):
        topk_int8_cuda(torch.zeros(1, 4), torch.zeros(3, 4, dtype=torch.int8),
                       torch.zeros(3), 2)
    with pytest.raises(ValueError, match="CUDA"):
        cosine_scores_cuda(torch.ones(1, 4), torch.ones(3, 4))
    x = torch.zeros(2, 2, 1, 6)
    h = torch.zeros(2, 2, 1, 2)
    with pytest.raises(ValueError, match="CUDA"):
        gru_scan_bwd_cuda(x, h, h, torch.zeros(2, 6, 2), torch.zeros(2, 6))
    with pytest.raises(ValueError, match="CUDA"):
        aspect_dropout_fwd_cuda(torch.zeros(2, 3), torch.zeros(3, 4), (0, 0),
                                0.5)
    with pytest.raises(ValueError, match="CUDA"):
        aspect_dropout_bwd_cuda(torch.zeros(2, 3), torch.zeros(3, 4),
                                torch.zeros(2, 4), (0, 0), 0.5)

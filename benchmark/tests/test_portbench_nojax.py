"""Nothing a run imports is JAX or the JAX package, compared by whole
top-level module names (the port's name begins with the JAX package's),
and the plain reference imports nothing of the program."""

import ast
import glob
import os
import subprocess
import sys

import harness

PROBE = r"""
import glob, os, sys
bench = sys.argv[1]
sys.path[:0] = [os.path.dirname(bench), bench]
import run, harness
run._environment()
for path in sorted(glob.glob(os.path.join(bench, "drivers", "*.py"))
                   + glob.glob(os.path.join(bench, "layer_metrics", "*.py"))
                   + glob.glob(os.path.join(bench, "reference", "*.py"))):
    harness.import_file(path, "probe_" + os.path.basename(path)[:-3]
                        .replace(".", "_"))
# what the drivers import from the program inside their runs
import fancyrec_tpu_torch.train.trainer
import fancyrec_tpu_torch.preprocess.features
import fancyrec_tpu_torch.models.resnet
print("forbidden:" + ",".join(harness.forbidden_modules()))
"""


def test_no_jax_in_a_run_process():
    out = subprocess.run([sys.executable, "-c", PROBE, harness.BENCH],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fancyrec_tpu_torch_like", sys)
    assert "fancyrec_tpu_torch_like" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fancyrec_tpu", sys)
    assert "fancyrec_tpu" in harness.forbidden_modules()


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(harness.BENCH, "reference", "*.py")):
        tree = ast.parse(open(path).read())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in (
                    "fancyrec_tpu_torch", "fancyrec_tpu", "jax", "jaxlib",
                    "flax"), (path, n)

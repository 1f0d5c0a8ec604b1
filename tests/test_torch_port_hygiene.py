"""The port stands alone: no module of ``bigdl_tpu_torch/`` and not
``chip_smoke.py`` imports ``jax``, the JAX package ``bigdl_tpu`` (the
name itself, or with a ``.`` after it — ``bigdl_tpu_torch`` is the port)
or the reference's ``scripts/`` (home of the Pallas conv kernels). Only
the tests import both."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "bigdl_tpu", "scripts")
FILES = sorted((ROOT / "bigdl_tpu_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [n for n in _imports(path) if _forbidden(n)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_sees_the_package_and_the_rule_bites():
    assert len(FILES) > 10 and (ROOT / "chip_smoke.py").exists()
    assert ROOT / "bigdl_tpu_torch" / "ops" / "conv3x3.py" in FILES
    for name in ("layout.py", "tensor_parallel.py"):
        assert ROOT / "bigdl_tpu_torch" / "parallel" / name in FILES
    assert _forbidden("jax.numpy") and _forbidden("bigdl_tpu")
    assert _forbidden("scripts.perf_pallas_conv")
    assert _forbidden("bigdl_tpu.serving")
    assert not _forbidden("bigdl_tpu_torch.ops") and not _forbidden("jaxlib2")


def test_scan_sees_the_training_facade_modules():
    pkg = ROOT / "bigdl_tpu_torch"
    for rel in ("optim/optimizer.py", "optim/regularizer.py",
                "optim/trigger.py", "optim/validation.py",
                "optim/evaluator.py", "nn/module.py", "nn/containers.py",
                "nn/graph.py", "models/lenet.py", "dataset/sample.py",
                "dataset/minibatch.py", "dataset/transformer.py",
                "dataset/dataset.py", "dataset/mnist.py",
                "utils/fileio.py", "serving/adapters.py"):
        assert pkg / rel in FILES, rel


def test_scan_sees_the_cnn_modules():
    pkg = ROOT / "bigdl_tpu_torch"
    for rel in ("models/vgg.py", "models/inception.py", "models/alexnet.py",
                "models/routes.py", "nn/basic.py", "nn/normalization.py",
                "nn/conv.py"):
        assert pkg / rel in FILES, rel

"""The PyTorch port stands alone: no file of ``mxnet_tpu_torch/`` and not
``chip_smoke.py`` imports ``jax`` or the JAX package ``mxnet_tpu``."""
import ast
import os

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "mxnet_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(os.path.join(ROOT, "mxnet_tpu_torch")):
        out.extend(os.path.join(dirpath, f) for f in sorted(files)
                   if f.endswith(".py"))
    return sorted(out)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_file_imports_no_jax(path):
    bad = sorted({r for r in _imported_roots(path) if r in FORBIDDEN})
    assert not bad, "%s imports %s" % (os.path.relpath(path, ROOT), bad)


def test_scan_covers_the_package():
    names = {os.path.relpath(p, ROOT) for p in _port_files()}
    assert "chip_smoke.py" in names
    assert os.path.join("mxnet_tpu_torch", "ops", "kernels.py") in names
    for module in ("serving/kv_cache.py", "serving/decode.py",
                   "serving/continuous.py", "serving/router.py",
                   "ops/quantize.py", "ops/random_ops.py",
                   "ndarray/random.py", "symbol/random.py",
                   "filesystem.py", "recordio.py", "io_native.py",
                   "image/codec.py", "image/image.py", "image/__init__.py",
                   "ops/image_ops.py", "ndarray/image.py", "symbol/image.py",
                   "gluon/data/vision/datasets.py",
                   "gluon/data/vision/transforms.py",
                   "image/detection.py", "io_pipeline/__init__.py",
                   "io_pipeline/adapter.py", "io_pipeline/device.py",
                   "io_pipeline/executor.py", "io_pipeline/pipeline.py",
                   "io_pipeline/sharding.py", "io_pipeline/stages.py",
                   "kvstore/__init__.py", "kvstore/gradient_compression.py",
                   "kvstore/nccl.py", "kvstore/dist.py",
                   "kvstore_server.py", "parallel/__init__.py",
                   "parallel/mesh.py", "parallel/collectives.py",
                   "parallel/comm.py", "parallel/ring.py", "parallel/moe.py",
                   "parallel/pipeline.py", "parallel/train.py",
                   "module/_spmd.py", "module/sharded.py",
                   "module/pipeline_module.py", "operator.py", "rtc.py",
                   "contrib/__init__.py", "contrib/tensorboard.py",
                   "profiler.py", "observability/__init__.py",
                   "observability/tracing.py", "observability/telemetry.py",
                   "observability/instrument.py"):
        assert os.path.join("mxnet_tpu_torch", *module.split("/")) in names
    assert len(names) > 20

"""``mx.contrib.tensorboard.LogMetricsCallback`` against the JAX
package's, on the CPU: through the JSON-lines fallback writer (the writer
the callback takes where ``torch.utils.tensorboard`` is missing) the same
metric updates give the same lines in both packages, ``wall_time`` left
out; a pluggable writer sees the same ``add_scalar`` calls."""
import json

import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

PKGS = [mj, mt]


class _Param:
    def __init__(self, metric):
        self.eval_metric = metric


def _updates(pkg):
    metric = pkg.metric.create(["acc", "ce"])
    metric.update([pkg.nd.array([0, 1, 1], ctx=pkg.cpu())],
                  [pkg.nd.array([[0.9, 0.1], [0.3, 0.7], [0.6, 0.4]],
                                ctx=pkg.cpu())])
    return metric


def _jsonl(pkg, tmp_path, monkeypatch, prefix):
    tb = pkg.contrib.tensorboard
    monkeypatch.setattr(tb, "_make_writer", tb._JsonlWriter)
    logdir = tmp_path / pkg.__name__
    cb = tb.LogMetricsCallback(str(logdir), prefix=prefix)
    metric = _updates(pkg)
    for _ in range(3):
        cb(_Param(metric))
    cb(_Param(None))
    cb.summary_writer.close()
    lines = []
    with open(logdir / "events.jsonl") as f:
        for line in f:
            obj = json.loads(line)
            assert obj.pop("wall_time") > 0
            lines.append(obj)
    return lines


@pytest.mark.parametrize("prefix", [None, "train"])
def test_jsonl_lines_equal(tmp_path, monkeypatch, prefix):
    want = _jsonl(mj, tmp_path, monkeypatch, prefix)
    got = _jsonl(mt, tmp_path, monkeypatch, prefix)
    assert len(got) == 6
    assert [(g["step"], g["tag"]) for g in got] \
        == [(w["step"], w["tag"]) for w in want]
    np.testing.assert_allclose([g["value"] for g in got],
                               [w["value"] for w in want], rtol=1e-6)
    assert got[0]["tag"] == ("accuracy" if prefix is None
                             else "train-accuracy")


def test_pluggable_writer_sees_the_same_calls(monkeypatch):
    seen = {}
    for pkg in PKGS:
        calls = seen[pkg.__name__] = []

        class Writer:
            def add_scalar(self, tag, value, step):
                calls.append((tag, round(float(value), 6), step))

        tb = pkg.contrib.tensorboard
        monkeypatch.setattr(tb, "_make_writer", lambda d: Writer())
        cb = tb.LogMetricsCallback("unused")
        metric = _updates(pkg)
        cb(_Param(metric))
        cb(_Param(metric))
    assert seen["mxnet_tpu"] == seen["mxnet_tpu_torch"]
    assert [c[2] for c in seen["mxnet_tpu_torch"]] == [0, 0, 1, 1]


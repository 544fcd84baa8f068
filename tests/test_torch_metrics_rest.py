"""The metrics of ``mxnet_tpu/metric.py`` that this slice ports, against
the JAX package's, on the same seeded numpy labels and predictions over
two batches: names and values within 1e-6 (relative; both compute in
numpy on the host, so the values agree to float64 rounding).
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-6, atol=1e-6)


def _class_batch(r, n=16, k=5):
    pred = r.rand(n, k).astype(np.float32)
    return r.randint(0, k, n).astype(np.float32), \
        pred / pred.sum(1, keepdims=True)


def _binary_batch(r, n=16):
    return r.randint(0, 2, n).astype(np.float32), \
        r.rand(n, 2).astype(np.float32)


def _regression_batch(r, n=16):
    return r.randn(n, 3).astype(np.float32), r.randn(n, 3).astype(np.float32)


def _vector_batch(r, n=16):
    label = r.randn(n).astype(np.float32)
    return label, (label + 0.5 * r.randn(n)).astype(np.float32)


def _mae_feval(label, pred):
    return float(np.abs(label - pred).sum()), label.size


CASES = [
    ("top_k_accuracy", dict(top_k=3), _class_batch),
    ("top_k_acc", dict(top_k=2), _class_batch),
    ("f1", {}, _binary_batch),
    ("nll_loss", {}, _class_batch),
    ("negativeloglikelihood", dict(eps=1e-6), _class_batch),
    ("ce", {}, _class_batch),
    ("mae", {}, _regression_batch),
    ("mse", {}, _regression_batch),
    ("rmse", {}, _regression_batch),
    ("pearsonr", {}, _vector_batch),
    ("loss", {}, _regression_batch),
    ("torch", {}, _regression_batch),
    ("caffe", {}, _regression_batch),
]


def _measure(pkg, metric, batches):
    for label, pred in batches:
        metric.update([pkg.nd.array(label, ctx=pkg.cpu())],
                      [pkg.nd.array(pred, ctx=pkg.cpu())])
    return metric.get_name_value()


def _compare(got, want):
    assert [n for n, _ in got] == [n for n, _ in want]
    np.testing.assert_allclose([v for _, v in got], [v for _, v in want],
                               **TOL)


@pytest.mark.parametrize("name,kwargs,make", CASES)
def test_metric_matches_jax(name, kwargs, make):
    r = np.random.RandomState(len(name))
    batches = [make(r) for _ in range(2)]
    _compare(_measure(mt, mt.metric.create(name, **kwargs), batches),
             _measure(mj, mj.metric.create(name, **kwargs), batches))


def test_custom_metric_and_np_metric_match_jax():
    r = np.random.RandomState(3)
    batches = [_regression_batch(r) for _ in range(2)]
    for fn in (_mae_feval, lambda label, pred: float(np.square(
            label - pred).mean())):
        _compare(_measure(mt, mt.metric.CustomMetric(fn), batches),
                 _measure(mj, mj.metric.CustomMetric(fn), batches))

    def my_metric(label, pred):
        return float(np.abs(label - pred).max())

    _compare(_measure(mt, mt.metric.np_metric()(my_metric), batches),
             _measure(mj, mj.metric.np_metric()(my_metric), batches))


def test_composite_of_new_metrics_matches_jax():
    r = np.random.RandomState(4)
    batches = [_class_batch(r) for _ in range(2)]
    names = ["acc", "ce", "nll_loss", "top_k_accuracy"]
    got = mt.metric.CompositeEvalMetric()
    want = mj.metric.CompositeEvalMetric()
    for n in names:
        kw = dict(top_k=2) if n.startswith("top_k") else {}
        got.add(mt.metric.create(n, **kw))
        want.add(mj.metric.create(n, **kw))
    _compare(_measure(mt, got, batches), _measure(mj, want, batches))


def test_metric_validation_matches_jax():
    for pkg in (mt, mj):
        with pytest.raises(AssertionError):
            pkg.metric.create("top_k_accuracy", top_k=1)
        f1 = pkg.metric.create("f1")
        with pytest.raises(ValueError):
            f1.update([pkg.nd.array(np.array([0.0, 1.0, 2.0]),
                                    ctx=pkg.cpu())],
                      [pkg.nd.array(np.eye(3, dtype=np.float32),
                                    ctx=pkg.cpu())])

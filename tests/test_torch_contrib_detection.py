"""Parity of the port's contrib ops (``mxnet_tpu_torch/ops/contrib_ops.py``:
``box_iou``, ``box_nms``, the MultiBox trio, quantize/dequantize, the FFT
pair) with the JAX package's (``mxnet_tpu/ops/contrib_ops.py``), on the
host.

Tolerances: values within 1e-5 relative to each output's largest magnitude
(1e-4 for the FFT pair, whose sums run in another order), gradients within
1e-4; suppression decisions and quantized codes exactly.  The MultiBox ops
are held to the JAX op bodies called with float tuples, because the JAX
registry truncates their tuple attrs to ints (ROADMAP R14; the test at the
end shows it).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.ops import contrib_ops as jc
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.registry import get_op as port_op

from test_torch_train_ops import _run_both

REL = 1e-5
FFT_REL = 1e-4
GRAD_REL = 1e-4


def _close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=rel, atol=rel * scale)


def _check_both(results, rel=REL, grad=GRAD_REL):
    outs_j, outs_t, grads_j, grads_t = results
    for a, b in zip(outs_j, outs_t):
        _close(b, a, rel)
    for a, b in zip(grads_j, grads_t):
        _close(b, a, grad)


def _boxes(rng, *lead, n):
    """Corner boxes in [0, 1] with positive extent."""
    xy = rng.rand(*lead, n, 2) * 0.7
    wh = rng.rand(*lead, n, 2) * 0.3 + 0.02
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


@pytest.mark.parametrize("fmt", ["corner", "center"])
def test_box_iou_both_formats_and_gradients(fmt):
    rng = np.random.RandomState(0)
    a, b = _boxes(rng, 2, n=5), _boxes(rng, 2, n=3)
    _check_both(_run_both("_contrib_box_iou", [a, b], {"format": fmt}))
    _check_both(_run_both("box_iou", [a[0], b[0]], {"format": fmt}))


def _det_rows(rng, n, n_cls, ties=True):
    """Detection rows (class, score, 4 box) with tied scores, invalid
    (negative) scores and overlapping boxes."""
    boxes = _boxes(rng, n=n)
    boxes[1::3] = boxes[0::3][:len(boxes[1::3])] + 0.01
    scores = np.round(rng.rand(n), 1 if ties else 6).astype(np.float32)
    scores[::7] = -0.5
    cls = rng.randint(0, n_cls, n).astype(np.float32)
    return np.concatenate([cls[:, None], scores[:, None], boxes], 1)


NMS_CASES = [
    dict(overlap_thresh=0.3, valid_thresh=0.05, id_index=0),
    dict(overlap_thresh=0.3, topk=5, id_index=0),
    dict(overlap_thresh=0.2, force_suppress=True, id_index=0),
    dict(overlap_thresh=0.4),                     # class-blind, id_index -1
    dict(overlap_thresh=0.3, topk=30, valid_thresh=0.0, id_index=0,
         force_suppress=True),
]


@pytest.mark.parametrize("attrs", NMS_CASES)
def test_box_nms_with_ties_topk_force_suppress_and_id_index(attrs):
    """Suppressed rows -1 in the input order, exactly the JAX package's;
    the gradient reaches the kept rows only."""
    rng = np.random.RandomState(1)
    data = np.stack([_det_rows(rng, 40, 3) for _ in range(3)])
    results = _run_both("_contrib_box_nms", [data], attrs)
    np.testing.assert_array_equal(results[1][0], results[0][0])
    _check_both(results)
    assert (results[1][0][..., 1] == -1).any()


def test_box_nms_center_format_and_leading_axes():
    rng = np.random.RandomState(2)
    data = np.stack([_det_rows(rng, 16, 2) for _ in range(4)]).reshape(
        2, 2, 16, 6)
    corner = data[..., 2:].copy()
    data[..., 2:4] = (corner[..., :2] + corner[..., 2:]) / 2
    data[..., 4:6] = corner[..., 2:] - corner[..., :2]
    attrs = dict(overlap_thresh=0.3, id_index=0, in_format="center",
                 out_format="center")
    want = np.asarray(jc._box_nms(jnp.asarray(data), **attrs))
    got = port_op("box_nms").impl(torch.tensor(data), **attrs).numpy()
    np.testing.assert_array_equal(got, want)


def test_box_nms_refuses_a_format_change():
    x = torch.zeros(1, 4, 6)
    with pytest.raises(mx.base.MXNetError):
        port_op("box_nms").impl(x, in_format="corner", out_format="center")
    with pytest.raises(ValueError):
        jc._box_nms(jnp.zeros((1, 4, 6)), in_format="corner",
                    out_format="center")


def test_nms_order_is_stable_and_the_plain_sweep_is_the_jax_scan():
    """Equal scores keep index order; ``box_nms_keep`` (the plain version
    on the host) keeps exactly the boxes the JAX scan keeps."""
    scores = torch.tensor([[0.5, 0.9, 0.5, 0.9, 0.1]])
    order, rank = K.nms_order(scores)
    assert order.tolist() == [[1, 3, 0, 2, 4]]
    assert rank.tolist() == [[2, 0, 3, 1, 4]]
    rng = np.random.RandomState(3)
    data = _det_rows(rng, 50, 2)
    want = np.asarray(jc._box_nms(jnp.asarray(data[None]),
                                  overlap_thresh=0.25, id_index=0))[0]
    d = torch.tensor(data)[None]
    order, rank = K.nms_order(d[..., 1])
    valid = d[..., 1] > 0
    keep = K.box_nms_keep(d[..., 2:6], d[..., 0], valid, order, rank, 0.25,
                          False) & valid
    np.testing.assert_array_equal(keep[0].numpy(), want[:, 1] != -1)


# SSD-300's first two feature maps' settings (MXNet 1.0's
# example/ssd/symbol/symbol_factory.py), cut to small maps
PRIOR_CASES = [
    dict(sizes=(0.1, 0.141), ratios=(1.0, 2.0, 0.5), steps=(8 / 300,) * 2),
    dict(sizes=(0.2, 0.272), ratios=(1.0, 2.0, 0.5, 3.0, 1 / 3),
         steps=(16 / 300,) * 2, clip=True),
    dict(sizes=(0.5,), ratios=(1.0,), offsets=(0.25, 0.75)),
]


@pytest.mark.parametrize("attrs", PRIOR_CASES)
def test_multibox_prior_against_the_jax_body_with_float_tuples(attrs):
    x = np.zeros((2, 3, 5, 4), np.float32)
    want = np.asarray(jc._multibox_prior(jnp.asarray(x), **attrs))
    raw = {k: str(v) if isinstance(v, tuple) else v for k, v in attrs.items()}
    op = port_op("_contrib_MultiBoxPrior")
    got = op.impl(torch.tensor(x), **op.normalize_attrs(raw))
    # the JAX package's anchors are float64 (x64 is on; ROADMAP R15), the
    # port's float32: the same values, rounded once
    assert got.dtype == torch.float32 and want.dtype == np.float64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))


def _gt_labels(rng, n, objects):
    lab = -np.ones((n, objects, 5), np.float32)
    for i in range(n):
        k = rng.randint(1, objects + 1)
        lab[i, :k, 0] = rng.randint(0, 20, k)
        lab[i, :k, 1:] = _boxes(rng, n=k) * 1.3 - 0.1
    return lab


def test_multibox_target_and_detection_against_the_jax_bodies():
    rng = np.random.RandomState(4)
    feat = np.zeros((1, 8, 6, 6), np.float32)
    prior = dict(sizes=(0.2, 0.272), ratios=(1.0, 2.0, 0.5),
                 steps=(1 / 6, 1 / 6))
    anchors = np.asarray(jc._multibox_prior(jnp.asarray(feat), **prior),
                         np.float32)
    A = anchors.shape[1]
    label = _gt_labels(rng, 3, 4)
    cls_pred = rng.randn(3, 21, A).astype(np.float32)
    var = (0.1, 0.1, 0.2, 0.2)
    tattrs = dict(overlap_threshold=0.3, variances=var)
    want = jc._multibox_target(jnp.asarray(anchors), jnp.asarray(label),
                               jnp.asarray(cls_pred), **tattrs)
    op = port_op("_contrib_MultiBoxTarget")
    got = op.impl(torch.tensor(anchors), torch.tensor(label),
                  torch.tensor(cls_pred),
                  **op.normalize_attrs({"overlap_threshold": 0.3,
                                        "variances": str(var)}))
    assert float(np.asarray(want[1]).sum()) > 0
    for g, w in zip(got, want):
        _close(g.numpy(), np.asarray(w))
    logits = rng.randn(3, 21, A).astype(np.float32) * 3
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    loc = (rng.randn(3, A * 4) * 0.5).astype(np.float32)
    dattrs = dict(nms_threshold=0.45, nms_topk=40, threshold=0.05,
                  variances=var)
    want = np.asarray(jc._multibox_detection(
        jnp.asarray(prob), jnp.asarray(loc), jnp.asarray(anchors), **dattrs))
    op = port_op("_contrib_MultiBoxDetection")
    got = op.impl(torch.tensor(prob), torch.tensor(loc),
                  torch.tensor(anchors),
                  **op.normalize_attrs(dict(dattrs, variances=str(var))))
    np.testing.assert_array_equal(got.numpy()[..., :1], want[..., :1])
    _close(got.numpy(), want)
    assert (want[..., 0] == -1).any() and (want[..., 0] >= 0).any()


def test_multibox_registry_path_at_integer_attrs_in_both_packages():
    """Integer tuples survive the JAX registry's int parsing, so there the
    two registries agree: nd and sym, ``simple_bind`` included."""
    x = np.zeros((1, 2, 4, 3), np.float32)
    attrs = dict(sizes=(1,), ratios=(1, 4), clip=True)
    want = jmx.nd.contrib.MultiBoxPrior(jmx.nd.array(x), **attrs).asnumpy(
        ).astype(np.float32)
    got = mx.nd.contrib.MultiBoxPrior(mx.nd.array(x, ctx=mx.cpu()),
                                      **attrs).asnumpy()
    np.testing.assert_array_equal(got, want)
    for pkg, ctx in ((jmx, jmx.cpu()), (mx, mx.cpu())):
        s = pkg.sym.contrib.MultiBoxPrior(pkg.sym.var("data"), **attrs)
        ex = s.simple_bind(ctx, data=x.shape, grad_req="null")
        out = ex.forward(is_train=False, data=pkg.nd.array(x, ctx=ctx))
        np.testing.assert_array_equal(
            out[0].asnumpy().astype(np.float32), want)


def test_multibox_symbol_json_keeps_the_attr_strings():
    """The same Python values write the same attr strings in both
    packages' symbol JSON."""
    attrs = dict(sizes=(0.1, 0.141), ratios=(1, 2, 0.5),
                 steps=(8 / 300, 8 / 300))
    js = [pkg.sym.contrib.MultiBoxPrior(pkg.sym.var("data"), name="p",
                                        **attrs).tojson()
          for pkg in (jmx, mx)]
    assert js[0] == js[1]
    s = mx.sym.load_json(js[1])
    assert s.infer_shape(data=(1, 3, 38, 38))[1] == [(1, 38 * 38 * 4, 4)]


def test_jax_registry_truncates_multibox_float_tuples():
    """Read-only (ROADMAP R14): the JAX registry parses ``sizes`` with
    ``pShape``, which truncates each element to an int, so an explicit
    float tuple becomes (0, 0) and the op divides by zero; the port
    parses floats, as MXNet 1.0 does."""
    jop = jax_op("_contrib_MultiBoxPrior")
    assert jop.normalize_attrs({"sizes": "(0.1, 0.141)"})["sizes"] == (0, 0)
    with pytest.raises(ZeroDivisionError):
        jmx.nd.contrib.MultiBoxPrior(jmx.nd.zeros((1, 3, 4, 4)),
                                     sizes=(0.1, 0.141), ratios=(1, 2, 0.5))
    top = port_op("_contrib_MultiBoxPrior")
    assert top.normalize_attrs({"sizes": "(0.1, 0.141)"})["sizes"] == \
        (0.1, 0.141)


@pytest.mark.parametrize("out_type", ["uint8", "int8"])
def test_quantize_and_dequantize(out_type):
    """Codes exactly (rounding half to even in both), the range passed
    through, and the dequantized values."""
    rng = np.random.RandomState(5)
    data = (rng.rand(4, 33) * 4 - 1).astype(np.float32)
    data[0, :4] = [-1.0, 3.0, 1.0 + 2 / 255 * 0.5 * 4, 0.0]  # a half tie
    lo, hi = np.array([-1.0], np.float32), np.array([3.0], np.float32)
    want = jc._quantize(jnp.asarray(data), jnp.asarray(lo), jnp.asarray(hi),
                        out_type=out_type)
    got = port_op("quantize").impl(torch.tensor(data), torch.tensor(lo),
                                   torch.tensor(hi), out_type=out_type)
    assert str(got[0].dtype).endswith(out_type)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), lo)
    np.testing.assert_array_equal(got[2].numpy(), hi)
    back_j = jc._dequantize(want[0], jnp.asarray(lo), jnp.asarray(hi))
    back_t = port_op("dequantize").impl(got[0], torch.tensor(lo),
                                        torch.tensor(hi))
    _close(back_t.numpy(), np.asarray(back_j))


@pytest.mark.parametrize("name", ["_contrib_fft", "_contrib_ifft"])
def test_fft_pair_values_and_gradients(name):
    """Interleaved real/imaginary output; ``ifft`` is unnormalised times
    n; ``compute_size`` is accepted and ignored."""
    rng = np.random.RandomState(6)
    x = rng.randn(3, 16).astype(np.float32)
    _check_both(_run_both(name, [x], {"compute_size": 8}), rel=FFT_REL,
                grad=FFT_REL)


def test_ifft_of_fft_is_n_times_the_input():
    x = torch.randn(2, 8)
    back = port_op("ifft").impl(port_op("fft").impl(x))
    torch.testing.assert_close(back, x * 8, rtol=1e-5, atol=1e-5)

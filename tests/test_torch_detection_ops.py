"""Parity of the port's detection ops (``mxnet_tpu_torch/ops/
detection_ops.py``: count_sketch, Proposal, MultiProposal, PSROIPooling,
DeformableConvolution, DeformablePSROIPooling, bipartite_matching) with
the JAX package's (``mxnet_tpu/ops/detection_ops.py``), forwards and
gradients, on the host, at small sizes.

Tolerances: values within 1e-5 relative to each output's largest
magnitude, gradients within 1e-4 (sums in another order; PSROIPooling's
bin sums come from a float64 summed-area table, the JAX package sums
float32 masked planes); suppression decisions, matchings and the
DeformableConvolution column exactly where they are compared alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops.registry import get_op as port_op

from test_torch_contrib_detection import _check_both, _close
from test_torch_train_ops import _run_both


# -- count_sketch --------------------------------------------------------------

def test_count_sketch_values_and_gradients():
    rng = np.random.RandomState(0)
    data = rng.randn(3, 5, 12).astype(np.float32)
    h = rng.randint(0, 7, (12,)).astype(np.float32)
    s = rng.choice([-1.0, 1.0], (12,)).astype(np.float32)
    _check_both(_run_both("_contrib_count_sketch", [data, h, s],
                          {"out_dim": 7}))


# -- Proposal / MultiProposal ------------------------------------------------

A = 9  # anchors: scales (8, 16, 32) x ratios (0.5, 1, 2)
PROP = dict(scales=(8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
            rpn_pre_nms_top_n=120, rpn_post_nms_top_n=40, threshold=0.7,
            rpn_min_size=16)


def _rpn(rng, n, h, w, ties=False):
    cls = rng.rand(n, 2 * A, h, w).astype(np.float32)
    if ties:  # equal scores: the stable order decides
        cls = np.round(cls * 4) / 4
    bbox = (rng.randn(n, 4 * A, h, w) * 0.2).astype(np.float32)
    info = np.array([[h * 16, w * 16, 1.0], [h * 16 - 7, w * 16 - 20, 1.2]],
                    np.float32)[:n]
    return cls, bbox, info


@pytest.mark.parametrize("name", ["_contrib_Proposal",
                                  "_contrib_MultiProposal"])
@pytest.mark.parametrize("case", ["plain", "ties", "score", "few_kept",
                                  "min_size"])
def test_proposals_against_the_jax_op(name, case):
    """Ties at -inf (boxes under the min size), ties in score, more kept
    boxes than post_nms slots ("plain") and fewer ("few_kept": the last
    kept box repeats), and ``output_score``."""
    rng = np.random.RandomState(1)
    batch = 1 if "Multi" not in name else 2
    cls, bbox, info = _rpn(rng, batch, 5, 6, ties=case == "ties")
    attrs = dict(PROP, output_score=case in ("score", "ties"))
    if case == "few_kept":
        attrs.update(threshold=0.1, rpn_post_nms_top_n=60)
    if case == "min_size":  # most boxes under the min size: -inf scores
        attrs.update(rpn_min_size=300)
    _check_both(_run_both(name, [cls, bbox, info], attrs, n_diff=2))


def test_proposal_suppression_is_the_jax_loop():
    """The plain sweep of ``proposal_nms_keep`` against the JAX package's
    ``_nms_keep``, exactly, on sorted boxes with overlaps near 0.7."""
    from mxnet_tpu.ops import detection_ops as jd
    rng = np.random.RandomState(2)
    xy = rng.rand(2, 90, 2) * 60
    wh = rng.rand(2, 90, 2) * 30 + 1
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    boxes[:, 1::2] = boxes[:, 0::2] + rng.rand(2, 45, 4).astype(
        np.float32) * 3
    got = K.proposal_nms_keep(torch.tensor(boxes), 0.7)
    for b in range(2):
        want = np.asarray(jd._nms_keep(jnp.asarray(boxes[b]), None, 0.7))
        np.testing.assert_array_equal(got[b].numpy(), want)


# -- PSROIPooling / DeformablePSROIPooling -------------------------------------

def _rois(rng, n_img, count, h, w, scale):
    x1 = rng.rand(count) * w / scale * 0.7
    y1 = rng.rand(count) * h / scale * 0.7
    x2 = x1 + rng.rand(count) * w / scale * 0.6
    y2 = y1 + rng.rand(count) * h / scale * 0.6
    b = rng.randint(0, n_img, count)
    rois = np.stack([b, x1, y1, x2, y2], 1).astype(np.float32)
    rois[0, 1:] = [-20, -20, w / scale + 30, h / scale + 30]  # past the edges
    return rois


@pytest.mark.parametrize("attrs", [
    dict(spatial_scale=0.25, output_dim=3, pooled_size=3),
    dict(spatial_scale=0.5, output_dim=2, pooled_size=4, group_size=2)])
def test_psroi_pooling_values_and_gradients(attrs):
    rng = np.random.RandomState(3)
    g = attrs.get("group_size") or attrs["pooled_size"]
    data = rng.randn(2, attrs["output_dim"] * g * g, 9, 11).astype(
        np.float32)
    rois = _rois(rng, 2, 6, 9, 11, attrs["spatial_scale"])
    _check_both(_run_both("_contrib_PSROIPooling", [data, rois], attrs,
                          n_diff=1))


@pytest.mark.parametrize("no_trans", [False, True])
def test_deformable_psroi_pooling_values_and_gradients(no_trans):
    rng = np.random.RandomState(4)
    attrs = dict(spatial_scale=0.25, output_dim=2, group_size=2,
                 pooled_size=2, part_size=2, sample_per_part=2,
                 trans_std=0.1, no_trans=no_trans)
    data = rng.randn(2, 2 * 4, 9, 11).astype(np.float32)
    rois = _rois(rng, 2, 5, 9, 11, 0.25)
    trans = rng.randn(5, 4, 2, 2).astype(np.float32)
    inputs = [data, rois] + ([] if no_trans else [trans])
    n_diff = 1 if no_trans else 3
    results = _run_both("_contrib_DeformablePSROIPooling", inputs, attrs,
                        n_diff=n_diff)
    outs_j, outs_t, grads_j, grads_t = results
    _close(outs_t[0], outs_j[0])
    _close(grads_t[0], grads_j[0], 1e-4)   # data
    if not no_trans:                        # the learned offsets
        _close(grads_t[2], grads_j[2], 1e-4)


# -- DeformableConvolution -----------------------------------------------------

CONV = [
    # kernel, stride, pad, dilate, filters, groups, deformable groups
    ((3, 3), (1, 1), (1, 1), (1, 1), 4, 1, 1),
    ((3, 3), (1, 1), (2, 2), (2, 2), 6, 2, 2),
    ((3, 3), (2, 2), (1, 1), (1, 1), 4, 1, 4),
    ((1, 1), (1, 1), (0, 0), (1, 1), 3, 1, 1)]


def _conv_inputs(rng, case, offsets):
    kernel, stride, pad, dilate, f, g, dg = case
    n, c, h, w = 2, 4, 7, 8
    ho = (h + 2 * pad[0] - (dilate[0] * (kernel[0] - 1) + 1)) // stride[0] + 1
    wo = (w + 2 * pad[1] - (dilate[1] * (kernel[1] - 1) + 1)) // stride[1] + 1
    shape = (n, 2 * dg * kernel[0] * kernel[1], ho, wo)
    off = {"zero": np.zeros(shape), "integer": rng.randint(-2, 3, shape),
           "random": rng.randn(*shape) * 1.5}[offsets].astype(np.float32)
    data = rng.randn(n, c, h, w).astype(np.float32)
    weight = rng.randn(f, c // g, *kernel).astype(np.float32)
    bias = rng.randn(f).astype(np.float32)
    attrs = dict(kernel=kernel, stride=stride, pad=pad, dilate=dilate,
                 num_filter=f, num_group=g, num_deformable_group=dg)
    return [data, off, weight, bias], attrs


@pytest.mark.parametrize("case,offsets", [
    (c, o) for c, extra in zip(CONV, ["zero", "integer", "integer", "zero"])
    for o in ("random", extra)],
    ids=lambda v: v if isinstance(v, str) else "k%ds%dd%dg%ddg%d" % (
        v[0][0], v[1][0], v[3][0], v[5], v[6]))
def test_deformable_convolution_values_and_gradients(case, offsets):
    """Samples on pixels (zero and integer offsets) and between them;
    the gradients of data, offsets, weight and bias."""
    rng = np.random.RandomState(5)
    inputs, attrs = _conv_inputs(rng, case, offsets)
    _check_both(_run_both("_contrib_DeformableConvolution", inputs, attrs))


def test_deformable_convolution_zero_offsets_are_a_convolution():
    """Zero offsets sample the grid points: the op is Convolution."""
    rng = np.random.RandomState(6)
    inputs, attrs = _conv_inputs(rng, CONV[1], "zero")
    got = port_op("_contrib_DeformableConvolution").impl(
        *[torch.tensor(x) for x in inputs],
        **port_op("_contrib_DeformableConvolution").normalize_attrs(attrs))
    want = torch.nn.functional.conv2d(
        torch.tensor(inputs[0]), torch.tensor(inputs[2]),
        torch.tensor(inputs[3]), stride=1, padding=2, dilation=2, groups=2)
    _close(got.numpy(), want.numpy())


def test_deformable_im2col_plain_column_is_the_jax_gather():
    """The plain column (what the CUDA kernel reproduces bit for bit) is the
    JAX package's ``_bilinear_gather`` column exactly."""
    from mxnet_tpu.ops import detection_ops as jd
    rng = np.random.RandomState(7)
    data = rng.randn(1, 4, 6, 7).astype(np.float32)
    off = (rng.randn(1, 2 * 2 * 9, 6, 7) * 2).astype(np.float32)
    col = K.deformable_im2col(torch.tensor(data), torch.tensor(off), (3, 3),
                              (1, 1), (1, 1), (1, 1), 2)
    by = (np.arange(6)[:, None, None, None] - 1
          + np.arange(3)[None, None, :, None])
    bx = (np.arange(7)[None, :, None, None] - 1
          + np.arange(3)[None, None, None, :])
    by = np.broadcast_to(by, (6, 7, 3, 3)).astype(np.float32)
    bx = np.broadcast_to(bx, (6, 7, 3, 3)).astype(np.float32)
    o = off[0].reshape(2, 9, 2, 6, 7)
    for dg in range(2):
        y = by.transpose(2, 3, 0, 1) + o[dg, :, 0].reshape(3, 3, 6, 7)
        x = bx.transpose(2, 3, 0, 1) + o[dg, :, 1].reshape(3, 3, 6, 7)
        want = np.asarray(jd._bilinear_gather(
            jnp.asarray(data[0, 2 * dg:2 * dg + 2]), jnp.asarray(y),
            jnp.asarray(x)))
        np.testing.assert_array_equal(col[0, 2 * dg:2 * dg + 2].numpy(),
                                      want)


# -- bipartite_matching ---------------------------------------------------------

@pytest.mark.parametrize("attrs", [
    dict(threshold=0.3), dict(threshold=0.3, topk=2),
    dict(threshold=0.6, is_ascend=True), dict(threshold=0.0, topk=1),
    dict(threshold=0.9)])
def test_bipartite_matching_with_ties_and_topk(attrs):
    """Scores on a grid of quarters (many ties) and continuous ones, one
    and two leading axes; the row and column markers exactly."""
    rng = np.random.RandomState(8)
    for score in (np.round(rng.rand(3, 6, 5) * 4) / 4,
                  rng.rand(2, 2, 4, 7), rng.rand(5, 3)):
        got = port_op("_contrib_bipartite_matching").impl(
            torch.tensor(score.astype(np.float32)),
            **port_op("_contrib_bipartite_matching").normalize_attrs(attrs))
        want = jax_op("_contrib_bipartite_matching").impl(
            jnp.asarray(score.astype(np.float32)),
            **jax_op("_contrib_bipartite_matching").normalize_attrs(attrs))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the namespaces ----------------------------------------------------------------

def test_the_seven_ops_reach_nd_contrib_and_sym_contrib():
    names = ["count_sketch", "Proposal", "MultiProposal", "PSROIPooling",
             "DeformableConvolution", "DeformablePSROIPooling",
             "bipartite_matching"]
    for n in names:
        assert callable(getattr(mx.nd.contrib, n))
        assert callable(getattr(mx.sym.contrib, n))
        if n != "count_sketch" and n != "bipartite_matching":
            assert port_op(n) is port_op("_contrib_" + n)
    score = mx.nd.array([[0.9, 0.2], [0.8, 0.7]], ctx=mx.cpu())
    rm, cm = mx.nd.contrib.bipartite_matching(score, threshold=0.5)
    np.testing.assert_array_equal(rm.asnumpy(), [0, 1])
    np.testing.assert_array_equal(cm.asnumpy(), [0, 1])

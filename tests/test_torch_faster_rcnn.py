"""Faster R-CNN VGG16's test network (``mxnet_tpu_torch/models/
rcnn_vgg.py``, MXNet 1.0's ``get_vgg_test``) at narrow widths in both
packages: the port builds the graph, the JAX package loads its JSON, both
bind a ``Module`` for inference with the same seeded weights (carried by
``convert.params_from_numpy``), and ``rois``, ``cls_prob`` and
``bbox_pred`` agree within 1e-4 of each output's scale (the convolutions
sum in another order; no proposal lies within 1e-4 of the suppression
threshold at these inputs).  Batch 1 runs ``Proposal``, batch 2
``MultiProposal``.

The JAX package's compiled graph pools some ROIs into other bins than
its own ``ROIPooling`` op run alone (ROADMAP R16; seen on the clipped
full-picture ROI), so the port's pooled features are held to that op on
the JAX graph's features and ROIs, and the heads' rows to the JAX
graph's where its pooling agrees with its op.
"""
import jax.numpy as jnp
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.models import rcnn_vgg

NARROW = dict(filters=(4, 4, 8, 8, 8), rpn_filters=8, fc_hidden=32,
              rpn_pre_nms_top_n=200, rpn_post_nms_top_n=20)
HEIGHT, WIDTH = 64, 96
REL = 1e-4


def _weights(symbol, shapes, seed):
    """Seeded weights: He-scaled convolutions and layers, the RPN heads at
    a small std (its scores stay unsaturated), zero biases."""
    rng = np.random.RandomState(seed)
    arg_shapes, _, _ = symbol.infer_shape(**shapes)
    params = {}
    for name, shape in zip(symbol.list_arguments(), arg_shapes):
        if name in shapes:
            continue
        if name.endswith("bias"):
            params[name] = np.zeros(shape, np.float32)
            continue
        std = 0.01 if name.startswith(("rpn_cls", "rpn_bbox")) \
            else np.sqrt(2.0 / np.prod(shape[1:]))
        params[name] = (rng.randn(*shape) * std).astype(np.float32)
    return params


def _forward(pkg, symbol, params, data, info):
    ctx = pkg.cpu()
    mod = pkg.mod.Module(symbol, data_names=("data", "im_info"),
                         label_names=None, context=ctx)
    mod.bind(data_shapes=[("data", data.shape), ("im_info", info.shape)],
             for_training=False)
    if pkg is mx:
        args, aux = convert.params_from_numpy(params, ctx=ctx)
    else:
        args = {k: pkg.nd.array(v) for k, v in params.items()}
        aux = {}
    mod.set_params(args, aux)
    mod.forward(pkg.io.DataBatch([pkg.nd.array(data, ctx=ctx),
                                  pkg.nd.array(info, ctx=ctx)]),
                is_train=False)
    return [o.asnumpy() for o in mod.get_outputs()]


def _close(got, want):
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=REL, atol=REL * scale)


@pytest.mark.parametrize("batch", [1, 2])
def test_get_vgg_test_in_both_packages(batch):
    symbol = rcnn_vgg.get_vgg_test(batch_images=batch, **NARROW)
    rng = np.random.RandomState(batch)
    data = rng.rand(batch, 3, HEIGHT, WIDTH).astype(np.float32) * 2 - 1
    info = np.array([[HEIGHT, WIDTH, 1.0]] * batch, np.float32)
    params = _weights(symbol, {"data": data.shape, "im_info": info.shape}, 7)
    inner = symbol.get_internals()
    probe = mx.sym.Group([symbol, inner["relu5_3_output"],
                          inner["roi_pool5_output"]])
    with mx.cpu():
        got = _forward(mx, probe, params, data, info)
    want = _forward(jmx, jmx.sym.load_json(probe.tojson()), params, data,
                    info)
    post = NARROW["rpn_post_nms_top_n"]
    assert [g.shape for g in got[:3]] == [
        (batch * post, 5), (batch, post, 21), (batch, post, 84)]
    _close(got[0], want[0])                                  # rois
    _close(got[3], want[3])                                  # relu5_3
    pooled = np.asarray(jax_op("ROIPooling").impl(
        jnp.asarray(want[3]), jnp.asarray(want[0]), pooled_size=(7, 7),
        spatial_scale=1.0 / 16))
    _close(got[4], pooled)
    agree = np.abs(want[4] - pooled).reshape(batch * post, -1).max(1) \
        <= REL * max(1.0, float(np.abs(pooled).max()))
    assert agree.sum() >= batch * post - 2
    for g, w in zip(got[1:3], want[1:3]):
        rows = agree.reshape(batch, post)
        _close(g[rows], w[rows])
    # the boxes lie in the picture, and picture b's rois name it
    rois = got[0]
    np.testing.assert_array_equal(rois[:, 0],
                                  np.repeat(np.arange(batch), post))
    assert (rois[:, 1] >= 0).all() and (rois[:, 3] <= WIDTH - 1).all()

"""The port's symbol model zoo (``mx.models``) against the JAX package's.

For each of the 12 builders this slice adds (BASELINE config 1's LeNet
and MLP through Inception-ResNet-v2), at its own input size and 1000
classes: the graph's JSON is identical between the packages, and so are
``list_arguments``, ``list_auxiliary_states`` and ``infer_shape``.  Then
each builder runs one inference forward at a reduced input (and, where
the builder takes one, a reduced depth or width) in both packages from
the same numpy weights, carried into each by its parameter converter
(``mx.convert.params_from_numpy`` in the port): the logits within
atol=rtol=1e-4 of the JAX package's, scaled by the largest logit.

Weights are He-normal from a numpy seed, BatchNorm gamma near 1, beta
and the moving mean near 0, the moving variance near 1: a well-scaled
start, so the comparison reads the graph and not rounding blown up.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import models as jmodels

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import models as tmodels

# builder -> (full input, {kwargs}) as the reference's scripts call them
FULL = {
    "lenet": ((1, 28, 28), {"num_classes": 10}),
    "mlp": ((1, 28, 28), {"num_classes": 10}),
    "alexnet": ((3, 224, 224), {}),
    "vgg": ((3, 224, 224), {"num_layers": 16}),
    "googlenet": ((3, 224, 224), {}),
    "inception_bn": ((3, 224, 224), {}),
    "inception_v3": ((3, 299, 299), {}),
    "inception_v4": ((3, 299, 299), {}),
    "inception_resnet_v2": ((3, 299, 299), {}),
    "resnet_v1": ((3, 224, 224), {"num_layers": 50,
                                  "image_shape": "3,224,224"}),
    "resnext": ((3, 224, 224), {"num_layers": 50,
                                "image_shape": "3,224,224"}),
    "mobilenet": ((3, 224, 224), {}),
}

# builder -> (reduced input, {kwargs}) for the forward
REDUCED = {
    "lenet": ((1, 28, 28), {"num_classes": 10}),
    "mlp": ((1, 28, 28), {"num_classes": 10}),
    "alexnet": ((3, 67, 67), {"num_classes": 16}),
    "vgg": ((3, 32, 32), {"num_layers": 11, "num_classes": 16}),
    "googlenet": ((3, 64, 64), {"num_classes": 16}),
    "inception_bn": ((3, 64, 64), {"num_classes": 16}),
    "inception_v3": ((3, 75, 75), {"num_classes": 16}),
    "inception_v4": ((3, 75, 75), {"num_classes": 16}),
    "inception_resnet_v2": ((3, 75, 75), {"num_classes": 16}),
    "resnet_v1": ((3, 28, 28), {"num_layers": 20, "num_classes": 16,
                                "image_shape": "3,28,28"}),
    "resnext": ((3, 64, 64), {"num_layers": 50, "num_classes": 16,
                              "image_shape": "3,64,64", "num_group": 4}),
    "mobilenet": ((3, 64, 64), {"alpha": 0.25, "num_classes": 16}),
}

ZOO = sorted(FULL)


def _build(pkg_models, pkg, name, kwargs):
    with pkg.sym.NameManager():
        return getattr(pkg_models, name).get_symbol(**kwargs)


def test_models_export_the_builders():
    assert set(ZOO) | {"resnet"} <= set(dir(tmodels))
    assert tmodels.get_symbol is tmodels.resnet.get_symbol


@pytest.mark.parametrize("name", ZOO)
def test_builder_graph_matches(name):
    shape, kwargs = FULL[name]
    sj = _build(jmodels, jmx, name, kwargs)
    st = _build(tmodels, mx, name, kwargs)
    assert st.tojson() == sj.tojson()
    assert st.list_arguments() == sj.list_arguments()
    assert st.list_auxiliary_states() == sj.list_auxiliary_states()
    assert st.list_outputs() == sj.list_outputs()
    data = (2,) + shape
    assert st.infer_shape(data=data) == sj.infer_shape(data=data)


def _weights(sym, data_shape, seed):
    rng = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=data_shape)
    out = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in ("data", "softmax_label"):
            continue
        if n.endswith("_gamma"):
            v = 1 + 0.1 * rng.randn(*s)
        elif n.endswith(("_beta", "_bias")):
            v = 0.1 * rng.randn(*s)
        else:
            v = rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))
        out["arg:" + n] = v.astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        v = 1 + 0.1 * rng.rand(*s) if n.endswith("_var") \
            else 0.05 * rng.randn(*s)
        out["aux:" + n] = v.astype(np.float32)
    return out


def _logits(sym):
    """The graph below ``SoftmaxOutput``: its data input."""
    return sym.get_children()[0]


def _forward(pkg, sym, weights, x, arg_params, aux_params):
    exe = sym.simple_bind(pkg.cpu(), grad_req="null", data=x.shape)
    exe.copy_params_from(arg_params, aux_params, allow_extra_params=True)
    exe.forward(is_train=False, data=x)
    return exe.outputs[0].asnumpy()


@pytest.mark.parametrize("name", ZOO)
def test_builder_forward_matches(name):
    shape, kwargs = REDUCED[name]
    sj = _logits(_build(jmodels, jmx, name, kwargs))
    st = _logits(_build(tmodels, mx, name, kwargs))
    data = (2,) + shape
    weights = _weights(sj, data, ZOO.index(name))
    x = np.random.RandomState(100 + ZOO.index(name)).rand(*data).astype(
        np.float32)
    jargs = {k[4:]: jmx.nd.array(v) for k, v in weights.items()
             if k.startswith("arg:")}
    jauxs = {k[4:]: jmx.nd.array(v) for k, v in weights.items()
             if k.startswith("aux:")}
    want = _forward(jmx, sj, weights, x, jargs, jauxs)
    targs, tauxs = mx.convert.params_from_numpy(weights, ctx=mx.cpu())
    got = _forward(mx, st, weights, x, targs, tauxs)
    assert got.shape == want.shape == (2, kwargs.get("num_classes", 1000))
    assert np.isfinite(want).all()
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * scale)

"""The core op surface in the port against the JAX package's ops.

Every op of ``mxnet_tpu/ops/tensor.py`` (but its three sparse-storage
ops) and the Gluon-facing ops of ``mxnet_tpu/ops/nn.py`` (``softmax``,
``SoftmaxActivation``, ``_PReLU``, ``Deconvolution``, ``InstanceNorm``,
``L2Normalization``, ``LRN``, ``softmax_cross_entropy``, ``MakeLoss``):
one case per op and attr set, the same seeded numpy inputs through both
registries.  Differentiable ops go through ``_run_both`` of
``tests/test_torch_train_ops.py`` (values and the ``jax.vjp`` / torch
autograd gradients under one cotangent); ops whose outputs carry no
gradient (comparisons, indices, init ops) compare values.  Tolerance
f32 atol=rtol=1e-5 (the same arithmetic in another order), unless a case
names its own.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops import registry as jax_registry
from mxnet_tpu.ops.registry import get_op as jax_op

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops.registry import get_op as port_op, op_registry

from test_torch_train_ops import TOL, _check, _run_both

R = np.random.RandomState(0)


def _f(*shape, lo=-1.0, hi=1.0):
    return R.uniform(lo, hi, shape).astype(np.float32)


def _values_both(name, inputs, attrs):
    """The op's outputs in both packages, as float64 arrays."""
    oj, ot = jax_op(name), port_op(name)
    aj, at = oj.normalize_attrs(attrs), ot.normalize_attrs(attrs)
    out_j = oj.impl(*[jnp.asarray(x) for x in inputs], **aj)
    out_t = ot.impl(*[torch.from_numpy(np.array(x)) for x in inputs], **at)
    out_j = out_j if isinstance(out_j, tuple) else (out_j,)
    out_t = out_t if isinstance(out_t, tuple) else (out_t,)
    assert len(out_j) == len(out_t)
    return ([np.asarray(o).astype(np.float64) for o in out_j],
            [o.detach().double().numpy() for o in out_t])


def _check_values(name, inputs, attrs, tol=TOL):
    out_j, out_t = _values_both(name, inputs, attrs)
    for a, b in zip(out_j, out_t):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(b, a, **tol)


POS = dict(lo=0.5, hi=2.0)
_BIN = ["add", "sub", "mul", "div", "mod", "power", "maximum", "minimum",
        "hypot"]
_LOGIC = ["equal", "not_equal", "greater", "greater_equal", "lesser",
          "lesser_equal"]

# (name, inputs, attrs[, n_diff]) of differentiable cases
GRAD_CASES = (
    [("elemwise_" + n, [_f(2, 3, **POS), _f(2, 3, **POS)], {})
     for n in _BIN]
    + [("broadcast_" + n, [_f(2, 3, 4, **POS), _f(1, 3, 1, **POS)], {})
       for n in _BIN]
    + [("_%s_scalar" % n, [_f(3, 4, **POS)], {"scalar": 1.7})
       for n in ("plus", "minus", "rminus", "mul", "div", "rdiv", "mod",
                 "rmod", "power", "rpower", "maximum", "minimum", "hypot")]
    + [("add_n", [_f(2, 3), _f(2, 3), _f(2, 3)], {}),
       ("_grad_add", [_f(2, 3), _f(2, 3)], {}),
       ("_copy", [_f(2, 3)], {}), ("identity", [_f(2, 3)], {}),
       ("make_loss", [_f(2, 3)], {}),
       ("clip", [_f(3, 4)], {"a_min": -0.5, "a_max": 0.4}),
       ("Cast", [_f(2, 3)], {"dtype": "float64"})]
    + [("sum", [_f(2, 3, 4)], a) for a in (
        {}, {"axis": 1, "keepdims": True}, {"axis": (0, 2), "exclude": True})]
    + [(n, [_f(2, 3, 4, **POS)], a)
       for n in ("mean", "prod", "nansum", "nanprod", "max", "min")
       for a in ({}, {"axis": (0, 2)}, {"axis": 1, "keepdims": True})]
    + [("nansum", [np.where(_f(3, 4) > 0.5, np.nan, _f(3, 4))],
        {"axis": 1}),
       ("nanprod", [np.where(_f(3, 4) > 0.5, np.nan, _f(3, 4, **POS))],
        {"axis": 0}),
       ("dot", [_f(3, 4), _f(4, 5)], {}),
       ("dot", [_f(4, 3), _f(5, 4)], {"transpose_a": True,
                                      "transpose_b": True}),
       ("dot", [_f(6), _f(6)], {}),
       ("dot", [_f(2, 3, 4), _f(4, 5)], {}),
       ("batch_dot", [_f(2, 3, 4), _f(2, 4, 5)], {}),
       ("batch_dot", [_f(2, 4, 3), _f(2, 5, 4)], {"transpose_a": True,
                                                  "transpose_b": True}),
       ("transpose", [_f(2, 3, 4)], {}),
       ("transpose", [_f(2, 3, 4)], {"axes": (1, 0, 2)}),
       ("slice", [_f(4, 5, 6)], {"begin": (1, None, 0), "end": (3, 4, None)}),
       ("crop", [_f(4, 5)], {"begin": (0, 1), "end": (2, 5),
                             "step": (1, 2)}),
       ("slice", [_f(5, 6)], {"begin": (None, 4), "end": (None, 0),
                              "step": (1, -2)}),
       ("slice_axis", [_f(3, 6)], {"axis": 1, "begin": 1, "end": None}),
       ("slice_axis", [_f(5, 3)], {"axis": 0, "begin": -4, "end": -1}),
       ("slice_like", [_f(4, 5), _f(2, 3)], {}, 1),
       ("slice_like", [_f(4, 5), _f(2, 3)], {"axes": (1,)}, 1),
       ("take", [_f(5, 3), np.array([4, 0, 7, -2, 1], np.float32)],
        {}, 1),
       ("take", [_f(3, 5), np.array([[4, 6], [-1, 2]], np.float32)],
        {"axis": 1, "mode": "wrap"}, 1),
       ("batch_take", [_f(4, 3), np.array([2, 0, 1, 2], np.float32)], {}, 1),
       ("where", [(_f(3, 4) > 0).astype(np.float32), _f(3, 4), _f(3, 4)],
        {}),
       ("where", [np.array([1, 0, 1], np.float32), _f(3, 4), _f(3, 4)], {}),
       ("tile", [_f(2, 3)], {"reps": (2, 1, 3)}),
       ("repeat", [_f(2, 3)], {"repeats": 2}),
       ("repeat", [_f(2, 3)], {"repeats": 3, "axis": 1}),
       ("reverse", [_f(2, 3, 4)], {"axis": (0, 2)}),
       ("flip", [_f(2, 3)], {"axis": 1}),
       ("SwapAxis", [_f(2, 3, 4)], {"dim1": 0, "dim2": 2}),
       ("swapaxes", [_f(2, 3)], {"dim1": 1, "dim2": 0}),
       ("squeeze", [_f(2, 1, 3, 1)], {}),
       ("squeeze", [_f(2, 1, 3, 1)], {"axis": (1, 3)}),
       ("expand_dims", [_f(2, 3)], {"axis": 1}),
       ("Concat", [_f(2, 3), _f(2, 4), _f(2, 1)], {"dim": 1}),
       ("concat", [_f(2, 3), _f(1, 3)], {"dim": 0}),
       ("stack", [_f(2, 3), _f(2, 3)], {"axis": 1}),
       ("SliceChannel", [_f(2, 6, 3)], {"num_outputs": 3, "axis": 1}),
       ("split", [_f(4, 2)], {"num_outputs": 2, "axis": 0,
                              "squeeze_axis": False}),
       ("split", [_f(2, 3)], {"num_outputs": 3, "axis": 1,
                              "squeeze_axis": True}),
       ("broadcast_to", [_f(1, 3, 1)], {"shape": (2, 0, 4)}),
       ("broadcast_axis", [_f(1, 3, 1)], {"axis": (0, 2), "size": (2, 5)}),
       ("gather_nd", [_f(3, 4, 2), np.array([[0, 2, 1], [3, 0, 3]],
                                            np.float32)], {}, 1),
       ("scatter_nd", [_f(3), np.array([[0, 2, 0], [1, 3, 1]], np.float32)],
        {"shape": (3, 4)}, 1),
       ("Pad", [_f(1, 2, 4, 5)], {"mode": "constant", "constant_value": 0.5,
                                  "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)}),
       ("pad", [_f(1, 2, 4, 5)], {"mode": "edge",
                                  "pad_width": (0, 0, 0, 0, 2, 1, 1, 3)}),
       ("Pad", [_f(1, 2, 4, 5)], {"mode": "reflect",
                                  "pad_width": (0, 0, 0, 0, 3, 1, 2, 2)}),
       ("pick", [_f(3, 4), np.array([0, 3, 1], np.float32)], {}, 1),
       ("sort", [_f(3, 5)], {}),
       ("sort", [_f(3, 5)], {"axis": 0, "is_ascend": False}),
       ("sort", [_f(3, 4)], {"axis": None}),
       ("topk", [_f(3, 6)], {"k": 2, "ret_typ": "value"}),
       ("topk", [_f(3, 6)], {"k": 3, "ret_typ": "both", "is_ascend": True,
                             "axis": 0})]
    # the nn ops the Gluon layers and losses call
    + [("softmax", [_f(3, 5)], {}), ("softmax", [_f(2, 3, 4)], {"axis": 1}),
       ("softmax", [_f(3, 5)], {"temperature": 2.0}),
       ("SoftmaxActivation", [_f(2, 3, 4)], {}),
       ("SoftmaxActivation", [_f(2, 3, 4)], {"mode": "channel"}),
       ("_PReLU", [_f(2, 3, 4, 4), _f(3, **POS)], {}),
       ("InstanceNorm", [_f(2, 3, 5, 5), _f(3, **POS), _f(3)], {"eps": 1e-3}),
       ("L2Normalization", [_f(2, 3, 4)], {}),
       ("L2Normalization", [_f(2, 3, 4)], {"mode": "channel"}),
       ("L2Normalization", [_f(2, 3, 4)], {"mode": "spatial"}),
       ("LRN", [_f(2, 6, 3, 3)], {"nsize": 3}),
       ("softmax_cross_entropy", [_f(4, 5), np.array([0, 4, 2, 1],
                                                     np.float32)], {}, 1),
       ("MakeLoss", [_f(2, 3)], {"grad_scale": 2.0}),
       ("Deconvolution", [_f(2, 3, 5, 5), _f(3, 4, 3, 3)],
        {"kernel": (3, 3), "num_filter": 4, "stride": (2, 2), "pad": (1, 1),
         "adj": (1, 1)}),
       ("Deconvolution", [_f(2, 4, 4, 4), _f(4, 3, 2, 2), _f(6)],
        {"kernel": (2, 2), "num_filter": 6, "num_group": 2,
         "no_bias": False, "dilate": (2, 2)}),
       ("Deconvolution", [_f(2, 3, 5, 5), _f(3, 2, 4, 4)],
        {"kernel": (4, 4), "num_filter": 2, "stride": (2, 2),
         "target_shape": (9, 10)}),
       ("Deconvolution", [_f(2, 3, 7), _f(3, 2, 3)],
        {"kernel": (3,), "num_filter": 2, "stride": (2,), "pad": (1,)}),
       ("Deconvolution", [_f(1, 2, 3, 3, 3), _f(2, 2, 2, 2, 2)],
        {"kernel": (2, 2, 2), "num_filter": 2, "stride": (2, 2, 2)})]
)

# unary math, with inputs in each function's domain
_UNARY_DOMAIN = {
    "sqrt": POS, "rsqrt": POS, "log": POS, "log10": POS, "log2": POS,
    "log1p": POS, "gamma": POS, "gammaln": POS, "reciprocal": POS,
    "cbrt": POS, "rcbrt": POS, "arccosh": dict(lo=1.2, hi=3.0),
    "arcsin": dict(lo=-0.9, hi=0.9), "arccos": dict(lo=-0.9, hi=0.9),
    "arctanh": dict(lo=-0.9, hi=0.9)}
_UNARY = ["abs", "sign", "ceil", "floor", "trunc", "fix", "square", "sqrt",
          "rsqrt", "cbrt", "rcbrt", "exp", "log", "log10", "log2", "log1p",
          "expm1", "sin", "cos", "tan", "arcsin", "arccos", "arctan",
          "degrees", "radians", "sinh", "cosh", "tanh", "arcsinh",
          "arccosh", "arctanh", "gamma", "gammaln", "negative",
          "reciprocal", "relu", "sigmoid", "softsign", "erf"]
GRAD_CASES += [(n, [_f(3, 4, **_UNARY_DOMAIN.get(n, {}))], {})
               for n in _UNARY]
GRAD_CASES += [("_np_exp", [_f(2, 3)], {}),
               # half-way points: rint rounds to even, round away from 0
               ("rint", [np.array([-2.5, -0.5, 0.5, 1.5, 2.2], np.float32)],
                {}),
               ("round", [np.array([-2.5, -0.5, 0.5, 1.5, 2.2], np.float32)],
                {})]


def _case_id(case):
    attrs = "-".join("%s=%s" % kv for kv in sorted(case[2].items()))
    return case[0] + ("[%s]" % attrs if attrs else "")


@pytest.mark.parametrize("case", GRAD_CASES, ids=[
    "%d-%s" % (i, _case_id(c)) for i, c in enumerate(GRAD_CASES)])
def test_op_values_and_gradients(case):
    name, inputs, attrs = case[:3]
    n_diff = case[3] if len(case) > 3 else None
    tol = dict(atol=2e-5, rtol=2e-5) if name in (
        "gamma", "power", "broadcast_power", "elemwise_power",
        "_rpower_scalar", "Deconvolution", "prod", "nanprod") else TOL
    _check(_run_both(name, inputs, attrs, n_diff=n_diff), tol)


VALUE_CASES = (
    [("_" + n, [_f(3, 4), np.where(_f(3, 4) > 0, 0.25, 0.0).astype(
        np.float32)], {}) for n in _LOGIC]
    + [("broadcast_" + n, [_f(2, 3), _f(1, 3)], {}) for n in _LOGIC]
    + [("_%s_scalar" % n, [np.array([0.0, 0.5, 1.0, 2.0], np.float32)],
        {"scalar": 0.5}) for n in _LOGIC]
    + [("logical_not", [np.array([0.0, 1.0, -2.0], np.float32)], {}),
       ("BlockGrad", [_f(2, 3)], {}), ("stop_gradient", [_f(2, 3)], {}),
       ("argmax", [_f(3, 4)], {}), ("argmax", [_f(3, 4)], {"axis": 1}),
       ("argmin", [_f(3, 4)], {"axis": 0, "keepdims": True}),
       ("argmin", [_f(3, 4)], {"keepdims": True}),
       ("argmax_channel", [_f(3, 4, 2)], {}),
       ("one_hot", [np.array([0, 2, 5, -1], np.float32)], {"depth": 4}),
       ("one_hot", [np.array([[1, 0], [3, 2]], np.float32)],
        {"depth": 4, "on_value": 2.0, "off_value": -1.0,
         "dtype": "float64"}),
       ("argsort", [_f(3, 5)], {}),
       ("argsort", [_f(3, 5)], {"axis": 0, "is_ascend": False,
                                "dtype": "int32"}),
       ("argsort", [_f(3, 4)], {"axis": None}),
       ("topk", [_f(3, 6)], {"k": 2}),
       ("topk", [_f(3, 6)], {"k": 2, "ret_typ": "mask", "axis": 1}),
       ("topk", [_f(4, 3)], {"k": 3, "axis": None}),
       ("topk", [np.array([[1, 3, 3, 0, 3]], np.float32)], {"k": 2}),
       ("zeros_like", [_f(2, 3)], {}), ("ones_like", [_f(2, 3)], {}),
       ("shape_array", [_f(2, 3, 4)], {}), ("size_array", [_f(2, 3)], {}),
       ("_zeros", [], {"shape": (2, 3)}),
       ("_ones", [], {"shape": (4,), "dtype": "int32"}),
       ("_full", [], {"shape": (2, 2), "value": 3.5}),
       ("_arange", [], {"start": 2.0, "stop": 7.0, "step": 1.5}),
       ("_arange", [], {"start": 4.0, "repeat": 2}),
       ("_eye", [], {"N": 3, "M": 4, "k": 1})]
)


@pytest.mark.parametrize("case", VALUE_CASES, ids=[
    "%d-%s" % (i, _case_id(c)) for i, c in enumerate(VALUE_CASES)])
def test_op_values(case):
    _check_values(*case)


def test_stop_gradient_blocks_the_gradient():
    x = torch.ones(3, requires_grad=True)
    y = port_op("BlockGrad").impl(x) * 2 + x
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.ones(3))


def test_every_tensor_op_and_the_gluon_nn_ops_are_registered():
    """Every name that ``mxnet_tpu/ops/tensor.py`` registers, but its three
    sparse-storage ops, and the Gluon-facing ``ops/nn.py`` ops are in the
    port's registry."""
    sparse = {"cast_storage", "sparse_retain", "_square_sum", "square_sum"}
    tensor_names = {n for n, op in jax_registry.op_registry().items()
                    if op.impl.__module__ == "mxnet_tpu.ops.tensor"}
    assert len(tensor_names) > 200
    nn_names = {"softmax", "SoftmaxActivation", "_PReLU", "Deconvolution",
                "InstanceNorm", "L2Normalization", "LRN",
                "softmax_cross_entropy", "MakeLoss"}
    missing = sorted((tensor_names - sparse | nn_names) - set(op_registry()))
    assert missing == []


def test_ops_reach_the_nd_and_sym_namespaces():
    x = mx.nd.array(np.arange(6, dtype=np.float32).reshape(2, 3),
                    ctx=mx.cpu())
    np.testing.assert_allclose(mx.nd.softmax(x).asnumpy().sum(1), 1.0,
                               rtol=1e-6)
    np.testing.assert_allclose(mx.nd.exp(x).asnumpy(), np.exp(x.asnumpy()),
                               rtol=1e-6)
    np.testing.assert_array_equal(mx.nd.transpose(x).asnumpy(),
                                  x.asnumpy().T)
    np.testing.assert_allclose(mx.nd.dot(x, x, transpose_b=True).asnumpy(),
                               x.asnumpy() @ x.asnumpy().T)
    assert mx.nd.concat(x, x, dim=0).shape == (4, 3)
    parts = mx.nd.split(x, num_outputs=3, axis=1)
    assert [p.shape for p in parts] == [(2, 1)] * 3
    z = mx.nd._zeros(shape=(2, 2), ctx=mx.cpu())
    assert z.context == mx.cpu() and float(z.asnumpy().sum()) == 0.0
    a, b = mx.sym.var("a"), mx.sym.var("b")
    cat = mx.sym.Concat(a, b, dim=1)
    assert cat.infer_shape(a=(2, 3), b=(2, 4))[1] == [(2, 7)]
    sp = mx.sym.split(a, num_outputs=2, axis=1)
    assert len(sp) == 2 and sp[1].infer_shape(a=(2, 6))[1] == [(2, 3)]


@pytest.mark.parametrize("name, n", [("Concat", 3), ("stack", 2),
                                     ("add_n", 4)])
def test_variadic_ops_in_symbol_json_run_in_both_packages(name, n):
    """A variadic node's ``num_args`` is filled from its inputs when left
    unset, in symbol JSON written by either package, and the graph runs
    through the executor of each."""
    r = np.random.RandomState(n)
    xs = [r.standard_normal((2, 3)).astype(np.float32) for _ in range(n)]
    outs = []
    for pkg in (mx, jmx):
        args = [pkg.sym.var("x%d" % i) for i in range(n)]
        net = getattr(pkg.sym, name)(*args, name="v")
        loaded = pkg.sym.load_json(net.tojson())
        exe = loaded.simple_bind(pkg.cpu(), **{"x%d" % i: (2, 3)
                                               for i in range(n)})
        exe.forward(**{"x%d" % i: pkg.nd.array(x, ctx=pkg.cpu())
                       for i, x in enumerate(xs)})
        outs.append(exe.outputs[0].asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], **TOL)


def test_registered_optimizer_ops_update_in_place_like_the_jax_package():
    """``mx.nd.sgd_update``/``sgd_mom_update``/``adam_update`` with
    ``out=weight``: the weight and, through ``mutate_map``, the states
    are updated as the JAX package's ops update them."""
    r = np.random.RandomState(4)
    w0, g0, m0, v0 = (r.standard_normal(5).astype(np.float32)
                      for _ in range(4))
    v0 = np.abs(v0)
    cases = [("sgd_update", [], {"lr": 0.1, "wd": 0.01}),
             ("sgd_mom_update", [m0], {"lr": 0.1, "momentum": 0.9,
                                       "wd": 0.01, "clip_gradient": 0.5}),
             ("adam_update", [m0, v0], {"lr": 0.01, "rescale_grad": 0.5})]
    for name, states, attrs in cases:
        res = []
        for pkg in (mx, jmx):
            arrs = [pkg.nd.array(a, ctx=pkg.cpu())
                    for a in [w0, g0] + states]
            getattr(pkg.nd, name)(*arrs, out=arrs[0], **attrs)
            res.append([a.asnumpy() for a in arrs[:1] + arrs[2:]])
        for got, want in zip(*res):
            assert not np.array_equal(got, w0)
            np.testing.assert_allclose(got, want, **TOL)

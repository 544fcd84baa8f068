"""The training slice's ops in the port against the JAX package's ops.

Each op runs through both registries on the same numpy inputs (made from
a seed); values and ``jax.vjp`` / torch autograd gradients under the same
cotangent are compared.  Tolerance: f32 atol=rtol=1e-5 (the same
arithmetic in another summation order), unless a test says otherwise.
The JAX kernel families ``pool`` and ``bn`` run in interpret mode where a
test sets them, so that tie routing and the one-pass BatchNorm formulas
are the Pallas kernels'; elsewhere the JAX side takes its XLA path.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.ops.registry import get_op as jax_op
from mxnet_tpu_torch.ops.registry import get_op as port_op

TOL = dict(atol=1e-5, rtol=1e-5)


def _run_both(name, inputs, attrs, train=False, n_diff=None, seed=9):
    """(jax outputs, port outputs, jax grads, port grads) of op ``name``,
    as float64 arrays; gradients of the visible outputs under one random
    cotangent (f32 normals, rounded to each output's dtype) with respect
    to the first ``n_diff`` inputs (default: all)."""
    oj, ot = jax_op(name), port_op(name)
    aj, at = oj.normalize_attrs(attrs), ot.normalize_attrs(attrs)
    if oj.takes_train_flag:
        aj["_train"] = train
    if ot.takes_train_flag:
        at["_train"] = train
    n_vis = ot.str_outputs(at)
    n_diff = len(inputs) if n_diff is None else n_diff

    def visible(out):
        out = out if isinstance(out, tuple) else (out,)
        return out[:n_vis]

    def fj(diff, rest):
        return visible(oj.impl(*diff, *rest, **aj))

    def program(diff, rest, cts):
        # the JAX side of a case as one jitted program: its full outputs
        # and the visible outputs' vjp, compiled once rather than
        # dispatched primitive by primitive
        full = oj.impl(*diff, *rest, **aj)
        outs, vjp = jax.vjp(lambda *d: fj(d, rest), *diff)
        return (full if isinstance(full, tuple) else (full,)), vjp(
            tuple(c.astype(o.dtype) for c, o in zip(cts, outs)))

    diff = [jnp.asarray(x) for x in inputs[:n_diff]]
    rest = [jnp.asarray(x) for x in inputs[n_diff:]]
    r = np.random.RandomState(seed)
    cts = [np.asarray(r.randn(*o.shape), np.float32)
           for o in jax.eval_shape(fj, diff, rest)]
    full_j, grads_j = jax.jit(program)(diff, rest,
                                       [jnp.asarray(c) for c in cts])
    ts = [torch.tensor(x, requires_grad=i < n_diff)
          for i, x in enumerate(inputs)]
    full_t = ot.impl(*ts, **at)
    full_t = full_t if isinstance(full_t, tuple) else (full_t,)
    # outputs that carry no gradient (eval-mode mean/var are the moving
    # statistics) take their cotangent nowhere, as under jax.vjp
    live = [(o, torch.from_numpy(c).to(o.dtype))
            for o, c in zip(full_t[:n_vis], cts) if o.requires_grad]
    grads_t = torch.autograd.grad([o for o, _ in live], ts[:n_diff],
                                  [c for _, c in live], allow_unused=True)
    grads_t = [np.zeros(x.shape) if g is None else g.double().numpy()
               for g, x in zip(grads_t, inputs)]
    return ([np.asarray(o, dtype=np.float64) for o in full_j],
            [o.detach().double().numpy() for o in full_t],
            [np.asarray(g, dtype=np.float64) for g in grads_j], grads_t)


def _check(results, tol=TOL):
    outs_j, outs_t, grads_j, grads_t = results
    assert len(outs_j) == len(outs_t)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b, a, **tol)
    for a, b in zip(grads_j, grads_t):
        np.testing.assert_allclose(b, a, **tol)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's pool and bn kernel families in interpret mode."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_POOL", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_BN", "1")


CONV_CASES = [
    dict(kernel=(3, 3), num_filter=5, pad=(1, 1), stride=(2, 2)),
    dict(kernel=(1, 1), num_filter=4, no_bias=True),
    dict(kernel=(3, 3), num_filter=6, dilate=(2, 2), num_group=2),
    dict(kernel=(7, 7), num_filter=4, pad=(3, 3), stride=(2, 2),
         no_bias=True),
]


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("attrs", CONV_CASES,
                         ids=lambda a: "k%d-g%d" % (a["kernel"][0],
                                                    a.get("num_group", 1)))
def test_convolution(attrs, train):
    r = np.random.RandomState(0)
    cin = 4 if attrs.get("num_group", 1) == 2 else 3
    x = r.randn(2, cin, 12, 12).astype(np.float32)
    w = r.randn(attrs["num_filter"], cin // attrs.get("num_group", 1),
                *attrs["kernel"]).astype(np.float32)
    inputs = [x, w]
    if not attrs.get("no_bias"):
        inputs.append(r.randn(attrs["num_filter"]).astype(np.float32))
    _check(_run_both("Convolution", inputs, attrs, train=train),
           dict(atol=1e-4, rtol=1e-5))


@pytest.mark.parametrize("act", ["relu", "sigmoid", "tanh", "softrelu",
                                 "softsign"])
def test_activation(act):
    x = np.random.RandomState(1).randn(3, 4, 5).astype(np.float32)
    x[0, 0, :3] = 0.0  # exact zeros: relu's gradient there is 0.5
    _check(_run_both("Activation", [x], {"act_type": act}))


def test_relu_gradient_at_zero_is_one_half():
    x = np.array([-1.0, 0.0, 1.0], np.float32)
    _, _, gj, gt = _run_both("Activation", [x], {"act_type": "relu"})
    ct = np.random.RandomState(9).randn(3).astype(np.float32)
    np.testing.assert_allclose(gt[0], ct * [0.0, 0.5, 1.0], rtol=1e-6)
    np.testing.assert_allclose(gj[0], gt[0], rtol=1e-6)


POOL_OP_CASES = [
    dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         pooling_convention="full"),
    dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(pool_type="avg", kernel=(3, 2), stride=(1, 2), pad=(1, 1),
         pooling_convention="full", count_include_pad=False),
    dict(pool_type="sum", kernel=(2, 3), stride=(2, 1), pad=(0, 1)),
    dict(pool_type="avg", kernel=(7, 7), global_pool=True),
    dict(pool_type="max", kernel=(1, 1), global_pool=True),
    dict(pool_type="max", kernel=(9, 9), stride=(1, 1)),  # 81 taps: autograd
]


@pytest.mark.parametrize("attrs", POOL_OP_CASES, ids=lambda a: "-".join(
    "%s" % (v,) for v in a.values()))
def test_pooling(attrs, jax_kernels):
    r = np.random.RandomState(2)
    x = np.maximum(r.randn(2, 3, 11, 13), 0).astype(np.float32)  # ties
    _check(_run_both("Pooling", [x], attrs))


def test_pooling_1d_takes_autograd():
    x = np.random.RandomState(3).randn(2, 3, 11).astype(np.float32)
    _check(_run_both("Pooling", [x], dict(pool_type="avg", kernel=(3,),
                                          stride=(2,), pad=(1,))))


def _bn_inputs(shape=(4, 6, 5, 7), seed=4):
    r = np.random.RandomState(seed)
    c = shape[1]
    return [(r.randn(*shape) * 2 + 1).astype(np.float32),
            (r.rand(c) + 0.5).astype(np.float32),
            r.randn(c).astype(np.float32),
            r.randn(c).astype(np.float32),
            (r.rand(c) + 0.5).astype(np.float32)]


BN_CASES = [
    dict(fix_gamma=False, eps=2e-5, momentum=0.9),
    dict(fix_gamma=True, eps=1e-3),
    dict(fix_gamma=False, output_mean_var=True),
    dict(fix_gamma=False, use_global_stats=True),
]


@pytest.mark.parametrize("jax_mode", ["xla", "kernel"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("attrs", BN_CASES, ids=lambda a: "-".join(
    "%s=%s" % kv for kv in a.items()))
def test_batch_norm(attrs, train, jax_mode, monkeypatch):
    """Outputs (with mean/var under output_mean_var, whose cotangents
    reach dx), the new moving statistics, and the gradients of data,
    gamma (an exact zero under fix_gamma) and beta."""
    if jax_mode == "kernel":
        monkeypatch.setenv("MXNET_TPU_PALLAS_BN", "1")
    results = _run_both("BatchNorm", _bn_inputs(), attrs, train=train,
                        n_diff=3)
    _check(results, dict(atol=2e-5, rtol=1e-5))
    if attrs.get("fix_gamma", True):
        assert not results[3][1].any()


def test_batch_norm_other_axis_takes_autograd():
    x = np.random.RandomState(5).randn(4, 5, 6).astype(np.float32)
    ins = [x] + [a[:6] for a in _bn_inputs((1, 6, 1, 1))[1:]]
    _check(_run_both("BatchNorm", ins, dict(axis=2, fix_gamma=False),
                     train=True, n_diff=3), dict(atol=2e-5, rtol=1e-5))


SOFTMAX_CASES = [
    dict(),
    dict(normalization="batch", grad_scale=0.5),
    dict(normalization="valid", use_ignore=True, ignore_label=2.0),
    dict(use_ignore=True, ignore_label=-1.0),
    dict(multi_output=True, normalization="valid", use_ignore=True,
         ignore_label=1.0),
    dict(preserve_shape=True),
]


@pytest.mark.parametrize("attrs", SOFTMAX_CASES, ids=lambda a: "-".join(
    "%s" % (v,) for v in a.values()) or "default")
def test_softmax_output(attrs):
    """The backward ignores the head gradient: (p - onehot) * grad_scale,
    masked by ignore_label, over the batch or valid count."""
    r = np.random.RandomState(6)
    if attrs.get("multi_output"):
        x = r.randn(3, 4, 5).astype(np.float32)
        lab = r.randint(0, 4, (3, 5)).astype(np.float32)
    elif attrs.get("preserve_shape"):
        x = r.randn(3, 2, 5).astype(np.float32)
        lab = r.randint(0, 5, (3, 2)).astype(np.float32)
    else:
        x = r.randn(6, 5).astype(np.float32)
        lab = np.array([0, 2, 4, -1, 2, 1], np.float32)
    _check(_run_both("SoftmaxOutput", [x, lab], attrs, n_diff=1))


def test_flatten():
    x = np.random.RandomState(7).randn(2, 3, 4, 5).astype(np.float32)
    _check(_run_both("Flatten", [x], {}))


def _small_net(sym):
    net = sym.Convolution(sym.Variable("data"), kernel=(3, 3),
                          num_filter=4, pad=(1, 1), name="conv1")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = sym.Flatten(net, name="flat1")
    net = sym.FullyConnected(net, num_hidden=3, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")


def test_shape_and_type_inference_match():
    sj, st = _small_net(mj.sym), _small_net(mt.sym)
    assert sj.list_arguments() == st.list_arguments()
    assert sj.list_auxiliary_states() == st.list_auxiliary_states()
    for got, want in zip(st.infer_shape(data=(4, 3, 6, 6)),
                         sj.infer_shape(data=(4, 3, 6, 6))):
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert [str(np.dtype(t)) for t in st.infer_type(data="float32")[0]] \
        == [str(np.dtype(t)) for t in sj.infer_type(data="float32")[0]]

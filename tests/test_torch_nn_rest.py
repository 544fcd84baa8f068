"""The last ``nn`` ops and update ops in the port against the JAX
package's.

The regression heads (``LinearRegressionOutput``,
``LogisticRegressionOutput``, ``MAERegressionOutput``), ``SVMOutput``,
the sequence ops (``SequenceLast``, ``SequenceMask``,
``SequenceReverse``, TNC, with and without ``use_sequence_length``) and
``UpSampling`` go through ``_run_both`` of ``tests/test_torch_train_ops.py``
(the same seeded numpy inputs through both registries, values and the
``jax.vjp`` / torch autograd gradients under one cotangent); so do the
update ops ``adamax_update``, ``ftml_update``, ``nadam_update`` and
``nag_mom_update``, whose new states are compared too.  ``sgld_update``
draws its noise from the port's generator: its deterministic part is held
to the JAX package's formula and its noise by its moments.  The
reference's ``test_regression_outputs`` and ``test_sequence_ops`` run on
the port, through bound symbols.

Tolerances: forward values atol=rtol=1e-5, gradients atol=rtol=1e-4 (the
same f32 math in another order); the SGLD noise's mean and variance
within 6 standard errors at 10^5 draws.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops.registry import get_op as port_op

from test_torch_train_ops import _run_both

FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _f(rng, *shape, lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape).astype(np.float32)


def _check(results, n_grads=None):
    outs_j, outs_t, grads_j, grads_t = results
    assert len(outs_j) == len(outs_t)
    for a, b in zip(outs_j, outs_t):
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, **FWD)
    for a, b in list(zip(grads_j, grads_t))[:n_grads]:
        np.testing.assert_allclose(b, a, **GRAD)


REG_CASES = {
    "linear-2d": ("LinearRegressionOutput", (6, 10), {}),
    "linear-col": ("LinearRegressionOutput", (6, 1), {"grad_scale": 2.0}),
    "logistic-2d": ("LogisticRegressionOutput", (6, 10), {}),
    "logistic-col": ("LogisticRegressionOutput", (6, 1), {}),
    "logistic-4d": ("LogisticRegressionOutput", (2, 3, 2, 2),
                    {"grad_scale": 0.5}),
    "mae-2d": ("MAERegressionOutput", (6, 10), {}),
    "mae-1d": ("MAERegressionOutput", (7,), {"grad_scale": 3.0}),
}


@pytest.mark.parametrize("case", sorted(REG_CASES))
def test_regression_heads(case):
    name, shape, attrs = REG_CASES[case]
    rng = np.random.RandomState(1)
    data = _f(rng, *shape, lo=-3, hi=3)
    label = (rng.rand(*shape) > 0.5).astype(np.float32) \
        if name == "LogisticRegressionOutput" else _f(rng, *shape)
    _check(_run_both(name, [data, label], attrs))


def test_regression_heads_infer_the_label_shape():
    for pkg in (jmx, mx):
        out = pkg.sym.LinearRegressionOutput(pkg.sym.var("data"),
                                             name="lro")
        args, outs, _ = out.infer_shape(data=(5, 3))
        assert out.list_arguments() == ["data", "lro_label"]
        assert args == [(5, 3), (5, 3)] and outs == [(5, 3)]


def test_svm_output():
    rng = np.random.RandomState(2)
    data = _f(rng, 6, 4)
    label = rng.randint(0, 4, 6).astype(np.float32)
    for attrs in ({}, {"margin": 0.5, "use_linear": True}):
        _check(_run_both("SVMOutput", [data, label], attrs))


T, N, C = 5, 3, 4
SEQ_CASES = {
    "last": ("SequenceLast", {}),
    "last-len": ("SequenceLast", {"use_sequence_length": True}),
    "last-len-axis1": ("SequenceLast", {"use_sequence_length": True,
                                        "axis": 1}),
    "mask": ("SequenceMask", {}),
    "mask-len": ("SequenceMask", {"use_sequence_length": True,
                                  "value": -2.0}),
    "mask-len-axis1": ("SequenceMask", {"use_sequence_length": True,
                                        "axis": 1}),
    "reverse": ("SequenceReverse", {}),
    "reverse-len": ("SequenceReverse", {"use_sequence_length": True}),
}


@pytest.mark.parametrize("case", sorted(SEQ_CASES))
def test_sequence_ops(case):
    name, attrs = SEQ_CASES[case]
    rng = np.random.RandomState(3)
    axis1 = attrs.get("axis") == 1
    data = _f(rng, *((N, T, C) if axis1 else (T, N, C)))
    lengths = np.array([2, 5, 1], np.float32)
    _check(_run_both(name, [data, lengths], attrs, n_diff=1), n_grads=1)


UP_CASES = {
    "nearest-2": ({"scale": 2}, (2, 3, 4, 5)),
    "nearest-3": ({"scale": 3, "sample_type": "nearest"}, (1, 2, 3, 3)),
    "bilinear-2": ({"scale": 2, "sample_type": "bilinear",
                    "num_filter": 3}, (2, 3, 4, 5)),
}


@pytest.mark.parametrize("case", sorted(UP_CASES))
def test_upsampling(case):
    attrs, shape = UP_CASES[case]
    rng = np.random.RandomState(4)
    _check(_run_both("UpSampling", [_f(rng, *shape)], attrs))


def test_upsampling_reads_only_its_first_input():
    rng = np.random.RandomState(5)
    a, b = _f(rng, 1, 2, 3, 3), _f(rng, 1, 2, 3, 3)
    outs = []
    for pkg in (jmx, mx):
        x = [pkg.nd.array(v, ctx=pkg.cpu()) for v in (a, b)]
        outs.append(pkg.nd.UpSampling(*x, scale=2, num_args=2).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **FWD)
    assert outs[1].shape == (1, 2, 6, 6)


def _state(rng, *shape, positive=False):
    v = _f(rng, *shape)
    return np.abs(v) + 0.1 if positive else v


UPDATE_CASES = {
    "adamax": ("adamax_update", 2, {"lr": 0.01, "t": 3, "wd": 0.01}),
    "adamax-clip": ("adamax_update", 2, {"lr": 0.02, "beta1": 0.8,
                                         "rescale_grad": 2.0,
                                         "clip_gradient": 0.5}),
    "nadam": ("nadam_update", 2, {"lr": 0.01, "t": 4, "wd": 0.001}),
    "nadam-clip": ("nadam_update", 2, {"lr": 0.005, "t": 1,
                                       "clip_gradient": 0.3,
                                       "schedule_decay": 0.01}),
    "ftml": ("ftml_update", 3, {"lr": 0.01, "t": 2, "wd": 0.01}),
    "ftml-clip": ("ftml_update", 3, {"lr": 0.02, "t": 5, "beta1": 0.7,
                                     "clip_grad": 0.4,
                                     "rescale_grad": 0.5}),
    "nag": ("nag_mom_update", 1, {"lr": 0.1, "momentum": 0.9, "wd": 1e-3}),
    "nag-clip": ("nag_mom_update", 1, {"lr": 0.05, "momentum": 0.5,
                                       "clip_gradient": 0.2}),
}


@pytest.mark.parametrize("case", sorted(UPDATE_CASES))
def test_update_ops(case):
    name, n_states, attrs = UPDATE_CASES[case]
    rng = np.random.RandomState(6)
    # states that are positive where the op divides by them or takes a
    # square root (ftml's d and v, adamax/nadam's var)
    positive = {1: (), 2: (1,), 3: (0, 1)}[n_states]
    states = [_state(rng, 4, 5, positive=i in positive)
              for i in range(n_states)]
    _check(_run_both(name, [_f(rng, 4, 5), _f(rng, 4, 5)] + states, attrs))


def test_update_ops_write_their_states_back():
    """Through ``mx.nd``: the new weight is returned (or written to
    ``out=``), the new states land in the state arrays, as in the JAX
    package."""
    rng = np.random.RandomState(7)
    vals = [_f(rng, 3, 4), _f(rng, 3, 4), _state(rng, 3, 4),
            _state(rng, 3, 4, positive=True)]
    got = {}
    for pkg in (jmx, mx):
        w, g, m, v = [pkg.nd.array(x, ctx=pkg.cpu()) for x in vals]
        pkg.nd.adamax_update(w, g, m, v, out=w, lr=0.01, t=2)
        got[pkg] = [a.asnumpy() for a in (w, m, v)]
    for a, b in zip(got[jmx], got[mx]):
        np.testing.assert_allclose(b, a, **FWD)
    assert not np.allclose(got[mx][1], vals[2])


def test_sgld_update():
    """The deterministic part ``w - lr/2 * g`` is the JAX package's; the
    noise is N(0, lr) from the port's generator: mean and variance within
    6 standard errors at 10^5 draws, the same seed the same bits."""
    rng = np.random.RandomState(8)
    n, lr, wd = 100000, 0.04, 0.01
    w, g = _f(rng, n), _f(rng, n)
    attrs = {"lr": lr, "wd": wd, "rescale_grad": 2.0, "clip_gradient": 1.5}
    want = w - lr / 2 * np.clip(g * 2.0 + wd * w, -1.5, 1.5)
    op = port_op("sgld_update")
    assert op.needs_rng and jmx.ops.registry.get_op("sgld_update").needs_rng
    mx.random.seed(11)
    out = op.impl(torch.from_numpy(w), torch.from_numpy(g),
                  **op.normalize_attrs(attrs)).numpy()
    noise = out.astype(np.float64) - want
    assert abs(noise.mean()) < 6 * np.sqrt(lr / n)
    # variance of a normal sample: standard error var * sqrt(2 / n)
    assert abs(noise.var() - lr) < 6 * lr * np.sqrt(2.0 / n)
    mx.random.seed(11)
    again = op.impl(torch.from_numpy(w), torch.from_numpy(g),
                    **op.normalize_attrs(attrs)).numpy()
    np.testing.assert_array_equal(again, out)


def test_reference_regression_outputs():
    """``tests/test_operator.py::test_regression_outputs`` on the port."""
    rng = np.random.RandomState(128)
    x = rng.rand(4, 3).astype(np.float32)
    y = rng.rand(4, 3).astype(np.float32)
    with mx.cpu():
        data = mx.sym.Variable("data")
        lab = mx.sym.Variable("lab")
        lro = mx.sym.LinearRegressionOutput(data=data, label=lab)
        ex = lro.bind(mx.current_context(),
                      args={"data": mx.nd.array(x), "lab": mx.nd.array(y)},
                      args_grad={"data": mx.nd.zeros((4, 3))},
                      grad_req={"data": "write", "lab": "null"})
        ex.forward(is_train=True)
        np.testing.assert_allclose(ex.outputs[0].asnumpy(), x, **FWD)
        ex.backward()
        np.testing.assert_allclose(ex.grad_dict["data"].asnumpy(),
                                   (x - y) / 3.0, rtol=1e-5, atol=1e-6)


def test_reference_sequence_ops():
    """``tests/test_operator.py::test_sequence_ops`` on the port."""
    rng = np.random.RandomState(128)
    x = rng.rand(4, 2, 3).astype(np.float32)
    seqlen = np.array([2, 4], np.float32)
    with mx.cpu():
        data = mx.sym.Variable("data")
        sl = mx.sym.Variable("sl")
        last = mx.sym.SequenceLast(data=data, sequence_length=sl,
                                   use_sequence_length=True)
        ex = last.bind(mx.current_context(),
                       args={"data": mx.nd.array(x),
                             "sl": mx.nd.array(seqlen)})
        ex.forward()
        np.testing.assert_allclose(ex.outputs[0].asnumpy(),
                                   np.stack([x[1, 0], x[3, 1]]), **FWD)
        mask = mx.sym.SequenceMask(data=data, sequence_length=sl,
                                   use_sequence_length=True, value=-1.0)
        ex = mask.bind(mx.current_context(),
                       args={"data": mx.nd.array(x),
                             "sl": mx.nd.array(seqlen)})
        ex.forward()
        out = ex.outputs[0].asnumpy()
        assert (out[2:, 0] == -1).all() and (out[:2, 0] != -1).all()


def test_new_ops_are_registered_in_both_packages():
    names = ["LinearRegressionOutput", "LogisticRegressionOutput",
             "MAERegressionOutput", "SVMOutput", "SequenceLast",
             "SequenceMask", "SequenceReverse", "UpSampling",
             "adamax_update", "ftml_update", "nadam_update",
             "nag_mom_update", "sgld_update"]
    for name in names:
        op = port_op(name)
        jop = jmx.ops.registry.get_op(name)
        assert set(op.params) == set(jop.params), name
        assert op.mutate_map == tuple(jop.mutate_map), name
        assert hasattr(mx.nd, name) and hasattr(mx.sym, name)


@pytest.mark.parametrize("name", ["adamax_update", "sgd_mom_update"])
def test_update_op_in_a_bound_graph_trains_forward(name):
    """ROADMAP C9: an update op inside a bound graph runs a training
    forward (the port raised KeyError writing the new state into the aux
    arrays by the argument's name) and, as in the JAX package, leaves the
    state arguments as bound."""
    rng = np.random.RandomState(9)
    states = 2 if name == "adamax_update" else 1
    vals = [_f(rng, 3, 4), _f(rng, 3, 4)] + [
        _state(rng, 3, 4, positive=True) for _ in range(states)]
    names = ["w", "g", "s0", "s1"][:2 + states]
    got = {}
    for pkg in (jmx, mx):
        args = [pkg.sym.var(n) for n in names]
        sym = getattr(pkg.sym, name)(*args, lr=0.01, momentum=0.9) \
            if name == "sgd_mom_update" \
            else getattr(pkg.sym, name)(*args, lr=0.01, t=2)
        ex = sym.bind(pkg.cpu(), args={
            n: pkg.nd.array(v, ctx=pkg.cpu()) for n, v in zip(names, vals)})
        ex.forward(is_train=True)
        got[pkg] = [ex.outputs[0].asnumpy()] + [
            ex.arg_dict[n].asnumpy() for n in names[2:]]
    for a, b in zip(got[jmx], got[mx]):
        np.testing.assert_allclose(b, a, **FWD)
    for state, value in zip(got[mx][1:], vals[2:]):
        np.testing.assert_array_equal(state, value)

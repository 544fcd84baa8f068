"""Repairs of four faults of the port against the JAX package (ROADMAP
C4-C7).  Each test runs the same calls in both packages on the host and
compares what they give.

C4: ``==``/``!=`` of NDArrays and Symbols build comparison ops (and
``None`` compares by identity), the truth, ``float()`` and ``int()`` of a
one-element array are its value, more elements refuse a truth value, and
``**``/``%`` are operators; the hash stays the identity's.  C5: a
backward after a forward that did not train runs the forward again in
training mode.  C6: slices with a negative step read and write.  C7:
``simple_bind`` allocates gradients by default (``grad_req="write"``),
while ``Predictor`` and ``ServedModel`` still bind without any.

Tolerances: elementwise results exactly; gradients atol=rtol=1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving

PKGS = [jmx, mx]


def _nd(pkg, value):
    return pkg.nd.array(value, ctx=pkg.cpu())


def _np(out):
    return out.asnumpy() if hasattr(out, "asnumpy") else np.asarray(out)


# -- C4 ---------------------------------------------------------------------

BINARY = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "eq_scalar": lambda a, b: a == 2.0,
    "ne_scalar": lambda a, b: a != 2.0,
    "pow": lambda a, b: a ** b,
    "pow_scalar": lambda a, b: a ** 2.0,
    "rpow": lambda a, b: 2.0 ** a,
    "mod": lambda a, b: a % b,
    "mod_scalar": lambda a, b: a % 3.0,
    "rmod": lambda a, b: 7.0 % b,
}


@pytest.mark.parametrize("case", sorted(BINARY))
def test_c4_ndarray_operators_build_ops(case):
    """Each operator gives the JAX package's array, exactly."""
    a = np.array([[1., 2., 3.], [4., 2., 6.]], np.float32)
    b = np.array([[3., 2., 1.], [2., 2., 5.]], np.float32)
    outs = [BINARY[case](_nd(p, a), _nd(p, b)) for p in PKGS]
    assert all(type(o).__name__ == "NDArray" for o in outs)
    np.testing.assert_array_equal(_np(outs[1]), _np(outs[0]))


def test_c4_ndarray_none_truth_float_int_hash():
    for pkg in PKGS:
        x = _nd(pkg, [1., 2.])
        assert (x == None) is False and (x != None) is True  # noqa: E711
        assert bool(_nd(pkg, [0.])) is False
        assert bool(_nd(pkg, [3.])) is True
        with pytest.raises(ValueError):
            bool(x)
        assert float(_nd(pkg, [2.5])) == 2.5
        assert int(_nd(pkg, [3.7])) == 3
        assert hash(x) == id(x)
        assert x in {x: 1}  # dicts and sets find an array by identity


def test_c4_membership_compares_elementwise():
    """``in`` over a list of arrays asks ``==``: the identical array is
    found first; another one-element array by value; a longer one
    refuses a truth value, in both packages."""
    for pkg in PKGS:
        x, y = _nd(pkg, [1.]), _nd(pkg, [1., 2.])
        assert x in [x] and _nd(pkg, [1.]) in [x]
        assert _nd(pkg, [4.]) not in [x]
        with pytest.raises(ValueError):
            _nd(pkg, [1., 2.]) in [y]  # noqa: B015


SYM_BINARY = {
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
    "eq_scalar": lambda a, b: a == 2.0,
    "ne_scalar": lambda a, b: a != 2.0,
    "pow": lambda a, b: a ** b,
    "pow_scalar": lambda a, b: a ** 3.0,
}


@pytest.mark.parametrize("case", sorted(SYM_BINARY))
def test_c4_symbol_operators_compose(case):
    """The composed graph's JSON is the JAX package's, and it computes
    the same values."""
    syms, outs = [], []
    a = np.array([1., 2., 3.], np.float32)
    b = np.array([3., 2., 2.], np.float32)
    for pkg in PKGS:
        with pkg.sym.NameManager():
            s = SYM_BINARY[case](pkg.sym.var("a"), pkg.sym.var("b"))
        assert isinstance(s, pkg.sym.Symbol) and hash(s) == id(s)
        syms.append(s)
        args = {n: _nd(pkg, v) for n, v in (("a", a), ("b", b))
                if n in s.list_arguments()}
        outs.append(s.bind(pkg.cpu(), args).forward()[0].asnumpy())
    assert syms[1].tojson() == syms[0].tojson()
    np.testing.assert_array_equal(outs[1], outs[0])


# -- C5 ---------------------------------------------------------------------

def test_c5_reshape_like_backward_after_predict_forward():
    """The reference's ``test_operator.py::test_reshape_like``, in both
    packages: ``forward()`` then ``backward(out_grad)``."""
    rng = np.random.RandomState(0)
    a = rng.rand(2, 6).astype(np.float32)
    b = np.zeros((3, 4), np.float32)
    for pkg in PKGS:
        sym = pkg.sym.reshape_like(pkg.sym.var("lhs"), pkg.sym.var("rhs"))
        exe = sym.bind(pkg.cpu(), {"lhs": _nd(pkg, a), "rhs": _nd(pkg, b)},
                       args_grad={"lhs": pkg.nd.zeros((2, 6), pkg.cpu()),
                                  "rhs": pkg.nd.zeros((3, 4), pkg.cpu())})
        out = exe.forward()[0]
        assert out.shape == (3, 4)
        np.testing.assert_array_equal(out.asnumpy().ravel(), a.ravel())
        exe.backward(_nd(pkg, np.ones((3, 4), np.float32)))
        np.testing.assert_array_equal(exe.grad_dict["lhs"].asnumpy(), 1.0)
        np.testing.assert_array_equal(exe.grad_dict["rhs"].asnumpy(), 0.0)


def test_c5_softmax_cross_entropy_backward_after_predict_forward():
    """The reference's ``test_operator.py::test_softmax_cross_entropy``
    gradient half: softmax minus one-hot, the port within 1e-5 of the
    JAX package and within atol=1e-5, rtol=1e-4 of numpy."""
    rng = np.random.RandomState(1)
    d = rng.randn(4, 5).astype(np.float32)
    lab = rng.randint(0, 5, (4,)).astype(np.float32)
    p = np.exp(d - d.max(1, keepdims=True))
    p /= p.sum(1, keepdims=True)
    onehot = np.eye(5, dtype=np.float32)[lab.astype(int)]
    grads = []
    for pkg in PKGS:
        sym = pkg.sym.softmax_cross_entropy(pkg.sym.var("data"),
                                            pkg.sym.var("label"))
        exe = sym.bind(pkg.cpu(), {"data": _nd(pkg, d),
                                   "label": _nd(pkg, lab)},
                       args_grad={"data": pkg.nd.zeros((4, 5), pkg.cpu())},
                       grad_req={"data": "write", "label": "null"})
        exe.forward()
        exe.backward(_nd(pkg, np.ones((1,), np.float32)))
        grads.append(exe.grad_dict["data"].asnumpy())
        np.testing.assert_allclose(grads[-1], p - onehot, rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-5)


# -- C6 ---------------------------------------------------------------------

READS = {
    "step-2": (slice(None, None, -2),),
    "5:0:-2": (slice(5, 0, -2),),
    "rows-1,col1": (slice(None, None, -1), 1),
    "rows-1,cols-3": (slice(None, None, -1), slice(None, None, -3)),
    "2::-2,1:5:2": (slice(2, None, -2), slice(1, 5, 2)),
    "empty": (slice(0, 3, -1),),
    "ellipsis": (Ellipsis, slice(4, 1, -1)),
}


@pytest.mark.parametrize("case", sorted(READS))
def test_c6_negative_step_read(case):
    x = np.arange(36, dtype=np.float32).reshape(6, 6)
    key = READS[case]
    key = key[0] if len(key) == 1 else key
    outs = [_nd(p, x)[key].asnumpy() for p in PKGS]
    np.testing.assert_array_equal(outs[1], x[key])
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("case", sorted(READS))
def test_c6_negative_step_write(case):
    x = np.arange(36, dtype=np.float32).reshape(6, 6)
    key = READS[case]
    key = key[0] if len(key) == 1 else key
    value = -1.0 - np.arange(x[key].size, dtype=np.float32).reshape(
        x[key].shape)
    want = x.copy()
    want[key] = value
    for pkg in PKGS:
        arr = _nd(pkg, x)
        arr[key] = _nd(pkg, value) if value.size else value
        np.testing.assert_array_equal(arr.asnumpy(), want)
        arr = _nd(pkg, x)
        arr[key] = 7.0
        want7 = x.copy()
        want7[key] = 7.0
        np.testing.assert_array_equal(arr.asnumpy(), want7)


def test_c6_negative_step_read_stays_on_the_tape():
    """A reversed slice read under ``record()`` carries its gradient (the
    port's slices are on the tape; ROADMAP C lists this difference)."""
    w = np.array([1., 2., 3.], np.float32)
    y = _nd(mx, np.arange(6, dtype=np.float32))
    y.attach_grad()
    with mx.autograd.record():
        z = (y[::-2] * _nd(mx, w)).sum()
    z.backward()
    np.testing.assert_array_equal(y.grad.asnumpy(), [0, 3, 0, 2, 0, 1])


# -- C7 ---------------------------------------------------------------------

def test_c7_simple_bind_allocates_gradients_by_default():
    """``simple_bind(x=(3,))`` -> ``forward(is_train=True)`` ->
    ``backward()`` fills ``grad_dict`` in both packages, equally."""
    x = np.array([1., -2., 3.], np.float32)
    grads = []
    for pkg in PKGS:
        v = pkg.sym.var("x")
        exe = (v * v * 0.5).simple_bind(pkg.cpu(), x=(3,))
        assert sorted(exe.grad_dict) == ["x"]
        exe.arg_dict["x"][:] = x
        exe.forward(is_train=True)
        exe.backward()
        grads.append(exe.grad_dict["x"].asnumpy())
    np.testing.assert_allclose(grads[1], x, rtol=1e-6)
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-6)


def _fc_net(pkg):
    with pkg.sym.NameManager():
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=3,
                                     name="fc")
        return pkg.sym.softmax(net)


def _no_backward(exe):
    assert exe.grad_dict == {} and exe._grad_names == []
    exe.forward(is_train=True)
    assert exe._recorded is None


def test_c7_predictor_and_served_model_build_no_backward():
    rng = np.random.RandomState(0)
    args = {"fc_weight": rng.randn(3, 4).astype(np.float32),
            "fc_bias": rng.randn(3).astype(np.float32)}
    x = rng.randn(2, 4).astype(np.float32)
    params = {"arg:" + k: _nd(mx, v) for k, v in args.items()}
    pred = mx.Predictor(_fc_net(mx).tojson(), params, {"data": (2, 4)},
                        ctx=mx.cpu())
    _no_backward(pred._exe)
    _no_backward(pred.reshaped({"data": (5, 4)})._exe)
    jpred = jmx.predict.Predictor(
        _fc_net(jmx).tojson(), {k: _nd(jmx, v) for k, v in args.items()},
        {"data": (2, 4)})
    assert jpred._exe.grad_dict == {}
    pred.forward(data=x)
    jpred.forward(data=x)
    np.testing.assert_allclose(pred.get_output(0).asnumpy(),
                               jpred.get_output(0).asnumpy(), atol=1e-6)
    model = serving.ServedModel(
        "m", _fc_net(mx), {k: _nd(mx, v) for k, v in args.items()}, {},
        {"data": (4,)}, max_batch_size=4, ctx=mx.cpu())
    for bucket in model.buckets:
        _no_backward(model.predictor_for(bucket)._exe)


def test_c7_simple_bind_sharing_keywords():
    """``shared_exec`` with ``shared_arg_names`` binds the sharer's
    parameters, gradients and aux states; ``shared_buffer`` takes the
    other arrays and gains the new ones; ``group2ctx`` over one context
    binds, and over two it places by ``ctx_group`` (no node here has one,
    so every array stays on the bind context)."""
    with mx.sym.NameManager():
        net = mx.sym.BatchNorm(mx.sym.FullyConnected(
            mx.sym.var("data"), num_hidden=3, name="fc"), name="bn")
    first = net.simple_bind(mx.cpu(), data=(2, 4))
    buffer = {}
    second = net.simple_bind(mx.cpu(), data=(2, 4), shared_exec=first,
                             shared_arg_names=["fc_weight", "fc_bias"],
                             shared_buffer=buffer)
    for name in ("fc_weight", "fc_bias"):
        assert second.arg_dict[name] is first.arg_dict[name]
        assert second.grad_dict[name] is first.grad_dict[name]
    for name in first.aux_dict:
        assert second.aux_dict[name] is first.aux_dict[name]
    assert second.arg_dict["data"] is buffer["data"]
    assert second.arg_dict["data"] is not first.arg_dict["data"]
    third = net.simple_bind(mx.cpu(), data=(2, 4), shared_buffer=buffer)
    assert third.arg_dict["data"] is buffer["data"]
    assert net.simple_bind(mx.cpu(), data=(2, 4),
                           group2ctx={"dev1": mx.cpu()}).arg_dict
    placed = net.simple_bind(mx.cpu(), data=(2, 4),
                             group2ctx={"dev1": mx.cpu(), "dev2": mx.gpu(0)})
    for table in (placed.arg_dict, placed.grad_dict, placed.aux_dict):
        assert all(a.context == mx.cpu() for a in table.values())

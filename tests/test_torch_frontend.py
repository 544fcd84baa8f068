"""The port's NDArray, Symbol and Executor protocol against the JAX
package's, on the host.

Every fluent method of ``NDArray`` and the ``mx.nd`` module functions
the reference defines, the operators, ``stype``/``tostype``;
``Symbol.bind`` (argument lists and dicts, ``grad_req`` as a string, a
list or a dict, the caller's arrays shared), ``eval``, ``get_internals``,
``attr``/``list_attr``, copies; ``Executor.grad_arrays``/``aux_arrays``/
``output_dict``; the compat modules; and the cases of the reference's
own tests (``tests/test_ndarray.py``, ``test_symbol.py``,
``test_namespaces.py``) that cover these names, run on the port.

Inputs come from numpy seeds.  Tolerances: forward values atol=rtol=1e-5,
gradients atol=rtol=1e-4 (the same f32 math, in another order).
"""
import copy
import io
import logging
import warnings

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

PKGS = [jmx, mx]
FWD = dict(atol=1e-5, rtol=1e-5)
GRAD = dict(atol=1e-4, rtol=1e-4)


def _nd(pkg, value, dtype=None):
    return pkg.nd.array(value, ctx=pkg.cpu(), dtype=dtype)


def _pos(rng, *shape):
    return (rng.rand(*shape) + 0.5).astype(np.float32)


def _signed(rng, *shape):
    """Values away from 0 and from .5 ties."""
    v = rng.rand(*shape) * 4 - 2
    v = np.where(np.abs(v) < 0.1, 0.3, v)
    return (np.floor(v * 8) / 8 + 1 / 16).astype(np.float32)


# name -> (inputs from rng, call, differentiable)
FLUENT = {
    "transpose": (lambda r: [_signed(r, 2, 3, 4)],
                  lambda x: x.transpose((2, 0, 1)), True),
    "transpose-default": (lambda r: [_signed(r, 2, 3, 4)],
                          lambda x: x.transpose(), True),
    "abs": (lambda r: [_signed(r, 3, 4)], lambda x: x.abs(), True),
    "argmax": (lambda r: [_signed(r, 3, 4)],
               lambda x: x.argmax(axis=1), False),
    "argmin": (lambda r: [_signed(r, 3, 4)],
               lambda x: x.argmin(axis=0, keepdims=True), False),
    "broadcast_to": (lambda r: [_signed(r, 3, 1)],
                     lambda x: x.broadcast_to((3, 4)), True),
    "clip": (lambda r: [_signed(r, 3, 4)],
             lambda x: x.clip(-0.7, 0.9), True),
    "dot": (lambda r: [_signed(r, 3, 4), _signed(r, 4, 2)],
            lambda x, y: x.dot(y), True),
    "dot-transpose_b": (lambda r: [_signed(r, 3, 4), _signed(r, 2, 4)],
                        lambda x, y: x.dot(y, transpose_b=True), True),
    "exp": (lambda r: [_signed(r, 3, 4)], lambda x: x.exp(), True),
    "expand_dims": (lambda r: [_signed(r, 3, 4)],
                    lambda x: x.expand_dims(1), True),
    "flatten": (lambda r: [_signed(r, 2, 3, 4)], lambda x: x.flatten(), True),
    "flip": (lambda r: [_signed(r, 3, 4)], lambda x: x.flip(1), True),
    "log": (lambda r: [_pos(r, 3, 4)], lambda x: x.log(), True),
    "max": (lambda r: [_signed(r, 3, 4)], lambda x: x.max(axis=1), True),
    "max-all": (lambda r: [_signed(r, 3, 4)], lambda x: x.max(), True),
    "min": (lambda r: [_signed(r, 3, 4)],
            lambda x: x.min(axis=0, keepdims=True), True),
    "one_hot": (lambda r: [np.array([0, 3, 1, 2], np.float32)],
                lambda x: x.one_hot(4), False),
    "one_hot-values": (lambda r: [np.array([1, 0, 2], np.float32)],
                       lambda x: x.one_hot(3, on_value=5.0, off_value=-1.0),
                       False),
    "relu": (lambda r: [_signed(r, 3, 4)], lambda x: x.relu(), True),
    "round": (lambda r: [_signed(r, 3, 4) * 3], lambda x: x.round(), False),
    "sigmoid": (lambda r: [_signed(r, 3, 4)], lambda x: x.sigmoid(), True),
    "sign": (lambda r: [_signed(r, 3, 4)], lambda x: x.sign(), False),
    "slice": (lambda r: [_signed(r, 4, 5)],
              lambda x: x.slice((1, 0), (3, 4)), True),
    "slice_axis": (lambda r: [_signed(r, 4, 5)],
                   lambda x: x.slice_axis(1, 1, 4), True),
    "softmax": (lambda r: [_signed(r, 3, 4)], lambda x: x.softmax(), True),
    "softmax-axis0": (lambda r: [_signed(r, 3, 4)],
                      lambda x: x.softmax(axis=0), True),
    "split": (lambda r: [_signed(r, 4, 6)],
              lambda x: x.split(num_outputs=3, axis=1), True),
    "sqrt": (lambda r: [_pos(r, 3, 4)], lambda x: x.sqrt(), True),
    "square": (lambda r: [_signed(r, 3, 4)], lambda x: x.square(), True),
    "swapaxes": (lambda r: [_signed(r, 2, 3, 4)],
                 lambda x: x.swapaxes(0, 2), True),
    "take": (lambda r: [_signed(r, 5, 3), np.array([4, 0, 2, 2], np.float32)],
             lambda x, i: x.take(i), True),
    "take-axis1": (lambda r: [_signed(r, 3, 5),
                              np.array([1, 4], np.float32)],
                   lambda x, i: x.take(i, axis=1), True),
    "tanh": (lambda r: [_signed(r, 3, 4)], lambda x: x.tanh(), True),
    "tile": (lambda r: [_signed(r, 2, 3)], lambda x: x.tile((2, 3)), True),
    # the operators through their ops
    "eq": (lambda r: [_signed(r, 3, 4), _signed(r, 3, 4)],
           lambda x, y: x == y, False),
    "ne-scalar": (lambda r: [_signed(r, 3, 4)], lambda x: x != 0.3125,
                  False),
    "pow": (lambda r: [_pos(r, 3, 4), _signed(r, 3, 4)],
            lambda x, y: x ** y, True),
    "rpow": (lambda r: [_signed(r, 3, 4)], lambda x: 1.5 ** x, True),
    "mod": (lambda r: [_pos(r, 3, 4) * 5, _pos(r, 3, 4)],
            lambda x, y: x % y, False),
    "rmod": (lambda r: [_pos(r, 3, 4)], lambda x: 3.0 % x, False),
}

# the 29 fluent methods of the reference's NDArray
FLUENT_NAMES = {
    "transpose", "abs", "argmax", "argmin", "broadcast_to", "clip", "dot",
    "exp", "expand_dims", "flatten", "flip", "log", "max", "min", "one_hot",
    "relu", "round", "sigmoid", "sign", "slice", "slice_axis", "softmax",
    "split", "sqrt", "square", "swapaxes", "take", "tanh", "tile"}


def test_every_fluent_method_has_a_case():
    assert len(FLUENT_NAMES) == 29
    assert FLUENT_NAMES <= {c.split("-")[0] for c in FLUENT}
    for name in FLUENT_NAMES:
        assert callable(getattr(mx.nd.NDArray, name)), name


def _outputs(out):
    return list(out) if isinstance(out, (list, tuple)) else [out]


@pytest.mark.parametrize("case", sorted(FLUENT))
def test_fluent_method_matches(case):
    """Forward within 1e-5; for a differentiable method, the gradients of
    a random projection of the outputs within 1e-4 (the index inputs of
    ``take`` take none)."""
    make, call, differentiable = FLUENT[case]
    rng = np.random.RandomState(sorted(FLUENT).index(case))
    inputs = make(rng)
    heads = None
    results = []
    for pkg in PKGS:
        xs = [_nd(pkg, v) for v in inputs]
        grad_xs = xs[:1] if case.startswith("take") else xs
        if differentiable:
            for x in grad_xs:
                x.attach_grad()
            with pkg.autograd.record():
                outs = _outputs(call(*xs))
            if heads is None:
                heads = [np.asarray(rng.randn(*o.shape), np.float32)
                         for o in outs]
            pkg.autograd.backward(outs, [_nd(pkg, h) for h in heads])
            grads = [x.grad.asnumpy() for x in grad_xs]
        else:
            outs, grads = _outputs(call(*xs)), []
        results.append(([o.asnumpy() for o in outs], grads))
    (jo, jg), (to, tg) = results
    assert [o.shape for o in to] == [o.shape for o in jo]
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t, j, **FWD)
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(t, j, **GRAD)


MODULE_FUNCS = {
    "arange": lambda pkg: pkg.nd.arange(10),
    "arange-start-step": lambda pkg: pkg.nd.arange(1, 7, 1.5),
    "arange-repeat": lambda pkg: pkg.nd.arange(0, 6, 2, repeat=3),
    "arange-int32": lambda pkg: pkg.nd.arange(2, 9, dtype="int32"),
    "moveaxis": lambda pkg: pkg.nd.moveaxis(
        _nd(pkg, np.arange(24, dtype=np.float32).reshape(2, 3, 4)), 0, 2),
    "moveaxis-neg": lambda pkg: pkg.nd.moveaxis(
        _nd(pkg, np.arange(24, dtype=np.float32).reshape(2, 3, 4)), -1, 0),
    "onehot_encode": lambda pkg: pkg.nd.onehot_encode(
        _nd(pkg, [2, 0, 1]), 3),
    "from_numpy": lambda pkg: pkg.nd.from_numpy(
        np.arange(6, dtype=np.float64).reshape(2, 3)),
    "invoke": lambda pkg: pkg.nd.invoke(
        "broadcast_add", [_nd(pkg, [[1.], [2.]]), _nd(pkg, [10., 20.])]),
    "invoke-attrs": lambda pkg: pkg.nd.invoke(
        "_plus_scalar", [_nd(pkg, [1., 2.])], {"scalar": 3.0}),
}


@pytest.mark.parametrize("case", sorted(MODULE_FUNCS))
def test_module_function_matches(case):
    """Values exactly, dtype and shape as the JAX package gives them."""
    outs = []
    for pkg in PKGS:
        with pkg.cpu():
            outs.append(MODULE_FUNCS[case](pkg))
    j, t = outs
    assert t.context == mx.cpu()
    assert np.dtype(t.dtype) == np.dtype(j.dtype)
    np.testing.assert_array_equal(t.asnumpy(), j.asnumpy())


def test_dlpack_shares_memory_and_moveaxis_copies():
    """``from_dlpack`` over ``to_dlpack_for_read``/``_for_write`` (and
    over an object with ``__dlpack__``) is the same memory.  The JAX
    package's pair does not round trip (its ``from_dlpack`` refuses a
    capsule), so the port is held to numpy here."""
    with mx.cpu():
        v = np.array([[1., 2.], [3., 4.]], np.float32)
        back = mx.nd.from_dlpack(mx.nd.to_dlpack_for_read(_nd(mx, v)))
        np.testing.assert_array_equal(back.asnumpy(), v)
        np.testing.assert_array_equal(mx.nd.from_dlpack(v).asnumpy(), v)
        x = _nd(mx, [1., 2., 3.])
        y = mx.nd.from_dlpack(mx.nd.to_dlpack_for_write(x))
        y[:] = 7.0
        np.testing.assert_array_equal(x.asnumpy(), [7., 7., 7.])
        m = _nd(mx, np.ones((2, 3), np.float32))
        moved = mx.nd.moveaxis(m, 0, 0)
        moved[:] = 0.0
        assert m.asnumpy().sum() == 6.0


def test_stype_and_tostype():
    x = _nd(mx, [1., 2.])
    assert x.stype == "default" == _nd(jmx, [1., 2.]).stype
    assert x.tostype("default") is x
    with pytest.raises(mx.MXNetError, match="A4"):
        x.tostype("csr")


# -- Symbol and Executor ------------------------------------------------------

def _net(pkg):
    """FC -> BatchNorm -> relu -> FC -> softmax, auto-named in a fresh
    NameManager."""
    with pkg.sym.NameManager():
        data = pkg.sym.var("data")
        net = pkg.sym.FullyConnected(data, num_hidden=5, name="fc1")
        net = pkg.sym.BatchNorm(net, fix_gamma=False, name="bn1")
        net = pkg.sym.Activation(net, act_type="relu")
        net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
        return pkg.sym.SoftmaxOutput(net, name="softmax")


def _net_values(seed=0):
    r = np.random.RandomState(seed)
    args = {"data": r.randn(4, 6).astype(np.float32),
            "fc1_weight": (r.randn(5, 6) * 0.4).astype(np.float32),
            "fc1_bias": (r.randn(5) * 0.1).astype(np.float32),
            "bn1_gamma": (1 + 0.1 * r.randn(5)).astype(np.float32),
            "bn1_beta": (0.1 * r.randn(5)).astype(np.float32),
            "fc2_weight": (r.randn(3, 5) * 0.4).astype(np.float32),
            "fc2_bias": (r.randn(3) * 0.1).astype(np.float32),
            "softmax_label": np.array([0, 2, 1, 2], np.float32)}
    auxs = {"bn1_moving_mean": (0.1 * r.randn(5)).astype(np.float32),
            "bn1_moving_var": (1 + 0.1 * r.rand(5)).astype(np.float32)}
    return args, auxs


BIND_FORMS = {
    "dicts-write": ("dict", "write"),
    "lists-write": ("list", "write"),
    "dicts-req-list": ("dict", "list"),
    "lists-req-dict": ("list", "dict"),
    "dicts-add": ("dict", "add"),
}


@pytest.mark.parametrize("form", sorted(BIND_FORMS))
def test_bind_forward_backward_matches(form):
    """``bind`` in each argument form: outputs within 1e-5, every
    gradient within 1e-4, the moving statistics within 1e-5; the
    executor holds the caller's own arrays; ``grad_arrays``,
    ``aux_arrays`` and ``output_dict`` as the JAX package's."""
    layout, req = BIND_FORMS[form]
    args, auxs = _net_values()
    results = []
    for pkg in PKGS:
        sym = _net(pkg)
        names = sym.list_arguments()
        grad_names = [n for n in names if n not in ("data", "softmax_label")]
        arg_arrays = {n: _nd(pkg, v) for n, v in args.items()}
        grads = {n: _nd(pkg, np.full(arg_arrays[n].shape, 0.5, np.float32))
                 for n in grad_names}
        aux_arrays = {n: _nd(pkg, v) for n, v in auxs.items()}
        if req == "list":
            grad_req = ["write" if n in grads else "null" for n in names]
        elif req == "dict":
            grad_req = {n: "write" for n in grads}
        else:
            grad_req = req
        if layout == "list":
            exe = sym.bind(pkg.cpu(), [arg_arrays[n] for n in names],
                           args_grad=[grads.get(n) for n in names],
                           grad_req=grad_req,
                           aux_states=[aux_arrays[n] for n in
                                       sym.list_auxiliary_states()])
        else:
            exe = sym.bind(pkg.cpu(), arg_arrays, args_grad=grads,
                           grad_req=grad_req, aux_states=aux_arrays)
        for n in names:
            assert exe.arg_dict[n] is arg_arrays[n]
        for n in grads:
            assert exe.grad_dict[n] is grads[n]
        assert [a is aux_arrays[n] for n, a in
                zip(sym.list_auxiliary_states(), exe.aux_arrays)] \
            == [True, True]
        exe.forward(is_train=True)
        exe.backward()
        results.append((
            sorted(exe.output_dict),
            [o.asnumpy() for o in exe.outputs],
            [None if g is None else g.asnumpy() for g in exe.grad_arrays],
            [a.asnumpy() for a in exe.aux_arrays]))
    (jk, jo, jg, ja), (tk, to, tg, ta) = results
    assert tk == jk == ["softmax_output"]
    for t, j in zip(to, jo):
        np.testing.assert_allclose(t, j, **FWD)
    assert [g is None for g in tg] == [g is None for g in jg]
    for t, j in zip(tg, jg):
        if j is not None:
            np.testing.assert_allclose(t, j, **GRAD)
    for t, j in zip(ta, ja):
        np.testing.assert_allclose(t, j, **FWD)


def test_eval_and_simple_forward_match():
    x = np.array([[1., -2.], [3., 4.]], np.float32)
    y = np.array([[0.5, 2.], [1., -1.]], np.float32)
    outs = []
    for pkg in PKGS:
        a, b = pkg.sym.var("a"), pkg.sym.var("b")
        out = (a * b + a ** 2).eval(pkg.cpu(), a=_nd(pkg, x), b=_nd(pkg, y))
        assert len(out) == 1
        outs.append(out[0].asnumpy())
        outs.append(pkg.test_utils.simple_forward(
            pkg.sym.relu(a) - b, ctx=pkg.cpu(), a=x, b=y))
    np.testing.assert_allclose(outs[2], outs[0], **FWD)
    np.testing.assert_allclose(outs[3], outs[1], **FWD)


def test_get_internals_matches():
    """The same internal outputs; an internal output binds and computes
    what the JAX package's does."""
    args, auxs = _net_values(1)
    names, values = [], []
    for pkg in PKGS:
        internals = _net(pkg).get_internals()
        names.append(internals.list_outputs())
        fc1 = internals["fc1_output"]
        assert fc1.list_arguments() == ["data", "fc1_weight", "fc1_bias"]
        exe = fc1.bind(pkg.cpu(), {n: _nd(pkg, args[n])
                                   for n in fc1.list_arguments()})
        values.append(exe.forward()[0].asnumpy())
    assert names[1] == names[0]
    assert "bn1_output" in names[1] and "data" in names[1]
    np.testing.assert_allclose(values[1], values[0], **FWD)


def test_attr_list_attr_and_copies_match():
    got = []
    for pkg in PKGS:
        with pkg.sym.NameManager():
            with pkg.AttrScope(ctx_group="dev1"):
                v = pkg.sym.var("x", lr_mult=2.0)
            w = pkg.sym.var("w", shape=(3, 4))
            net = pkg.sym.FullyConnected(v, w, num_hidden=3, no_bias=True,
                                         name="fc")
        shallow, deep = copy.copy(net), copy.deepcopy(net)
        assert shallow is not net and deep is not net
        assert shallow.tojson() == deep.tojson() == net.tojson()
        got.append((v.attr("ctx_group"), v.attr("__lr_mult__"),
                    w.attr("__shape__"), v.attr("missing"),
                    net.attr("num_hidden"), net.list_attr(),
                    net.list_attr(recursive=True),
                    pkg.sym.Group([v, w]).attr("ctx_group"),
                    pkg.sym.Group([v, w]).list_attr(), net.tojson()))
    assert got[1] == got[0]
    assert got[1][0] == "dev1" and got[1][2] == "(3, 4)"


def test_get_internals_names_multi_output_ops():
    """BatchNorm with ``output_mean_var`` and ``topk`` with both outputs
    name their outputs as the reference does."""
    for pkg in PKGS:
        with pkg.sym.NameManager():
            d = pkg.sym.var("d")
            bn = pkg.sym.BatchNorm(d, output_mean_var=True, name="bn")
            tk = pkg.sym.topk(d, k=2, ret_typ="both", name="tk")
        assert bn.list_outputs() == ["bn_output", "bn_mean", "bn_var"]
        assert tk.list_outputs() == ["tk_output", "tk_indices"]


# -- test_utils -----------------------------------------------------------

def test_check_numeric_and_symbolic_helpers():
    """The port's ``test_utils`` checks a graph's gradients against finite
    differences, and its forward and backward against numpy."""
    tu = mx.test_utils
    with mx.cpu():
        a, b = mx.sym.var("a"), mx.sym.var("b")
        sym = a * b + mx.sym.tanh(a)
        rng = np.random.RandomState(3)
        x, y = _signed(rng, 3, 4), _signed(rng, 3, 4)
        tu.check_numeric_gradient(sym, [x, y], numeric_eps=1e-2, rtol=1e-2,
                                  atol=1e-3, dtype=np.float64)
        tu.check_symbolic_forward(sym, {"a": x, "b": y}, [x * y + np.tanh(x)],
                                  rtol=1e-5, atol=1e-6)
        head = _signed(rng, 3, 4)
        tu.check_symbolic_backward(
            sym, [x, y], [head],
            {"a": head * (y + 1 - np.tanh(x) ** 2), "b": head * x},
            rtol=1e-5, atol=1e-5)
        tu.check_symbolic_backward(sym, [x, y], [head],
                                   {"a": head * (y + 1 - np.tanh(x) ** 2)},
                                   grad_req="add", rtol=1e-5, atol=1e-5)
        with pytest.raises(AssertionError):
            tu.check_symbolic_forward(sym, {"a": x, "b": y}, [x * y],
                                      rtol=1e-5, atol=1e-6)
        tu.assert_almost_equal(np.ones(3), np.ones(3) + 1e-7)
        assert tu.default_context() == mx.cpu()
        assert tu.list_gpus() == list(range(mx.num_gpus()))
        assert tu.rand_ndarray((2, 3)).shape == (2, 3)
        with pytest.raises(mx.MXNetError, match="A4"):
            tu.rand_ndarray((2, 3), "csr")
        with pytest.raises(mx.MXNetError):
            tu.download("http://example.invalid/x")


def test_check_consistency_over_two_host_contexts():
    """``check_consistency`` over two host contexts (the chip run puts
    the card beside the host): it returns the ground truth and raises
    when a forward disagrees."""
    with mx.cpu():
        net = _net(mx)
        ctx_list = [{"ctx": mx.cpu(0), "data": (4, 6),
                     "type_dict": {"data": np.float32}},
                    {"ctx": mx.cpu(1), "data": (4, 6),
                     "type_dict": {"data": np.float32}}]
        gt = mx.test_utils.check_consistency(net, ctx_list)
        assert gt[0].shape == (4, 3) and np.isfinite(gt[0]).all()
        bad = [net, mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
            mx.sym.var("data"), num_hidden=3, name="fc2") * 1.0,
            name="softmax")]
        with pytest.raises((AssertionError, ValueError)):
            mx.test_utils.check_consistency(bad, ctx_list)


def test_get_mnist_matches_jax():
    j, t = jmx.test_utils.get_mnist(), mx.test_utils.get_mnist()
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
    with mx.cpu():
        train, val = mx.test_utils.get_mnist_iterator(32, (1, 28, 28))
        assert train.provide_data[0].shape == (32, 1, 28, 28)


# -- the reference's own cases, on the port -----------------------------------

def test_reference_ndarray_cases():
    """``tests/test_ndarray.py``'s cases of arange, ``**``, ``==``,
    ``T``/``transpose``/``swapaxes``, ``max``/``min``, ``take``/
    ``one_hot`` and ``argmax``/``argmin``."""
    with mx.cpu():
        assert mx.nd.arange(0, 10, 2).asnumpy().tolist() == [0, 2, 4, 6, 8]
        a = mx.nd.array([1.0, 2.0, 3.0])
        b = mx.nd.array([3.0, 2.0, 1.0])
        np.testing.assert_allclose((a ** 2).asnumpy(), [1, 4, 9])
        np.testing.assert_allclose((a == b).asnumpy(), [0, 1, 0])
        m = mx.nd.array(np.arange(6).reshape(2, 3))
        assert m.T.shape == (3, 2)
        c = mx.nd.array(np.arange(24).reshape(2, 3, 4))
        assert c.transpose((2, 0, 1)).shape == (4, 2, 3)
        assert c.swapaxes(0, 2).shape == (4, 3, 2)
        r = mx.nd.array(np.arange(12, dtype=np.float32).reshape(3, 4))
        np.testing.assert_allclose(r.max().asnumpy(), 11)
        np.testing.assert_allclose(r.min().asnumpy(), 0)
        w = mx.nd.array(np.arange(12, dtype=np.float32).reshape(4, 3))
        idx = mx.nd.array([0, 2])
        np.testing.assert_allclose(w.take(idx).asnumpy(),
                                   [[0, 1, 2], [6, 7, 8]])
        np.testing.assert_allclose(idx.one_hot(4).asnumpy(),
                                   [[1, 0, 0, 0], [0, 0, 1, 0]])
        o = mx.nd.array([[3.0, 1.0, 2.0]])
        np.testing.assert_allclose(o.argmax(axis=1).asnumpy(), [0])
        np.testing.assert_allclose(o.argmin(axis=1).asnumpy(), [1])


def _mlp(sym):
    data = sym.Variable("data")
    net = sym.FullyConnected(data=data, num_hidden=10, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(data=net, num_hidden=4, name="fc2")
    return sym.SoftmaxOutput(net, name="softmax")


def test_reference_symbol_cases():
    """``tests/test_symbol.py``'s internals, attribute and operator cases
    and its multi-output indexing through ``bind``."""
    with mx.cpu():
        internals = _mlp(mx.sym).get_internals()
        assert "fc1_output" in internals.list_outputs()
        assert internals["fc1_output"].list_arguments() == [
            "data", "fc1_weight", "fc1_bias"]
        with mx.AttrScope(ctx_group="dev1"):
            v = mx.sym.Variable("x")
        assert v.attr("ctx_group") == "dev1"
        w = mx.sym.Variable("w", shape=(3, 4), lr_mult=2.0)
        assert w.attr("__shape__") == "(3, 4)"
        assert w.attr("__lr_mult__") == "2.0"
        a, b = mx.sym.Variable("a"), mx.sym.Variable("b")
        x = np.array([[2.0, 4.0]], np.float32)
        y = np.array([[1.0, 3.0]], np.float32)
        for sym, expected in [
                (a + b, x + y), (a - b, x - y), (a * b, x * y),
                (a / b, x / y), (a + 1, x + 1), (2 * a, 2 * x),
                (a ** 2, x ** 2), (-a, -x)]:
            args = {"a": mx.nd.array(x)}
            if "b" in sym.list_arguments():
                args["b"] = mx.nd.array(y)
            ex = sym.bind(mx.current_context(), args=args)
            ex.forward()
            np.testing.assert_allclose(ex.outputs[0].asnumpy(), expected,
                                       rtol=1e-5)
        parts = mx.sym.SliceChannel(mx.sym.Variable("data"), num_outputs=3,
                                    axis=1, name="split")
        ex = parts[0].bind(mx.current_context(), args={
            "data": mx.nd.array(np.arange(6, dtype=np.float32)
                                .reshape(2, 3))})
        ex.forward()
        np.testing.assert_allclose(ex.outputs[0].asnumpy(), [[0], [3]])


def test_reference_compat_module_cases():
    """``tests/test_namespaces.py``'s ``mx.log``/``mx.misc`` cases, and
    ``libinfo``, ``engine``, ``visualization`` on the port."""
    n_before = len(mx.log.getLogger("port_nsparity").handlers)
    logger = mx.log.getLogger("port_nsparity", level=mx.log.INFO)
    assert len(logger.handlers) == n_before
    buf = io.StringIO()
    handler = logging.StreamHandler(buf)
    handler.setFormatter(mx.log.GlogFormatter(colored=False))
    logger.addHandler(handler)
    logger.info("msg %d", 7)
    try:
        raise ValueError("boom-trace")
    except ValueError:
        logger.exception("step failed")
    out = buf.getvalue()
    assert out.startswith("I") and "msg 7" in out
    assert "boom-trace" in out and "Traceback" in out
    assert mx.log.module_logger("x").name == "mxnet_tpu_torch.x"
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        sched = mx.misc.FactorScheduler(step=10, factor=0.5)
        assert any(issubclass(x.category, DeprecationWarning)
                   for x in caught)
    sched.base_lr = 1.0
    assert abs(sched(25) - 0.25) < 1e-9
    assert isinstance(sched, mx.lr_scheduler.FactorScheduler)
    assert mx.libinfo.__version__ == mx.__version__
    feats = mx.libinfo.features()
    assert feats["CUDA"] == (mx.num_gpus() > 0)
    assert isinstance(mx.libinfo.find_lib_path(), list)
    with mx.engine.bulk(8):
        pass
    assert mx.engine.set_bulk_size(4) == 0


def test_print_summary_and_plot_network():
    with mx.cpu():
        sym = mx.models.lenet.get_symbol(10)
    buf = io.StringIO()
    import contextlib
    with contextlib.redirect_stdout(buf):
        mx.visualization.print_summary(sym, shape={"data": (1, 1, 28, 28)})
    text = buf.getvalue()
    assert "(1, 20, 24, 24)" in text and "softmax (SoftmaxOutput)" in text
    try:
        import graphviz  # noqa: F401
    except ImportError:
        with pytest.raises(mx.MXNetError, match="graphviz"):
            mx.plot_network(sym)
    else:
        assert mx.plot_network(sym) is not None

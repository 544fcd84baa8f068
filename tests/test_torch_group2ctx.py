"""``group2ctx``: manual model parallelism, against the JAX package's.

Each ``ctx_group``'s variables (and an op's auto-created inputs) are
allocated on the group's context; the executor computes on its bind
context, its inputs copied there, and stores each gradient on its
argument's context.  The port's host contexts share the host device but
every array reports its own (``cpu(1)``, ``cpu(2)``).  The JAX side runs
on the harness's virtual CPU devices.  Weights and inputs come from
numpy seeds; tolerances are stated in each test.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

# the same f32 product and softmax in both packages, other summation
# orders (tests/test_symbol.py's own limit)
JAX_TOL = dict(rtol=1e-6, atol=1e-6)
GROUPS = {"dev1": 1, "dev2": 2}


def _net(pkg):
    """tests/test_symbol.py's model-parallel graph: fc1 in dev1, fc2 in
    dev2."""
    with pkg.AttrScope(ctx_group="dev1"):
        a = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=4,
                                   name="fc1")
    with pkg.AttrScope(ctx_group="dev2"):
        b = pkg.sym.FullyConnected(a, num_hidden=2, name="fc2")
    return pkg.sym.SoftmaxOutput(b, name="softmax")


def _values(exe, seed=0):
    rng = np.random.RandomState(seed)
    out = {}
    for k in sorted(exe.arg_dict):
        shape = exe.arg_dict[k].shape
        out[k] = (rng.rand(*shape) * (1.0 if k == "data" else 0.1)) \
            .astype(np.float32)
    return out


def _bind(pkg, shape=(2, 3), placed=True):
    net = _net(pkg)
    kw = {"group2ctx": {g: pkg.cpu(i) for g, i in GROUPS.items()}} \
        if placed else {}
    return net, net.simple_bind(pkg.cpu(0), data=shape, **kw)


def test_placement_and_gradient_placement():
    """Each group's weights, the data fc1 reads, and their gradients live
    on the group's context; the rest on the bind context."""
    _, exe = _bind(mt)
    want = {"data": 1, "fc1_weight": 1, "fc1_bias": 1, "fc2_weight": 2,
            "fc2_bias": 2, "softmax_label": 0}
    for name, i in want.items():
        assert exe.arg_dict[name].context == mt.cpu(i), name
        assert exe.grad_dict[name].context == mt.cpu(i), name
    for k, v in _values(exe).items():
        exe.arg_dict[k][:] = v
    exe.forward(is_train=True)
    exe.backward()
    for name, i in want.items():
        assert exe.grad_dict[name].context == mt.cpu(i), name


def test_matches_the_single_bind_and_the_jax_package():
    """Outputs and gradients bit for bit the port's bind without
    group2ctx, and within JAX_TOL of the JAX package's group2ctx bind."""
    _, exe = _bind(mt)
    _, plain = _bind(mt, placed=False)
    _, jexe = _bind(mj)
    vals = _values(exe)
    for e in (exe, plain, jexe):
        for k, v in vals.items():
            e.arg_dict[k][:] = v
    outs = []
    for e in (exe, plain, jexe):
        out = e.forward(is_train=True)[0].asnumpy()
        e.backward()
        outs.append((out, {k: g.asnumpy() for k, g in e.grad_dict.items()
                           if g is not None}))
    (out, grads), (out_p, grads_p), (out_j, grads_j) = outs
    assert np.array_equal(out, out_p)
    for k in grads_p:
        assert np.array_equal(grads[k], grads_p[k]), k
    np.testing.assert_allclose(out, out_j, **JAX_TOL)
    np.testing.assert_allclose(out.sum(axis=1), 1.0, atol=1e-5)
    for k in ("fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"):
        np.testing.assert_allclose(grads[k], grads_j[k], err_msg=k,
                                   **JAX_TOL)


def test_reshape_and_forward_kwargs_keep_placement():
    net, exe = _bind(mt)
    bigger = exe.reshape(data=(4, 3), softmax_label=(4,),
                         allow_up_sizing=True)
    for name in exe.arg_dict:
        assert bigger.arg_dict[name].context == \
            exe.arg_dict[name].context, name
    # unchanged shapes share the arrays
    assert bigger.arg_dict["fc2_weight"] is exe.arg_dict["fc2_weight"]
    x = np.random.RandomState(3).rand(4, 3).astype(np.float32)
    bigger.forward(is_train=False, data=x)
    assert bigger.arg_dict["data"].context == mt.cpu(1)
    np.testing.assert_array_equal(bigger.arg_dict["data"].asnumpy(), x)


def test_bind_takes_arrays_on_the_group_contexts():
    """``bind(group2ctx=)``: arrays may lie on the bind context or a group
    context; elsewhere they are refused."""
    net = _net(mt)
    shapes = dict(zip(net.list_arguments(),
                      net.infer_shape(data=(2, 3))[0]))
    where = {"fc2_weight": mt.cpu(2), "fc2_bias": mt.cpu(2)}
    args = {n: mt.nd.zeros(s, ctx=where.get(n, mt.cpu(0)))
            for n, s in shapes.items()}
    grads = {n: mt.nd.zeros(s, ctx=where.get(n, mt.cpu(0)))
             for n, s in shapes.items()}
    exe = net.bind(mt.cpu(0), args, args_grad=grads,
                   group2ctx={"dev2": mt.cpu(2)})
    exe.forward(is_train=True)
    exe.backward()
    assert exe.grad_dict["fc2_weight"].context == mt.cpu(2)
    with pytest.raises(mt.MXNetError, match="bind: argument"):
        net.bind(mt.cpu(0), dict(args, fc1_bias=mt.nd.zeros(
            shapes["fc1_bias"], ctx=mt.cpu(5))),
            group2ctx={"dev2": mt.cpu(2)})


def test_an_ops_weights_and_aux_states_follow_its_group():
    """A BatchNorm in a group: its gamma, beta and moving statistics are
    allocated on the group's context, and the training forward writes
    the statistics there."""
    data = mt.sym.var("data")
    with mt.AttrScope(ctx_group="norm"):
        net = mt.sym.BatchNorm(data, fix_gamma=False, name="bn")
    exe = net.simple_bind(mt.cpu(0), data=(4, 3),
                          group2ctx={"norm": mt.cpu(3)})
    for name in ("bn_gamma", "bn_beta"):
        assert exe.arg_dict[name].context == mt.cpu(3)
    for a in exe.aux_dict.values():
        assert a.context == mt.cpu(3)
    exe.arg_dict["bn_gamma"][:] = 1.0
    exe.arg_dict["data"][:] = np.arange(12, dtype=np.float32).reshape(4, 3)
    exe.forward(is_train=True)
    assert exe.aux_dict["bn_moving_mean"].context == mt.cpu(3)
    assert float(np.abs(exe.aux_dict["bn_moving_mean"].asnumpy()).sum()) > 0


def test_training_with_an_updater_matches_the_single_bind():
    """3 SGD-momentum steps through ``mx.optimizer.get_updater``: every
    weight bit for bit the single bind's, and within 1e-6 of the JAX
    package's group2ctx run."""
    runs = []
    for pkg, placed in ((mt, True), (mt, False), (mj, True)):
        _, exe = _bind(pkg, shape=(8, 3), placed=placed)
        vals = _values(exe, seed=5)
        label = (np.arange(8) % 2).astype(np.float32)
        for k, v in vals.items():
            exe.arg_dict[k][:] = label if k == "softmax_label" else v
        updater = pkg.optimizer.get_updater(pkg.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, rescale_grad=1 / 8.0))
        names = ["fc1_weight", "fc1_bias", "fc2_weight", "fc2_bias"]
        for _ in range(3):
            exe.forward(is_train=True)
            exe.backward()
            for i, n in enumerate(names):
                updater(i, exe.grad_dict[n], exe.arg_dict[n])
        if pkg is mt and placed:
            assert exe.arg_dict["fc1_weight"].context == mt.cpu(1)
        runs.append({n: exe.arg_dict[n].asnumpy() for n in names})
    for n in runs[0]:
        assert np.array_equal(runs[0][n], runs[1][n]), n
        np.testing.assert_allclose(runs[0][n], runs[2][n], err_msg=n,
                                   **JAX_TOL)


def test_host_contexts_report_their_own_index():
    """cpu(1) and cpu(2) share the host tensor device and report their
    own context; a copy to a context reports it."""
    a = mt.nd.zeros((2,), ctx=mt.cpu(2))
    assert a.context == mt.cpu(2) and a.tensor.device == torch.device("cpu")
    assert a.copyto(mt.cpu(1)).context == mt.cpu(1)
    assert a.as_in_context(mt.cpu(2)) is a
    assert mt.nd.array([1.0], ctx=mt.cpu(1)).context == mt.cpu(1)
    assert mt.nd.zeros((2,), ctx=mt.cpu()).context == mt.cpu(0)

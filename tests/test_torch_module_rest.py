"""The rest of the Module family: ``shared_module``, monitors,
``SequentialModule`` and ``PythonLossModule``, the port against the
JAX package on the CPU, with the JAX package's own
``tests/test_module.py`` cases for them mirrored on the port.

Weights and inputs come from numpy seeds and reach both packages as
numpy arrays.  Tolerances are stated where they are used.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-5)


def _mlp(mx, classes=4):
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                                name="fc1")
    net = mx.sym.Activation(net, act_type="relu", name="relu1")
    net = mx.sym.FullyConnected(net, num_hidden=classes, name="fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _mlp_params(seed=0, d=6, classes=4):
    r = np.random.RandomState(seed)
    return {"fc1_weight": r.uniform(-0.5, 0.5, (8, d)),
            "fc1_bias": r.uniform(-0.1, 0.1, (8,)),
            "fc2_weight": r.uniform(-0.5, 0.5, (classes, 8)),
            "fc2_bias": r.uniform(-0.1, 0.1, (classes,))}


def _nd(mx, params):
    return {k: mx.nd.array(np.asarray(v, np.float32), ctx=mx.cpu())
            for k, v in params.items()}


def _batch(mx, n, d=6, seed=0, classes=4):
    r = np.random.RandomState(seed)
    x = r.randn(n, d).astype(np.float32)
    y = r.randint(0, classes, n).astype(np.float32)
    return mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                           [mx.nd.array(y, ctx=mx.cpu())])


def _module(mx, n, params):
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.bind([("data", (n, 6))], [("softmax_label", (n,))])
    mod.init_params(arg_params=_nd(mx, params))
    return mod


@pytest.mark.parametrize("optimizer,kwargs", [
    ("sgd", {"learning_rate": 0.3, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01})])
def test_shared_module_trains_one_set_of_parameters(optimizer, kwargs):
    """Two Modules of different batch sizes over one set of parameters:
    the second is bound with ``shared_module=`` and borrows the
    optimizer; steps through either train the same tensors and state,
    matching the JAX package's general path (1e-5)."""
    finals = {}
    for mx in (mt, mj):
        a = _module(mx, 8, _mlp_params())
        a.init_optimizer(optimizer=optimizer, optimizer_params=kwargs)
        b = mx.mod.Module(_mlp(mx), context=mx.cpu())
        b.bind([("data", (4, 6))], [("softmax_label", (4,))],
               shared_module=a)
        assert b.params_initialized and b.optimizer_initialized
        assert b._arg_params is a._arg_params
        if mx is mj:
            a._fused_step = None  # the JAX package's general path
        else:
            assert b._fused_step.shared is a._fused_step.shared
        for i in range(4):
            mod = a if i % 2 == 0 else b
            mod.forward_backward(_batch(mx, 8 if mod is a else 4, seed=i))
            mod.update()
        finals[mx] = {k: v.asnumpy() for k, v in b.get_params()[0].items()}
    for k in finals[mj]:
        np.testing.assert_allclose(finals[mt][k], finals[mj][k], err_msg=k,
                                   **TOL)


def test_shared_module_binds_the_same_arrays():
    a = _module(mt, 8, _mlp_params())
    b = mt.mod.Module(_mlp(mt), context=mt.cpu())
    b.bind([("data", (4, 6))], [("softmax_label", (4,))], shared_module=a)
    ea, eb = a._exec_group.execs[0], b._exec_group.execs[0]
    for n in _mlp_params():
        assert ea.arg_dict[n] is eb.arg_dict[n]
        assert ea.grad_dict[n] is eb.grad_dict[n]
    assert ea.arg_dict["data"] is not eb.arg_dict["data"]
    with pytest.raises(AssertionError):
        mt.mod.Module(_mlp(mt), context=mt.cpu()).bind(
            [("data", (4, 6))], shared_module=mt.mod.Module(_mlp(mt)))


def test_shared_module_reallocates_a_changed_shape_zeroed(caplog):
    a = _module(mt, 8, _mlp_params())
    b = mt.mod.Module(_mlp(mt, classes=3), context=mt.cpu())
    with caplog.at_level(logging.WARNING):
        b.bind([("data", (4, 6))], [("softmax_label", (4,))],
               shared_module=a)
    assert "fc2_weight" in caplog.text and "ZEROED" in caplog.text
    eb = b._exec_group.execs[0]
    assert eb.arg_dict["fc2_weight"].shape == (3, 8)
    np.testing.assert_array_equal(eb.arg_dict["fc2_weight"].asnumpy(), 0)
    assert eb.arg_dict["fc1_weight"] is a._exec_group.execs[0].arg_dict[
        "fc1_weight"]


def _monitored(mx, pattern, sort):
    mod = _module(mx, 8, _mlp_params())
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1})
    mon = mx.Monitor(2, pattern=pattern, sort=sort)
    mod.install_monitor(mon)
    rows = []
    for i in range(3):
        mon.tic()
        mod.forward_backward(_batch(mx, 8, seed=i))
        mod.update()
        rows.append(mon.toc())
    return mod, rows


@pytest.mark.parametrize("pattern,sort", [(".*", False),
                                          ("fc.*", True)])
def test_monitor_toc_names_and_values_match_jax(pattern, sort):
    """Every other batch (interval 2) the monitor reports every matching
    op output and argument with the default statistic, ||x||/sqrt(n):
    the JAX package's names in its order, and its values (1e-5)."""
    got_mod, got = _monitored(mt, pattern, sort)
    _, want = _monitored(mj, pattern, sort)
    assert got_mod._fused_step is None  # the monitor retired it
    assert [len(r) for r in got] == [len(r) for r in want]
    assert got[1] == [] and got[0] and got[2]
    for g_rows, w_rows in zip(got, want):
        assert [(s, n) for s, n, _ in g_rows] == \
            [(s, n) for s, n, _ in w_rows]
        np.testing.assert_allclose(
            [float(v) for _, _, v in g_rows],
            [float(v) for _, _, v in w_rows], **TOL)
    names = {n for _, n, _ in got[0]}
    if pattern == ".*":
        assert {"fc1_output", "relu1_output", "softmax_output",
                "fc2_weight", "data"} <= names


def test_monitor_before_init_optimizer_keeps_the_general_path():
    """A monitor installed between ``bind`` and ``init_optimizer``, the
    order of the JAX package's ``fit``: the fused step turns the module
    down, and the monitor reports every batch as the JAX package's does
    (names, order, values within 1e-5)."""
    rows = {}
    for mx in (mt, mj):
        mod = _module(mx, 8, _mlp_params())
        mon = mx.Monitor(1, pattern=".*")
        mod.install_monitor(mon)
        mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                             "momentum": 0.9})
        rows[mx] = []
        for i in range(3):
            mon.tic()
            mod.forward_backward(_batch(mx, 8, seed=i))
            mod.update()
            rows[mx].append(mon.toc())
        if mx is mt:
            assert mod._fused_step is None
    got, want = rows[mt], rows[mj]
    assert all(got) and [len(r) for r in got] == [len(r) for r in want]
    for g_rows, w_rows in zip(got, want):
        assert [n for _, n, _ in g_rows] == [n for _, n, _ in w_rows]
        np.testing.assert_allclose(
            [float(v) for _, _, v in g_rows],
            [float(v) for _, _, v in w_rows], **TOL)


def test_monitor_all_taps_inputs_too():
    exe = _mlp(mt).simple_bind(mt.cpu(), data=(2, 6))
    seen = []
    exe.set_monitor_callback(lambda name, arr: seen.append(name),
                             monitor_all=True)
    exe.forward()
    assert "fc1_data" in seen and "fc1_weight" in seen
    assert "fc2_output" in seen
    assert seen.index("fc1_data") < seen.index("fc1_output")


def test_monitor_health_waits_for_its_slice():
    # the sentinel's slice is in: a health monitor builds and taps nothing
    mon = mt.Monitor(1, stats="health")
    assert mon.stats == "health"
    exe = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=2,
                                name="fc").simple_bind(mt.cpu(),
                                                       data=(2, 3))
    mon.install(exe)
    assert mon.exes == [] and exe._monitor_callback is None


def test_fit_with_monitor_logs_every_interval(caplog):
    r = np.random.RandomState(0)
    x = r.randn(32, 6).astype(np.float32)
    y = r.randint(0, 4, 32).astype(np.float32)
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    with caplog.at_level(logging.INFO):
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                monitor=mt.Monitor(2, pattern="fc2_output"),
                arg_params=_nd(mt, _mlp_params()))
    lines = [rec.getMessage() for rec in caplog.records
             if rec.getMessage().startswith("Batch:")]
    assert len(lines) == 2 and all("fc2_output" in ln for ln in lines)
    assert mod._fused_step is None


def _two_stage(mx, seed=0):
    net1 = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=8,
                                 name="fc1")
    net1 = mx.sym.Activation(net1, act_type="relu")
    net2 = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4,
                                 name="fc2")
    net2 = mx.sym.SoftmaxOutput(net2, name="softmax")
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(net1, label_names=None, context=mx.cpu())) \
       .add(mx.mod.Module(net2, context=mx.cpu()), take_labels=True,
            auto_wiring=True)
    return seq


def test_sequential_module_matches_jax():
    """Two stages with take_labels/auto_wiring: three epochs of SGD from
    the same weights in both packages (1e-5)."""
    r = np.random.RandomState(0)
    x = r.randn(32, 6).astype(np.float32)
    y = (x @ r.randn(6, 4)).argmax(1).astype(np.float32)
    out = {}
    for mx in (mt, mj):
        seq = _two_stage(mx)
        it = mx.io.NDArrayIter(x, y, batch_size=8, label_name="softmax_label")
        seq.fit(it, num_epoch=3, arg_params=_nd(mx, _mlp_params()),
                optimizer_params={"learning_rate": 0.3}, allow_missing=False)
        assert seq.label_shapes[0][0] == "softmax_label"
        assert [n for n, _ in seq.output_shapes] == ["softmax_output"]
        out[mx] = ({k: v.asnumpy() for k, v in seq.get_params()[0].items()},
                   dict(seq.score(it, "acc")))
    for k in out[mj][0]:
        np.testing.assert_allclose(out[mt][0][k], out[mj][0][k], err_msg=k,
                                   **TOL)
    assert out[mt][1] == pytest.approx(out[mj][1])


def test_sequential_module_chain_learns():
    """``tests/test_module.py::test_sequential_module_chain`` on the port."""
    rng = np.random.RandomState(0)
    W = rng.randn(8, 4).astype("f")
    X = rng.randn(128, 8).astype("f")
    Y = (X @ W).argmax(1).astype("f")
    seq = _two_stage(mt)
    it = mt.io.NDArrayIter(X, Y, batch_size=32, shuffle=True,
                           label_name="softmax_label")
    mt.random.seed(0)
    seq.fit(it, num_epoch=6, initializer=mt.initializer.Xavier(),
            optimizer_params={"learning_rate": 0.5})
    acc = dict(seq.score(it, "acc"))["accuracy"]
    assert acc > 0.8, acc
    args, _ = seq.get_params()
    assert "fc1_weight" in args and "fc2_weight" in args


def test_sequential_module_duplicate_names_raise():
    net = mt.sym.FullyConnected(mt.sym.var("data"), num_hidden=4,
                                name="fc")
    seq = mt.mod.SequentialModule()
    seq.add(mt.mod.Module(net, label_names=None, context=mt.cpu())) \
       .add(mt.mod.Module(net, label_names=None, context=mt.cpu()),
            auto_wiring=True)
    seq.bind(data_shapes=[("data", (2, 8))])
    with pytest.raises(AssertionError):
        seq.init_params(mt.initializer.Xavier())


def test_sequential_module_input_grads_match_jax():
    grads = {}
    for mx in (mt, mj):
        net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=4,
                                    name="fcg")
        seq = mx.mod.SequentialModule()
        seq.add(mx.mod.Module(net, label_names=None, context=mx.cpu()))
        seq.bind(data_shapes=[("data", (2, 3))], inputs_need_grad=True)
        assert seq.inputs_need_grad and seq.for_training
        r = np.random.RandomState(2)
        seq.init_params(arg_params=_nd(mx, {
            "fcg_weight": r.rand(4, 3), "fcg_bias": r.rand(4)}))
        batch = mx.io.DataBatch(data=[mx.nd.array(
            np.ones((2, 3), "f"), ctx=mx.cpu())])
        seq.forward(batch, is_train=True)
        seq.backward([mx.nd.array(np.arange(8, dtype="f").reshape(2, 4),
                                  ctx=mx.cpu())])
        grads[mx] = seq.get_input_grads()[0].asnumpy()
    np.testing.assert_allclose(grads[mt], grads[mj], **TOL)
    assert np.abs(grads[mt]).sum() > 0


def _loss_chain(mx):
    net = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=2, name="fc")
    head = mx.mod.PythonLossModule(
        grad_func=lambda scores, labels: scores.asnumpy()
        - labels.asnumpy())
    seq = mx.mod.SequentialModule()
    seq.add(mx.mod.Module(net, label_names=None, context=mx.cpu())) \
       .add(head, take_labels=True, auto_wiring=True)
    return seq


def test_python_loss_module_matches_jax():
    """A PythonLossModule tail supplies the gradient (scores - labels):
    eight epochs of regression in both packages agree (1e-5) and the
    loss falls, as ``tests/test_module.py::test_python_loss_module``."""
    rng = np.random.RandomState(1)
    X = rng.randn(64, 3).astype("f")
    T = X @ rng.randn(3, 2).astype("f")
    r = np.random.RandomState(3)
    init = {"fc_weight": r.uniform(-0.5, 0.5, (2, 3)),
            "fc_bias": np.zeros(2)}
    out = {}
    for mx in (mt, mj):
        seq = _loss_chain(mx)
        it = mx.io.NDArrayIter(X, T, batch_size=16,
                               label_name="softmax_label")
        seq.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
        seq.init_params(arg_params=_nd(mx, init))
        seq.init_optimizer(optimizer_params={"learning_rate": 0.05})
        losses = []
        for _ in range(8):
            it.reset()
            total = 0.0
            for batch in it:
                seq.forward(batch, is_train=True)
                o = seq.get_outputs()[0].asnumpy()
                total += float(((o - batch.label[0].asnumpy()) ** 2).mean())
                seq.backward()
                seq.update()
            losses.append(total)
        out[mx] = (losses, seq.get_params()[0]["fc_weight"].asnumpy())
    assert out[mt][0][-1] < out[mt][0][0] * 0.5, out[mt][0]
    np.testing.assert_allclose(out[mt][0], out[mj][0], rtol=1e-5)
    np.testing.assert_allclose(out[mt][1], out[mj][1], **TOL)


def test_python_module_protocol():
    head = mt.mod.PythonLossModule(name="l")
    head.bind([("data", (4, 2))], [("softmax_label", (4, 2))])
    assert head.output_shapes == [("l_output", (4, 2))]
    assert head.get_params() == ({}, {})
    head.forward(mt.io.DataBatch([mt.nd.ones((4, 2), ctx=mt.cpu())],
                                 [mt.nd.zeros((4, 2), ctx=mt.cpu())]))
    with pytest.raises(NotImplementedError):
        head.backward()
    with pytest.raises(AssertionError):
        head._validate_descs([("x", (4, 2))], None)

"""The port's ShardedModule (and its lockstep dp-group evaluator) against
the JAX package's.

The JAX side builds its meshes from the harness's 8 virtual CPU devices
(``jax.devices("cpu")``), the port from ``[mx.cpu()] * n`` positions.
Both get the same numpy inputs from seeds, and the port starts from the
JAX module's initial parameters.  Tolerances: each step's outputs,
parameters and moving statistics within 1e-5 (absolute, f32 on both
sides, sums in other orders) of the JAX module's; the row-wise table's
ops on 2 and 4 groups within 1e-5 of one group.  The ports of
``tests/test_sharded_module.py`` keep that file's own thresholds
(accuracy, the 5% cross-entropy band).
"""
import logging

import jax
import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
import mxnet_tpu_torch as mx
from mxnet_tpu.module.fused_step import _map_state as jmap_state
from mxnet_tpu.parallel import MeshSpec as JMeshSpec
from mxnet_tpu.parallel import create_mesh as jcreate_mesh
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.executor import _Program
from mxnet_tpu_torch.module import _spmd
from mxnet_tpu_torch.ops import nn as tnn
from mxnet_tpu_torch.parallel import P
from mxnet_tpu_torch.parallel import mesh as tmesh_mod

TOL = 1e-5


def jmesh(**sizes):
    spec = JMeshSpec(**sizes)
    return jcreate_mesh(spec, devices=jax.devices("cpu")[:spec.n_devices])


def tmesh(**sizes):
    spec = mx.parallel.MeshSpec(**sizes)
    return mx.parallel.create_mesh(spec, devices=[mx.cpu()] * spec.n_devices)


def _toy_problem(rng, n_in=16, n_cls=8, n=256):
    W = rng.randn(n_in, n_cls).astype("f")
    X = rng.randn(n, n_in).astype("f")
    Y = (X @ W).argmax(1).astype("f")
    return X, Y


def _mlp(m, n_cls=8, hidden=64):
    net = m.sym.var("data")
    net = m.sym.FullyConnected(net, num_hidden=hidden, name="fc1")
    net = m.sym.Activation(net, act_type="relu", name="relu1")
    net = m.sym.FullyConnected(net, num_hidden=n_cls, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def _tarrays(table):
    return {k: mx.nd.array(v.asnumpy(), ctx=mx.cpu())
            for k, v in table.items()}


def _tbatch(x, y):
    return mx.io.DataBatch([mx.nd.array(x, ctx=mx.cpu())],
                           [mx.nd.array(y, ctx=mx.cpu())])


def _jbatch(x, y):
    return jmx.io.DataBatch([jmx.nd.array(x)], [jmx.nd.array(y)])


def _pair(sym_of, sizes, data_shape, label_shape, seed=1, opt=None,
          **kwargs):
    """A JAX and a port ShardedModule over meshes of ``sizes``, bound to
    the same shapes, the port's parameters and moving statistics taken
    from the JAX module's Xavier draw, both with ``opt``'s SGD."""
    opt = opt or {"learning_rate": 0.1, "momentum": 0.9}
    jm = jmx.mod.ShardedModule(sym_of(jmx), mesh=jmesh(**sizes), **kwargs)
    tm = mx.mod.ShardedModule(sym_of(mx), mesh=tmesh(**sizes), **kwargs)
    for m in (jm, tm):
        m.bind(data_shapes=[("data", data_shape)],
               label_shapes=[("softmax_label", label_shape)])
    np.random.seed(seed)
    jm.init_params(jmx.initializer.Xavier())
    args, aux = jm.get_params()
    tm.init_params(initializer=None, arg_params=_tarrays(args),
                   aux_params=_tarrays(aux))
    for m in (jm, tm):
        m.init_optimizer(optimizer="sgd", optimizer_params=dict(opt))
    return jm, tm


def _assert_close_state(jm, tm, what):
    for j, t in zip(jm.get_params(), tm.get_params()):
        assert set(j) == set(t)
        for k in j:
            np.testing.assert_allclose(t[k].asnumpy(), j[k].asnumpy(),
                                       rtol=0, atol=TOL,
                                       err_msg="%s %s" % (what, k))


def _lockstep(jm, tm, batches):
    """forward_backward both modules over ``batches`` ((x, y) pairs):
    every step's outputs, parameters and moving statistics within TOL."""
    for i, (x, y) in enumerate(batches):
        jm.forward_backward(_jbatch(x, y))
        tm.forward_backward(_tbatch(x, y))
        np.testing.assert_allclose(tm.get_outputs()[0].asnumpy(),
                                   jm.get_outputs()[0].asnumpy(),
                                   rtol=0, atol=TOL,
                                   err_msg="outputs, step %d" % i)
        _assert_close_state(jm, tm, "step %d" % i)


def _batches(X, Y, size, n):
    return [(X[i * size:(i + 1) * size], Y[i * size:(i + 1) * size])
            for i in range(n)]


# -- ports of tests/test_sharded_module.py ----------------------------------

def test_fit_on_dp_tp_mesh_learns():
    rng = np.random.RandomState(0)
    X, Y = _toy_problem(rng)
    jm, tm = _pair(_mlp, dict(dp=2, tp=2), (64, 16), (64,),
                   opt={"learning_rate": 0.5, "momentum": 0.9})
    _lockstep(jm, tm, _batches(X, Y, 64, 4))
    it = mx.io.NDArrayIter(X, Y, batch_size=64, shuffle=True,
                           label_name="softmax_label")
    mod = mx.mod.ShardedModule(_mlp(mx), mesh=tmesh(dp=2, tp=2))
    mod.fit(it, num_epoch=10, initializer=mx.initializer.Xavier(),
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9})
    acc = dict(mod.score(it, "acc"))["accuracy"]
    assert acc > 0.9, acc
    # the default rule really sharded the big weight over tp
    assert "tp" in str(mod._dev_params["fc1_weight"].sharding.spec)
    assert mod.dp_mode == "split" and mod.dp_mode_reason is None


def test_shard_attr_and_partition_override():
    """ctor dict wins over the __shard__ attr wins over the default rule,
    with the JAX package's specs."""
    def net(m):
        x = m.sym.var("data")
        w = m.sym.var("fc1_weight", __shard__="None,tp")
        x = m.sym.FullyConnected(x, weight=w, num_hidden=64, name="fc1")
        x = m.sym.Activation(x, act_type="relu")
        x = m.sym.FullyConnected(x, num_hidden=8, name="fc2")
        return m.sym.SoftmaxOutput(x, name="softmax")
    from jax.sharding import PartitionSpec as JP
    jm = jmx.mod.ShardedModule(net(jmx), mesh=jmesh(dp=2, tp=2),
                               param_partition={"fc2_weight": JP()})
    tm = mx.mod.ShardedModule(net(mx), mesh=tmesh(dp=2, tp=2),
                              param_partition={"fc2_weight": P()})
    for m, init in ((jm, jmx.initializer.Xavier()),
                    (tm, mx.initializer.Xavier())):
        m.bind(data_shapes=[("data", (32, 16))],
               label_shapes=[("softmax_label", (32,))])
        m.init_params(init)
    assert str(tm._dev_params["fc1_weight"].sharding.spec) == \
        str(P(None, "tp")) == str(JP(None, "tp"))
    assert tm._dev_params["fc2_weight"].sharding.spec == P()
    for n in tm._param_names:
        assert str(tm._dev_params[n].sharding.spec) == \
            str(jm._dev_params[n].sharding.spec), n
    rng = np.random.RandomState(1)
    X, Y = _toy_problem(rng)
    args, aux = jm.get_params()
    tm.init_params(initializer=None, arg_params=_tarrays(args),
                   aux_params={}, force_init=True)
    for m in (jm, tm):
        m.init_optimizer(optimizer="sgd",
                         optimizer_params={"learning_rate": 0.1})
    _lockstep(jm, tm, _batches(X, Y, 32, 3))


def _seq_net(m, vocab=16):
    net = m.sym.var("data")
    net = m.sym.Embedding(net, input_dim=vocab, output_dim=16, name="embed")
    net = m.sym.Flatten(net)
    net = m.sym.FullyConnected(net, num_hidden=32, name="fc1")
    net = m.sym.Activation(net, act_type="relu")
    net = m.sym.FullyConnected(net, num_hidden=2, name="fc2")
    return m.sym.SoftmaxOutput(net, name="softmax")


def test_sequence_axis_shards_sp():
    """sequence_axis=1 shards the token dim over sp; each dp group
    gathers its rows over sp (counted), and training still learns."""
    rng = np.random.RandomState(2)
    n, seq, vocab = 128, 8, 16
    X = rng.randint(0, vocab, (n, seq)).astype("f")
    Y = (X[:, 0] % 2).astype("f")
    jm, tm = _pair(_seq_net, dict(dp=2, sp=2, tp=2), (32, seq), (32,),
                   opt={"learning_rate": 0.5, "momentum": 0.9},
                   sequence_axis=1)
    _lockstep(jm, tm, _batches(X, Y, 32, 3))
    # two inputs gathered over sp, plus the tp-split weights
    assert tm.collectives["all-gather"] >= 2
    it = mx.io.NDArrayIter(X, Y, batch_size=32,
                           label_name="softmax_label")
    mod = mx.mod.ShardedModule(_seq_net(mx), mesh=tmesh(dp=2, sp=2, tp=2),
                               sequence_axis=1)
    mod.fit(it, num_epoch=12, initializer=mx.initializer.Xavier(),
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9})
    acc = dict(mod.score(it, "acc"))["accuracy"]
    assert acc > 0.9, acc


def test_matches_single_device_module():
    """Same symbol, same init, same batches: the mesh step tracks the
    plain single-device Module (the JAX test's 5% band) and the JAX
    ShardedModule (TOL a step)."""
    rng = np.random.RandomState(3)
    X, Y = _toy_problem(rng, n=128)
    jm, tm = _pair(_mlp, dict(dp=2), (32, 16), (32,),
                   opt={"learning_rate": 0.2})
    _lockstep(jm, tm, _batches(X, Y, 32, 4))

    def run(mod_factory, epochs=3):
        it = mx.io.NDArrayIter(X, Y, batch_size=32,
                               label_name="softmax_label")
        mod = mod_factory()
        mod.bind(data_shapes=it.provide_data,
                 label_shapes=it.provide_label)
        mx.random.seed(42)  # the port's initializers draw from mx.random
        mod.init_params(mx.initializer.Xavier())
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.2})
        metric = mx.metric.create("ce")
        for _ in range(epochs):
            it.reset()
            metric.reset()
            for batch in it:
                mod.forward_backward(batch)
                mod.update()
                mod.update_metric(metric, batch.label)
        return metric.get()[1]

    ce_mesh = run(lambda: mx.mod.ShardedModule(_mlp(mx), mesh=tmesh(dp=2)))
    ce_ref = run(lambda: mx.mod.Module(_mlp(mx), context=mx.cpu()))
    assert abs(ce_mesh - ce_ref) < 0.05 * max(ce_ref, 1e-3), \
        (ce_mesh, ce_ref)


def test_checkpoint_roundtrip_into_plain_module(tmp_path):
    """A ShardedModule checkpoint loads into a plain Module of either
    package, and a JAX ShardedModule's into the port's Module: the same
    symbol JSON and .params bytes."""
    rng = np.random.RandomState(4)
    X, Y = _toy_problem(rng, n=128)
    jm, tm = _pair(_mlp, dict(dp=2, tp=2), (32, 16), (32,),
                   opt={"learning_rate": 0.5, "momentum": 0.9})
    _lockstep(jm, tm, _batches(X, Y, 32, 3))
    it = mx.io.NDArrayIter(X, Y, batch_size=32, label_name="softmax_label")
    acc = dict(tm.score(it, "acc"))["accuracy"]
    prefix = str(tmp_path / "shard")
    tm.save_checkpoint(prefix, 1)
    jprefix = str(tmp_path / "jshard")
    jm.save_checkpoint(jprefix, 1)
    with open(prefix + "-symbol.json") as a, \
            open(jprefix + "-symbol.json") as b:
        assert a.read() == b.read()

    plain = mx.mod.Module.load(prefix, 1, context=mx.cpu())
    plain.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
               for_training=False)
    assert abs(dict(plain.score(it, "acc"))["accuracy"] - acc) < 1e-6
    jit = jmx.io.NDArrayIter(X, Y, batch_size=32,
                             label_name="softmax_label")
    jplain = jmx.mod.Module.load(prefix, 1)
    jplain.bind(data_shapes=jit.provide_data,
                label_shapes=jit.provide_label, for_training=False)
    assert abs(dict(jplain.score(jit, "acc"))["accuracy"] - acc) < 1e-6
    # and back: the JAX module's checkpoint into the port's Module
    back = mx.mod.Module.load(jprefix, 1, context=mx.cpu())
    back.bind(data_shapes=it.provide_data, label_shapes=it.provide_label,
              for_training=False)
    got = back.get_params()[0]
    for k, v in tm.get_params()[0].items():
        np.testing.assert_allclose(got[k].asnumpy(), v.asnumpy(), rtol=0,
                                   atol=TOL, err_msg=k)
    # a plain Module's checkpoint into a ShardedModule
    tm2 = mx.mod.ShardedModule(_mlp(mx), mesh=tmesh(dp=2, tp=2))
    tm2.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    _, args, aux = mx.model.load_checkpoint(prefix, 1)
    tm2.init_params(initializer=None, arg_params=args, aux_params=aux)
    assert abs(dict(tm2.score(it, "acc"))["accuracy"] - acc) < 1e-6


def test_batch_not_divisible_raises():
    rng = np.random.RandomState(5)
    X, Y = _toy_problem(rng, n=66)
    it = mx.io.NDArrayIter(X, Y, batch_size=33, label_name="softmax_label")
    mod = mx.mod.ShardedModule(_mlp(mx), mesh=tmesh(dp=2))
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    with pytest.raises(mx.base.MXNetError,
                       match="batch 33 does not divide over dp=2"):
        mod.init_params(mx.initializer.Xavier())
    jmod = jmx.mod.ShardedModule(_mlp(jmx), mesh=jmesh(dp=2))
    jmod.bind(data_shapes=[("data", (33, 16))],
              label_shapes=[("softmax_label", (33,))])
    with pytest.raises(jmx.base.MXNetError,
                       match="batch 33 does not divide over dp=2"):
        jmod.init_params(jmx.initializer.Xavier())


def test_force_rebind_resets_compiled_state():
    """bind(force_rebind=True) after training drops the step built for
    the old batch shape and carries the trained parameters across."""
    rng = np.random.RandomState(3)
    X, Y = _toy_problem(rng)
    jm, tm = _pair(_mlp, dict(dp=2, tp=2), (64, 16), (64,),
                   opt={"learning_rate": 0.5, "momentum": 0.9})
    _lockstep(jm, tm, _batches(X, Y, 64, 2))
    mod = mx.mod.ShardedModule(_mlp(mx), mesh=tmesh(dp=2, tp=2))
    it64 = mx.io.NDArrayIter(X, Y, batch_size=64,
                             label_name="softmax_label")
    mod.fit(it64, num_epoch=10, initializer=mx.initializer.Xavier(),
            optimizer="sgd",
            optimizer_params={"learning_rate": 0.5, "momentum": 0.9})
    acc64 = dict(mod.score(it64, "acc"))["accuracy"]
    assert mod.optimizer_initialized and mod._step is not None
    w_before = mod.get_params()[0]["fc1_weight"].asnumpy()

    it32 = mx.io.NDArrayIter(X, Y, batch_size=32,
                             label_name="softmax_label")
    mod.bind(data_shapes=it32.provide_data,
             label_shapes=it32.provide_label, force_rebind=True)
    assert mod._step is None and mod._fwd is None
    assert not mod.optimizer_initialized
    assert mod.params_initialized
    assert np.allclose(mod.get_params()[0]["fc1_weight"].asnumpy(),
                       w_before)
    acc32 = dict(mod.score(it32, "acc"))["accuracy"]
    assert abs(acc32 - acc64) < 0.02, (acc32, acc64)
    assert acc32 > 0.9, acc32


# -- the mesh Modules' own semantics ----------------------------------------

def test_no_card_and_no_mesh_raises(monkeypatch):
    monkeypatch.setattr(tmesh_mod, "num_gpus", lambda: 0)
    monkeypatch.setattr(tmesh_mod, "_CURRENT_MESH", None)
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.mod.ShardedModule(_mlp(mx))
    with pytest.raises(mx.MXNetError, match="no CUDA device"):
        mx.mod.PipelineModule(mx.sym.var("x"), 2, _mlp(mx))


def test_train_only_through_forward_backward():
    mod = mx.mod.ShardedModule(_mlp(mx), mesh=tmesh(dp=2))
    mod.bind(data_shapes=[("data", (8, 16))],
             label_shapes=[("softmax_label", (8,))])
    mod.init_params(mx.initializer.Xavier())
    batch = _tbatch(np.zeros((8, 16), "f"), np.zeros(8, "f"))
    with pytest.raises(mx.MXNetError, match="forward_backward"):
        mod.forward(batch, is_train=True)
    with pytest.raises(mx.MXNetError, match="fuses backward"):
        mod.backward()
    with pytest.raises(mx.MXNetError, match="inputs_need_grad"):
        mod.get_input_grads()
    with pytest.raises(mx.MXNetError, match="monitors"):
        mod.install_monitor(None)
    with pytest.raises(mx.MXNetError, match="fused-capable"):
        class Mine(mx.optimizer.SGD):
            def update(self, *a):
                pass
        mod.init_optimizer(optimizer=Mine())


def _conv_bn_net(m, norm="null", use_ignore=False):
    x = m.sym.var("data")
    x = m.sym.Convolution(x, num_filter=8, kernel=(3, 3), pad=(1, 1),
                          name="c1")
    x = m.sym.BatchNorm(x, fix_gamma=False, name="bn1")
    x = m.sym.Activation(x, act_type="relu")
    x = m.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max")
    x = m.sym.Convolution(x, num_filter=8, kernel=(3, 3), pad=(1, 1),
                          name="c2")
    x = m.sym.BatchNorm(x, name="bn2")
    x = m.sym.Activation(x, act_type="relu")
    x = m.sym.Pooling(x, global_pool=True, kernel=(1, 1), pool_type="avg")
    x = m.sym.FullyConnected(m.sym.Flatten(x), num_hidden=4, name="fc")
    return m.sym.SoftmaxOutput(x, name="softmax", normalization=norm,
                               use_ignore=use_ignore, ignore_label=-1)


def _conv_problem(seed, n=16):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, 3, 8, 8).astype("f"),
            rng.randint(0, 4, n).astype("f"))


@pytest.mark.parametrize("sizes", [dict(dp=2), dict(dp=4, tp=2)],
                         ids=["dp2", "dp4_tp2"])
def test_batchnorm_statistics_are_the_global_batchs(sizes, monkeypatch):
    """A conv + BatchNorm + pooling net: 3 steps' outputs, parameters and
    moving statistics within TOL of the JAX ShardedModule, whose GSPMD
    step normalizes over the whole batch.  The same first step with the
    sync taken away (each group's own statistics, through the private
    cross-op table) misses by more than 100x TOL."""
    X, Y = _conv_problem(0)
    jm, tm = _pair(_conv_bn_net, sizes, X.shape, Y.shape)
    assert tm.dp_mode == "split"
    start = tm.get_params()
    _lockstep(jm, tm, [(X, Y)] * 3)
    dp = sizes["dp"]
    assert tm.collectives["all-reduce"] == 4 + 10  # 2 BN x 2, 10 grads

    per_group = dict(_spmd.CROSS)
    per_group["BatchNorm"] = (
        lambda ins, attrs, train, mesh: [
            tnn._batch_norm(*i, **attrs, _train=train) for i in ins],
        per_group["BatchNorm"][1])
    monkeypatch.setattr(_spmd, "CROSS", per_group)
    un = mx.mod.ShardedModule(_conv_bn_net(mx), mesh=tmesh(**sizes))
    un.bind(data_shapes=[("data", X.shape)],
            label_shapes=[("softmax_label", Y.shape)])
    un.init_params(initializer=None, arg_params=start[0],
                   aux_params=start[1])
    un.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    un.forward_backward(_tbatch(X, Y))
    jfirst = jmx.mod.ShardedModule(_conv_bn_net(jmx), mesh=jmesh(**sizes))
    jfirst.bind(data_shapes=[("data", X.shape)],
                label_shapes=[("softmax_label", Y.shape)])
    jfirst.init_params(initializer=None,
                       arg_params={k: jmx.nd.array(v.asnumpy())
                                   for k, v in start[0].items()},
                       aux_params={k: jmx.nd.array(v.asnumpy())
                                   for k, v in start[1].items()})
    jfirst.init_optimizer(optimizer="sgd", optimizer_params={
        "learning_rate": 0.1, "momentum": 0.9})
    jfirst.forward_backward(_jbatch(X, Y))
    gap = max(np.abs(un.get_outputs()[0].asnumpy()
                     - jfirst.get_outputs()[0].asnumpy()).max(),
              max(np.abs(un.get_params()[1][k].asnumpy()
                         - jfirst.get_params()[1][k].asnumpy()).max()
                  for k in start[1]))
    assert dp > 1 and gap > 100 * TOL, gap


@pytest.mark.parametrize("norm", ["batch", "valid"])
def test_softmax_output_normalization_over_the_global_batch(norm):
    """'batch' divides by the global row count, 'valid' (with ignored
    labels) by the psum of the groups' valid counts: 3 steps within TOL
    of the JAX module at dp=2.  Group 0's rows hold more ignored labels
    than group 1's, so a per-group count would miss."""
    X, Y = _conv_problem(1)
    Y[:6] = -1
    Y[12] = -1

    def net(m):
        return _conv_bn_net(m, norm=norm, use_ignore=True)
    jm, tm = _pair(net, dict(dp=2), X.shape, Y.shape)
    _lockstep(jm, tm, [(X, Y)] * 3)


def _axis0_net(m):
    x = m.sym.FullyConnected(m.sym.var("data"), num_hidden=8, name="fc1")
    x = m.sym.broadcast_sub(x, m.sym.mean(x, axis=0, keepdims=True,
                                          name="batch_mean"))
    x = m.sym.FullyConnected(m.sym.relu(x), num_hidden=8, name="fc2")
    return m.sym.SoftmaxOutput(x, name="softmax")


def test_an_op_over_the_batch_axis_runs_globally(caplog):
    """A graph that reduces axis 0 cannot split over dp groups: dp_mode
    is 'global', the reason (and a warning) names the op, and the step
    still matches the JAX module."""
    rng = np.random.RandomState(6)
    X, Y = _toy_problem(rng, n=96)
    with caplog.at_level(logging.WARNING):
        jm, tm = _pair(_axis0_net, dict(dp=2, tp=2), (32, 16), (32,),
                       opt={"learning_rate": 0.2, "momentum": 0.9})
    assert tm.dp_mode == "global"
    assert tm.dp_mode_reason == "mean (node batch_mean)"
    assert "mean (node batch_mean)" in caplog.text
    _lockstep(jm, tm, _batches(X, Y, 32, 3))
    assert tm.collectives["all-reduce"] == 0  # one group: nothing to sum


def test_set_mesh_module_state_from_a_jax_sharded_module():
    """convert.set_mesh_module_state carries a trained JAX ShardedModule's
    masters, momentum and moving statistics into the port's: the next
    steps agree within TOL."""
    X, Y = _conv_problem(2)
    jm, tm = _pair(_conv_bn_net, dict(dp=2, tp=2), X.shape, Y.shape)
    for _ in range(2):
        jm.forward_backward(_jbatch(X, Y))
    convert.set_mesh_module_state(
        tm, {k: np.asarray(v) for k, v in jm._masters.items()},
        momentum={k: jmap_state(np.asarray, v)
                  for k, v in jm._states.items()},
        aux={k: np.asarray(v) for k, v in jm._dev_aux.items()})
    _assert_close_state(jm, tm, "carried")
    _lockstep(jm, tm, [(X, Y)] * 2)
    with pytest.raises(mx.MXNetError, match="names"):
        convert.set_mesh_module_state(tm, {"fc_weight": np.zeros((4, 8))})


def test_multi_precision_masters_and_the_adam_update():
    """bf16 storage with f32 masters under multi_precision, and Adam's
    per-step scalars, sharded over tp: within the JAX module's."""
    def net(m):
        x = m.sym.var("data")
        x = m.sym.FullyConnected(x, num_hidden=32, name="fc1")
        x = m.sym.Activation(x, act_type="relu")
        x = m.sym.FullyConnected(x, num_hidden=8, name="fc2")
        return m.sym.SoftmaxOutput(x, name="softmax")
    rng = np.random.RandomState(7)
    X, Y = _toy_problem(rng, n=64)
    jm, tm = _pair(net, dict(dp=2, tp=2), (32, 16), (32,),
                   opt={"learning_rate": 0.01})
    for m in (jm, tm):
        m.init_optimizer(optimizer="adam", force_init=True,
                         optimizer_params={"learning_rate": 0.01})
    _lockstep(jm, tm, _batches(X, Y, 32, 2))


# -- the row-wise table ----------------------------------------------------

def _unary(name, **kw):
    return lambda S, d, d2: getattr(S, name)(d, **kw)


def _binary(name):
    return lambda S, d, d2: getattr(S, name)(d, d2)


def _scalar(name):
    return lambda S, d, d2: getattr(S, name)(d, scalar=0.5)


def _bias(S):
    return S.var("w_bias", shape=(1, 3, 1, 1))


ROW_OPS = {}
for _n in ("abs arccos arcsin arcsinh arctan arctanh cbrt ceil cos cosh "
           "degrees erf exp expm1 fix floor gamma gammaln log log10 log1p "
           "log2 logical_not negative radians rcbrt reciprocal relu rint "
           "round rsqrt sigmoid sign sin sinh softsign sqrt square tan tanh "
           "trunc BlockGrad _copy Flatten ones_like zeros_like "
           "argmax_channel MakeLoss").split():
    ROW_OPS[_n] = _unary(_n)
for _n in ("elemwise_add elemwise_sub elemwise_mul elemwise_div "
           "elemwise_power elemwise_maximum elemwise_minimum elemwise_mod "
           "elemwise_hypot _grad_add _equal _not_equal _greater "
           "_greater_equal _lesser _lesser_equal reshape_like "
           "LinearRegressionOutput LogisticRegressionOutput "
           "MAERegressionOutput").split():
    ROW_OPS[_n] = _binary(_n)
for _n in ("_plus_scalar _minus_scalar _rminus_scalar _mul_scalar "
           "_div_scalar _rdiv_scalar _power_scalar _rpower_scalar "
           "_maximum_scalar _minimum_scalar _mod_scalar _rmod_scalar "
           "_hypot_scalar _equal_scalar _not_equal_scalar _greater_scalar "
           "_greater_equal_scalar _lesser_scalar "
           "_lesser_equal_scalar").split():
    ROW_OPS[_n] = _scalar(_n)
for _n in ("broadcast_add broadcast_sub broadcast_mul broadcast_div "
           "broadcast_power broadcast_maximum broadcast_minimum "
           "broadcast_mod broadcast_hypot broadcast_equal "
           "broadcast_not_equal broadcast_greater broadcast_greater_equal "
           "broadcast_lesser broadcast_lesser_equal").split():
    ROW_OPS[_n] = (lambda n: lambda S, d, d2: getattr(S, n)(d, _bias(S)))(_n)
ROW_OPS.update({
    "arccosh": lambda S, d, d2: S.arccosh(d + 1.5),
    "Activation": _unary("Activation", act_type="tanh"),
    "Cast": _unary("Cast", dtype="float32"),
    "clip": _unary("clip", a_min=0.2, a_max=0.7),
    "Dropout": _unary("Dropout", p=0.0),
    "SoftmaxActivation": _unary("SoftmaxActivation", mode="channel"),
    "L2Normalization": _unary("L2Normalization", mode="instance"),
    "LRN": _unary("LRN", nsize=3),
    "Pooling": _unary("Pooling", kernel=(2, 2), stride=(2, 2)),
    "one_hot": lambda S, d, d2: S.one_hot(S.floor(d * 4), depth=4),
    "add_n": lambda S, d, d2: S.add_n(d, d2, d),
    "where": lambda S, d, d2: S.where(S._greater(d, d2), d, d2),
    "UpSampling": lambda S, d, d2: S.UpSampling(d, scale=2,
                                                sample_type="nearest"),
    "batch_dot": lambda S, d, d2: S.batch_dot(
        S.Reshape(d, shape=(0, -1, 6)), S.Reshape(d2, shape=(0, 6, -1))),
    "broadcast_to": lambda S, d, d2: S.broadcast_to(
        S.slice_axis(d, axis=1, begin=0, end=1), shape=(0, 3, 0, 0)),
    "Reshape": lambda S, d, d2: S.Reshape(d, shape=(-1, 6)),
    "scaled_dot_product_attention": lambda S, d, d2: (
        lambda q: S.scaled_dot_product_attention(q, q, q, causal=True))(
            S.Reshape(d, shape=(0, 6, 3, 6))),
    "FullyConnected": lambda S, d, d2: S.FullyConnected(d, num_hidden=5),
    "Convolution": lambda S, d, d2: S.Convolution(d, num_filter=4,
                                                  kernel=(3, 3)),
    "Deconvolution": lambda S, d, d2: S.Deconvolution(d, num_filter=2,
                                                      kernel=(2, 2)),
    "Embedding": lambda S, d, d2: S.Embedding(S.floor(d * 10),
                                              input_dim=10, output_dim=4),
    "InstanceNorm": lambda S, d, d2: S.InstanceNorm(d),
    "_PReLU": lambda S, d, d2: S._PReLU(d - 0.5,
                                        S.var("w_gamma", shape=(3,))),
    "LeakyReLU": _unary("LeakyReLU", act_type="elu"),
    "multi_head_attention": lambda S, d, d2: (
        lambda q: S.multi_head_attention(
            q, q, q, *[S.var("w_%d" % i) for i in range(8)], num_heads=2,
            causal=True))(S.Reshape(d, shape=(0, 6, 18))),
    "LayerNorm": lambda S, d, d2: S.LayerNorm(d, axis=-1),
    "SVMOutput": lambda S, d, d2: S.SVMOutput(
        S.FullyConnected(d, num_hidden=5), S.floor(S.sum(d2, axis=(1, 2,
                                                                   3)))),
    "softmax": _unary("softmax", axis=1),
    "log_softmax": _unary("log_softmax", axis=-1),
    "Concat": lambda S, d, d2: S.Concat(d, d2, dim=1),
    "SliceChannel": lambda S, d, d2: S.SliceChannel(d, num_outputs=3,
                                                    axis=1)[1],
    "slice_axis": _unary("slice_axis", axis=2, begin=1, end=4),
    "reverse": _unary("reverse", axis=1),
    "repeat": _unary("repeat", repeats=2, axis=1),
    "pick": lambda S, d, d2: S.pick(
        S.Reshape(d, shape=(0, -1)),
        S.floor(S.sum(d2, axis=(1, 2, 3))), axis=1),
    "topk": _unary("topk", axis=1, k=2),
    "sort": _unary("sort", axis=2),
    "argsort": _unary("argsort", axis=1),
    "argmax": _unary("argmax", axis=1),
    "argmin": _unary("argmin", axis=3),
    "broadcast_axis": lambda S, d, d2: S.broadcast_axis(
        S.slice_axis(d, axis=1, begin=0, end=1), axis=1, size=3),
    "squeeze": lambda S, d, d2: S.squeeze(
        S.slice_axis(d, axis=1, begin=0, end=1), axis=1),
    "expand_dims": _unary("expand_dims", axis=1),
    "stack": lambda S, d, d2: S.stack(d, d2, axis=1),
    "sum": _unary("sum", axis=(1, 2)),
    "mean": _unary("mean", axis=(0,), exclude=True),
    "max": _unary("max", axis=3),
    "min": _unary("min", axis=(2, 3)),
    "prod": _unary("prod", axis=1),
    "nansum": _unary("nansum", axis=(1, 3)),
    "nanprod": _unary("nanprod", axis=2),
    "norm": _unary("norm", axis=1),
    "transpose": _unary("transpose", axes=(0, 2, 1, 3)),
    "SwapAxis": _unary("SwapAxis", dim1=1, dim2=2),
    "tile": _unary("tile", reps=(1, 2, 1, 1)),
    "Pad": _unary("Pad", mode="constant",
                  pad_width=(0, 0, 0, 0, 1, 1, 1, 1)),
    "slice": _unary("slice", begin=(None, 1), end=(None, 3)),
    "dot": lambda S, d, d2: S.dot(S.Reshape(d, shape=(0, -1)),
                                  S.var("w_dot", shape=(108, 5))),
    "take": lambda S, d, d2: S.take(S.var("w_take", shape=(10, 4)),
                                    S.floor(d * 10)),
})


def test_every_row_wise_op_has_a_case():
    assert set(ROW_OPS) == set(_spmd.ROW_WISE)


def _run_groups(sym, values, n):
    """``sym`` over ``n`` groups of the 8-row batch (the lockstep plan;
    one group: the plain program): outputs (rows concatenated) and the
    gradients of every input with ones head gradients (the data's
    concatenated, the weights' summed over groups)."""
    shapes = {k: tuple(v.shape) for k, v in values.items()}
    prog = _Program(sym, shapes)
    batch = {"data", "data2"}
    if n == 1:
        groups = [dict(values)]
    else:
        groups = [{k: (v.chunk(n)[g] if k in batch else v)
                   for k, v in values.items()} for g in range(n)]
    leaves = [{k: v.clone().requires_grad_(v.is_floating_point())
               for k, v in g.items()} for g in groups]
    with torch.enable_grad():
        if n == 1:
            outs, _ = prog.evaluate(leaves[0], train=True)
            outs, rows = [outs], [True] * len(outs)
        else:
            plan = _spmd.GroupProgram(sym, shapes, batch, n, tmesh(dp=n))
            assert plan.reason is None, plan.reason
            outs, _ = plan.evaluate(leaves, True, [torch.device("cpu")] * n)
            rows = plan.batched_outputs
        ys = [o for gi, g in enumerate(outs) for o, b in zip(g, rows)
              if o.requires_grad and (b or gi == 0)]
        xs = [t for g in leaves for t in g.values() if t.requires_grad]
        grads = torch.autograd.grad(ys, xs, [torch.ones_like(y) for y in ys],
                                    allow_unused=True) if ys else []
    grads = dict(zip([id(x) for x in xs], grads))
    merged = [torch.cat([g[i] for g in outs]) if b and n > 1 else outs[0][i]
              for i, b in enumerate(rows)]
    ins = {}
    for k in values:
        per = [grads.get(id(g[k])) for g in leaves]
        per = [torch.zeros_like(g[k]) if p is None else p
               for p, g in zip(per, leaves)]
        ins[k] = torch.cat(per) if k in batch and n > 1 else sum(per)
    return merged, ins


@pytest.mark.parametrize("name", sorted(ROW_OPS))
def test_row_wise_op_on_groups_equals_one_group(name):
    """Every op of the row-wise table, in a graph of its own over an
    8-row batch: on 2 and 4 groups its outputs and gradients equal one
    group's within TOL."""
    sym = ROW_OPS[name](mx.sym, mx.sym.var("data"), mx.sym.var("data2"))
    rng = np.random.RandomState(11)
    shape = (8, 3, 6, 6)
    known = {"data": shape, "data2": shape}
    arg_shapes, _, _ = sym.infer_shape(
        **{k: v for k, v in known.items() if k in sym.list_arguments()})
    values = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        values[n] = torch.from_numpy(
            rng.uniform(0.1, 0.9, s).astype(np.float32))
    want = _run_groups(sym, values, 1)
    for n in (2, 4):
        got = _run_groups(sym, values, n)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_allclose(a.detach().numpy(),
                                       b.detach().numpy(), rtol=TOL,
                                       atol=TOL)
        for k in values:
            np.testing.assert_allclose(got[1][k].numpy(),
                                       want[1][k].numpy(), rtol=TOL,
                                       atol=TOL, err_msg=k)


@pytest.mark.parametrize("case", [
    ("sum", dict(axis=0)), ("mean", {}), ("softmax", dict(axis=0)),
    ("transpose", dict(axes=(1, 0, 2, 3))), ("SwapAxis", dict(dim1=0,
                                                               dim2=1)),
    ("slice_axis", dict(axis=0, begin=0, end=4)),
    ("Concat", dict(dim=0)), ("SliceChannel", dict(axis=0, num_outputs=2)),
    ("Reshape", dict(shape=(4, -1))), ("expand_dims", dict(axis=0)),
    ("softmax_cross_entropy", {}),
], ids=lambda c: c[0])
def test_ops_across_the_batch_axis_do_not_split(case):
    """An op that names axis 0, reduces every axis or reshapes the rows
    apart takes the graph to the global batch."""
    name, attrs = case
    S, d = mx.sym, mx.sym.var("data")
    if name == "Concat":
        sym = S.Concat(d, d, **attrs)
    elif name == "softmax_cross_entropy":
        sym = S.softmax_cross_entropy(S.Reshape(d, shape=(0, -1)),
                                      S.var("data2"))
    else:
        sym = getattr(S, name)(d, **attrs)
    shapes = {"data": (8, 3, 6, 6), "data2": (8,)}
    shapes = {k: v for k, v in shapes.items() if k in sym.list_arguments()}
    plan = _spmd.GroupProgram(sym, shapes, set(shapes), 2, tmesh(dp=2))
    assert plan.reason is not None and plan.reason.startswith(name), \
        plan.reason

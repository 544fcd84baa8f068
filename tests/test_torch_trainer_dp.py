"""The port's ``gluon.Trainer`` over two contexts against the JAX
package's.

The same two-layer net and numpy weights in both packages over
[cpu(0), cpu(1)], batches through ``split_and_load``: ``Trainer`` with
``'device'`` (the store updates the weights), with ``'tpu_ici'`` (each
context's Updater applies the all-reduced gradients), the
``allreduce_grads`` + ``update`` split, and optimizer states saved and
loaded.  Parameters within 1e-5 of the JAX package's; each context's
copy equal bit for bit.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

TOL = dict(rtol=1e-5, atol=1e-5)


def _weights(seed):
    r = np.random.RandomState(seed)
    w = {"dense0_weight": 0.4 * r.standard_normal((16, 6)),
         "dense0_bias": 0.1 * r.standard_normal(16),
         "dense1_weight": 0.4 * r.standard_normal((4, 16)),
         "dense1_bias": 0.1 * r.standard_normal(4)}
    return {k: v.astype(np.float32) for k, v in w.items()}


def _batches(seed, steps=3, batch=16):
    r = np.random.RandomState(seed)
    w = r.standard_normal((6, 4))
    out = []
    for _ in range(steps):
        x = r.standard_normal((batch, 6)).astype(np.float32)
        out.append((x, np.argmax(x @ w, axis=1).astype(np.float32)))
    return out


def _net(pkg, weights, ctxs):
    with pkg.name.NameManager():
        net = pkg.gluon.nn.HybridSequential(prefix="")
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(16, activation="relu", in_units=6))
            net.add(pkg.gluon.nn.Dense(4, in_units=16))
    net.initialize(ctx=ctxs)
    params = net.collect_params()
    for name, value in weights.items():
        params[name].set_data(pkg.nd.array(value, ctx=pkg.cpu()))
    return net


def _step(pkg, net, ctxs, x, y):
    loss_fn = pkg.gluon.loss.SoftmaxCrossEntropyLoss()
    xs = pkg.gluon.utils.split_and_load(pkg.nd.array(x, ctx=ctxs[0]), ctxs)
    ys = pkg.gluon.utils.split_and_load(pkg.nd.array(y, ctx=ctxs[0]), ctxs)
    with pkg.autograd.record():
        losses = [loss_fn(net(a), b) for a, b in zip(xs, ys)]
    for loss in losses:
        loss.backward()


def _train(pkg, store, split=False, hybridize=False, steps=3,
           optimizer="sgd", params=None):
    ctxs = [pkg.cpu(0), pkg.cpu(1)]
    net = _net(pkg, _weights(1), ctxs)
    if hybridize:
        net.hybridize()
    trainer = pkg.gluon.Trainer(
        net.collect_params(), optimizer,
        params or {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4},
        kvstore=store)
    for x, y in _batches(2, steps):
        _step(pkg, net, ctxs, x, y)
        if split:
            trainer.allreduce_grads()
            trainer.update(x.shape[0])
        else:
            trainer.step(x.shape[0])
    return net, trainer


def _values(net):
    return {n: [d.asnumpy() for d in p.list_data()]
            for n, p in net.collect_params().items()}


@pytest.mark.parametrize("store,on_kv", [("device", True),
                                         ("tpu_ici", False),
                                         ("local", True)])
def test_trainer_over_two_contexts_matches_the_jax_package(store, on_kv):
    net_j, tr_j = _train(mj, store)
    net_t, tr_t = _train(mt, store, hybridize=True)
    assert tr_t._update_on_kvstore == tr_j._update_on_kvstore == on_kv
    got_j, got_t = _values(net_j), _values(net_t)
    for n in got_j:
        np.testing.assert_array_equal(got_t[n][0], got_t[n][1])
        np.testing.assert_allclose(got_t[n][0], got_j[n][0], err_msg=n,
                                   **TOL)
        assert not np.array_equal(got_t[n][0], _weights(1)[n])


def test_allreduce_grads_then_update_matches_step():
    """'tpu_ici': ``allreduce_grads`` + ``update`` equals the JAX
    package's split and the port's own ``step`` bit for bit."""
    net_j, _ = _train(mj, "tpu_ici", split=True)
    net_t, _ = _train(mt, "tpu_ici", split=True)
    net_s, _ = _train(mt, "tpu_ici")
    got_j, got_t, got_s = _values(net_j), _values(net_t), _values(net_s)
    for n in got_j:
        np.testing.assert_allclose(got_t[n][0], got_j[n][0], err_msg=n,
                                   **TOL)
        np.testing.assert_array_equal(got_t[n][0], got_s[n][0])
        np.testing.assert_array_equal(got_t[n][1], got_s[n][1])


def test_update_raises_when_the_store_updates():
    for pkg in (mj, mt):
        ctxs = [pkg.cpu(0), pkg.cpu(1)]
        net = _net(pkg, _weights(1), ctxs)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1},
                                    kvstore="device")
        x, y = _batches(3, 1)[0]
        _step(pkg, net, ctxs, x, y)
        with pytest.raises(AssertionError):
            trainer.update(16)


def test_allreduce_grads_sums_the_contexts_gradients():
    """After ``allreduce_grads`` every context holds the sum of the two
    contexts' gradients (the JAX package's within 1e-5)."""
    got = {}
    for pkg in (mj, mt):
        ctxs = [pkg.cpu(0), pkg.cpu(1)]
        net = _net(pkg, _weights(4), ctxs)
        trainer = pkg.gluon.Trainer(net.collect_params(), "sgd",
                                    {"learning_rate": 0.1},
                                    kvstore="tpu_ici")
        x, y = _batches(5, 1)[0]
        _step(pkg, net, ctxs, x, y)
        before = {n: sum(g.asnumpy() for g in p.list_grad())
                  for n, p in net.collect_params().items()}
        trainer.allreduce_grads()
        got[pkg] = {n: [g.asnumpy() for g in p.list_grad()]
                    for n, p in net.collect_params().items()}
        for n, grads in got[pkg].items():
            for g in grads:
                np.testing.assert_allclose(g, before[n], rtol=1e-6,
                                           atol=1e-6)
    for n in got[mj]:
        np.testing.assert_allclose(got[mt][n][0], got[mj][n][0], **TOL)


@pytest.mark.parametrize("store", ["device", "tpu_ici"])
def test_save_and_load_states_resume_the_run(store, tmp_path):
    """States saved after 2 steps of SGD with momentum (through the store
    when it updates) load into a fresh Trainer over a net holding the same
    weights: its next step equals the uninterrupted run's bit for bit,
    and the JAX package's within 1e-5.  (Adam would not do: with one
    Updater a context over one Optimizer, each context's update advances
    the shared step count, so the contexts' copies drift apart, in both
    packages as in MXNet 1.0.)"""
    fname = str(tmp_path / "trainer.states")
    sgd = {"learning_rate": 0.1, "momentum": 0.9}
    full_j, _ = _train(mj, store, steps=3, params=sgd)
    full_t, _ = _train(mt, store, steps=3, params=sgd)
    half, trainer = _train(mt, store, steps=2, params=sgd)
    trainer.save_states(fname)
    ctxs = [mt.cpu(0), mt.cpu(1)]
    net = _net(mt, {n: p.data(ctxs[0]).asnumpy()
                    for n, p in half.collect_params().items()}, ctxs)
    resumed = mt.gluon.Trainer(net.collect_params(), "sgd", dict(sgd),
                               kvstore=store)
    resumed.load_states(fname)
    x, y = _batches(2, 3)[2]
    _step(mt, net, ctxs, x, y)
    resumed.step(x.shape[0])
    got, want, ref = _values(net), _values(full_t), _values(full_j)
    for n in want:
        np.testing.assert_array_equal(got[n][0], want[n][0])
        np.testing.assert_array_equal(got[n][1], want[n][0])
        np.testing.assert_allclose(got[n][0], ref[n][0], err_msg=n, **TOL)


def test_one_context_needs_no_store():
    ctxs = [mt.cpu()]
    net = _net(mt, _weights(1), ctxs)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    x, y = _batches(6, 1)[0]
    _step(mt, net, ctxs, x, y)
    trainer.step(16)
    assert trainer._kvstore is None and not trainer._update_on_kvstore


def test_replicas_on_one_device_train_as_two_contexts():
    """[cpu(0)] * 2 (how one card runs this path): each replica keeps its
    own arrays, and the run equals the one over [cpu(0), cpu(1)] bit for
    bit."""
    ctxs = [mt.cpu(0)] * 2
    net = _net(mt, _weights(1), ctxs)
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1, "momentum": 0.9,
                                "wd": 1e-4}, kvstore="device")
    for x, y in _batches(2, 3):
        _step(mt, net, ctxs, x, y)
        trainer.step(x.shape[0])
    two, _ = _train(mt, "device")
    got, want = _values(net), _values(two)
    for n, p in net.collect_params().items():
        a, b = p.list_data()
        assert a.tensor.data_ptr() != b.tensor.data_ptr()
        np.testing.assert_array_equal(got[n][0], want[n][0])
        np.testing.assert_array_equal(got[n][1], want[n][1])
    assert torch.equal(p.list_data()[0].tensor, p.list_data()[1].tensor)

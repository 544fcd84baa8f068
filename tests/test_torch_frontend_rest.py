"""The frontend names the port gained beside the random and nn ops, against
the JAX package's: ``Block``/``HybridBlock.save_parameters``/
``load_parameters``, ``Parameter.list_grad``/``reset_ctx``,
``ParameterDict.reset_ctx``/``setattr``, ``Predictor(dev_type=,
dev_id=)``, ``predict.load_checkpoint_predictor``,
``initializer.zeros_init``, ``gluon.utils.check_sha1`` and the raising
``download`` stub.  Each name has the JAX package's parameters.

Inputs come from numpy seeds; forward values are compared at
atol=rtol=1e-5 (the same f32 math in another order).
"""
import hashlib
import inspect

import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.base import MXNetError

FWD = dict(atol=1e-5, rtol=1e-5)


def _params_of(fn):
    return list(inspect.signature(fn).parameters)


@pytest.mark.parametrize("path", [
    "gluon.Block.save_parameters", "gluon.Block.load_parameters",
    "gluon.HybridBlock.save_parameters", "gluon.HybridBlock.load_parameters",
    "gluon.Parameter.list_grad", "gluon.Parameter.reset_ctx",
    "gluon.ParameterDict.reset_ctx", "gluon.ParameterDict.setattr",
    "predict.Predictor.__init__", "predict.load_checkpoint_predictor",
    "gluon.utils.check_sha1", "gluon.utils.download", "sym.arange",
])
def test_signature_is_the_references(path):
    def resolve(pkg):
        obj = pkg
        for part in path.split("."):
            if obj is pkg and part == "predict":
                obj = __import__(pkg.__name__ + ".predict",
                                 fromlist=["predict"])
                continue
            obj = getattr(obj, part)
        return obj
    assert _params_of(resolve(mx)) == _params_of(resolve(jmx))


def _dense(pkg, prefix):
    with pkg.sym.NameManager():
        net = pkg.gluon.nn.HybridSequential(prefix=prefix)
        with net.name_scope():
            net.add(pkg.gluon.nn.Dense(5, in_units=4))
            net.add(pkg.gluon.nn.Dense(3, in_units=5))
    return net


def test_save_and_load_parameters_both_ways(tmp_path):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4).astype(np.float32)
    src = {pkg: _dense(pkg, "net_") for pkg in (jmx, mx)}
    src[mx].initialize(mx.initializer.Uniform(0.5), ctx=mx.cpu())
    src[mx].save_parameters(str(tmp_path / "port.params"))
    src[jmx].load_parameters(str(tmp_path / "port.params"), ctx=jmx.cpu())
    src[jmx].save_parameters(str(tmp_path / "jax.params"))
    back = _dense(mx, "net_")
    back.load_parameters(str(tmp_path / "jax.params"), ctx=mx.cpu())
    outs = [net(pkg.nd.array(x, ctx=pkg.cpu())).asnumpy()
            for pkg, net in ((mx, src[mx]), (jmx, src[jmx]), (mx, back))]
    np.testing.assert_allclose(outs[1], outs[0], **FWD)
    np.testing.assert_array_equal(outs[2], outs[0])


def test_parameter_list_grad_and_reset_ctx():
    with mx.sym.NameManager():
        dense = mx.gluon.nn.Dense(3, in_units=2)
    dense.initialize(ctx=mx.cpu())
    w = dense.weight
    value = w.data().asnumpy()
    x = mx.nd.array(np.ones((4, 2), np.float32), ctx=mx.cpu())
    with mx.autograd.record():
        y = dense(x)
    y.backward()
    grads = w.list_grad()
    assert len(grads) == 1 and grads[0] is w.grad()
    np.testing.assert_allclose(grads[0].asnumpy(), np.full((3, 2), 4.0))
    w.reset_ctx(mx.cpu(0))
    assert w.list_ctx() == [mx.cpu(0)]
    np.testing.assert_array_equal(w.data().asnumpy(), value)
    frozen = mx.gluon.Parameter("frozen_weight", grad_req="null",
                                shape=(2,))
    frozen.initialize(ctx=mx.cpu())
    with pytest.raises(RuntimeError):
        frozen.list_grad()
    pending = mx.gluon.Parameter("later", allow_deferred_init=True)
    pending.initialize(ctx=mx.cpu())
    pending.reset_ctx([mx.cpu(1)])
    assert pending.list_ctx() == [mx.cpu(1)]
    with pytest.raises(ValueError):
        mx.gluon.Parameter("never", shape=(2,)).reset_ctx(mx.cpu())


def test_parameter_dict_reset_ctx_and_setattr():
    net = _dense(mx, "pd_")
    net.initialize(ctx=mx.cpu())
    params = net.collect_params()
    params.setattr("grad_req", "null")
    assert {p.grad_req for p in params.values()} == {"null"}
    params.setattr("lr_mult", 0.5)
    assert {p.lr_mult for p in params.values()} == {0.5}
    before = {k: p.data().asnumpy() for k, p in params.items()}
    params.reset_ctx(mx.cpu(0))
    for k, p in params.items():
        assert p.list_ctx() == [mx.cpu(0)]
        np.testing.assert_array_equal(p.data().asnumpy(), before[k])


def _fc_checkpoint(pkg, prefix, rng):
    data = pkg.sym.Variable("data")
    net = pkg.sym.FullyConnected(data, num_hidden=3, name="fc")
    args = {"fc_weight": pkg.nd.array(rng.randn(3, 4).astype(np.float32),
                                      ctx=pkg.cpu()),
            "fc_bias": pkg.nd.array(rng.randn(3).astype(np.float32),
                                    ctx=pkg.cpu())}
    pkg.model.save_checkpoint(prefix, 3, net, args, {})


def test_predictor_device_arguments():
    rng = np.random.RandomState(1)
    data = mx.sym.Variable("data")
    net = mx.sym.FullyConnected(data, num_hidden=3, name="fc")
    params = {"arg:fc_weight": mx.nd.array(rng.randn(3, 4).astype(
        np.float32), ctx=mx.cpu()),
        "arg:fc_bias": mx.nd.zeros((3,), ctx=mx.cpu())}
    pred = mx.Predictor(net.tojson(), params, {"data": (2, 4)},
                        dev_type="cpu", dev_id=0)
    assert pred._ctx == mx.cpu(0)
    # an explicit ctx wins over dev_type
    pred = mx.Predictor(net.tojson(), params, {"data": (2, 4)},
                        dev_type="gpu", dev_id=3, ctx=mx.cpu())
    assert pred._ctx == mx.cpu()
    x = rng.randn(2, 4).astype(np.float32)
    pred.forward(data=x)
    np.testing.assert_allclose(
        pred.get_output(0).asnumpy(),
        x @ params["arg:fc_weight"].asnumpy().T, **FWD)
    if mx.num_gpus() == 0:  # "gpu" maps to gpu(dev_id): no card, no bind
        with pytest.raises(MXNetError):
            mx.Predictor(net.tojson(), params, {"data": (2, 4)},
                         dev_type="gpu", dev_id=0)


def test_load_checkpoint_predictor_matches_the_reference(tmp_path):
    prefix = str(tmp_path / "fc")
    _fc_checkpoint(jmx, prefix, np.random.RandomState(2))
    x = np.random.RandomState(3).randn(5, 4).astype(np.float32)
    outs = []
    for pkg in (jmx, mx):
        pred = pkg.predict.load_checkpoint_predictor(
            prefix, 3, {"data": (5, 4)}, ctx=pkg.cpu())
        pred.forward(data=x)
        outs.append(pred.get_output(0).asnumpy())
    np.testing.assert_allclose(outs[1], outs[0], **FWD)


def test_zeros_init():
    assert mx.initializer.zeros_init is mx.initializer.Zero
    arr = mx.nd.ones((2, 3), ctx=mx.cpu())
    mx.initializer.zeros_init()(mx.initializer.InitDesc("w_weight"), arr)
    np.testing.assert_array_equal(arr.asnumpy(), 0.0)


def test_check_sha1_and_download(tmp_path):
    path = tmp_path / "blob.bin"
    path.write_bytes(b"mxnet" * 100000)
    digest = hashlib.sha1(b"mxnet" * 100000).hexdigest()
    for pkg in (jmx, mx):
        assert pkg.gluon.utils.check_sha1(str(path), digest)
        assert not pkg.gluon.utils.check_sha1(str(path), "0" * 40)
    with pytest.raises(MXNetError):
        mx.gluon.utils.download("http://localhost/none", str(tmp_path))


def test_prefetching_iter_close_during_next_leaves_no_worker():
    """ROADMAP C10: ``close()`` while a worker is inside its base
    iterator's ``next()``: the worker leaves once ``next()`` returns (it
    used to clear the stop signal and wait for ever, a thread that leaked
    into later tests)."""
    import threading
    import time

    entered, release = threading.Event(), threading.Event()

    class Blocking(mx.io.DataIter):
        provide_data = [mx.io.DataDesc("data", (2, 3))]
        provide_label = []

        def next(self):
            entered.set()
            release.wait(10)
            return mx.io.DataBatch([mx.nd.zeros((2, 3), ctx=mx.cpu())], [])

    it = mx.io.PrefetchingIter(Blocking())
    assert entered.wait(5)
    timer = threading.Timer(0.2, release.set)
    timer.start()
    t0 = time.perf_counter()
    it.close()
    timer.join()
    assert time.perf_counter() - t0 < 4.0
    assert not [t for t in mx.threads.live_package_threads()
                if "/io/prefetch" in t.name]

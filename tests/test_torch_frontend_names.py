"""The last frontend names of the JAX package in the port, each against
the JAX package on the CPU, and the op registry closed at the JAX
package's 411 names.

``Predictor.reshape``/``num_outputs``; ``executor_cache.stats()`` with
``MXNET_TPU_EXEC_CACHE=0`` and ``MXNET_TPU_EXEC_CACHE_SIZE``;
``base.check_call``/``get_env``/``string_types``;
``BucketingModule.switch_bucket_key``; ``EvalMetric.update_dict``/
``get_config`` and ``CompositeEvalMetric.get_metric``/``update_dict``;
``DataDesc.get_list``; ``Initializer.set_verbosity`` with
``ParameterDict.initialize(verbose=)``; ``mx.cpu_pinned``;
``Symbol.tocsr``; the abstract ``BaseModule`` methods; and
``FusedTrainStep.supports``.  Outputs agree within 1e-6 relative (f32,
the same graph summed in another order).
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

PKGS = [mj, mt]
TOL = dict(rtol=1e-6, atol=1e-6)


def _mlp(pkg):
    x = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(x, num_hidden=5, name="fc1")
    h = pkg.sym.Activation(h, act_type="tanh", name="act")
    return pkg.sym.FullyConnected(h, num_hidden=3, name="fc2")


def _weights(seed=0):
    r = np.random.RandomState(seed)
    return {"fc1_weight": r.randn(5, 4), "fc1_bias": r.randn(5),
            "fc2_weight": r.randn(3, 5), "fc2_bias": r.randn(3)}


def test_registry_holds_every_name_of_the_jax_package():
    want = set(mj.ops.registry.op_registry())
    got = set(mt.ops.registry.op_registry())
    assert len(want) == 411
    assert want <= got
    assert "Custom" in got and callable(mt.nd.Custom) \
        and callable(mt.sym.Custom)


def test_predictor_reshape_and_num_outputs():
    r = np.random.RandomState(1)
    outs = []
    for pkg in PKGS:
        params = {"arg:" + k: pkg.nd.array(v.astype(np.float32),
                                           ctx=pkg.cpu())
                  for k, v in _weights().items()}
        p = pkg.predict.Predictor(_mlp(pkg).tojson(), params,
                                  {"data": (2, 4)}, ctx=pkg.cpu())
        assert p.num_outputs == 1
        same = p.reshape({"data": (7, 4)})
        assert same is p and p.get_output_shape(0) == (7, 3)
        x = r.rand(7, 4).astype(np.float32)
        p.forward(data=x)
        outs.append(p.get_output(0).asnumpy())
        r = np.random.RandomState(1)
    np.testing.assert_allclose(outs[1], outs[0], **TOL)


def test_executor_cache_stats_keys_and_knobs(monkeypatch):
    for pkg in PKGS:
        ec = pkg.executor_cache
        assert set(ec.stats()) == set(mj.executor_cache.stats())
    ec = mt.executor_cache
    sym = _mlp(mt)
    ec.clear()
    ec.reset_stats()
    monkeypatch.setenv("MXNET_TPU_EXEC_CACHE", "0")
    for _ in range(2):
        sym.simple_bind(mt.cpu(), data=(3, 4), grad_req="null")
    s = ec.stats()
    assert (s["enabled"], s["misses"], s["hits"], s["entries"]) \
        == (False, 2, 0, 0)
    monkeypatch.delenv("MXNET_TPU_EXEC_CACHE")
    monkeypatch.setenv("MXNET_TPU_EXEC_CACHE_SIZE", "1")
    ec.reset_stats()
    mt.observability.memprof.reset()
    for batch in (3, 4, 3):
        sym.simple_bind(mt.cpu(), data=(batch, 4), grad_req="null")
    s = ec.stats()
    assert (s["misses"], s["evictions"], s["entries"]) == (3, 2, 1)
    # one memprof record a plan build; no CUDA-graph capture on the host
    assert [r["kind"] for r in s["programs"]] == ["fwd"] * 3
    assert s["compile_ms"]["count"] == 0
    assert s["disk"]["enabled"] is False
    ec.clear()


def test_base_helpers():
    for pkg in PKGS:
        base = pkg.base
        base.check_call(True)
        with pytest.raises(pkg.MXNetError, match="boom"):
            base.check_call(False, "boom")
        assert base.string_types == (str,)
    for name, typ, value, want in (("MXT_X", int, "7", 7),
                                   ("MXT_Y", bool, "0", False),
                                   ("MXT_Z", bool, "yes", True),
                                   ("MXT_UNSET", int, None, 5)):
        got = []
        for pkg in PKGS:
            env = {} if value is None else {name: value}
            with pytest.MonkeyPatch.context() as mp:
                for k, v in env.items():
                    mp.setenv(k, v)
                got.append(pkg.base.get_env(name, 5, typ))
        assert got == [want, want]


def test_switch_bucket_key():
    for pkg in PKGS:
        def gen(key, pkg=pkg):
            x = pkg.sym.Variable("data")
            return (pkg.sym.FullyConnected(x, num_hidden=3, name="fc"),
                    ("data",), None)
        mod = pkg.mod.BucketingModule(gen, default_bucket_key=4,
                                      context=pkg.cpu())
        mod.bind([("data", (2, 4))], None, for_training=False)
        mod.switch_bucket_key(4)
        assert mod._active_key == 4


def test_metric_update_dict_get_config_and_composite():
    label = np.array([0, 1, 1], np.float32)
    pred = np.array([[0.9, 0.1], [0.2, 0.8], [0.6, 0.4]], np.float32)
    got = []
    for pkg in PKGS:
        acc = pkg.metric.Accuracy(output_names=["out"],
                                  label_names=["lab"])
        acc.update_dict({"lab": pkg.nd.array(label, ctx=pkg.cpu())},
                        {"out": pkg.nd.array(pred, ctx=pkg.cpu())})
        comp = pkg.metric.CompositeEvalMetric(["acc", "ce"])
        comp.update_dict({"l": pkg.nd.array(label, ctx=pkg.cpu())},
                         {"p": pkg.nd.array(pred, ctx=pkg.cpu())})
        got.append((acc.get(), acc.get_config(), comp.get_metric(1).get(),
                    comp.get()))
    assert got[0][1] == got[1][1]
    assert got[1][1]["metric"] == "Accuracy"
    for a, b in ((got[0][0], got[1][0]), (got[0][2], got[1][2])):
        assert a[0] == b[0] and np.isclose(a[1], b[1], **TOL)
    assert got[0][3][0] == got[1][3][0]
    np.testing.assert_allclose(got[1][3][1], got[0][3][1], **TOL)


def test_datadesc_get_list():
    got = []
    for pkg in PKGS:
        dl = pkg.io.DataDesc.get_list([("data", (2, 3)), ("label", (2,))],
                                      [("data", np.float16),
                                       ("label", np.int32)])
        plain = pkg.io.DataDesc.get_list([("data", (2, 3))], None)
        got.append([(d.name, tuple(d.shape), np.dtype(d.dtype))
                    for d in dl + plain])
    assert got[0] == got[1]


def test_initializer_set_verbosity_and_initialize_verbose():
    for pkg in PKGS:
        init = pkg.init.Uniform(0.1) if hasattr(pkg, "init") \
            else pkg.initializer.Uniform(0.1)
        assert init.set_verbosity(True) is init and init._verbose
    init = mt.initializer.Uniform(0.1)
    params = mt.gluon.ParameterDict()
    params.get("w_weight", shape=(2, 2))
    params.initialize(init, ctx=mt.cpu(), verbose=True)
    assert init._verbose is True


def test_cpu_pinned_and_tocsr():
    for pkg in PKGS:
        c = pkg.cpu_pinned(1)
        assert (c.device_type, c.device_id, str(c)) \
            == ("cpu_pinned", 1, "cpu_pinned(1)")
        with pytest.raises(pkg.MXNetError, match="not supported"):
            pkg.sym.Variable("x").tocsr()


def _abstract(pkg):
    base = pkg.module.BaseModule()
    out = []
    for name in ("data_names", "output_names", "data_shapes",
                 "label_shapes", "output_shapes"):
        try:
            getattr(base, name)
        except NotImplementedError:
            out.append(name)
    calls = {"get_params": (), "init_params": (), "install_monitor": (None,),
             "forward": (None,), "backward": (), "get_outputs": (),
             "get_input_grads": (), "update": (),
             "update_metric": (None, None), "bind": (None,),
             "init_optimizer": ()}
    for name, args in calls.items():
        try:
            getattr(base, name)(*args)
        except NotImplementedError:
            out.append(name)
    return out


def test_base_module_abstract_methods_raise():
    assert _abstract(mt) == _abstract(mj)
    assert len(_abstract(mt)) == 16


def test_fused_train_step_supports(monkeypatch):
    from mxnet_tpu_torch.module.fused_step import FusedTrainStep
    r = np.random.RandomState(0)
    x = r.rand(20, 4).astype(np.float32)
    y = r.randint(0, 3, 20).astype(np.float32)

    def fit():
        sym = mt.sym.SoftmaxOutput(_mlp(mt), name="softmax")
        mod = mt.mod.Module(sym, context=mt.cpu())
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=10), num_epoch=1)
        return mod

    mod = fit()
    assert mod._fused_step is not None and FusedTrainStep.supports(mod)
    monkeypatch.setattr(FusedTrainStep, "supports",
                        staticmethod(lambda m: False))
    assert fit()._fused_step is None

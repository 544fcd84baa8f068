"""The port's multi-context Module against the JAX package's.

C12 (``Module``'s positional parameters), ``decide_slices`` with a work
load, MLP and conv+BatchNorm fits over two contexts through the
``'local'``, ``'device'`` and ``'tpu_ici'`` stores, ``'device'`` with 2-bit
compression, ``BucketingModule`` over two contexts and the fused step's
refusals.  The JAX side runs on the harness's virtual CPU devices
(``cpu(0)``, ``cpu(1)``), the port on the host.  Inputs and weights come
from numpy seeds; each test states its tolerance.
"""
import logging

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.kvstore import gradient_compression as gc_j
from mxnet_tpu_torch.kvstore import gradient_compression as gc_t
from mxnet_tpu_torch.module.fused_step import FusedTrainStep


def _mlp(sym):
    net = sym.FullyConnected(sym.Variable("data"), num_hidden=16, name="fc1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.FullyConnected(net, num_hidden=4, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _conv_bn(sym):
    net = sym.Convolution(sym.Variable("data"), kernel=(3, 3),
                          num_filter=4, pad=(1, 1), name="conv1")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = sym.Flatten(net, name="flat1")
    net = sym.FullyConnected(net, num_hidden=3, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _weights(sym, shapes, seed):
    """He-scaled weights, gamma near 1, small beta and bias, unit moving
    variance (numpy, by name)."""
    r = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("gamma"):
            args[n] = (1 + 0.1 * r.uniform(-1, 1, s)).astype(np.float32)
        elif n.endswith(("beta", "bias")):
            args[n] = (0.1 * r.uniform(-1, 1, s)).astype(np.float32)
        else:
            args[n] = (r.standard_normal(s)
                       * np.sqrt(2.0 / np.prod(s[1:]))).astype(np.float32)
    auxs = {n: (np.ones(s) if n.endswith("var") else np.zeros(s))
            .astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


def _task(seed, n, shape, classes):
    r = np.random.RandomState(seed)
    x = r.standard_normal((n,) + shape).astype(np.float32)
    w = r.standard_normal((int(np.prod(shape)), classes))
    y = np.argmax(x.reshape(n, -1) @ w, axis=1).astype(np.float32)
    return x, y


def _fit(pkg, net_fn, x, y, batch, epochs, store, weights, contexts=2,
         **module_kwargs):
    sym = net_fn(pkg.sym)
    mod = pkg.mod.Module(sym, context=[pkg.cpu(i) for i in range(contexts)],
                         **module_kwargs)
    it = pkg.io.NDArrayIter(x, y, batch_size=batch)
    args, auxs = weights
    mod.fit(it, num_epoch=epochs, kvstore=store, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": 1e-4},
            arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in args.items()},
            aux_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                        for k, v in auxs.items()})
    arg, aux = mod.get_params()
    return mod, {k: v.asnumpy() for t in (arg, aux) for k, v in t.items()}


def test_module_takes_the_jax_packages_positional_parameters():
    """C12: the sixth positional parameter is ``work_load_list``, the
    seventh ``fixed_param_names``, then ``state_names`` and
    ``compression_params``: a fixed ``fc_weight`` stays a parameter that
    does not train, as in the JAX package."""
    x, y = _task(0, 16, (6,), 4)
    weights = _weights(_mlp(mt.sym), {"data": (8, 6)}, 1)
    got = {}
    for pkg in (mj, mt):
        sym = _mlp(pkg.sym)
        mod = pkg.mod.Module(sym, ("data",), ("softmax_label",), logging,
                             pkg.cpu(), None, ["fc_weight"], None,
                             {"type": "2bit", "threshold": 0.5})
        assert mod._work_load_list == [1]
        assert mod._fixed_param_names == ["fc_weight"]
        assert mod._state_names == []
        assert mod._compression_params == {"type": "2bit",
                                           "threshold": 0.5}
        it = pkg.io.NDArrayIter(x, y, batch_size=8)
        mod.fit(it, num_epoch=1, optimizer_params={"learning_rate": 0.1},
                arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                            for k, v in weights[0].items()})
        arg, _ = mod.get_params()
        got[pkg] = {k: v.asnumpy() for k, v in arg.items()}
        assert "fc_weight" in got[pkg]
        np.testing.assert_array_equal(got[pkg]["fc_weight"],
                                      weights[0]["fc_weight"])
        assert not np.array_equal(got[pkg]["fc1_weight"],
                                  weights[0]["fc1_weight"])
    for k in got[mj]:
        np.testing.assert_allclose(got[mt][k], got[mj][k], rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("batch,workload", [(8, [1, 3]), (10, [1, 1]),
                                            (9, [2, 1, 1]), (7, [1, 3])])
def test_decide_slices_with_a_work_load(batch, workload):
    slices = {}
    for pkg in (mj, mt):
        mod = pkg.mod.Module(_mlp(pkg.sym),
                             context=[pkg.cpu(i)
                                      for i in range(len(workload))],
                             work_load_list=workload)
        mod.bind([("data", (batch, 6))], [("softmax_label", (batch,))])
        group = mod._exec_group
        slices[pkg] = [(s.start, s.stop) for s in group.slices]
        assert [e.arg_dict["data"].shape[0] for e in group.execs] == \
            [b - a for a, b in slices[pkg]]
    assert slices[mt] == slices[mj]
    if workload == [1, 3]:
        assert slices[mt] == [(0, 2), (2, 8)] if batch == 8 else True


@pytest.mark.parametrize("store", ["local", "device", "tpu_ici"])
def test_mlp_over_two_contexts_matches_the_jax_package(store, monkeypatch):
    """3 epochs of 4 batches of 16 over [cpu(0), cpu(1)]: every parameter
    within 1e-5 of the JAX package's general path (its KVStore and
    Updater, as the port trains); the contexts' weights equal bit for bit.
    Under 'tpu_ici' the JAX package's fused data-parallel step (distinct
    devices) ends 3.8e-4 away from its own general path on this task, so
    the port is held to it within 1e-3."""
    x, y = _task(2, 64, (6,), 4)
    weights = _weights(_mlp(mt.sym), {"data": (16, 6)}, 3)
    mod_t, got_t = _fit(mt, _mlp, x, y, 16, 3, store, weights)
    if store == "tpu_ici":
        mod_j, fused_j = _fit(mj, _mlp, x, y, 16, 3, store, weights)
        assert mod_j._fused_step is not None
        for k in fused_j:
            np.testing.assert_allclose(got_t[k], fused_j[k], rtol=1e-3,
                                       atol=1e-3, err_msg=k)
    from mxnet_tpu.module import fused_step as fused_j_mod
    monkeypatch.setattr(fused_j_mod.FusedTrainStep, "supports",
                        staticmethod(lambda module: False))
    mod_j, got_j = _fit(mj, _mlp, x, y, 16, 3, store, weights)
    assert mod_t._update_on_kvstore == mod_j._update_on_kvstore
    assert type(mod_t._kvstore).__name__.replace("Nccl", "TpuIci") == \
        type(mod_j._kvstore).__name__
    for k in got_j:
        np.testing.assert_allclose(got_t[k], got_j[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    for block in mod_t._exec_group.param_arrays:
        assert torch.equal(block[0].tensor, block[1].tensor)


def test_conv_bn_over_two_contexts_matches_the_jax_package():
    """A conv+BatchNorm net at 3x24x24 (ROADMAP R5) with 'device', 2
    epochs of 2 batches of 8 over two contexts (each normalizing its own
    slice): parameters and moving statistics (the contexts' mean) within
    1e-4 of the JAX package's."""
    x, y = _task(4, 16, (3, 24, 24), 3)
    weights = _weights(_conv_bn(mt.sym), {"data": (8, 3, 24, 24)}, 5)
    _, got_j = _fit(mj, _conv_bn, x, y, 8, 2, "device", weights)
    mod, got_t = _fit(mt, _conv_bn, x, y, 8, 2, "device", weights)
    assert mod._update_on_kvstore and mod._fused_step is None
    for k in got_j:
        np.testing.assert_allclose(got_t[k], got_j[k], rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _recording_quantizer(monkeypatch, cls, seen):
    real = cls.quantize

    def quantize(self, key, grad):
        codes = real(self, key, grad)
        seen.append((key, np.array(codes, dtype=np.uint8).copy()))
        return codes
    monkeypatch.setattr(cls, "quantize", quantize)


def test_device_store_with_two_bit_compression(monkeypatch):
    """'device' with 2-bit compression over two contexts, 2 epochs of 4
    steps: the first push's codes equal the JAX package's bit for bit;
    over every later push at most 0.1% of the code bytes differ (a
    gradient within float rounding of the threshold quantizes to another
    code), and the trained parameters stay within 2e-3 of the JAX
    package's (measured: no code byte of 720 differs, the parameters
    6e-8 apart)."""
    x, y = _task(6, 64, (6,), 4)
    weights = _weights(_mlp(mt.sym), {"data": (16, 6)}, 7)
    seen_j, seen_t = [], []
    _recording_quantizer(monkeypatch, gc_j.GradientCompression, seen_j)
    _recording_quantizer(monkeypatch, gc_t.GradientCompression, seen_t)
    comp = {"type": "2bit", "threshold": 0.05}
    _, got_j = _fit(mj, _mlp, x, y, 16, 2, "device", weights,
                    compression_params=comp)
    mod, got_t = _fit(mt, _mlp, x, y, 16, 2, "device", weights,
                      compression_params=comp)
    assert mod._kvstore._gc is not None
    n_params = 4
    assert len(seen_t) == len(seen_j) == 2 * n_params * 8
    for (kj, cj), (kt, ct) in zip(seen_j[:2 * n_params],
                                  seen_t[:2 * n_params]):
        assert kt[0] == kj[0]
        np.testing.assert_array_equal(ct, cj)
    flipped = sum(int(np.count_nonzero(a[1] != b[1]))
                  for a, b in zip(seen_j, seen_t))
    total = sum(a[1].size for a in seen_j)
    assert flipped <= total // 1000
    for k in got_j:
        np.testing.assert_allclose(got_t[k], got_j[k], rtol=2e-3, atol=2e-3,
                                   err_msg=k)


def _bucket_sym_gen(sym):
    def gen(key):
        data = sym.Variable("data")
        net = sym.FullyConnected(sym.Reshape(data, shape=(-1, key)),
                                 num_hidden=8, name="fc1")
        net = sym.FullyConnected(sym.Activation(net, act_type="tanh"),
                                 num_hidden=3, name="fc2")
        return sym.SoftmaxOutput(net, name="softmax"), ("data",), \
            ("softmax_label",)
    return gen


def test_bucketing_module_over_two_contexts():
    """Two buckets of one shared FC layer over [cpu(0), cpu(1)] with
    'device': each bucket's module gets the contexts and the work load,
    every bucket shares the anchor's store, and training matches the JAX
    package's within 1e-5."""
    r = np.random.RandomState(8)
    batches = []
    for key in (6, 6, 6, 6):
        batches.append((key, r.standard_normal((8, key)).astype(np.float32),
                        r.randint(0, 3, 8).astype(np.float32)))
    w = {"fc1_weight": (0.3 * r.standard_normal((8, 6))).astype(np.float32),
         "fc1_bias": np.zeros(8, np.float32),
         "fc2_weight": (0.3 * r.standard_normal((3, 8))).astype(np.float32),
         "fc2_bias": np.zeros(3, np.float32)}
    got = {}
    for pkg in (mj, mt):
        mod = pkg.mod.BucketingModule(
            _bucket_sym_gen(pkg.sym), default_bucket_key=6,
            context=[pkg.cpu(0), pkg.cpu(1)], work_load_list=[1, 1])
        mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in w.items()})
        mod.init_optimizer(kvstore="device", optimizer="sgd",
                           optimizer_params={"learning_rate": 0.1})
        for key, x, y in batches:
            batch = pkg.io.DataBatch(
                [pkg.nd.array(x, ctx=pkg.cpu())],
                [pkg.nd.array(y, ctx=pkg.cpu())], bucket_key=key,
                provide_data=[("data", x.shape)],
                provide_label=[("softmax_label", y.shape)])
            mod.forward_backward(batch)
            mod.update()
        anchor = mod._buckets[6]
        assert len(anchor._exec_group.execs) == 2
        assert anchor._work_load_list == [1, 1]
        assert anchor._kvstore is not None
        got[pkg] = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    for k in got[mj]:
        np.testing.assert_allclose(got[mt][k], got[mj][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


@pytest.mark.parametrize("contexts,store,why", [
    (1, "dist_sync", "the store updates the weights"),
    (1, "dist_sync_tpu", "one context with a store"),
    (2, None, "several contexts without a collective store"),
    (2, "device", "the store updates the weights"),
    (2, "local", "the store updates the weights"),
    (2, "nccl", "several contexts without a collective store"),
    (2, "tpu_ici", None),
])
def test_fused_step_refusals(contexts, store, why):
    """The JAX package's gating: a module the fused step cannot serve
    takes the general path and says why; two host contexts under
    'tpu_ici' are two dp positions and fuse."""
    mod = mt.mod.Module(_mlp(mt.sym),
                        context=[mt.cpu(i) for i in range(contexts)])
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(kvstore=store)
    assert (mod._fused_step is None) == (why is not None)
    assert FusedTrainStep.refusal(mod) == why


def test_fused_step_refuses_unequal_slices_and_waits_for_the_dp_step(
        monkeypatch):
    """Under a collective store unequal slices refuse, and equal ones take
    the fused data-parallel step (``tests/test_torch_fused_dp.py``)."""
    mod = mt.mod.Module(_mlp(mt.sym), context=[mt.cpu(0), mt.cpu(1)],
                        work_load_list=[1, 3])
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(kvstore="tpu_ici")
    assert mod._fused_step is None
    assert FusedTrainStep.refusal(mod) == "unequal batch slices"
    mod._exec_group.slices = [slice(0, 4), slice(4, 8)]
    assert FusedTrainStep.refusal(mod) is None


def test_one_context_keeps_the_fused_step_without_a_store():
    mod = mt.mod.Module(_mlp(mt.sym), context=mt.cpu())
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(kvstore="device")
    assert mod._kvstore is None and mod._fused_step is not None


def test_outputs_and_input_gradients_merge_over_the_contexts():
    """``get_outputs``/``get_input_grads`` join the contexts' slices along
    the batch axis (merge_multi_context=False keeps them apart), and
    ``backward`` slices head gradients: equal to the JAX package's."""
    x, _ = _task(9, 8, (6,), 4)
    sym_fn = (lambda sym: sym.FullyConnected(sym.Variable("data"),
                                             num_hidden=3, name="fc"))
    weights = _weights(sym_fn(mt.sym), {"data": (8, 6)}, 10)
    head = np.random.RandomState(11).standard_normal((8, 3)).astype(
        np.float32)
    got = {}
    for pkg in (mj, mt):
        mod = pkg.mod.Module(sym_fn(pkg.sym), label_names=None,
                             context=[pkg.cpu(0), pkg.cpu(1)],
                             work_load_list=[3, 1])
        mod.bind([("data", (8, 6))], None, inputs_need_grad=True)
        mod.init_params(arg_params={k: pkg.nd.array(v, ctx=pkg.cpu())
                                    for k, v in weights[0].items()})
        mod.forward(pkg.io.DataBatch([pkg.nd.array(x, ctx=pkg.cpu())]),
                    is_train=True)
        mod.backward([pkg.nd.array(head, ctx=pkg.cpu())])
        parts = mod.get_outputs(merge_multi_context=False)[0]
        got[pkg] = (mod.get_outputs()[0].asnumpy(),
                    mod.get_input_grads()[0].asnumpy(),
                    [p.shape for p in parts], mod.output_shapes)
    for a, b in zip(got[mj][:2], got[mt][:2]):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6)
    assert got[mt][2] == got[mj][2] == [(6, 3), (2, 3)]
    assert got[mt][3] == got[mj][3]

"""The port's fused data-parallel Module step against the JAX package's.

Over several contexts under ``kvstore='tpu_ici'`` both packages train
the whole step as one unit: the batch split over the contexts, BatchNorm
over the global batch, the gradients summed, one update.  The JAX side
runs on the harness's virtual CPU devices; the port's contexts are dp
positions on the host (``[cpu(0), cpu(1)]``, also ``[cpu(0)] * 2``).
Every run starts from weights made with numpy from a seed; each test
states its tolerance.  The settings are those of the JAX package's
``tests/test_fused_extra.py`` (the dp pair), ``tests/test_comm_overlap.py``
(the fused dp overlap cases) and ``tests/test_elastic.py`` (the residual
round trips).  The JAX fused step reads a parameter's lr and wd
multipliers at index ``i`` where its Module names index ``i * n``, so
parity with it is checked at wd 0 (ROADMAP R13); the port's step is held
to its own general path with wd.
"""
import logging
import pickle

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.module import fused_step as fused_j
from mxnet_tpu_torch import convert
from mxnet_tpu_torch.module.fused_step import FusedTrainStep
from mxnet_tpu_torch.parallel import collectives, comm

_KNOBS = ("MXNET_TPU_COMM_BUCKET_MB", "MXNET_TPU_GRAD_COMPRESS",
          "MXNET_TPU_GRAD_COMPRESS_THRESHOLD")
# the port's fused step against its general path and against the JAX
# fused step: f32 sums in other orders over tens of SGD-momentum steps
# (the JAX package's own fused-against-general tolerance)
FIT_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def _clean_comm(monkeypatch):
    """Overlap off unless a test opts in."""
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)


def _ctxs(pkg, n):
    return [pkg.cpu(i) for i in range(n)]


def _mlp(sym, hidden=8, classes=4):
    h = sym.Activation(sym.FullyConnected(
        sym.var("data"), num_hidden=hidden, name="fc1"), act_type="relu")
    return sym.SoftmaxOutput(sym.FullyConnected(
        h, num_hidden=classes, name="fc2"), name="softmax")


def _conv_bn(sym):
    net = sym.Convolution(sym.var("data"), kernel=(3, 3), num_filter=4,
                          pad=(1, 1), name="conv1")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = sym.Flatten(net, name="flat1")
    net = sym.FullyConnected(net, num_hidden=3, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


def _weights(sym, shapes, seed):
    """Scaled normal weights, gamma near 1, small beta and bias, unit
    moving variance: numpy, by name."""
    r = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in shapes or n.endswith("label"):
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


def _nd(pkg, table):
    return {k: pkg.nd.array(v, ctx=pkg.cpu()) for k, v in table.items()}


def _state(mod):
    arg, aux = mod.get_params()
    out = {k: v.asnumpy().copy() for k, v in arg.items()}
    out.update(("aux:" + k, v.asnumpy().copy()) for k, v in aux.items())
    return out


def _close(got, want, **tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


# -- gating -------------------------------------------------------------------

@pytest.mark.parametrize("contexts", [
    [mt.cpu(0), mt.cpu(1)], [mt.cpu(0)] * 2, [mt.cpu(i) for i in range(4)]])
def test_contexts_are_positions_and_fuse(contexts):
    """Repeated contexts fuse too (the JAX package refuses contexts that
    share a device): each context is a dp position by its place."""
    mod = mt.mod.Module(_mlp(mt.sym), context=contexts)
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(kvstore="tpu_ici")
    assert FusedTrainStep.refusal(mod) is None
    fs = mod._fused_step
    assert fs is not None and fs.n_dev == len(contexts)
    assert fs.dp_mode == "split" and fs.dp_mode_reason is None


@pytest.mark.parametrize("store,workload,why", [
    (None, None, "several contexts without a collective store"),
    ("device", None, "the store updates the weights"),
    ("nccl", None, "several contexts without a collective store"),
    ("tpu_ici", [1, 3], "unequal batch slices"),
])
def test_dp_refusals(store, workload, why):
    mod = mt.mod.Module(_mlp(mt.sym), context=[mt.cpu(0), mt.cpu(1)],
                        work_load_list=workload)
    mod.bind([("data", (8, 6))], [("softmax_label", (8,))])
    mod.init_params(mt.initializer.Xavier())
    mod.init_optimizer(kvstore=store)
    assert mod._fused_step is None
    assert FusedTrainStep.refusal(mod) == why


# -- the monolithic step ------------------------------------------------------

def _dp_task(seed=0, n=512, features=16, classes=4):
    rng = np.random.RandomState(seed)
    w = rng.randn(features, classes)
    x = rng.randn(n, features).astype(np.float32)
    return x, np.argmax(x @ w, axis=1).astype(np.float32)


def _fit_mlp(pkg, contexts, x, y, weights, epochs=8, batch=64, wd=0.0,
             hidden=8):
    it = pkg.io.NDArrayIter(x, y, batch_size=batch, shuffle=False)
    mod = pkg.mod.Module(_mlp(pkg.sym, hidden=hidden), context=contexts)
    mod.fit(it, num_epoch=epochs, kvstore="tpu_ici",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9,
                              "wd": wd},
            arg_params=_nd(pkg, weights))
    it.reset()
    acc = dict(mod.score(it, pkg.metric.Accuracy()))["accuracy"]
    return mod, acc


def test_fused_dp_step_matches_its_general_path_and_the_jax_step(
        monkeypatch):
    """test_fused_extra's dp setting: the MLP over four contexts, 8
    epochs of 8 batches of 64: the fused step engages, the replicas are
    equal bit for bit, and the parameters are within FIT_TOL of the
    port's general path and of the JAX package's fused step."""
    x, y = _dp_task()
    weights, _ = _weights(_mlp(mt.sym), {"data": (64, 16)}, 1)
    mod, acc = _fit_mlp(mt, _ctxs(mt, 4), x, y, weights)
    fs = mod._fused_step
    assert fs is not None and fs.n_dev == 4 and fs.ran
    assert acc > 0.85, acc
    execs = mod._exec_group.execs
    for n in weights:
        for e in execs[1:]:
            assert torch.equal(e.arg_dict[n].tensor,
                               execs[0].arg_dict[n].tensor), n
    got = _state(mod)
    mod_j, acc_j = _fit_mlp(mj, _ctxs(mj, 4), x, y, weights)
    assert mod_j._fused_step is not None
    _close(got, _state(mod_j), **FIT_TOL)
    assert abs(acc - acc_j) < 1e-6
    with monkeypatch.context() as m:
        m.setattr(FusedTrainStep, "refusal",
                  staticmethod(lambda module: "held off"))
        mod_g, acc_g = _fit_mlp(mt, _ctxs(mt, 4), x, y, weights)
    assert mod_g._fused_step is None
    _close(got, _state(mod_g), **FIT_TOL)
    assert abs(acc - acc_g) < 1e-6


def test_fused_dp_step_reads_each_parameters_own_weight_decay(
        monkeypatch):
    """With wd 1e-3 the fused step over two contexts is within 1e-5 of
    the general path of both packages (which index a parameter's copy on
    context k as i * n + k): bias and weight keep their own
    multipliers."""
    x, y = _dp_task(3, n=128)
    weights, _ = _weights(_mlp(mt.sym), {"data": (32, 16)}, 4)
    kw = dict(epochs=2, batch=32, wd=1e-3)
    with monkeypatch.context() as m:
        m.setattr(FusedTrainStep, "refusal",
                  staticmethod(lambda module: "held off"))
        m.setattr(fused_j.FusedTrainStep, "supports",
                  staticmethod(lambda module: False))
        want_t = _state(_fit_mlp(mt, _ctxs(mt, 2), x, y, weights, **kw)[0])
        want_j = _state(_fit_mlp(mj, _ctxs(mj, 2), x, y, weights, **kw)[0])
    mod, _ = _fit_mlp(mt, _ctxs(mt, 2), x, y, weights, **kw)
    assert mod._fused_step is not None
    got = _state(mod)
    _close(got, want_t, rtol=1e-5, atol=1e-6)
    _close(got, want_j, rtol=1e-5, atol=1e-6)


def _bn_run(pkg, contexts, x, y, weights, steps=3, **opt):
    batch = x.shape[0] // steps
    mod = pkg.mod.Module(_conv_bn(pkg.sym), context=contexts)
    mod.bind([("data", (batch,) + x.shape[1:])],
             [("softmax_label", (batch,))])
    mod.init_params(arg_params=_nd(pkg, weights[0]),
                    aux_params=_nd(pkg, weights[1]))
    mod.init_optimizer(kvstore="tpu_ici" if len(contexts) > 1 else "local",
                       optimizer="sgd",
                       optimizer_params=dict({"learning_rate": 0.1,
                                              "momentum": 0.9}, **opt))
    assert mod._fused_step is not None
    outs = []
    for k in range(steps):
        rows = slice(k * batch, (k + 1) * batch)
        mod.forward_backward(pkg.io.DataBatch(
            [pkg.nd.array(x[rows], ctx=pkg.cpu())],
            [pkg.nd.array(y[rows], ctx=pkg.cpu())]))
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    return mod, outs


def _bn_task(seed=4):
    r = np.random.RandomState(seed)
    x = r.standard_normal((48, 3, 8, 8)).astype(np.float32)
    y = r.randint(0, 3, 48).astype(np.float32)
    return x, y, _weights(_conv_bn(mt.sym), {"data": (16, 3, 8, 8)}, 5)


@pytest.mark.parametrize("contexts", [
    [mt.cpu(0), mt.cpu(1)], [mt.cpu(0)] * 2])
def test_batchnorm_over_the_global_batch(contexts):
    """A conv net with BatchNorm over two positions, 3 steps of 16: the
    parameters and moving statistics within 1e-5 of the port's
    single-context fused step at the global batch (the same math:
    BatchNorm's channel sums psum'd), within 1e-4 of the JAX fused dp
    step; the outputs too."""
    x, y, weights = _bn_task()
    mod, outs = _bn_run(mt, contexts, x, y, weights)
    fs = mod._fused_step
    assert fs.dp_mode == "split"
    got = _state(mod)
    one, one_outs = _bn_run(mt, [mt.cpu()], x, y, weights)
    _close(got, _state(one), rtol=1e-5, atol=1e-5)
    for a, b in zip(outs, one_outs):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
    mod_j, outs_j = _bn_run(mj, _ctxs(mj, 2), x, y, weights)
    _close(got, _state(mod_j), rtol=1e-4, atol=1e-4)
    for a, b in zip(outs, outs_j):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
    # every replica's parameters and statistics are the same bits
    execs = mod._exec_group.execs
    for table in ("arg_dict", "aux_dict"):
        for n, a in getattr(execs[0], table).items():
            if n not in ("data", "softmax_label"):
                assert torch.equal(a.tensor,
                                   getattr(execs[1], table)[n].tensor), n


def test_step_counts_its_collectives():
    """One all-reduce a BatchNorm forward and backward, one a gradient."""
    x, y, weights = _bn_task()
    mod, _ = _bn_run(mt, [mt.cpu(0), mt.cpu(1)], x, y, weights)
    n_params = len(mod._fused_step.param_names)
    assert mod._fused_step.collectives["all-reduce"] == 2 + n_params
    with collectives.watch() as w:
        mod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(x[:16], ctx=mt.cpu())],
            [mt.nd.array(y[:16], ctx=mt.cpu())]))
        mod.update()
    assert w.counts == mod._fused_step.collectives


def test_an_op_across_rows_runs_the_global_batch_on_the_first_position(
        caplog):
    """A graph whose loss sums over the batch axis cannot run per
    position: dp_mode 'global' (with a warning naming the op), the same
    math as one context at the global batch within 1e-5, and each
    context gets its rows of the outputs."""
    def net(sym):
        h = sym.FullyConnected(sym.var("data"), num_hidden=3, name="fc")
        centred = sym.broadcast_sub(h, sym.mean(h, axis=0, keepdims=True))
        return sym.MakeLoss(sym.sum(sym.square(centred)), name="loss")

    r = np.random.RandomState(7)
    x = r.standard_normal((32, 5)).astype(np.float32)
    weights = {"fc_weight": r.standard_normal((3, 5)).astype(np.float32),
               "fc_bias": np.zeros(3, np.float32)}
    got = {}
    for contexts in ([mt.cpu(0), mt.cpu(1)], [mt.cpu()]):
        mod = mt.mod.Module(net(mt.sym), label_names=None, context=contexts)
        mod.bind([("data", (16, 5))])
        mod.init_params(arg_params=_nd(mt, weights))
        with caplog.at_level(logging.WARNING):
            mod.init_optimizer(kvstore="tpu_ici" if len(contexts) > 1
                               else "local",
                               optimizer_params={"learning_rate": 0.01,
                                                 "momentum": 0.9})
        for k in range(2):
            mod.forward_backward(mt.io.DataBatch(
                [mt.nd.array(x[16 * k:16 * (k + 1)], ctx=mt.cpu())], []))
            mod.update()
        got[len(contexts)] = _state(mod)
        if len(contexts) > 1:
            fs = mod._fused_step
            assert fs.dp_mode == "global"
            assert fs.dp_mode_reason.startswith("mean (node ")
            assert any("dp_mode 'global'" in r.message
                       for r in caplog.records)
    _close(got[2], got[1], rtol=1e-5, atol=1e-6)


def test_get_params_is_the_trained_state_bit_for_bit():
    """Over three contexts the mean of equal replicas can round
    ((a + a + a) / 3); the fused step hands its state out as it is."""
    x, y = _dp_task(5, n=96)
    weights, _ = _weights(_mlp(mt.sym), {"data": (48, 16)}, 6)
    mod, _ = _fit_mlp(mt, _ctxs(mt, 3), x, y, weights, epochs=1, batch=48)
    arg, _ = mod.get_params()
    for n, a in mod._exec_group.execs[0].arg_dict.items():
        if n in arg:
            assert torch.equal(arg[n].tensor, a.tensor), n


# -- state --------------------------------------------------------------------

def test_fused_dp_checkpoint_and_retire(tmp_path):
    """test_fused_extra's checkpoint case: the momentum round trips through
    an optimizer-state file, and retiring hands each context's Updater
    slot (index i * 2 + k) its own copy of it; training on through the
    general path then matches the fused step within FIT_TOL."""
    rng = np.random.RandomState(1)
    x = rng.randn(128, 8).astype(np.float32)
    y = np.argmax(x @ rng.randn(8, 3), axis=1).astype(np.float32)

    def net(sym):
        return sym.SoftmaxOutput(sym.FullyConnected(
            sym.var("data"), num_hidden=3, name="fc"), name="softmax")

    weights, _ = _weights(net(mt.sym), {"data": (32, 8)}, 2)

    def fit(epochs, retire_after=None):
        it = mt.io.NDArrayIter(x, y, batch_size=32)
        mod = mt.mod.Module(net(mt.sym), context=[mt.cpu(0), mt.cpu(1)])
        kw = dict(kvstore="tpu_ici", arg_params=_nd(mt, weights),
                  optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        mod.fit(it, num_epoch=epochs, **kw)
        if retire_after is not None:
            mod._retire_fused_step("test")
            it.reset()
            mod.fit(it, num_epoch=retire_after, force_init=False, **kw)
        return mod

    mod = fit(2)
    fs = mod._fused_step
    assert fs is not None
    f = str(tmp_path / "opt.states")
    mod.save_optimizer_states(f)
    raw = pickle.load(open(f, "rb"))
    assert raw["format"] == "fused_v2"
    before = {k: v["state"].copy() for k, v in fs.export_states().items()}
    for st in fs.states:
        st.zero_()
    mod.load_optimizer_states(f)
    for k, v in fs.export_states().items():
        assert np.array_equal(v["state"], before[k]), k
    fs.transfer_to_updater(mod._updater)
    names = mod._exec_group.param_names
    for i, name in enumerate(names):
        slots = [mod._updater.states[i * 2 + k] for k in range(2)]
        assert slots[0].tensor is not slots[1].tensor
        for s in slots:
            assert np.array_equal(s.asnumpy(), before[name])
    # two fused epochs then one general against three fused
    retired = fit(2, retire_after=1)
    assert retired._fused_step is None
    _close(_state(retired), _state(fit(3)), **FIT_TOL)


def test_set_fused_step_state_carries_the_jax_steps_state():
    """convert.set_fused_step_state: a JAX fused dp run's masters,
    momentum and moving statistics after 2 steps, carried into the port's
    step, train on for 1 step as the JAX package does (within 1e-4)."""
    x, y, weights = _bn_task(9)
    mod_j, _ = _bn_run(mj, _ctxs(mj, 2), x[:32], y[:32], weights, steps=2)
    mod, _ = _bn_run(mt, [mt.cpu(0), mt.cpu(1)], x[:16], y[:16], weights,
                     steps=1)
    convert.set_fused_step_state(mod, mod_j)
    fj = mod_j._fused_step
    for n, st in zip(fj.param_names, fj.states):
        assert np.array_equal(
            mod._fused_step.shared.states[n].numpy(), np.asarray(st))
    batch = (x[32:], y[32:])
    for pkg, m in ((mj, mod_j), (mt, mod)):
        m.forward_backward(pkg.io.DataBatch(
            [pkg.nd.array(batch[0], ctx=pkg.cpu())],
            [pkg.nd.array(batch[1], ctx=pkg.cpu())]))
        m.update()
    _close(_state(mod), _state(mod_j), rtol=1e-4, atol=1e-4)


# -- the overlap path (test_comm_overlap's fused dp cases) --------------------

_N_DEV = 8


def _fit_dp(pkg, monkeypatch, bucket=None, compress=None, threshold=None,
            epochs=2, lr=0.1, hidden=16, n_dev=_N_DEV, seed=0):
    for k in _KNOBS:
        monkeypatch.delenv(k, raising=False)
    if bucket is not None:
        monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", str(bucket))
    if compress is not None:
        monkeypatch.setenv("MXNET_TPU_GRAD_COMPRESS", compress)
    if threshold is not None:
        monkeypatch.setenv("MXNET_TPU_GRAD_COMPRESS_THRESHOLD",
                           str(threshold))
    rng = np.random.RandomState(seed)
    w = rng.randn(16, 4)
    x = rng.randn(256, 16).astype(np.float32)
    y = np.argmax(x @ w, axis=1).astype(np.float32)
    weights, _ = _weights(_mlp(mt.sym, hidden=hidden), {"data": (64, 16)},
                          11)
    it = pkg.io.NDArrayIter(x, y, batch_size=64, shuffle=False)
    mod = pkg.mod.Module(_mlp(pkg.sym, hidden=hidden),
                         context=_ctxs(pkg, n_dev))
    mod.fit(it, num_epoch=epochs, kvstore="tpu_ici",
            optimizer_params={"learning_rate": lr, "momentum": 0.9},
            arg_params=_nd(pkg, weights))
    it.reset()
    acc = dict(mod.score(it, pkg.metric.Accuracy()))["accuracy"]
    params = {n: mod._exec_group.execs[0].arg_dict[n].asnumpy()
              for n in mod._exec_group.param_names}
    return mod, acc, params


def test_fused_dp_overlap_matches_monolithic(monkeypatch):
    """Bucketed == monolithic within rtol 1e-4 / atol 1e-6, and both
    within FIT_TOL of the JAX package's bucketed step; the port's record
    of collectives shows one all-reduce a bucket a step (the JAX
    package's test reads compiled HLO, which this XLA combines: R1)."""
    mod0, acc0, p0 = _fit_dp(mt, monkeypatch)
    assert mod0._fused_step is not None
    assert mod0._fused_step._comm_plan is None
    mod1, acc1, p1 = _fit_dp(mt, monkeypatch, bucket=0.001)
    fs = mod1._fused_step
    assert fs._comm_plan is not None, fs.overlap_off_reason
    assert len(fs._comm_plan.buckets) >= 2
    for k in p0:
        np.testing.assert_allclose(p0[k], p1[k], rtol=1e-4, atol=1e-6)
    assert acc1 == pytest.approx(acc0, abs=1e-6)
    assert fs.collectives["all-reduce"] == len(fs._comm_plan.buckets)
    assert mod0._fused_step.collectives["all-reduce"] == len(p0)
    _, acc_j, p_j = _fit_dp(mj, monkeypatch, bucket=0.001)
    for k in p_j:
        np.testing.assert_allclose(p1[k], p_j[k], **FIT_TOL)
    assert acc1 == pytest.approx(acc_j, abs=1e-6)


def test_fused_dp_compressed_converges_and_cuts_wire(monkeypatch):
    """2-bit mode still learns the task and moves at most 1/8 (1/16 and
    padding) of the f32 gradient bytes a step: one all-gather of codes a
    bucket; the residuals are live state.  After one epoch (4 steps)
    the residuals are the JAX package's within rtol 1e-4 / atol 1e-6
    (the same codes from gradients equal up to rounding)."""
    mod, acc, _ = _fit_dp(mt, monkeypatch, bucket=0.001, compress="2bit",
                          threshold=0.05, epochs=12, hidden=32)
    fs = mod._fused_step
    plan = fs._comm_plan
    assert plan is not None and plan.compress == "2bit"
    assert plan.wire_bytes <= plan.grad_f32_bytes / 8.0
    assert acc >= 0.5, acc  # chance = 0.25
    assert fs.collectives["all-gather"] == plan.n_buckets
    assert fs.collectives["all-reduce"] == 0
    assert fs._residuals and any(float(np.abs(np.asarray(r)).sum()) > 0
                                 for r in fs._residuals)
    firsts = []
    for pkg in (mt, mj):
        m, _, _ = _fit_dp(pkg, monkeypatch, bucket=0.001, compress="2bit",
                          threshold=0.05, epochs=1, hidden=32)
        firsts.append([np.asarray(r) for r in m._fused_step._residuals])
    assert [r.shape for r in firsts[0]] == [r.shape for r in firsts[1]]
    for a, b in zip(*firsts):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_residual_survives_checkpoint(monkeypatch, tmp_path):
    """The residuals are optimizer state: they ride
    save_optimizer_states / load_optimizer_states bit for bit."""
    mod, _, _ = _fit_dp(mt, monkeypatch, bucket=0.001, compress="2bit",
                        threshold=0.05, epochs=2)
    fs = mod._fused_step
    before = [np.asarray(r) for r in fs._residuals]
    assert before and any(np.abs(b).sum() > 0 for b in before)
    path = str(tmp_path / "opt.states")
    mod.save_optimizer_states(path)
    for r in fs._residuals:
        for s in r.shards:
            s.zero_()
    mod.load_optimizer_states(path)
    after = [np.asarray(r) for r in fs._residuals]
    assert all(np.array_equal(a, b) for a, b in zip(after, before))


def test_overlap_gate_reasons(monkeypatch):
    """BatchNorm's aux state keeps the monolithic reduction; one context
    has nothing to overlap.  The reasons are the JAX package's."""
    monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", "4")
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (np.arange(64) % 2).astype(np.float32)
    reasons = []
    for pkg in (mt, mj):
        net = pkg.sym.FullyConnected(pkg.sym.var("data"), num_hidden=8,
                                     name="fc1")
        net = pkg.sym.BatchNorm(net, name="bn")
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            net, num_hidden=2, name="fc2"), name="softmax")
        mod = pkg.mod.Module(net, context=_ctxs(pkg, 2))
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
                kvstore="tpu_ici",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        fs = mod._fused_step
        assert fs is not None and fs._comm_plan is None
        assert "auxiliary state" in fs.overlap_off_reason
        mod2 = pkg.mod.Module(_mlp(pkg.sym, classes=2), context=pkg.cpu())
        mod2.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
                 optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        fs2 = mod2._fused_step
        assert fs2 is not None and fs2._comm_plan is None
        assert fs2.overlap_off_reason == "single-device"
        reasons.append(fs.overlap_off_reason)
    assert reasons[0] == reasons[1]


def test_overlap_gate_batch_normalized_loss(monkeypatch):
    """SoftmaxOutput(normalization='batch') divides by the batch it sees:
    per position that is the local batch, so the gate keeps the
    monolithic path, with the JAX package's reason word for word."""
    monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", "4")
    rng = np.random.RandomState(0)
    x = rng.randn(64, 8).astype(np.float32)
    y = (np.arange(64) % 2).astype(np.float32)
    reasons = []
    for pkg in (mt, mj):
        net = pkg.sym.SoftmaxOutput(pkg.sym.FullyConnected(
            pkg.sym.var("data"), num_hidden=2, name="fc"),
            normalization="batch", name="softmax")
        mod = pkg.mod.Module(net, context=_ctxs(pkg, 2))
        mod.fit(pkg.io.NDArrayIter(x, y, batch_size=16), num_epoch=1,
                kvstore="tpu_ici",
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        fs = mod._fused_step
        assert fs is not None and fs._comm_plan is None
        assert "batch-normalized loss gradient" in fs.overlap_off_reason
        reasons.append(fs.overlap_off_reason)
    assert reasons[0] == reasons[1]


# -- residual round trips across dp (test_elastic's three) --------------------

@pytest.fixture
def _compressed(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", "0.001")
    monkeypatch.setenv("MXNET_TPU_GRAD_COMPRESS", "2bit")
    monkeypatch.setenv("MXNET_TPU_GRAD_COMPRESS_THRESHOLD", "0.05")


def _elastic_fit(n_dev, epochs=2):
    rng = np.random.RandomState(0)
    x = rng.randn(256, 16).astype(np.float32)
    y = (np.arange(256) % 4).astype(np.float32)
    weights, _ = _weights(_mlp(mt.sym, hidden=32), {"data": (64, 16)}, 12)
    it = mt.io.NDArrayIter(x, y, batch_size=64, shuffle=False)
    mod = mt.mod.Module(_mlp(mt.sym, hidden=32), context=_ctxs(mt, n_dev))
    mod.fit(it, num_epoch=epochs, kvstore="tpu_ici",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
            arg_params=_nd(mt, weights))
    return mod


def _residuals(mod):
    return [np.asarray(r) for r in mod._fused_step._residuals]


def test_optimizer_roundtrip_dp8_to_dp8_bitwise(tmp_path, _compressed):
    mod8 = _elastic_fit(8)
    res8 = _residuals(mod8)
    assert res8 and any(np.abs(r).sum() > 0 for r in res8)
    path = str(tmp_path / "opt.states")
    mod8.save_optimizer_states(path)
    raw = pickle.load(open(path, "rb"))
    assert raw["format"] == "fused_v2"
    assert "__comm_residuals__" in raw["states"]
    mod8b = _elastic_fit(8, epochs=1)
    mod8b.load_optimizer_states(path)
    for a, b in zip(_residuals(mod8b), res8):
        assert np.array_equal(a, b)  # bit for bit at equal dp
    sa = mod8._fused_step.export_states()
    sb = mod8b._fused_step.export_states()
    for name in ("fc1_weight", "fc2_weight"):
        assert np.array_equal(sa[name]["state"], sb[name]["state"]), name


def test_optimizer_roundtrip_dp8_to_dp4_sum_merges(tmp_path, _compressed):
    mod8 = _elastic_fit(8)
    res8 = _residuals(mod8)
    path = str(tmp_path / "opt.states")
    mod8.save_optimizer_states(path)
    mod4 = _elastic_fit(4, epochs=1)
    mod4.load_optimizer_states(path)
    want, reason = comm.reshard_residuals(res8, 4)
    assert reason is None
    got = _residuals(mod4)
    assert [r.shape for r in got] == [w.shape for w in want]
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    # the pending quantization error is conserved across the merge, up
    # to the order of 8 f32 additions (a few ulp of the terms' sum)
    eps = float(np.finfo(np.float32).eps)
    for a, b in zip(want, res8):
        np.testing.assert_allclose(a.sum(axis=0), b.sum(axis=0), rtol=0,
                                   atol=8 * eps * float(np.abs(b).sum(
                                       axis=0).max()))


def test_optimizer_roundtrip_layout_change_warns_and_drops(
        tmp_path, _compressed, monkeypatch, caplog):
    mod8 = _elastic_fit(8)
    path = str(tmp_path / "opt.states")
    mod8.save_optimizer_states(path)
    monkeypatch.setenv("MXNET_TPU_COMM_BUCKET_MB", "0.002")
    mod4 = _elastic_fit(4, epochs=1)
    with caplog.at_level(logging.WARNING):
        mod4.load_optimizer_states(path)
    assert any("dropping them" in r.message for r in caplog.records)
    assert all(np.abs(r).sum() == 0 for r in _residuals(mod4))


# -- the record of collectives under a graph ----------------------------------

def test_captured_collectives_count_again_at_each_replay():
    """``collectives.captured`` takes a capture's calls out of the active
    watches; ``add_counts`` counts them at each replay."""
    mesh = mt.parallel.create_mesh(dp=2, devices=[mt.cpu()] * 2)
    blocks = [torch.ones(3), torch.ones(3)]
    with collectives.watch() as outer:
        with collectives.captured() as graph:
            collectives.psum(blocks, mesh, "dp")
            collectives.all_gather(blocks, mesh, "dp")
        assert outer.counts["all-reduce"] == 0
        assert graph == {"all-reduce": 1, "all-gather": 1}
        for _ in range(3):
            collectives.add_counts(graph)
    assert outer.counts["all-reduce"] == 3 and outer.counts["all-gather"] == 3

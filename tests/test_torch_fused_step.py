"""The port's fused train step against the JAX package's, on the CPU.

Every optimizer configuration of ``tests/test_fused_optimizers.py`` on
its FC net: the port's fused step against the JAX package's fused step
and against the port's own general path (the Updater); the ``_fused_ok``
rule; the Updater state that retiring the step hands over.  bf16 under
``multi_precision``: inferred dtypes, training, f32 masters after one
epoch against the JAX package's, eval-mode BatchNorm's dtype, masters
carried across a ``reshape``, ``set_params`` honoured between steps.  A
CIFAR-depth ResNet through ``Module.fit`` in both packages, f32 and bf16.

Inputs and initial weights come from numpy seeds and reach both
packages as numpy arrays.  Tolerances are stated where they are used.
"""
import logging

import numpy as np
import pytest

import mxnet_tpu as mj
from mxnet_tpu.models import resnet as resnet_j

import mxnet_tpu_torch as mt
from mxnet_tpu_torch.models import resnet as resnet_t
from test_torch_module import _init

# every registered optimizer, as tests/test_fused_optimizers.py
OPTIMIZERS = [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.1}),
    ("signum", {"learning_rate": 0.01, "momentum": 0.9}),
    ("nag", {"learning_rate": 0.05, "momentum": 0.9}),
    ("dcasgd", {"learning_rate": 0.05, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("adagrad", {"learning_rate": 0.05}),
    ("rmsprop", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("adadelta", {}),
    ("ftrl", {"learning_rate": 0.05}),
    ("ftml", {"learning_rate": 0.01}),
    ("adamax", {"learning_rate": 0.01}),
    ("nadam", {"learning_rate": 0.01}),
    ("test", {}),
]
# the fused-vs-updater tolerance of tests/test_fused_optimizers.py: three
# epochs of f32 arithmetic (an optimizer's scalar products rounded to f32
# once in the fused step, in double on the general path)
FUSED_TOL = dict(rtol=2e-5, atol=2e-5)


def _fc_data(seed=0, n=64):
    rng = np.random.RandomState(seed)
    w = rng.randn(12, 4).astype(np.float32)
    x = rng.randn(n, 12).astype(np.float32)
    y = (x @ w).argmax(axis=1).astype(np.float32)
    init = {"fc_weight": rng.uniform(-0.1, 0.1, (4, 12)).astype(np.float32),
            "fc_bias": rng.uniform(-0.1, 0.1, (4,)).astype(np.float32)}
    return x, y, init


def _fc_module(mx, name, params, x, y, init, fused=True):
    it = mx.io.NDArrayIter(x, y, batch_size=32, shuffle=False,
                           label_name="softmax_label")
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                              name="fc"), name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in init.items()})
    mod.init_optimizer(optimizer=name, optimizer_params=dict(params))
    if not fused:
        mod._fused_step = None
    return mod, it


def _train(mod, it, epochs):
    for _ in range(epochs):
        it.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()


def _params(mod):
    return {k: v.asnumpy() for k, v in mod.get_params()[0].items()}


@pytest.mark.parametrize("name,params", OPTIMIZERS)
def test_fused_matches_jax_and_general_path(name, params):
    """The port's fused step, the JAX package's fused step and the port's
    general path from the same weights, 3 epochs of 2 batches: every
    parameter within FUSED_TOL."""
    x, y, init = _fc_data()
    mod_t, it_t = _fc_module(mt, name, params, x, y, init)
    mod_g, _ = _fc_module(mt, name, params, x, y, init, fused=False)
    mod_j, it_j = _fc_module(mj, name, params, x, y, init)
    assert mod_t._fused_step is not None, name
    assert mod_j._fused_step is not None, name
    _train(mod_t, it_t, 3)
    _train(mod_g, it_t, 3)
    _train(mod_j, it_j, 3)
    assert mod_t._fused_step is not None and mod_t._fused_step.ran
    assert mod_t._optimizer.num_update == mod_j._optimizer.num_update == 6
    pt, pg, pj = _params(mod_t), _params(mod_g), _params(mod_j)
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], err_msg=name, **FUSED_TOL)
        np.testing.assert_allclose(pt[k], pg[k], err_msg=name, **FUSED_TOL)
    assert any(not np.array_equal(pt[k], init[k]) for k in init)


def test_subclass_overriding_update_is_not_fused():
    """A subclass that changes update() but not fused_update must not be
    fused with its parent's math (the JAX package's rule)."""
    for opt_mod in (mj.optimizer, mt.optimizer):
        class Custom(opt_mod.SGD):
            def update(self, index, weight, grad, state):
                weight += 0.0 * grad

        class JustDefaults(opt_mod.SGD):
            pass

        assert opt_mod.SGD()._fused_ok()
        assert not Custom()._fused_ok()
        assert JustDefaults()._fused_ok()
    x, y, init = _fc_data()
    it = mt.io.NDArrayIter(x, y, batch_size=32)
    mod = mt.mod.Module(mt.sym.SoftmaxOutput(mt.sym.FullyConnected(
        mt.sym.Variable("data"), num_hidden=4, name="fc"), name="softmax"),
        context=mt.cpu())
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params()

    class Custom(mt.optimizer.SGD):
        def update(self, index, weight, grad, state):
            weight += 0.0 * grad

    mod.init_optimizer(optimizer=Custom(rescale_grad=1 / 32))
    assert mod._fused_step is None


def _structure(state):
    if isinstance(state, tuple):
        return tuple(_structure(s) for s in state)
    return None if state is None else "array"


@pytest.mark.parametrize("name,params", [
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("adam", {"learning_rate": 0.01}),
    ("rmsprop", {"learning_rate": 0.01, "centered": True}),
    ("dcasgd", {"learning_rate": 0.05}),
])
def test_transfer_to_updater_structure(name, params):
    """Retiring the fused step hands the Updater, for every parameter, a
    state of the structure create_state_multi_precision makes, in both
    packages; then the general path keeps training from it: one more
    step in each path agrees with the JAX package at FUSED_TOL."""
    x, y, init = _fc_data()
    mods = []
    for mx in (mt, mj):
        mod, it = _fc_module(mx, name, params, x, y, init)
        it.reset()
        batch = next(iter(it))
        mod.forward_backward(batch)
        mod.update()
        mod._fused_step.transfer_to_updater(mod._updater)
        want = _structure(mod._optimizer.create_state_multi_precision(
            0, mod._exec_group.execs[0].arg_dict["fc_weight"]))
        assert sorted(mod._updater.states) == [0, 1]
        for st in mod._updater.states.values():
            assert _structure(st) == want, (name, st)
        mod._fused_step = None
        mod.forward_backward(batch)
        mod.update()
        mods.append(mod)
    pt, pj = _params(mods[0]), _params(mods[1])
    for k in pj:
        np.testing.assert_allclose(pt[k], pj[k], err_msg=name, **FUSED_TOL)


def test_update_without_fused_forward_backward_retires_the_step():
    """forward + backward + update() retires the fused step (the JAX
    package's semantics) and keeps the momentum."""
    x, y, init = _fc_data()
    mod, it = _fc_module(mt, "sgd", {"learning_rate": 0.1,
                                     "momentum": 0.9}, x, y, init)
    it.reset()
    batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    mom = mod._fused_step.states[0].clone()
    mod.forward(batch, is_train=True)
    mod.backward()
    mod.update()
    assert mod._fused_step is None
    assert not np.array_equal(mod._updater.states[0].asnumpy(), mom.numpy())


# ---------------------------------------------------------------------------
# bf16 under multi_precision
# ---------------------------------------------------------------------------

def _bf16_mlp(mx, multi_precision=True, seed=0, n=256, batch=32,
              init=None):
    """The JAX package's ``_bf16_mlp`` (tests/test_fused_optimizers.py),
    its weights from ``init`` (numpy, f32) or uniform(0.5) from the
    seed."""
    rng = np.random.RandomState(seed)
    w = rng.randn(12, 4).astype(np.float32)
    x = rng.randn(n, 12).astype(np.float32)
    y = (x @ w).argmax(axis=1).astype(np.float32)
    if init is None:
        init = {"fc1_weight": rng.uniform(-0.5, 0.5, (16, 12)),
                "fc1_bias": rng.uniform(-0.5, 0.5, (16,)),
                "fc2_weight": rng.uniform(-0.5, 0.5, (4, 16)),
                "fc2_bias": rng.uniform(-0.5, 0.5, (4,))}
    it = mx.io.NDArrayIter(x, y, batch_size=batch, shuffle=False,
                           label_name="softmax_label")
    data = mx.sym.Cast(mx.sym.Variable("data"), dtype="bfloat16")
    h = mx.sym.Activation(
        mx.sym.FullyConnected(data, num_hidden=16, name="fc1"),
        act_type="relu")
    net = mx.sym.SoftmaxOutput(
        mx.sym.FullyConnected(h, num_hidden=4, name="fc2"), name="softmax")
    mod = mx.mod.Module(net, context=mx.cpu())
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mod.init_params(arg_params={
        k: mx.nd.array(np.asarray(v, np.float32), ctx=mx.cpu()).astype(
            "bfloat16")
        for k, v in init.items()})
    mod.init_optimizer(optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9,
                                         "multi_precision": multi_precision})
    return mod, it


def test_bf16_params_inferred():
    """A Cast-to-bf16 graph gives bf16 conv/FC weights and f32 BatchNorm
    parameters and moving statistics, as in the JAX package; so does the
    bf16 ResNet."""
    for mx in (mt, mj):
        data = mx.sym.Cast(mx.sym.Variable("data"), dtype="bfloat16")
        net = mx.sym.BatchNorm(mx.sym.Convolution(
            data, kernel=(3, 3), num_filter=8, name="conv"), name="bn")
        arg_types, _, aux_types = net.infer_type(data="float32")
        by_name = dict(zip(net.list_arguments(), arg_types))
        assert mx.base.dtype_name(by_name["conv_weight"]) == "bfloat16"
        assert mx.base.dtype_name(by_name["bn_gamma"]) == "float32"
        assert all(mx.base.dtype_name(t) == "float32" for t in aux_types)
    types = {}
    for mx, rn in ((mt, resnet_t), (mj, resnet_j)):
        sym = rn.get_symbol(10, 20, "3,24,24", dtype="bfloat16")
        args, outs, auxs = sym.infer_type(data="float32")
        types[mx] = ([mx.base.dtype_name(t) for t in args],
                     [mx.base.dtype_name(t) for t in outs],
                     [mx.base.dtype_name(t) for t in auxs])
        assert sym.list_arguments()[0] == "data"
    assert types[mt] == types[mj]
    names = resnet_t.get_symbol(10, 20, "3,24,24",
                                dtype="bfloat16").list_arguments()
    kinds = dict(zip(names, types[mt][0]))
    assert kinds["conv0_weight"] == kinds["fc1_weight"] == "bfloat16"
    assert kinds["bn1_gamma"] == "float32" and types[mt][1] == ["float32"]


def test_bf16_multi_precision_trains():
    """bf16 storage with f32 masters converges on the fused path: train
    accuracy above 0.9 after 15 epochs, storage bf16, masters f32."""
    mod, it = _bf16_mlp(mt)
    fs = mod._fused_step
    assert fs is not None and any(fs.mixed)
    metric = mt.metric.create("acc")
    for _ in range(15):
        it.reset()
        metric.reset()
        for batch in it:
            mod.forward_backward(batch)
            mod.update()
            mod.update_metric(metric, batch.label)
    assert metric.get()[1] > 0.9, metric.get()
    args, _ = mod.get_params()
    assert mt.base.dtype_name(args["fc1_weight"].dtype) == "bfloat16"
    j = fs.param_names.index("fc1_weight")
    assert fs._masters[j].dtype == mt.base.torch_dtype("float32")


def test_bf16_masters_after_one_epoch_match_jax():
    """The f32 masters after one epoch (8 steps) against the JAX
    package's.  Both forwards run in bf16, so the two packages' rounding
    of an activation may differ by one bf16 ulp (2**-8 relative) and the
    gradients with it: each master is held to a relative L2 error of
    max(1e-2, 2**-8 * steps * lr-scaled growth); the test takes 1e-2,
    the looser of the two at these sizes, and reports the largest
    measured."""
    mods = {mx: _bf16_mlp(mx) for mx in (mt, mj)}
    for mod, it in mods.values():
        _train(mod, it, 1)
    ft, fj = mods[mt][0]._fused_step, mods[mj][0]._fused_step
    worst = 0.0
    for name in ft.param_names:
        a = ft._masters[ft.param_names.index(name)].numpy()
        b = np.asarray(fj._masters[fj.param_names.index(name)])
        assert a.dtype == b.dtype == np.float32
        rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
        worst = max(worst, rel)
        assert rel <= max(1e-2, 2.0 ** -8), (name, rel)
    logging.info("bf16 masters: worst relative L2 %.3g", worst)


def test_bn_eval_keeps_bf16():
    """Eval-mode BatchNorm returns the data's dtype (bf16) with f32
    gamma/beta, as the training mode and the JAX package do."""
    import torch
    from mxnet_tpu_torch.ops.nn import _batch_norm
    x = torch.rand(2, 3, 4, 4).to(torch.bfloat16)
    g, b = torch.ones(3), torch.zeros(3)
    mm, mv = torch.zeros(3), torch.ones(3)
    out_t = _batch_norm(x, g, b, mm, mv, fix_gamma=False, _train=True)[0]
    out_e = _batch_norm(x, g, b, mm, mv, fix_gamma=False, _train=False)[0]
    assert out_t.dtype == out_e.dtype == torch.bfloat16


def test_reshape_carries_f32_masters():
    """An explicit reshape rebuilds the executor: the fused step carries
    its f32 masters and momentum to it (re-deriving them from bf16
    storage would round them), then trains on at the new batch size and
    still converges (train accuracy above 0.9)."""
    mod, it = _bf16_mlp(mt)
    it.reset()
    batch = next(iter(it))
    for _ in range(3):
        mod.forward_backward(batch)
        mod.update()
    fs = mod._fused_step
    before = [m.clone() for m in fs._masters]
    assert any(not np.array_equal(m.numpy(), m.bfloat16().float().numpy())
               for m in before), "no master carries sub-bf16 precision"
    moms = [s.clone() for s in fs.states]
    rng = np.random.RandomState(9)
    desc = [mt.io.DataDesc("data", (16, 12))]
    ldesc = [mt.io.DataDesc("softmax_label", (16,))]
    mod.reshape(data_shapes=desc, label_shapes=ldesc)
    small = mt.io.DataBatch(
        data=[mt.nd.array(rng.rand(16, 12).astype(np.float32), ctx=mt.cpu())],
        label=[mt.nd.array(rng.randint(0, 4, (16,)).astype(np.float32),
                           ctx=mt.cpu())],
        provide_data=desc, provide_label=ldesc)
    assert mod._fused_step is fs
    mod.forward_backward(small)
    mod.update()
    assert fs.exe is mod._exec_group.execs[0] and fs.ran
    for j in range(len(before)):
        # one more SGD-momentum step moved each master from its carried
        # f32 value by exactly its new momentum
        np.testing.assert_array_equal(
            fs._masters[j].numpy(),
            (before[j] + fs.states[j]).numpy())
        assert not np.array_equal(fs.states[j].numpy(), moms[j].numpy())
    mod.reshape(data_shapes=it.provide_data, label_shapes=it.provide_label)
    metric = mt.metric.create("acc")
    _train(mod, it, 10)
    it.reset()
    for b in it:
        mod.forward(b, is_train=False)
        mod.update_metric(metric, b.label)
    assert metric.get()[1] > 0.9


def test_set_params_between_steps_is_honoured():
    """set_params between fused steps writes into the bound tensors; the
    step re-derives each master from the new storage, unless the values
    written equal the master cast (fit's epoch-end set_params), which
    keeps the f32 masters."""
    mod, it = _bf16_mlp(mt)
    it.reset()
    batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    fs = mod._fused_step
    kept = [m.clone() for m in fs._masters]
    mod.set_params(*mod.get_params())  # the same values: masters kept
    fs._refresh()
    for a, b in zip(kept, fs._masters):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    new = {k: mt.nd.array(np.full(v.shape, 0.25, np.float32),
                       ctx=mt.cpu()).astype(
        "bfloat16") for k, v in mod.get_params()[0].items()}
    mod.set_params(new, {})
    fs._refresh()
    for m in fs._masters:
        assert np.all(m.numpy() == 0.25)
    mod.forward_backward(batch)
    mod.update()
    assert all(not np.all(m.numpy() == 0.25) for m in fs._masters)


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_rebound_parameter_keeps_training(precision):
    """A parameter whose bound NDArray is rebound to a new tensor between
    fused steps (``w += 1`` under ``autograd.record()``) keeps training:
    without a master (f32) the step updates the new tensor; with an f32
    master (bf16 storage) it re-derives the master from the new tensor.
    Either way the next SGD-momentum step moves the value the forward
    reads by exactly its momentum (w += mom)."""
    import torch
    if precision == "float32":
        x, y, init = _fc_data()
        mod, it = _fc_module(mt, "sgd", {"learning_rate": 0.1,
                                          "momentum": 0.9}, x, y, init)
    else:
        mod, it = _bf16_mlp(mt)
    it.reset()
    batch = next(iter(it))
    mod.forward_backward(batch)
    mod.update()
    fs = mod._fused_step
    name = fs.param_names[0]
    j = 0
    assert fs.mixed[j] == (precision == "bfloat16")
    w = mod._exec_group.execs[0].arg_dict[name]
    old = w.tensor
    with mt.autograd.record():
        w += 1.0
    assert w.tensor is not old and w.tensor.dtype == old.dtype
    rebound = w.tensor.detach().float().clone()
    mod.forward_backward(batch)
    mod.update()
    now = w.tensor.detach().float()
    np.testing.assert_array_equal(now.numpy(),
                                  (rebound + fs.states[j]).to(
                                      w.tensor.dtype).float().numpy())
    np.testing.assert_array_equal(fs._masters[j].float().numpy(),
                                  (rebound + fs.states[j]).numpy())
    assert not torch.equal(now, rebound)


def test_captured_launches_records_and_restores():
    """``captured_launches`` yields the wrapper calls made inside its block
    (a capture's, counted again at each replay) and sets the counts back;
    a block that raises records nothing and restores them too."""
    from mxnet_tpu_torch.ops import kernels as K
    K.reset_launch_counts()
    K._launch("max_pool_backward", lambda: 0)
    before = K.launch_counts()
    with K.captured_launches() as got:
        for _ in range(3):
            K._launch("bn_channel_sums", lambda: 0)
        K._launch("avg_pool_backward", lambda: 0)
    assert got == {"bn_channel_sums": 3, "avg_pool_backward": 1}
    assert K.launch_counts() == before
    K.add_launch_counts(got)
    assert K.launch_counts()["bn_channel_sums"] == 3
    with pytest.raises(RuntimeError):
        with K.captured_launches() as failed:
            K._launch("bn_channel_sums", lambda: 0)
            raise RuntimeError("capture failed")
    assert failed == {} and K.launch_counts()["bn_channel_sums"] == 3
    K.reset_launch_counts()


# ---------------------------------------------------------------------------
# a CIFAR-depth ResNet through Module.fit, both packages
# ---------------------------------------------------------------------------

# lr of the ResNet fits: at batch 4 the second step's BatchNorm statistics
# amplify a first-step difference of f32 rounding (1e-5 relative between
# the packages' gradients) to 2e-4 in conv0's weight at lr 0.05; at 0.01 the
# two packages stay within the f32 tolerance below
LR = 0.01


def _resnet_fit(dtype, epochs=2):
    """ResNet-20 v2 at CIFAR depth, batch 4 of 3x24x24, 2 batches an
    epoch, SGD-momentum with multi_precision, from the same numpy weights
    in both packages.  (The builders take CIFAR depths up to 28 pixels;
    at 3x28x28 the JAX package's first-step gradients differ from an f64
    evaluation by up to 3.4%, where the port's agree with it within
    3e-5: ROADMAP R5.)
    Returns per-package (per-batch losses, arg params, aux params)."""
    sym_j = resnet_j.get_symbol(10, 20, "3,24,24", dtype=dtype)
    sym_t = resnet_t.get_symbol(10, 20, "3,24,24", dtype=dtype)
    shapes = {"data": (4, 3, 24, 24), "softmax_label": (4,)}
    args, auxs = _init(sym_j, shapes, 11)
    r = np.random.RandomState(12)
    x = r.rand(8, 3, 24, 24).astype(np.float32)
    y = r.randint(0, 10, 8).astype(np.float32)
    kw = dict(num_epoch=epochs, optimizer_params={
        "learning_rate": LR, "momentum": 0.9, "wd": 1e-4,
        "multi_precision": True})
    arg_types = dict(zip(sym_t.list_arguments(),
                         sym_t.infer_type(data="float32")[0]))
    out = {}
    for mx, sym in ((mj, sym_j), (mt, sym_t)):
        losses = []

        def on_batch(param, losses=losses):
            prob = param.locals["self"].get_outputs()[0].asnumpy()
            lab = param.locals["batch"].label[0].asnumpy().astype(int)
            losses.append(float(-np.log(prob[np.arange(len(lab)), lab]
                                        + 1e-12).mean()))

        mod = mx.mod.Module(sym, context=mx.cpu())
        arg_p = {k: mx.nd.array(v, ctx=mx.cpu()).astype(
            mt.base.dtype_name(arg_types[k]))
                 for k, v in args.items()}
        aux_p = {k: mx.nd.array(v, ctx=mx.cpu()) for k, v in auxs.items()}
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=4), arg_params=arg_p,
                aux_params=aux_p, batch_end_callback=on_batch, **kw)
        assert mod._fused_step is not None and mod._fused_step.ran
        a, x_ = mod.get_params()
        out[mx] = (losses, {k: v.asnumpy().astype(np.float32)
                            for k, v in a.items()},
                   {k: v.asnumpy() for k, v in x_.items()})
    return args, out


def test_resnet_fit_fused_f32_matches_jax():
    """f32: one epoch of two batches, as
    test_module_fit_resnet18_matches_reference, at its tolerance: losses,
    parameters and moving statistics within atol 2e-5, rtol 1e-4 (two SGD
    steps of f32 arithmetic in another order)."""
    args, out = _resnet_fit("float32", epochs=1)
    (lj, aj, xj), (lt, at, xt) = out[mj], out[mt]
    assert len(lt) == len(lj) == 2 and np.all(np.isfinite(lt))
    np.testing.assert_allclose(lt, lj, rtol=1e-4, atol=2e-5)
    for k in aj:
        np.testing.assert_allclose(at[k], aj[k], atol=2e-5, rtol=1e-4,
                                   err_msg=k)
    for k in xj:
        np.testing.assert_allclose(xt[k], xj[k], atol=2e-5, rtol=1e-4,
                                   err_msg=k)
    assert max(float(np.abs(aj[k] - args[k]).max()) for k in args) > 1e-3


def test_resnet_fit_fused_bf16_losses_match_jax():
    """bf16 with f32 masters: per-batch losses within 5e-2 of the JAX
    package's (its own bf16-consistency tolerance), every loss finite,
    conv/FC storage bf16."""
    _, out = _resnet_fit("bfloat16")
    lj, lt = out[mj][0], out[mt][0]
    assert len(lt) == len(lj) == 4 and np.all(np.isfinite(lt))
    np.testing.assert_allclose(lt, lj, rtol=5e-2, atol=5e-2)

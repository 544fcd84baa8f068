"""The port's training stack against the JAX package's.

Executor backward (grad_req write/add/null) and the BatchNorm aux
write-back, SGD with momentum and its weight-decay names, the
initializer's name rules, Accuracy/CrossEntropy, NDArrayIter, the
ResNet-50 v2 symbol, and ``Module.fit`` of a ResNet-18 and of a small
conv net in both packages from the same numpy weights.  Inputs come from
numpy seeds; each test states its tolerance.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu.models import resnet as resnet_j
from mxnet_tpu_torch.models import resnet as resnet_t


def _small_net(sym):
    net = sym.Convolution(sym.Variable("data"), kernel=(3, 3),
                          num_filter=4, pad=(1, 1), name="conv1")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = sym.Flatten(net, name="flat1")
    net = sym.FullyConnected(net, num_hidden=3, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")


def _init(sym, shapes, seed):
    """He-scaled weights, gamma near 1, small beta/bias, unit moving
    variance: a well-conditioned start (see PERF.md on BatchNorm's one-pass
    formulas at badly scaled inputs)."""
    r = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args = {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n in shapes:
            continue
        if n.endswith("_gamma"):
            args[n] = (1 + 0.1 * r.randn(*s)).astype(np.float32)
        elif n.endswith(("_beta", "_bias")):
            args[n] = (0.1 * r.randn(*s)).astype(np.float32)
        else:
            args[n] = (r.randn(*s) * np.sqrt(2.0 / np.prod(s[1:]))).astype(
                np.float32)
    auxs = {n: (r.rand(*s) * 0.1 + (1.0 if n.endswith("var") else 0.0))
            .astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return args, auxs


SHAPES = {"data": (4, 3, 6, 6), "softmax_label": (4,)}


def _bind_both(grad_req):
    sj, st = _small_net(mj.sym), _small_net(mt.sym)
    args, auxs = _init(sj, SHAPES, 0)
    r = np.random.RandomState(1)
    feed = {"data": r.rand(*SHAPES["data"]).astype(np.float32),
            "softmax_label": np.array([0, 2, 1, 2], np.float32)}
    ej = sj.simple_bind(mj.cpu(), grad_req=grad_req, **SHAPES)
    et = st.simple_bind(mt.cpu(), grad_req=grad_req, **SHAPES)
    for name, value in dict(args, **feed).items():
        ej.arg_dict[name][:] = value
        mt.nd.array(value, ctx=mt.cpu()).copyto(et.arg_dict[name])
    for name, value in auxs.items():
        ej.aux_dict[name][:] = value
        mt.nd.array(value, ctx=mt.cpu()).copyto(et.aux_dict[name])
    return ej, et


@pytest.mark.parametrize("req", ["write", "add", "null"])
def test_executor_backward_matches(req):
    """Gradients at atol=rtol=1e-5; 'add' accumulates two backwards;
    'null' allocates no gradients."""
    ej, et = _bind_both(req)
    for exe in (ej, et):
        exe.forward(is_train=True)
        exe.backward()
        if req == "add":
            exe.backward()
    np.testing.assert_allclose(et.outputs[0].asnumpy(),
                               ej.outputs[0].asnumpy(), atol=1e-5, rtol=1e-5)
    if req == "null":
        assert et.grad_dict == {} and ej.grad_dict == {}
        return
    assert sorted(et.grad_dict) == sorted(ej.grad_dict)
    for name in ej.grad_dict:
        np.testing.assert_allclose(et.grad_dict[name].asnumpy(),
                                   ej.grad_dict[name].asnumpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


def test_train_forward_writes_moving_stats_back():
    """is_train=True advances moving_mean/var (atol 1e-6); is_train=False
    leaves them alone; backward after the write-back still differentiates
    the forward that ran."""
    ej, et = _bind_both("write")
    before = et.aux_dict["bn1_moving_mean"].asnumpy().copy()
    for exe in (ej, et):
        exe.forward(is_train=False)
    np.testing.assert_array_equal(et.aux_dict["bn1_moving_mean"].asnumpy(),
                                  before)
    for exe in (ej, et):
        exe.forward_backward()
    for name in ("bn1_moving_mean", "bn1_moving_var"):
        np.testing.assert_allclose(et.aux_dict[name].asnumpy(),
                                   ej.aux_dict[name].asnumpy(), atol=1e-6)
    assert not np.array_equal(et.aux_dict["bn1_moving_mean"].asnumpy(),
                              before)
    np.testing.assert_allclose(et.grad_dict["conv1_weight"].asnumpy(),
                               ej.grad_dict["conv1_weight"].asnumpy(),
                               atol=1e-5, rtol=1e-5)


def test_backward_needs_a_training_forward():
    """A backward after a forward that did not train runs the forward
    again in training mode, as the JAX package does: gradients within
    atol=rtol=1e-5 of its, outputs and moving statistics left as the
    inference forward gave them."""
    ej, et = _bind_both("write")
    before = et.aux_dict["bn1_moving_mean"].asnumpy().copy()
    for exe in (ej, et):
        exe.forward(is_train=False)
    out = et.outputs[0].asnumpy().copy()
    for exe in (ej, et):
        exe.backward()
    np.testing.assert_array_equal(et.outputs[0].asnumpy(), out)
    np.testing.assert_array_equal(et.aux_dict["bn1_moving_mean"].asnumpy(),
                                  before)
    for name in ej.grad_dict:
        np.testing.assert_allclose(et.grad_dict[name].asnumpy(),
                                   ej.grad_dict[name].asnumpy(),
                                   atol=1e-5, rtol=1e-5, err_msg=name)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
def test_sgd_updates_match(momentum):
    """Three updates of random gradients with rescale_grad, clipping, wd
    and per-name wd_mult: weights within 1e-6."""
    names = ["fc_weight", "fc_bias", "bn_gamma", "bn_beta"]
    idx2name = dict(enumerate(names))
    kw = dict(learning_rate=0.1, momentum=momentum, wd=0.01,
              rescale_grad=0.5, clip_gradient=0.8, param_idx2name=idx2name)
    oj, ot = mj.optimizer.create("sgd", **kw), mt.optimizer.create("sgd", **kw)
    assert oj.wd_mult == ot.wd_mult == {"fc_bias": 0.0, "bn_beta": 0.0}
    uj, ut = mj.optimizer.get_updater(oj), mt.optimizer.get_updater(ot)
    r = np.random.RandomState(2)
    weights = {i: r.randn(3, 4).astype(np.float32) for i in idx2name}
    wj = {i: mj.nd.array(w) for i, w in weights.items()}
    wt = {i: mt.nd.array(w, ctx=mt.cpu()) for i, w in weights.items()}
    for _ in range(3):
        for i in idx2name:
            g = r.randn(3, 4).astype(np.float32) * 2
            uj(i, mj.nd.array(g), wj[i])
            ut(i, mt.nd.array(g, ctx=mt.cpu()), wt[i])
    for i in idx2name:
        np.testing.assert_allclose(wt[i].asnumpy(), wj[i].asnumpy(),
                                   atol=1e-6, rtol=1e-6)


def test_wd_mult_names_of_resnet():
    sym = resnet_t.get_symbol(10, 18, "3,40,40")
    names = [n for n in sym.list_arguments()
             if n not in ("data", "softmax_label")]
    kw = dict(param_idx2name=dict(enumerate(names)), wd=1e-4)
    assert mt.optimizer.create("sgd", **kw).wd_mult == \
        mj.optimizer.create("sgd", **kw).wd_mult


@pytest.mark.parametrize("name,value", [
    ("conv0_weight", None), ("fc1_bias", 0.0), ("bn0_gamma", 1.0),
    ("bn0_beta", 0.0), ("bn0_moving_mean", 0.0), ("bn0_moving_var", 1.0)])
def test_initializer_name_rules(name, value):
    """Xavier's name rules in both packages: constants exactly, and the
    weight rule's spread within 5% of its target std sqrt(2 / fan_in)."""
    shape = (64, 32, 3, 3) if name.endswith("weight") else (64,)
    init_t = mt.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2)
    init_j = mj.initializer.Xavier(rnd_type="gaussian", factor_type="in",
                                   magnitude=2)
    at = mt.nd.zeros(shape, mt.cpu())
    aj = mj.nd.zeros(shape)
    init_t(mt.initializer.InitDesc(name), at)
    init_j(mj.initializer.InitDesc(name), aj)
    if value is None:
        want = np.sqrt(2.0 / (32 * 9))
        for arr in (at, aj):
            assert abs(arr.asnumpy().std() / want - 1) < 0.05
    else:
        np.testing.assert_array_equal(at.asnumpy(), aj.asnumpy())
        assert (at.asnumpy() == value).all()


def test_initializer_constants_and_seed():
    for make in (lambda m: m.initializer.Constant(0.25),
                 lambda m: m.initializer.One(),
                 lambda m: m.initializer.Zero()):
        at, aj = mt.nd.zeros((3, 2), mt.cpu()), mj.nd.zeros((3, 2))
        make(mt)("w_weight", at)
        make(mj)("w_weight", aj)
        np.testing.assert_array_equal(at.asnumpy(), aj.asnumpy())
    draws = []
    for _ in range(2):
        mt.random.seed(7)
        arr = mt.nd.zeros((4, 4), mt.cpu())
        mt.initializer.Uniform(0.1)("u_weight", arr)
        draws.append(arr.asnumpy())
    np.testing.assert_array_equal(*draws)
    assert np.abs(draws[0]).max() <= 0.1
    assert isinstance(mt.initializer.create("normal", sigma=0.5),
                      mt.initializer.Normal)


def test_metrics_match():
    r = np.random.RandomState(3)
    prob = r.rand(8, 5).astype(np.float32)
    prob /= prob.sum(1, keepdims=True)
    label = r.randint(0, 5, 8).astype(np.float32)
    for name in ("acc", "ce"):
        mtm, mjm = mt.metric.create(name), mj.metric.create(name)
        for _ in range(2):
            mtm.update([mt.nd.array(label, ctx=mt.cpu())],
                       [mt.nd.array(prob, ctx=mt.cpu())])
            mjm.update([mj.nd.array(label)], [mj.nd.array(prob)])
        assert mtm.get()[0] == mjm.get()[0]
        np.testing.assert_allclose(mtm.get()[1], mjm.get()[1], rtol=1e-6)
    comp = mt.metric.create(["acc", "ce"])
    comp.update([mt.nd.array(label, ctx=mt.cpu())],
                [mt.nd.array(prob, ctx=mt.cpu())])
    assert comp.get()[0] == ["accuracy", "cross-entropy"]


@pytest.mark.parametrize("handle", ["pad", "discard", "roll_over"])
def test_ndarray_iter_matches(handle):
    r = np.random.RandomState(4)
    x = r.rand(10, 3).astype(np.float32)
    y = np.arange(10, dtype=np.float32)
    it_t = mt.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
    it_j = mj.io.NDArrayIter(x, y, batch_size=4, last_batch_handle=handle)
    assert [(d.name, d.shape) for d in it_t.provide_data] == \
        [(d.name, d.shape) for d in it_j.provide_data]
    assert [(d.name, d.shape) for d in it_t.provide_label] == \
        [(d.name, d.shape) for d in it_j.provide_label]
    for epoch in range(2):
        got = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
               for b in it_t]
        want = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                for b in it_j]
        assert len(got) == len(want)
        for (gd, gl, gp), (wd, wl, wp) in zip(got, want):
            np.testing.assert_array_equal(gd, wd)
            np.testing.assert_array_equal(gl, wl)
            assert gp == wp
        it_t.reset()
        it_j.reset()


def test_resnet50_symbol_matches():
    # fresh auto-name counters: the unnamed stem pool is "pooling0" in both
    with mt.sym.NameManager():
        st = resnet_t.get_symbol(1000, 50, "3,224,224")
    with mj.NameManager():
        sj = resnet_j.get_symbol(1000, 50, "3,224,224")
    assert st.list_arguments() == sj.list_arguments()
    assert st.list_auxiliary_states() == sj.list_auxiliary_states()
    assert st.list_outputs() == sj.list_outputs()
    ops_t = [(n.op_name, n.name) for n in st._topo() if not n.is_var]
    ops_j = [(n.op_name, n.name) for n in sj._topo() if not n.is_var]
    assert ops_t == ops_j
    assert sum(op == "BatchNorm" for op, _ in ops_t) == 51
    for got, want in zip(st.infer_shape(data=(32, 3, 224, 224)),
                         sj.infer_shape(data=(32, 3, 224, 224))):
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
    assert mt.sym.load_json(sj.tojson()).list_arguments() == \
        st.list_arguments()


def test_params_from_numpy_splits_resnet_aux():
    sym = resnet_t.get_symbol(10, 18, "3,40,40")
    args, auxs = _init(sym, {"data": (2, 3, 40, 40),
                             "softmax_label": (2,)}, 5)
    blob = dict({"arg:" + k: v for k, v in args.items()},
                **{"aux:" + k: v for k, v in auxs.items()})
    arg_p, aux_p = mt.convert.params_from_numpy(blob, mt.cpu())
    assert sorted(arg_p) == sorted(args)
    assert sorted(aux_p) == sorted(sym.list_auxiliary_states())
    assert all(np.array_equal(aux_p[k].asnumpy(), auxs[k]) for k in auxs)


def _fit_both(sym_j, sym_t, shapes, x, y, batch):
    args, auxs = _init(sym_j, shapes, 6)
    kw = dict(num_epoch=1, optimizer_params={
        "learning_rate": 0.05, "momentum": 0.9, "wd": 1e-4})
    mod_j = mj.mod.Module(sym_j, context=mj.cpu())
    mod_j.fit(mj.io.NDArrayIter(x, y, batch_size=batch),
              arg_params={k: mj.nd.array(v) for k, v in args.items()},
              aux_params={k: mj.nd.array(v) for k, v in auxs.items()}, **kw)
    arg_p, aux_p = mt.convert.params_from_numpy(
        dict(args, **{"aux:" + k: v for k, v in auxs.items()}), mt.cpu())
    mod_t = mt.mod.Module(sym_t, context=mt.cpu())
    mod_t.fit(mt.io.NDArrayIter(x, y, batch_size=batch), arg_params=arg_p,
              aux_params=aux_p, **kw)
    return args, auxs, mod_j.get_params(), mod_t.get_params()


def _assert_fit_agrees(args, auxs, params_j, params_t):
    """Parameters and moving stats at atol=2e-5, rtol=1e-4 (two SGD steps
    of f32 arithmetic in another order), and the updates were real."""
    (aj, xj), (at, xt) = params_j, params_t
    assert sorted(at) == sorted(aj) and sorted(xt) == sorted(xj)
    moved = 0.0
    for k in args:
        np.testing.assert_allclose(at[k].asnumpy(), aj[k].asnumpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
        moved = max(moved, float(np.abs(aj[k].asnumpy() - args[k]).max()))
    for k in auxs:
        np.testing.assert_allclose(xt[k].asnumpy(), xj[k].asnumpy(),
                                   atol=2e-5, rtol=1e-4, err_msg=k)
    assert moved > 1e-3


def test_module_fit_resnet18_matches_reference():
    """The whole slice: Module.fit of ResNet-18 v2 at 3x40x40, batch 2, two
    batches, in both packages from the same weights (the JAX side on its
    default CPU path)."""
    r = np.random.RandomState(7)
    x = r.rand(4, 3, 40, 40).astype(np.float32)
    y = r.randint(0, 10, 4).astype(np.float32)
    shapes = {"data": (2, 3, 40, 40), "softmax_label": (2,)}
    _assert_fit_agrees(*_fit_both(resnet_j.get_symbol(10, 18, "3,40,40"),
                                  resnet_t.get_symbol(10, 18, "3,40,40"),
                                  shapes, x, y, 2))


def test_module_fit_small_convnet_matches_reference_kernels(monkeypatch):
    """The same with the JAX package's pool and bn Pallas kernels in
    interpret mode inside its fused train step."""
    monkeypatch.setenv("MXNET_TPU_PALLAS_POOL", "1")
    monkeypatch.setenv("MXNET_TPU_PALLAS_BN", "1")
    r = np.random.RandomState(8)
    x = r.rand(8, 3, 6, 6).astype(np.float32)
    y = r.randint(0, 3, 8).astype(np.float32)
    _assert_fit_agrees(*_fit_both(_small_net(mj.sym), _small_net(mt.sym),
                                  SHAPES, x, y, 4))


def test_module_refuses_a_kvstore_it_does_not_have():
    """An unknown store name raises where a store is made (several
    contexts); one context with a known local store updates locally, as
    the JAX package does."""
    mod = mt.mod.Module(_small_net(mt.sym), context=[mt.cpu(0), mt.cpu(1)])
    mod.bind([("data", (4, 3, 6, 6))], [("softmax_label", (4,))])
    mod.init_params(mt.initializer.Xavier())
    with pytest.raises(mt.MXNetError):
        mod.init_optimizer(kvstore="no_such_store")
    mod.init_optimizer(kvstore=None)
    assert mod.optimizer_initialized and mod._kvstore is None
    one = mt.mod.Module(_small_net(mt.sym), context=mt.cpu())
    one.bind([("data", (4, 3, 6, 6))], [("softmax_label", (4,))])
    one.init_params(mt.initializer.Xavier())
    one.init_optimizer(kvstore="device")
    assert one._kvstore is None and one._update_on_kvstore is False

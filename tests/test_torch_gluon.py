"""The port's Gluon pieces (``mxnet_tpu_torch``: autograd, NDArray ops,
Parameter/ParameterDict, Block naming, layers, losses, Adam, Trainer,
utils, Perplexity, ``convert.set_gluon_params``) against the JAX package,
on the CPU, from seeded numpy inputs.

Tolerances: f32 forward values and gradients atol=rtol=1e-5 (XLA:CPU and
torch sum in other orders); optimizer updates atol=rtol=1e-6 (the same
elementwise formula in the same order); names, shapes, JSON and saved
bytes exactly.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.symbol import NameManager

TOL = dict(atol=1e-5, rtol=1e-5)
PKGS = ((mx, NameManager), (jmx, JNameManager))


def _arr(pkg, a):
    return pkg.nd.array(np.asarray(a, np.float32), ctx=pkg.cpu())


@pytest.mark.parametrize("req", ["write", "add"])
def test_autograd_grad_req_write_and_add(req):
    x0 = np.random.RandomState(0).normal(size=(3, 4)).astype(np.float32)
    grads = []
    for pkg, _ in PKGS:
        x = _arr(pkg, x0)
        x.attach_grad(grad_req=req)
        for _ in range(2):
            with pkg.autograd.record():
                y = x * x * 2.0 + x
            y.backward()
        grads.append(x.grad.asnumpy())
    want = (4 * x0 + 1) * (2 if req == "add" else 1)
    np.testing.assert_allclose(grads[0], want, **TOL)
    np.testing.assert_allclose(grads[0], grads[1], **TOL)


def test_autograd_scopes_and_grad():
    from mxnet_tpu_torch import autograd
    assert not autograd.is_recording() and not autograd.is_training()
    with autograd.record():
        assert autograd.is_recording() and autograd.is_training()
        with autograd.pause():
            assert not autograd.is_recording()
        with autograd.predict_mode():
            assert not autograd.is_training()
    with autograd.train_mode():
        assert autograd.is_training() and not autograd.is_recording()
    x = _arr(mx, [1.0, 2.0, 3.0])
    x.attach_grad()
    with autograd.record():
        y = (x * x).sum()
        with autograd.pause():
            z = x * 3.0  # not recorded
    assert not z.tensor.requires_grad
    (g,) = [autograd.grad(y, [x])[0]]
    np.testing.assert_allclose(g.asnumpy(), [2.0, 4.0, 6.0])
    assert not x.grad.asnumpy().any()  # grad() leaves the buffer alone
    with pytest.raises(mx.MXNetError):
        z.backward()


def test_backward_with_head_gradient_and_unreached_variable():
    outs = []
    for pkg, _ in PKGS:
        a, b = _arr(pkg, [1.0, -2.0]), _arr(pkg, [5.0, 5.0])
        a.attach_grad()
        b.attach_grad()
        b.grad[:] = 7.0
        with pkg.autograd.record():
            y = a * 3.0
        y.backward(_arr(pkg, [10.0, 100.0]))
        outs.append((a.grad.asnumpy(), b.grad.asnumpy()))
    for got, want in zip(outs[0], outs[1]):
        np.testing.assert_allclose(got, want)
    np.testing.assert_allclose(outs[0][0], [30.0, 300.0])


@pytest.mark.parametrize("op", ["pick", "mean_exclude", "reshape",
                                "log_softmax", "scalar_ops", "sum_keep"])
def test_imperative_ops_match(op):
    r = np.random.RandomState(1)
    x0 = r.normal(size=(2, 3, 5)).astype(np.float32)
    idx = r.randint(0, 5, (2, 3)).astype(np.float32)
    outs = []
    for pkg, _ in PKGS:
        x = _arr(pkg, x0)
        x.attach_grad()
        with pkg.autograd.record():
            if op == "pick":
                y = pkg.nd.pick(x, _arr(pkg, idx), axis=-1, keepdims=True)
            elif op == "mean_exclude":
                y = pkg.nd.mean(x, axis=0, exclude=True)
            elif op == "reshape":
                y = pkg.nd.Reshape(x, shape=(0, -3)) * 2.0
            elif op == "log_softmax":
                y = pkg.nd.log_softmax(x, axis=-1)
            elif op == "scalar_ops":
                y = (1.0 - x) / 2.0 + 3.0 * (x - 0.5) - (2.0 / (x * x + 1.0))
            else:
                y = pkg.nd.sum(x, axis=(0, 2), keepdims=True)
        y.backward(_arr(pkg, np.linspace(-1, 1, int(np.prod(y.shape)))
                        .reshape(y.shape)))
        outs.append((y.asnumpy(), x.grad.asnumpy()))
    for got, want in zip(outs[0], outs[1]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def _small_net(pkg, names):
    gl = pkg.gluon
    with names():
        net = gl.nn.HybridSequential()
        with net.name_scope():
            net.add(gl.nn.Embedding(11, 8))
            net.add(gl.nn.Dense(16, flatten=False, activation="relu"))
            net.add(gl.nn.LayerNorm())
            net.add(gl.nn.Dropout(0.0))
            net.add(gl.nn.Dense(6, flatten=False))
    return net


def test_parameter_names_and_shapes_match():
    tables = []
    for pkg, names in PKGS:
        net = _small_net(pkg, names)
        net.initialize(ctx=pkg.cpu())
        net(_arr(pkg, np.zeros((2, 4))))
        tables.append({k: tuple(p.shape)
                       for k, p in net.collect_params().items()})
    assert list(tables[0]) == list(tables[1])
    assert tables[0] == tables[1]
    assert "hybridsequential0_dense0_weight" in tables[0]


def _numpy_params(net):
    r = np.random.RandomState(3)
    return {k: (1.0 + 0.1 * r.standard_normal(p.shape) if k.endswith("gamma")
                else 0.3 * r.standard_normal(p.shape)).astype(np.float32)
            for k, p in net.collect_params().items()}


@pytest.mark.parametrize("hybridize", [False, True])
def test_layers_forward_and_backward_match(hybridize):
    tokens = np.random.RandomState(4).randint(0, 11, (2, 4)).astype(
        np.float32)
    weights, outs = None, []
    for pkg, names in PKGS:
        net = _small_net(pkg, names)
        net.initialize(ctx=pkg.cpu())
        net(_arr(pkg, tokens))
        if weights is None:
            weights = _numpy_params(net)
        for k, p in net.collect_params().items():
            p.set_data(_arr(pkg, weights[k]))
        if hybridize:
            net.hybridize()
        with pkg.autograd.record():
            y = net(_arr(pkg, tokens))
            s = (y * y).sum()
        s.backward()
        outs.append((y.asnumpy(), {k: p.grad().asnumpy()
                                   for k, p in net.collect_params().items()}))
    np.testing.assert_allclose(outs[0][0], outs[1][0], **TOL)
    for k in weights:
        np.testing.assert_allclose(outs[0][1][k], outs[1][1][k], err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("kind", ["sparse", "dense", "from_logits",
                                  "sample_weight", "l2", "l1"])
def test_losses_match(kind):
    r = np.random.RandomState(5)
    pred0 = r.normal(size=(3, 4, 7)).astype(np.float32)
    sparse = r.randint(0, 7, (3, 4)).astype(np.float32)
    dense = r.dirichlet(np.ones(7), (3, 4)).astype(np.float32)
    sw = r.uniform(size=(3, 1, 1)).astype(np.float32)
    outs = []
    for pkg, _ in PKGS:
        L = pkg.gluon.loss
        pred = _arr(pkg, pred0)
        pred.attach_grad()
        args = []
        if kind in ("sparse", "sample_weight"):
            fn, args = L.SoftmaxCrossEntropyLoss(), [_arr(pkg, sparse)]
            if kind == "sample_weight":
                args.append(_arr(pkg, sw))
        elif kind == "dense":
            fn = L.SoftmaxCrossEntropyLoss(sparse_label=False)
            args = [_arr(pkg, dense)]
        elif kind == "from_logits":
            fn = L.SoftmaxCrossEntropyLoss(from_logits=True)
            args = [_arr(pkg, sparse)]
        elif kind == "l2":
            fn, args = L.L2Loss(weight=3.0), [_arr(pkg, dense)]
        else:
            fn, args = L.L1Loss(), [_arr(pkg, dense)]
        with pkg.autograd.record():
            loss = fn(pred, *args)
        loss.backward()
        outs.append((loss.asnumpy(), pred.grad.asnumpy()))
    assert outs[0][0].shape == (3,)
    for got, want in zip(outs[0], outs[1]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("cfg", [
    dict(learning_rate=0.01),
    dict(learning_rate=0.05, wd=0.1, clip_gradient=0.3),
    dict(learning_rate=0.02, beta1=0.8, beta2=0.99, rescale_grad=0.5),
], ids=["plain", "wd-clip", "betas-rescale"])
def test_adam_three_steps_match(cfg):
    r = np.random.RandomState(6)
    w0 = r.normal(size=(5, 3)).astype(np.float32)
    grads = [r.normal(size=(5, 3)).astype(np.float32) for _ in range(3)]
    finals = []
    for pkg, _ in PKGS:
        opt = pkg.optimizer.create("adam", **cfg)
        upd = pkg.optimizer.get_updater(opt)
        w = _arr(pkg, w0)
        for g in grads:
            upd(0, _arr(pkg, g), w)
        finals.append(w.asnumpy())
    np.testing.assert_allclose(finals[0], finals[1], atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_trainer_step_matches(opt):
    params = dict(learning_rate=0.1, wd=0.01)
    if opt == "sgd":
        params["momentum"] = 0.9
    r = np.random.RandomState(7)
    x0 = r.normal(size=(4, 5)).astype(np.float32)
    y0 = r.randint(0, 3, (4,)).astype(np.float32)
    finals, lr = [], []
    for pkg, names in PKGS:
        gl = pkg.gluon
        with names():
            net = gl.nn.Dense(3, in_units=5)
        net.initialize(pkg.initializer.Constant(0.0), ctx=pkg.cpu())
        net.weight.set_data(_arr(pkg, r.normal(size=(3, 5)) * 0 + 0.2))
        net.bias.lr_mult = 0.5
        trainer = gl.Trainer(net.collect_params(), opt, dict(params))
        loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
        for _ in range(3):
            with pkg.autograd.record():
                loss = loss_fn(net(_arr(pkg, x0)), _arr(pkg, y0))
            loss.backward()
            trainer.step(4)
        trainer.set_learning_rate(0.05)
        lr.append(trainer.learning_rate)
        finals.append({k: p.data().asnumpy()
                       for k, p in net.collect_params().items()})
    assert lr == [0.05, 0.05]
    for k in finals[1]:
        np.testing.assert_allclose(finals[0][k], finals[1][k], err_msg=k,
                                   **TOL)


def test_trainer_states_round_trip(tmp_path):
    from mxnet_tpu_torch import autograd, gluon
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=mx.cpu())
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": 0.1})
    x = _arr(mx, np.ones((2, 3)))

    def step(tr):
        with autograd.record():
            loss = (net(x) * net(x)).sum()
        loss.backward()
        tr.step(2)

    step(trainer)
    trainer.save_states(str(tmp_path / "s"))
    snapshot = {k: p.data().asnumpy() for k, p in
                net.collect_params().items()}
    step(trainer)
    after_two = {k: p.data().asnumpy() for k, p in
                 net.collect_params().items()}
    for k, p in net.collect_params().items():
        p.set_data(_arr(mx, snapshot[k]))
    fresh = gluon.Trainer(net.collect_params(), "adam",
                          {"learning_rate": 0.1})
    fresh.load_states(str(tmp_path / "s"))
    step(fresh)
    for k, p in net.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), after_two[k])


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_params_files_round_trip(direction, tmp_path):
    nets = []
    for pkg, names in PKGS:
        net = _small_net(pkg, names)
        net.initialize(ctx=pkg.cpu())
        net(_arr(pkg, np.zeros((2, 4))))
        nets.append(net)
    src, dst = nets if direction == "port_to_jax" else nets[::-1]
    weights = _numpy_params(src)
    src_pkg = mx if src is nets[0] else jmx
    for k, p in src.collect_params().items():
        p.set_data(_arr(src_pkg, weights[k]))
    path = str(tmp_path / "net.params")
    src.save_params(path)
    dst.load_params(path)
    for k, p in dst.collect_params().items():
        np.testing.assert_array_equal(p.data().asnumpy(), weights[k])


def test_set_gluon_params_from_jax_numpy_and_files(tmp_path):
    jnet = _small_net(jmx, JNameManager)
    jnet.initialize(ctx=jmx.cpu())
    tokens = np.random.RandomState(8).randint(0, 11, (2, 4)).astype(
        np.float32)
    want = jnet(_arr(jmx, tokens)).asnumpy()
    arrays = {k: p.data().asnumpy() for k, p in
              jnet.collect_params().items()}
    jnet.hybridize()
    jnet(_arr(jmx, tokens))
    jnet.export(str(tmp_path / "j"))
    jnet.save_params(str(tmp_path / "j.params"))
    for source in (arrays, str(tmp_path / "j-0000.params"),
                   str(tmp_path / "j.params")):
        net = _small_net(mx, NameManager)  # deferred: no forward yet
        mx.convert.set_gluon_params(net, source, ctx=mx.cpu())
        np.testing.assert_allclose(net(_arr(mx, tokens)).asnumpy(), want,
                                   **TOL)
    with pytest.raises(mx.MXNetError):
        mx.convert.set_gluon_params(_small_net(mx, NameManager),
                                    {"nope": np.zeros(1)}, ctx=mx.cpu())


def test_utils_and_perplexity_match():
    r = np.random.RandomState(9)
    arrays = [r.normal(size=s).astype(np.float32) for s in ((3, 4), (5,))]
    probs = r.dirichlet(np.ones(6), (2, 5)).astype(np.float32)
    labels = np.array([[0, 1, 2, 3, 4], [5, 1, 0, 2, 2]], np.float32)
    res = []
    for pkg, _ in PKGS:
        nds = [_arr(pkg, a) for a in arrays]
        norm = pkg.gluon.utils.clip_global_norm(nds, 1.0)
        parts = pkg.gluon.utils.split_and_load(
            _arr(pkg, np.arange(12).reshape(6, 2)), [pkg.cpu()])
        metric = pkg.metric.Perplexity(ignore_label=0)
        metric.update([_arr(pkg, labels)], [_arr(pkg, probs)])
        res.append((norm, [a.asnumpy() for a in nds],
                    [p.asnumpy() for p in parts], metric.get()[1]))
    assert abs(res[0][0] - res[1][0]) < 1e-4
    for a, b in zip(res[0][1] + res[0][2], res[1][1] + res[1][2]):
        np.testing.assert_allclose(a, b, **TOL)
    assert abs(res[0][3] - res[1][3]) < 1e-4 * res[1][3]


def test_ndarray_surface_matches():
    r = np.random.RandomState(11)
    x0 = r.normal(size=(4, 6)).astype(np.float32)
    outs = []
    for pkg, _ in PKGS:
        x = _arr(pkg, x0)
        x.attach_grad()
        with pkg.autograd.record():
            y = (x[1:3] * 2.0).reshape((3, 4)).sum()
        y.backward()
        z = _arr(pkg, x0)
        z[0] = 5.0
        z[2:4] = _arr(pkg, np.ones((2, 6)))
        z[:, 1] = 0.0
        made = [pkg.nd.ones((2, 3), ctx=pkg.cpu()),
                pkg.nd.full((2, 3), 7.0, ctx=pkg.cpu()),
                pkg.nd.zeros((2, 3), ctx=pkg.cpu())]
        assert pkg.nd.empty((2, 3), ctx=pkg.cpu()).shape == (2, 3)
        pkg.nd.waitall()
        cast = x.astype("float64")
        outs.append([y.asnumpy(), z.asnumpy(), cast.asnumpy()]
                    + [m.asnumpy() for m in made])
        assert np.dtype(cast.dtype) == np.float64
        grads = x.grad.asnumpy()
    for got, want in zip(*outs):
        np.testing.assert_allclose(got, want, **TOL)
    # a slice read under record() is on the port's tape (torch records
    # the view); the JAX package's __getitem__ leaves the tape, so its
    # gradient is 0 there: an intended difference (ROADMAP C)
    assert not grads.any()
    want = np.zeros_like(x0)
    want[1:3] = 2.0
    x = _arr(mx, x0)
    x.attach_grad()
    with mx.autograd.record():
        y = (x[1:3] * 2.0).reshape((3, 4)).sum()
    y.backward()
    np.testing.assert_array_equal(x.grad.asnumpy(), want)


def test_hybridized_losses_match_imperative():
    from mxnet_tpu_torch import autograd, gluon
    r = np.random.RandomState(12)
    pred0 = r.normal(size=(3, 5)).astype(np.float32)
    label0 = r.normal(size=(3, 5)).astype(np.float32)
    res = []
    for hybrid in (False, True):
        fn = gluon.loss.L2Loss(weight=2.0)
        if hybrid:
            fn.hybridize()
        pred = _arr(mx, pred0)
        pred.attach_grad()
        with autograd.record():
            loss = fn(pred, _arr(mx, label0))
        loss.backward()
        res.append((loss.asnumpy(), pred.grad.asnumpy()))
    for got, want in zip(*res):
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-7)


def test_trainer_over_two_contexts_raises():
    from mxnet_tpu_torch import gluon
    net = gluon.nn.Dense(2, in_units=3)
    net.initialize(ctx=[mx.cpu(0), mx.cpu(1)])
    with pytest.raises(mx.MXNetError):
        gluon.Trainer(net.collect_params(), "sgd")

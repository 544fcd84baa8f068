"""``mx.operator``'s ``Custom`` op against the JAX package's, on the CPU.

- ``testsquare`` (the JAX package's ``tests/test_contrib_custom.py``
  case) forward and gradient, exact in both;
- MXNet 1.0's ``example/numpy-ops/custom_softmax.py`` MLP, cut to
  784 -> 32 -> 16 -> 10 at batch 20, three SGD steps through ``Module`` in
  both packages from the same seeded parameters: parameters within 1e-5
  relative of each other and of the built-in ``SoftmaxOutput``'s run;
- ``mx.sym.Custom``'s arguments and inferred shapes are equal, and an
  unregistered ``op_type`` raises in both.

The example runs with the changes the JAX package's contract forces
(ROADMAP R17): the label variable passed to ``Custom`` explicitly,
``np.asarray(in_data[i])`` in place of ``in_data[i].asnumpy()``, and
``register_op`` (the JAX package's ``operator.register`` is its op
registry's, which registers no prop).
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

REL = 1e-5
SIZES = (784, 32, 16, 10)
BATCH = 20
STEPS = 3
SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 0.00001}


def _register_square(pkg):
    @pkg.operator.register_op("testsquare")
    class SquareProp(pkg.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            class Op(pkg.operator.CustomOp):
                def forward(self, is_train, req, in_data, out_data, aux):
                    self.assign(out_data[0], req[0], in_data[0] ** 2)

                def backward(self, req, out_grad, in_data, out_data,
                             in_grad, aux):
                    self.assign(in_grad[0], req[0],
                                2 * in_data[0] * out_grad[0])
            return Op()


def register_softmax(pkg):
    """The example's ``Softmax``/``SoftmaxProp`` under ``op_type``
    'softmax' (need_top_grad=False: a loss layer)."""

    class Softmax(pkg.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            x = np.asarray(in_data[0])
            y = np.exp(x - x.max(axis=1).reshape((x.shape[0], 1)))
            y /= y.sum(axis=1).reshape((x.shape[0], 1))
            self.assign(out_data[0], req[0], pkg.nd.array(y, ctx=pkg.cpu()))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            lab = np.asarray(in_data[1]).ravel().astype(int)
            y = np.array(out_data[0])
            y[np.arange(lab.shape[0]), lab] -= 1.0
            self.assign(in_grad[0], req[0], pkg.nd.array(y, ctx=pkg.cpu()))

    @pkg.operator.register_op("softmax")
    class SoftmaxProp(pkg.operator.CustomOpProp):
        def __init__(self):
            super(SoftmaxProp, self).__init__(need_top_grad=False)

        def list_arguments(self):
            return ["data", "label"]

        def list_outputs(self):
            return ["output"]

        def infer_shape(self, in_shape):
            data_shape = in_shape[0]
            label_shape = (in_shape[0][0],)
            return [data_shape, label_shape], [data_shape], []

        def create_operator(self, ctx, shapes, dtypes):
            return Softmax()


def mlp(pkg, head, sizes=SIZES):
    """The example's net; ``head`` 'custom' or 'builtin'."""
    h = pkg.sym.Variable("data")
    for i, n in enumerate(sizes[1:]):
        h = pkg.sym.FullyConnected(data=h, name="fc%d" % (i + 1),
                                   num_hidden=n)
        if i < len(sizes) - 2:
            h = pkg.sym.Activation(data=h, name="relu%d" % (i + 1),
                                   act_type="relu")
    label = pkg.sym.Variable("softmax_label")
    if head == "custom":
        return pkg.sym.Custom(data=h, label=label, name="softmax",
                              op_type="softmax")
    return pkg.sym.SoftmaxOutput(data=h, label=label, name="softmax")


def _params(seed, sizes=SIZES):
    r = np.random.RandomState(seed)
    out = {}
    for i in range(len(sizes) - 1):
        out["fc%d_weight" % (i + 1)] = (0.1 * r.randn(
            sizes[i + 1], sizes[i])).astype(np.float32)
        out["fc%d_bias" % (i + 1)] = np.zeros(sizes[i + 1], np.float32)
    return out


def _data(seed, sizes=SIZES, batch=BATCH, steps=STEPS):
    r = np.random.RandomState(seed + 1)
    x = r.rand(batch * steps, sizes[0]).astype(np.float32)
    y = r.randint(0, sizes[-1], batch * steps).astype(np.float32)
    return x, y


def train(pkg, head, seed=0):
    """``Module.fit`` for one epoch of ``STEPS`` batches; the trained
    parameters and the per-batch cross-entropy."""
    register_softmax(pkg)
    x, y = _data(seed)
    it = pkg.io.NDArrayIter(x, y, batch_size=BATCH, shuffle=False,
                            label_name="softmax_label")
    mod = pkg.mod.Module(mlp(pkg, head), context=pkg.cpu())
    params = {k: pkg.nd.array(v, ctx=pkg.cpu())
              for k, v in _params(seed).items()}
    losses = []
    mod.fit(it, num_epoch=1, optimizer="sgd", optimizer_params=SGD,
            arg_params=params, eval_metric="ce")
    args, _ = mod.get_params()
    it.reset()
    for batch in it:
        mod.forward(batch, is_train=False)
        p = mod.get_outputs()[0].asnumpy()
        lab = batch.label[0].asnumpy().astype(int)
        losses.append(float(-np.log(p[np.arange(len(lab)), lab]).mean()))
    return {k: v.asnumpy() for k, v in args.items()}, losses


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def test_testsquare_forward_and_gradient_exact():
    outs = []
    for pkg in (mj, mt):
        _register_square(pkg)
        x = pkg.nd.array(np.array([1.0, 2.0, 3.0], np.float32),
                         ctx=pkg.cpu())
        pkg.autograd.mark_variables([x], [pkg.nd.zeros(x.shape,
                                                       ctx=pkg.cpu())])
        with pkg.autograd.record():
            y = pkg.nd.Custom(x, op_type="testsquare")
            loss = pkg.nd.sum(y)
        loss.backward()
        outs.append((y.asnumpy(), x.grad.asnumpy()))
    for (y, g) in outs:
        np.testing.assert_array_equal(y, [1, 4, 9])
        np.testing.assert_array_equal(g, [2, 4, 6])


def test_custom_softmax_mlp_matches_the_jax_package_and_softmax_output():
    want, want_loss = train(mj, "custom")
    got, got_loss = train(mt, "custom")
    builtin, _ = train(mt, "builtin")
    assert sorted(got) == sorted(want)
    for k in want:
        assert _rel(got[k], want[k]) <= REL, k
        assert _rel(got[k], builtin[k]) <= REL, k
    assert not np.allclose(got["fc1_weight"], _params(0)["fc1_weight"])
    np.testing.assert_allclose(got_loss, want_loss, rtol=1e-4)


def test_symbol_arguments_and_shapes_equal():
    seen = []
    for pkg in (mj, mt):
        register_softmax(pkg)
        net = mlp(pkg, "custom")
        shapes = net.infer_shape(data=(BATCH, SIZES[0]),
                                 softmax_label=(BATCH,))
        bare = pkg.sym.Custom(pkg.sym.FullyConnected(
            pkg.sym.Variable("data"), num_hidden=10, name="fc"),
            op_type="softmax", name="softmax")
        seen.append((net.list_arguments(), net.list_outputs(), shapes,
                     bare.list_arguments()))
    assert seen[0] == seen[1]
    # R17: no label input is created beyond those passed
    assert seen[1][3] == ["data", "fc_weight", "fc_bias"]


def test_unregistered_op_type_raises_in_both():
    for pkg in (mj, mt):
        x = pkg.nd.array(np.ones((2, 2), np.float32), ctx=pkg.cpu())
        with pytest.raises(pkg.MXNetError, match="not registered"):
            pkg.nd.Custom(x, op_type="no_such_custom_op")


def test_custom_keeps_the_general_path_in_data_parallel_planning():
    """``_spmd``'s tables hold no ``Custom``: a fused data-parallel step
    over a graph with one runs over the global batch (``dp_mode``
    'global', the reason naming the node), and the step trains."""
    from mxnet_tpu_torch.module import _spmd
    assert "Custom" not in _spmd.ROW_WISE and "Custom" not in _spmd.CROSS
    register_softmax(mt)
    x, y = _data(0)
    mod = mt.mod.Module(mlp(mt, "custom"), context=[mt.cpu(0), mt.cpu(1)])
    mod.bind([("data", (BATCH, SIZES[0]))], [("softmax_label", (BATCH,))])
    mod.init_params(arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                                for k, v in _params(0).items()})
    mod.init_optimizer(kvstore="tpu_ici", optimizer="sgd",
                       optimizer_params=SGD)
    mod.forward_backward(mt.io.DataBatch(
        [mt.nd.array(x[:BATCH], ctx=mt.cpu())],
        [mt.nd.array(y[:BATCH], ctx=mt.cpu())]))
    mod.update()
    fs = mod._fused_step
    assert fs is not None and fs.dp_mode == "global"
    assert fs.dp_mode_reason.startswith("Custom (node ")
    args, _ = mod.get_params()
    assert not np.allclose(args["fc1_weight"].asnumpy(),
                           _params(0)["fc1_weight"])

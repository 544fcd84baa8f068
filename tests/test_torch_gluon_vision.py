"""The Gluon pieces of the vision path in the port against the JAX
package: every convolution and pooling layer class (1-D, 2-D, 3-D),
``ReflectionPad2D`` and ``InstanceNorm``; ``SymbolBlock`` over an exported
graph; ``autograd.Function``; the zoo's ``get_model`` names,
``pretrained=True`` from a local ``.params`` file, and ``.params`` files
of a zoo net saved by either package and loaded by the other.

Tolerances: f32 atol=rtol=1e-5 for layer outputs and gradients (the same
arithmetic in another summation order; convolutions 1e-4 absolute on
sums of up to 54 products); forwards of whole nets relative L2 1e-5.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.symbol import NameManager

from test_torch_vision_zoo import build, images, seeded_weights, set_weights

TOL = dict(atol=1e-5, rtol=1e-5)
CONV_TOL = dict(atol=1e-4, rtol=1e-5)

# (class name, args, kwargs, input shape)
LAYERS = [
    ("Conv1D", (4, 3), dict(strides=2, padding=1, in_channels=3), (2, 3, 9)),
    ("Conv2D", (4, (3, 2)), dict(strides=(2, 1), padding=(1, 0),
                                 dilation=(1, 2), in_channels=3),
     (2, 3, 9, 8)),
    ("Conv2D", (6, 3), dict(groups=2, padding=1, in_channels=4,
                            activation="relu", use_bias=False),
     (2, 4, 7, 7)),
    ("Conv3D", (2, 2), dict(in_channels=2), (2, 2, 5, 6, 4)),
    ("Conv1DTranspose", (3, 3), dict(strides=2, padding=1, output_padding=1,
                                     in_channels=2), (2, 2, 7)),
    ("Conv2DTranspose", (3, 3), dict(strides=2, padding=1, output_padding=1,
                                     in_channels=2), (2, 2, 5, 6)),
    ("Conv2DTranspose", (4, (2, 3)), dict(groups=2, in_channels=4,
                                          use_bias=False), (2, 4, 4, 5)),
    ("Conv3DTranspose", (2, 2), dict(strides=2, in_channels=2),
     (1, 2, 3, 4, 3)),
    ("MaxPool1D", (2,), {}, (2, 3, 9)),
    ("MaxPool2D", (3, 2, 1), {}, (2, 3, 9, 8)),
    ("MaxPool2D", (2,), dict(ceil_mode=True), (2, 3, 9, 7)),
    ("MaxPool3D", (2,), {}, (2, 2, 5, 6, 4)),
    ("AvgPool1D", (3, 2, 1), {}, (2, 3, 9)),
    ("AvgPool2D", (3, 2, 1), {}, (2, 3, 9, 8)),
    ("AvgPool2D", (2,), dict(ceil_mode=True), (2, 3, 9, 7)),
    ("AvgPool3D", (2,), {}, (2, 2, 5, 6, 4)),
    ("GlobalMaxPool1D", (), {}, (2, 3, 9)),
    ("GlobalMaxPool2D", (), {}, (2, 3, 7, 7)),
    ("GlobalMaxPool3D", (), {}, (2, 2, 3, 4, 3)),
    ("GlobalAvgPool1D", (), {}, (2, 3, 9)),
    ("GlobalAvgPool2D", (), {}, (2, 3, 7, 7)),
    ("GlobalAvgPool3D", (), {}, (2, 2, 3, 4, 3)),
    ("ReflectionPad2D", (2,), {}, (2, 3, 5, 6)),
    ("InstanceNorm", (), dict(in_channels=3, scale=True), (2, 3, 5, 4)),
]


def _layer_run(pkg, cls, args, kwargs, x, weights, ct):
    names = NameManager if pkg is mx else JNameManager
    with names():
        layer = getattr(pkg.gluon.nn, cls)(*args, **kwargs)
    ctx = pkg.cpu()
    layer.initialize(ctx=ctx)
    params = layer.collect_params()
    for name, p in params.items():
        p.set_data(pkg.nd.array(weights[name], ctx=ctx))
    xa = pkg.nd.array(x, ctx=ctx)
    xa.attach_grad()
    with pkg.autograd.record():
        out = layer(xa)
        head = (out * pkg.nd.array(ct, ctx=ctx)).sum()
    head.backward()
    grads = {n: p.grad().asnumpy() for n, p in params.items()
             if p.grad_req != "null"}
    return repr(layer), out.asnumpy(), xa.grad.asnumpy(), grads


@pytest.mark.parametrize("case", LAYERS, ids=[
    "%d-%s" % (i, c[0]) for i, c in enumerate(LAYERS)])
def test_layer_matches_the_jax_package(case):
    cls, args, kwargs, shape = case
    r = np.random.RandomState(len(shape))
    x = r.standard_normal(shape).astype(np.float32)
    with NameManager():
        probe = getattr(mx.gluon.nn, cls)(*args, **kwargs)
    probe.initialize(ctx=mx.cpu())
    out_shape = probe(mx.nd.array(x, ctx=mx.cpu())).shape
    weights = {n: (r.standard_normal(p.shape) * 0.5
                   + (1.0 if n.endswith("gamma") else 0.0)).astype(np.float32)
               for n, p in probe.collect_params().items()}
    ct = r.standard_normal(out_shape).astype(np.float32)
    got = _layer_run(mx, cls, args, kwargs, x, weights, ct)
    want = _layer_run(jmx, cls, args, kwargs, x, weights, ct)
    assert got[0] == want[0]  # __repr__
    tol = CONV_TOL if cls.startswith("Conv") else TOL
    np.testing.assert_allclose(got[1], want[1], **tol)
    np.testing.assert_allclose(got[2], want[2], **tol)
    assert sorted(got[3]) == sorted(want[3])
    for name in got[3]:
        np.testing.assert_allclose(got[3][name], want[3][name], **tol,
                                   err_msg=name)


def _small_convnet(pkg):
    names = NameManager if pkg is mx else JNameManager
    nn = pkg.gluon.nn
    with names():
        net = nn.HybridSequential()
        with net.name_scope():
            net.add(nn.Conv2D(4, 3, padding=1, in_channels=3),
                    nn.BatchNorm(in_channels=4), nn.Activation("relu"),
                    nn.MaxPool2D(2), nn.Conv2DTranspose(2, 2, strides=2,
                                                        in_channels=4),
                    nn.GlobalAvgPool2D(), nn.Flatten(),
                    nn.Dense(5, in_units=2))
    return net


def _sgd_step(pkg, net, x, y):
    params = net.collect_params()
    trainer = pkg.gluon.Trainer(params, "sgd", {"learning_rate": 0.1,
                                                "momentum": 0.9})
    with pkg.autograd.record():
        loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
            net(pkg.nd.array(x, ctx=pkg.cpu())),
            pkg.nd.array(y, ctx=pkg.cpu()))
    loss.backward()
    trainer.step(x.shape[0])
    return {n: p.data().asnumpy() for n, p in params.items()}


def test_symbol_block_runs_an_exported_graph_like_the_jax_package(tmp_path):
    """Export the port's hybridized net, load it back as a SymbolBlock
    with ``collect_params().load``: its forward equals the net's (bit for
    bit: the same ops in the same order) and the JAX package's SymbolBlock
    over the same files; one SGD-momentum step through it equals the JAX
    one (aux states are Parameters with grad_req 'null')."""
    r = np.random.RandomState(11)
    x = r.uniform(0, 1, (4, 3, 8, 8)).astype(np.float32)
    y = r.randint(0, 5, 4).astype(np.float32)
    net = _small_convnet(mx)
    net.initialize(mx.initializer.Xavier(), ctx=mx.cpu())
    net.hybridize()
    net(mx.nd.array(x, ctx=mx.cpu()))
    prefix = str(tmp_path / "small")
    net.export(prefix)
    with mx.autograd.predict_mode():
        want = net(mx.nd.array(x, ctx=mx.cpu())).asnumpy()
    blocks = {}
    for pkg in (mx, jmx):
        sb = pkg.gluon.SymbolBlock(pkg.sym.load(prefix + "-symbol.json"),
                                   pkg.sym.var("data"))
        saved = pkg.nd.load(prefix + "-0000.params")
        for name, p in sb.collect_params().items():
            assert (("aux:" if p.grad_req == "null" else "arg:") + name) \
                in saved
        blocks[pkg] = sb
    blocks[mx].collect_params().load(prefix + "-0000.params", ctx=mx.cpu())
    for name, p in blocks[jmx].collect_params().items():
        kind = "aux:" if p.grad_req == "null" else "arg:"
        p._load_init(jmx.nd.load(prefix + "-0000.params")[kind + name],
                     jmx.cpu())
    assert sorted(blocks[mx].collect_params().keys()) == sorted(
        net.collect_params().keys())
    outs = []
    for pkg, sb in blocks.items():
        with pkg.autograd.predict_mode():
            outs.append(sb(pkg.nd.array(x, ctx=pkg.cpu())).asnumpy())
    assert np.array_equal(outs[0], want)
    np.testing.assert_allclose(outs[0], outs[1], **TOL)
    got, ref = (_sgd_step(pkg, sb, x, y) for pkg, sb in blocks.items())
    for name in ref:
        np.testing.assert_allclose(got[name], ref[name], **TOL,
                                   err_msg=name)
    moved = [n for n, p in blocks[mx].collect_params().items()
             if p.grad_req != "null"]
    saved = mx.nd.load(prefix + "-0000.params")
    assert all(not np.array_equal(got[n], saved["arg:" + n].asnumpy())
               for n in moved)


def _sigmoid_function(pkg):
    class Sigmoid(pkg.autograd.Function):
        def forward(self, x):
            y = 1 / (1 + pkg.nd.exp(-x))
            self.save_for_backward(y)
            return y

        def backward(self, dy):
            (y,) = self.saved_tensors
            return dy * y * (1 - y)
    return Sigmoid()


def test_autograd_function_matches_the_jax_package():
    r = np.random.RandomState(12)
    x0, w0 = r.standard_normal((3, 4)).astype(np.float32), \
        r.standard_normal((3, 4)).astype(np.float32)
    res = []
    for pkg in (mx, jmx):
        x = pkg.nd.array(x0, ctx=pkg.cpu())
        x.attach_grad()
        with pkg.autograd.record():
            y = _sigmoid_function(pkg)(x * 2)
            loss = (y * pkg.nd.array(w0, ctx=pkg.cpu())).sum()
        loss.backward()
        plain = _sigmoid_function(pkg)(pkg.nd.array(x0, ctx=pkg.cpu()))
        res.append((y.asnumpy(), x.grad.asnumpy(), plain.asnumpy()))
    for a, b in zip(*res):
        np.testing.assert_allclose(a, b, **TOL)
    s = 1 / (1 + np.exp(-2 * x0))
    np.testing.assert_allclose(res[0][1], w0 * s * (1 - s) * 2, **TOL)
    with pytest.raises(mx.MXNetError):
        mx.autograd.get_symbol(mx.nd.array(x0, ctx=mx.cpu()))


def test_get_model_names_match_the_jax_package():
    assert sorted(vision._MODELS) == sorted(
        jmx.gluon.model_zoo.vision._MODELS)
    assert "resnet50_v2" in vision._MODELS and "squeezenet1.0" in \
        vision._MODELS
    with NameManager():
        net = vision.get_model("ResNet50_V2", classes=7)
    assert isinstance(net, vision.ResNetV2)
    with pytest.raises(ValueError):
        vision.get_model("resnet51_v2")


def _forward(pkg, net, x):
    net.hybridize()
    with pkg.autograd.predict_mode():
        return net(pkg.nd.array(x, ctx=pkg.cpu())).asnumpy()


def test_pretrained_loads_a_local_params_file(tmp_path, monkeypatch):
    """``pretrained=True`` reads ``<MXNET_TPU_MODEL_DIR>/resnet18_v1.params``
    (here written by the JAX package's ``save_params``); a missing file
    raises with the path, as the store never downloads."""
    x = images(32, 2)
    ref = build(jmx, "resnet18_v1")
    ref.infer_shape(jmx.nd.array(x, ctx=jmx.cpu()))
    weights = seeded_weights(ref, seed=3)
    set_weights(jmx, ref, weights)
    ref.save_params(str(tmp_path / "resnet18_v1.params"))
    monkeypatch.setenv("MXNET_TPU_MODEL_DIR", str(tmp_path))
    with NameManager():
        net = vision.resnet18_v1(pretrained=True, ctx=mx.cpu(), classes=10,
                                 thumbnail=True)
    got, want = _forward(mx, net, x), _forward(jmx, ref, x)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)
    with NameManager(), pytest.raises(FileNotFoundError,
                                      match="resnet34_v1.params"):
        vision.resnet34_v1(pretrained=True, ctx=mx.cpu())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_zoo_params_files_load_in_the_other_package(writer, tmp_path):
    x = images(32, 2)
    nets = {pkg: build(pkg, "resnet18_v2") for pkg in (mx, jmx)}
    for pkg, net in nets.items():
        net.infer_shape(pkg.nd.array(x, ctx=pkg.cpu()))
    src, dst = (jmx, mx) if writer == "jax" else (mx, jmx)
    set_weights(src, nets[src], seeded_weights(nets[mx], seed=4))
    path = str(tmp_path / "net.params")
    nets[src].save_params(path)
    if dst is mx:
        mx.convert.set_gluon_params(nets[mx], path, ctx=mx.cpu())
    else:
        nets[jmx].load_params(path, ctx=jmx.cpu())
    got, want = _forward(mx, nets[mx], x), _forward(jmx, nets[jmx], x)
    assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want)

"""Every Gluon vision zoo builder in the port against the JAX package's,
the VGG, AlexNet, SqueezeNet and MobileNet families here (the others in
``tests/test_torch_vision_{resnet,resnet_v2,densenet,large}.py``).

Each builder runs at the smallest input its architecture admits (32x32;
AlexNet 63; DenseNet 221, whose last pool is 7x7 at a 32nd of the input;
Inception v3 299), with 10 classes, both packages' nets built under a
fresh ``NameManager``: the parameter names and shapes are equal, and
after ``convert.set_gluon_params`` sets the port's net from the same
numpy weights the JAX net is given, the hybridized predict-mode forward
is equal (relative L2 1e-5: f32 convolutions summed in other orders).
"""
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.gluon.model_zoo import vision
from mxnet_tpu_torch.symbol import NameManager

CLASSES = 10
# the smallest input side each family admits
MIN_SIDE = {"alexnet": 63, "densenet": 221, "inception": 299}
FORWARD_REL = 1e-5


def min_side(name):
    return next((v for k, v in MIN_SIDE.items() if name.startswith(k)), 32)


def build(pkg, name, **kwargs):
    """A zoo net of ``pkg`` (``mx`` or ``jmx``) under a fresh NameManager;
    ResNets in their thumbnail (32x32) form."""
    if name.startswith("resnet"):
        kwargs.setdefault("thumbnail", True)
    names = NameManager if pkg is mx else JNameManager
    with names():
        return pkg.gluon.model_zoo.vision.get_model(name, classes=CLASSES,
                                                    **kwargs)


def seeded_weights(net, seed=0):
    """Well-scaled numpy weights for every parameter of ``net`` (shapes
    known): He-normal convolution and dense weights, gamma and the moving
    variance near 1, beta, biases and the moving mean near 0."""
    r = np.random.RandomState(seed)
    out = {}
    for name, p in net.collect_params().items():
        shape = tuple(p.shape)
        if name.endswith(("gamma", "running_var")):
            v = 1 + 0.1 * r.uniform(-1, 1, shape)
        elif name.endswith(("beta", "running_mean", "bias")):
            v = 0.1 * r.uniform(-1, 1, shape)
        else:
            v = r.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
        out[name] = v.astype(np.float32)
    return out


def images(side, batch=1, seed=1):
    return np.random.RandomState(seed).uniform(
        0, 1, (batch, 3, side, side)).astype(np.float32)


def set_weights(pkg, net, weights):
    """The port through ``convert.set_gluon_params``; the JAX net through
    its Parameters' own loading path."""
    if pkg is mx:
        mx.convert.set_gluon_params(net, weights, ctx=mx.cpu())
        return
    for name, p in net.collect_params().items():
        p._load_init(jmx.nd.array(weights[name], ctx=jmx.cpu()), jmx.cpu())


def check_builder(name):
    x = images(min_side(name))
    nets = {pkg: build(pkg, name) for pkg in (mx, jmx)}
    for pkg, net in nets.items():
        net.infer_shape(pkg.nd.array(x, ctx=pkg.cpu()))
    shapes = [{n: tuple(p.shape) for n, p in net.collect_params().items()}
              for net in nets.values()]
    assert list(shapes[0]) == list(shapes[1])  # names, in order
    assert shapes[0] == shapes[1]
    weights = seeded_weights(nets[mx])
    outs = []
    for pkg, net in nets.items():
        set_weights(pkg, net, weights)
        net.hybridize()
        with pkg.autograd.predict_mode():
            outs.append(net(pkg.nd.array(x, ctx=pkg.cpu())).asnumpy())
    got, want = outs
    assert got.shape == (x.shape[0], CLASSES) and np.all(np.isfinite(got))
    assert np.linalg.norm(got - want) <= FORWARD_REL * np.linalg.norm(want)


FAMILIES = ("vgg", "alexnet", "squeezenet", "mobilenet")


@pytest.mark.parametrize("name", sorted(
    n for n in vision._MODELS if n.startswith(FAMILIES)))
def test_builder_matches_the_jax_package(name):
    check_builder(name)

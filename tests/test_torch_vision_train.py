"""One SGD-momentum Trainer step of a zoo vision net in the port against
the JAX package: the smallest builder of each family (and ResNet-50 v2,
the network ``chip_smoke.py`` trains on the card), hybridized, at the
smallest input its architecture admits, through ``autograd.record()`` ->
``SoftmaxCrossEntropyLoss`` -> ``backward`` -> ``Trainer('sgd',
{learning_rate 0.01, momentum 0.9, wd 1e-4}).step``.

Dropout is set to rate 0 in both nets before they are traced: the two
packages draw their masks from different generators (an intended
difference).  Tolerances, all measured here at these seeds:
- training-mode outputs within relative L2 1e-3 of the JAX package's
  (BatchNorm over batch statistics of 2-50 values a channel amplifies
  f32 rounding: 1e-6 to 1.8e-4 measured);
- each parameter's step (its change) within relative L2 5e-2 of the JAX
  package's, or within 4x the port's own change of that step when its
  input moves by one ulp (a gradient that is rounding noise, such as a
  convolution bias before a BatchNorm).  A ReLU unit whose pre-activation
  lies within rounding of 0 passes its gradient in one package and not
  in the other: one such unit of VGG-11's 4096-wide first dense layer
  moves that layer's step by 2.2% and every step upstream by 3-4%
  (Inception v3: 3.6%); the other families agree within 1%.
Every trainable parameter moves.
"""
import numpy as np
import pytest

import mxnet_tpu as jmx

import mxnet_tpu_torch as mx

from test_torch_vision_zoo import (build, images, min_side, seeded_weights,
                                   set_weights)

SGD = {"learning_rate": 0.01, "momentum": 0.9, "wd": 1e-4}
OUT_REL = 1e-3
STEP_REL = 5e-2
ULP_FACTOR = 4.0


def _blocks(block):
    yield block
    for child in block._children:
        yield from _blocks(child)


def build_without_dropout(pkg, name, x, make=None):
    """The zoo net ``name`` (or ``make(pkg)``) with its Dropout rate set
    to 0 before it is traced, its parameter shapes inferred from ``x``."""
    net = build(pkg, name) if make is None else make(pkg)
    for b in _blocks(net):
        if type(b).__name__ == "Dropout":
            b._rate = 0.0
    net.infer_shape(pkg.nd.array(x, ctx=pkg.cpu()))
    return net


def train_step(pkg, net, weights, x, y):
    """(training-mode output, {name: parameter change}) of one step from
    ``weights``."""
    set_weights(pkg, net, weights)
    net.hybridize()
    ctx = pkg.cpu()
    params = net.collect_params()
    trainer = pkg.gluon.Trainer(params, "sgd", dict(SGD))
    with pkg.autograd.record():
        out = net(pkg.nd.array(x, ctx=ctx))
        loss = pkg.gluon.loss.SoftmaxCrossEntropyLoss()(
            out, pkg.nd.array(y, ctx=ctx))
    loss.backward()
    trainer.step(x.shape[0])
    return out.asnumpy(), {n: p.data().asnumpy() - weights[n]
                           for n, p in params.items()}


def rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def check_steps(got, want, ulp, trainable):
    """Each parameter's change against the JAX package's by the rule of
    the module docstring; every trainable one moved."""
    for name in want:
        diff = np.linalg.norm(got[name] - want[name])
        limit = max(STEP_REL * np.linalg.norm(want[name]),
                    ULP_FACTOR * np.linalg.norm(got[name] - ulp[name]))
        assert diff <= limit, (name, diff, limit)
    for name in trainable:
        assert np.abs(got[name]).max() > 0, name


# (builder, batch, side): the smallest of each family, ResNet-50 v2, and
# MobileNet at 64 (at 32 its last BatchNorms normalize 2 values a
# channel, where a step is chaos)
# (DenseNet and Inception in tests/test_torch_vision_large.py)
CASES = [("resnet18_v1", 2, 32), ("resnet50_v2", 2, 32), ("vgg11_bn", 2, 32),
         ("alexnet", 2, 63), ("squeezenet1.1", 2, 32),
         ("mobilenet0.25", 2, 64)]


@pytest.mark.parametrize("name, batch, side", CASES,
                         ids=[c[0] for c in CASES])
def test_one_sgd_momentum_step_matches_the_jax_package(name, batch, side):
    check_one_step(name, batch, side)


def check_one_step(name, batch, side, make=None):
    assert side >= min_side(name)
    x = images(side, batch)
    y = np.random.RandomState(2).randint(0, 10, batch).astype(np.float32)
    nets = {pkg: build_without_dropout(pkg, name, x, make)
            for pkg in (mx, jmx)}
    port_ulp = build_without_dropout(mx, name, x, make)
    weights = seeded_weights(nets[mx])
    out, got = train_step(mx, nets[mx], weights, x, y)
    out_j, want = train_step(jmx, nets[jmx], weights, x, y)
    _, ulp = train_step(mx, port_ulp, weights,
                        np.nextafter(x, np.float32(2)), y)
    assert np.all(np.isfinite(out)) and rel(out, out_j) <= OUT_REL
    trainable = [n for n, p in nets[mx].collect_params().items()
                 if p.grad_req != "null"]
    check_steps(got, want, ulp, trainable)

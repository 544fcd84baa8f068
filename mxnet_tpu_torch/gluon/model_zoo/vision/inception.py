"""Inception v3 (Szegedy et al. 2015).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/inception.py``: the
mixed blocks are branch lists of conv-BN-ReLU stages, with the same
graph and parameter tree.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["Inception3", "inception_v3"]


def _bn_conv(channels, kernel_size, strides=1, padding=0):
    """conv -> BN -> relu, the only conv flavor Inception uses."""
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels=channels, kernel_size=kernel_size,
                      strides=strides, padding=padding, use_bias=False))
    out.add(nn.BatchNorm(epsilon=0.001))
    out.add(nn.Activation("relu"))
    return out


def _seq(*blocks):
    out = nn.HybridSequential(prefix="")
    out.add(*blocks)
    return out


class _Branches(HybridBlock):
    """Run child branches on the same input, concat outputs on channels."""

    def __init__(self, branches, **kwargs):
        super().__init__(**kwargs)
        self.branches = branches
        for b in branches:
            self.register_child(b)

    def hybrid_forward(self, F, x):
        outs = [b(x) for b in self.branches]
        return F.concat(*outs, dim=1)


class _SplitConcat(HybridBlock):
    """Two parallel convs on the same input, concatenated (E-block tails)."""

    def __init__(self, a, b, **kwargs):
        super().__init__(**kwargs)
        self.a = a
        self.b = b

    def hybrid_forward(self, F, x):
        return F.concat(self.a(x), self.b(x), dim=1)


def _mix(prefix, *branches):
    """Branches given as stage lists; each becomes one sequential."""
    return _Branches([_seq(*stages) for stages in branches], prefix=prefix)


def _make_A(pool_features, prefix):
    return _mix(
        prefix,
        [_bn_conv(64, 1)],
        [_bn_conv(48, 1), _bn_conv(64, 5, padding=2)],
        [_bn_conv(64, 1), _bn_conv(96, 3, padding=1),
         _bn_conv(96, 3, padding=1)],
        [nn.AvgPool2D(pool_size=3, strides=1, padding=1),
         _bn_conv(pool_features, 1)],
    )


def _make_B(prefix):
    return _mix(
        prefix,
        [_bn_conv(384, 3, strides=2)],
        [_bn_conv(64, 1), _bn_conv(96, 3, padding=1),
         _bn_conv(96, 3, strides=2)],
        [nn.MaxPool2D(pool_size=3, strides=2)],
    )


def _make_C(channels_7x7, prefix):
    c = channels_7x7
    return _mix(
        prefix,
        [_bn_conv(192, 1)],
        [_bn_conv(c, 1), _bn_conv(c, (1, 7), padding=(0, 3)),
         _bn_conv(192, (7, 1), padding=(3, 0))],
        [_bn_conv(c, 1), _bn_conv(c, (7, 1), padding=(3, 0)),
         _bn_conv(c, (1, 7), padding=(0, 3)),
         _bn_conv(c, (7, 1), padding=(3, 0)),
         _bn_conv(192, (1, 7), padding=(0, 3))],
        [nn.AvgPool2D(pool_size=3, strides=1, padding=1), _bn_conv(192, 1)],
    )


def _make_D(prefix):
    return _mix(
        prefix,
        [_bn_conv(192, 1), _bn_conv(320, 3, strides=2)],
        [_bn_conv(192, 1), _bn_conv(192, (1, 7), padding=(0, 3)),
         _bn_conv(192, (7, 1), padding=(3, 0)),
         _bn_conv(192, 3, strides=2)],
        [nn.MaxPool2D(pool_size=3, strides=2)],
    )


def _fork_1x3_3x1():
    return _SplitConcat(_bn_conv(384, (1, 3), padding=(0, 1)),
                        _bn_conv(384, (3, 1), padding=(1, 0)))


def _make_E(prefix):
    return _mix(
        prefix,
        [_bn_conv(320, 1)],
        [_bn_conv(384, 1), _fork_1x3_3x1()],
        [_bn_conv(448, 1), _bn_conv(384, 3, padding=1), _fork_1x3_3x1()],
        [nn.AvgPool2D(pool_size=3, strides=1, padding=1), _bn_conv(192, 1)],
    )


class Inception3(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            trunk = nn.HybridSequential(prefix="")
            stem = (_bn_conv(32, 3, strides=2), _bn_conv(32, 3),
                    _bn_conv(64, 3, padding=1),
                    nn.MaxPool2D(pool_size=3, strides=2),
                    _bn_conv(80, 1), _bn_conv(192, 3),
                    nn.MaxPool2D(pool_size=3, strides=2))
            mixed = (_make_A(32, "A1_"), _make_A(64, "A2_"),
                     _make_A(64, "A3_"),
                     _make_B("B_"),
                     _make_C(128, "C1_"), _make_C(160, "C2_"),
                     _make_C(160, "C3_"), _make_C(192, "C4_"),
                     _make_D("D_"),
                     _make_E("E1_"), _make_E("E2_"))
            trunk.add(*stem)
            trunk.add(*mixed)
            trunk.add(nn.AvgPool2D(pool_size=8))
            trunk.add(nn.Dropout(0.5))
            self.features = trunk
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def inception_v3(pretrained=False, ctx=None, **kwargs):
    net = Inception3(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "inceptionv3", ctx)
    return net

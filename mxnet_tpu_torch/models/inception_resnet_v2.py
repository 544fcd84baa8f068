"""Inception-ResNet-v2 symbol builder (parity:
example/image-classification/symbols/inception-resnet-v2.py;
architecture from Szegedy et al. 2016).

The port's copy of ``mxnet_tpu/models/inception_resnet_v2.py``: each
residual inception block's branch concat is projected by a linear 1x1
conv, scaled, and added to the shortcut before the relu."""
from __future__ import annotations

from .. import symbol as sym

from .inception_v4 import conv_bn


def _linear_conv(data, num_filter, name):
    """1x1 conv with bias, no BN/relu (the residual projection)."""
    return sym.Convolution(data, num_filter=num_filter, kernel=(1, 1),
                           name=name)


def _residual(data, branch, num_filter, scale, name):
    proj = _linear_conv(branch, num_filter, name + "_proj")
    out = data + proj * scale
    return sym.Activation(out, act_type="relu", name=name + "_relu")


def stem(data):
    n = conv_bn(data, 32, (3, 3), "stem_c1", stride=(2, 2))
    n = conv_bn(n, 32, (3, 3), "stem_c2")
    n = conv_bn(n, 64, (3, 3), "stem_c3", pad=(1, 1))
    n = sym.Pooling(n, kernel=(3, 3), stride=(2, 2), pool_type="max")
    n = conv_bn(n, 80, (1, 1), "stem_c4")
    n = conv_bn(n, 192, (3, 3), "stem_c5")
    n = sym.Pooling(n, kernel=(3, 3), stride=(2, 2), pool_type="max")
    # 35x35 mixed block to 320 channels
    b1 = conv_bn(n, 96, (1, 1), "stem_b1")
    b2 = conv_bn(n, 48, (1, 1), "stem_b2a")
    b2 = conv_bn(b2, 64, (5, 5), "stem_b2b", pad=(2, 2))
    b3 = conv_bn(n, 64, (1, 1), "stem_b3a")
    b3 = conv_bn(b3, 96, (3, 3), "stem_b3b", pad=(1, 1))
    b3 = conv_bn(b3, 96, (3, 3), "stem_b3c", pad=(1, 1))
    bp = sym.Pooling(n, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg")
    bp = conv_bn(bp, 64, (1, 1), "stem_proj")
    return sym.Concat(b1, b2, b3, bp, dim=1)  # 320


def block35(data, name, scale=0.17):
    b1 = conv_bn(data, 32, (1, 1), name + "_b1")
    b2 = conv_bn(data, 32, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 32, (3, 3), name + "_b2b", pad=(1, 1))
    b3 = conv_bn(data, 32, (1, 1), name + "_b3a")
    b3 = conv_bn(b3, 48, (3, 3), name + "_b3b", pad=(1, 1))
    b3 = conv_bn(b3, 64, (3, 3), name + "_b3c", pad=(1, 1))
    branch = sym.Concat(b1, b2, b3, dim=1)
    return _residual(data, branch, 320, scale, name)


def reduction_a(data, name):
    bp = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name=name + "_pool")
    b1 = conv_bn(data, 384, (3, 3), name + "_b1", stride=(2, 2))
    b2 = conv_bn(data, 256, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 256, (3, 3), name + "_b2b", pad=(1, 1))
    b2 = conv_bn(b2, 384, (3, 3), name + "_b2c", stride=(2, 2))
    return sym.Concat(bp, b1, b2, dim=1)  # 1088


def block17(data, name, scale=0.1):
    b1 = conv_bn(data, 192, (1, 1), name + "_b1")
    b2 = conv_bn(data, 128, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 160, (1, 7), name + "_b2b", pad=(0, 3))
    b2 = conv_bn(b2, 192, (7, 1), name + "_b2c", pad=(3, 0))
    branch = sym.Concat(b1, b2, dim=1)
    return _residual(data, branch, 1088, scale, name)


def reduction_b(data, name):
    bp = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name=name + "_pool")
    b1 = conv_bn(data, 256, (1, 1), name + "_b1a")
    b1 = conv_bn(b1, 384, (3, 3), name + "_b1b", stride=(2, 2))
    b2 = conv_bn(data, 256, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 288, (3, 3), name + "_b2b", stride=(2, 2))
    b3 = conv_bn(data, 256, (1, 1), name + "_b3a")
    b3 = conv_bn(b3, 288, (3, 3), name + "_b3b", pad=(1, 1))
    b3 = conv_bn(b3, 320, (3, 3), name + "_b3c", stride=(2, 2))
    return sym.Concat(bp, b1, b2, b3, dim=1)  # 2080


def block8(data, name, scale=0.2, relu=True):
    b1 = conv_bn(data, 192, (1, 1), name + "_b1")
    b2 = conv_bn(data, 192, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 224, (1, 3), name + "_b2b", pad=(0, 1))
    b2 = conv_bn(b2, 256, (3, 1), name + "_b2c", pad=(1, 0))
    branch = sym.Concat(b1, b2, dim=1)
    proj = _linear_conv(branch, 2080, name + "_proj")
    out = data + proj * scale
    if relu:
        out = sym.Activation(out, act_type="relu", name=name + "_relu")
    return out


def get_symbol(num_classes=1000, **kwargs):
    data = sym.var("data")
    net = stem(data)
    for i in range(5):
        net = block35(net, "ir35_%d" % (i + 1))
    net = reduction_a(net, "redA")
    for i in range(10):
        net = block17(net, "ir17_%d" % (i + 1))
    net = reduction_b(net, "redB")
    for i in range(5):
        net = block8(net, "ir8_%d" % (i + 1),
                     relu=(i < 4))
    net = conv_bn(net, 1536, (1, 1), "conv_final")
    net = sym.Pooling(net, global_pool=True, kernel=(8, 8), pool_type="avg")
    net = sym.Flatten(net)
    net = sym.Dropout(net, p=0.2)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")

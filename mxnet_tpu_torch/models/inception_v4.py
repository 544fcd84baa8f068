"""Inception-v4 symbol builder (parity:
example/image-classification/symbols/inception-v4.py; architecture from
Szegedy et al. 2016, "Inception-v4, Inception-ResNet and the Impact of
Residual Connections").

The port's copy of ``mxnet_tpu/models/inception_v4.py``: one conv_bn
helper; each block builds its branches and concatenates on channels."""
from __future__ import annotations

from .. import symbol as sym


def conv_bn(data, num_filter, kernel, name, stride=(1, 1), pad=(0, 0)):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True, name=name)
    bn = sym.BatchNorm(c, fix_gamma=False, eps=1e-3, name=name + "_bn")
    return sym.Activation(bn, act_type="relu", name=name + "_relu")


def stem(data):
    n = conv_bn(data, 32, (3, 3), "stem_c1", stride=(2, 2))
    n = conv_bn(n, 32, (3, 3), "stem_c2")
    n = conv_bn(n, 64, (3, 3), "stem_c3", pad=(1, 1))
    p1 = sym.Pooling(n, kernel=(3, 3), stride=(2, 2), pool_type="max")
    c1 = conv_bn(n, 96, (3, 3), "stem_c4", stride=(2, 2))
    n = sym.Concat(p1, c1, dim=1)
    # two parallel towers to 96 channels each
    t1 = conv_bn(n, 64, (1, 1), "stem_t1a")
    t1 = conv_bn(t1, 96, (3, 3), "stem_t1b")
    t2 = conv_bn(n, 64, (1, 1), "stem_t2a")
    t2 = conv_bn(t2, 64, (7, 1), "stem_t2b", pad=(3, 0))
    t2 = conv_bn(t2, 64, (1, 7), "stem_t2c", pad=(0, 3))
    t2 = conv_bn(t2, 96, (3, 3), "stem_t2d")
    n = sym.Concat(t1, t2, dim=1)
    c2 = conv_bn(n, 192, (3, 3), "stem_c5", stride=(2, 2))
    p2 = sym.Pooling(n, kernel=(3, 3), stride=(2, 2), pool_type="max")
    return sym.Concat(c2, p2, dim=1)  # 384 channels


def block_a(data, name):
    bp = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name=name + "_pool")
    bp = conv_bn(bp, 96, (1, 1), name + "_proj")
    b1 = conv_bn(data, 96, (1, 1), name + "_b1")
    b2 = conv_bn(data, 64, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 96, (3, 3), name + "_b2b", pad=(1, 1))
    b3 = conv_bn(data, 64, (1, 1), name + "_b3a")
    b3 = conv_bn(b3, 96, (3, 3), name + "_b3b", pad=(1, 1))
    b3 = conv_bn(b3, 96, (3, 3), name + "_b3c", pad=(1, 1))
    return sym.Concat(bp, b1, b2, b3, dim=1)


def reduction_a(data, name):
    bp = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name=name + "_pool")
    b1 = conv_bn(data, 384, (3, 3), name + "_b1", stride=(2, 2))
    b2 = conv_bn(data, 192, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 224, (3, 3), name + "_b2b", pad=(1, 1))
    b2 = conv_bn(b2, 256, (3, 3), name + "_b2c", stride=(2, 2))
    return sym.Concat(bp, b1, b2, dim=1)


def block_b(data, name):
    bp = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name=name + "_pool")
    bp = conv_bn(bp, 128, (1, 1), name + "_proj")
    b1 = conv_bn(data, 384, (1, 1), name + "_b1")
    b2 = conv_bn(data, 192, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 224, (1, 7), name + "_b2b", pad=(0, 3))
    b2 = conv_bn(b2, 256, (7, 1), name + "_b2c", pad=(3, 0))
    b3 = conv_bn(data, 192, (1, 1), name + "_b3a")
    b3 = conv_bn(b3, 192, (7, 1), name + "_b3b", pad=(3, 0))
    b3 = conv_bn(b3, 224, (1, 7), name + "_b3c", pad=(0, 3))
    b3 = conv_bn(b3, 224, (7, 1), name + "_b3d", pad=(3, 0))
    b3 = conv_bn(b3, 256, (1, 7), name + "_b3e", pad=(0, 3))
    return sym.Concat(bp, b1, b2, b3, dim=1)


def reduction_b(data, name):
    bp = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pool_type="max",
                     name=name + "_pool")
    b1 = conv_bn(data, 192, (1, 1), name + "_b1a")
    b1 = conv_bn(b1, 192, (3, 3), name + "_b1b", stride=(2, 2))
    b2 = conv_bn(data, 256, (1, 1), name + "_b2a")
    b2 = conv_bn(b2, 256, (1, 7), name + "_b2b", pad=(0, 3))
    b2 = conv_bn(b2, 320, (7, 1), name + "_b2c", pad=(3, 0))
    b2 = conv_bn(b2, 320, (3, 3), name + "_b2d", stride=(2, 2))
    return sym.Concat(bp, b1, b2, dim=1)


def block_c(data, name):
    bp = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="avg", name=name + "_pool")
    bp = conv_bn(bp, 256, (1, 1), name + "_proj")
    b1 = conv_bn(data, 256, (1, 1), name + "_b1")
    b2 = conv_bn(data, 384, (1, 1), name + "_b2")
    b2a = conv_bn(b2, 256, (1, 3), name + "_b2a", pad=(0, 1))
    b2b = conv_bn(b2, 256, (3, 1), name + "_b2b", pad=(1, 0))
    b3 = conv_bn(data, 384, (1, 1), name + "_b3")
    b3 = conv_bn(b3, 448, (3, 1), name + "_b3a", pad=(1, 0))
    b3 = conv_bn(b3, 512, (1, 3), name + "_b3b", pad=(0, 1))
    b3a = conv_bn(b3, 256, (1, 3), name + "_b3c", pad=(0, 1))
    b3b = conv_bn(b3, 256, (3, 1), name + "_b3d", pad=(1, 0))
    return sym.Concat(bp, b1, b2a, b2b, b3a, b3b, dim=1)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.var("data")
    net = stem(data)
    for i in range(4):
        net = block_a(net, "incA%d" % (i + 1))
    net = reduction_a(net, "redA")
    for i in range(7):
        net = block_b(net, "incB%d" % (i + 1))
    net = reduction_b(net, "redB")
    for i in range(3):
        net = block_c(net, "incC%d" % (i + 1))
    net = sym.Pooling(net, global_pool=True, kernel=(8, 8), pool_type="avg")
    net = sym.Flatten(net)
    net = sym.Dropout(net, p=0.2)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")

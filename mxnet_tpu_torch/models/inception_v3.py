"""Inception-v3 symbol builder (parity: example/image-classification/symbols/
inception-v3.py; architecture from Szegedy et al. 2015, "Rethinking the
Inception Architecture", 299x299 input).

The port's copy of ``mxnet_tpu/models/inception_v3.py``: the same graph
and names."""
from __future__ import annotations

from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True,
                        name="%s_conv" % name)
    bn = sym.BatchNorm(c, fix_gamma=True, name="%s_bn" % name)
    return sym.Activation(bn, act_type="relu")


def _pool(data, kernel, stride, pad, pool_type):
    return sym.Pooling(data, kernel=kernel, stride=stride, pad=pad,
                       pool_type=pool_type)


def _inception_a(net, p1, p3r, p3, pd3r, pd3, proj, name):
    """35x35 module: 1x1 / 5x5 / double-3x3 / avg-pool-proj."""
    b1 = _conv(net, p1, (1, 1), name="%s_1x1" % name)
    b5 = _conv(net, p3r, (1, 1), name="%s_5x5r" % name)
    b5 = _conv(b5, p3, (5, 5), pad=(2, 2), name="%s_5x5" % name)
    bd = _conv(net, pd3r, (1, 1), name="%s_d3r" % name)
    bd = _conv(bd, pd3, (3, 3), pad=(1, 1), name="%s_d3a" % name)
    bd = _conv(bd, pd3, (3, 3), pad=(1, 1), name="%s_d3b" % name)
    bp = _pool(net, (3, 3), (1, 1), (1, 1), "avg")
    bp = _conv(bp, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b5, bd, bp, name="%s_concat" % name)


def _reduction_a(net, pd3r, pd3, name):
    """35->17 reduction: 3x3 stride 2 / double-3x3 stride 2 / max pool."""
    b3 = _conv(net, 384, (3, 3), stride=(2, 2), name="%s_3x3" % name)
    bd = _conv(net, pd3r, (1, 1), name="%s_d3r" % name)
    bd = _conv(bd, pd3, (3, 3), pad=(1, 1), name="%s_d3a" % name)
    bd = _conv(bd, pd3, (3, 3), stride=(2, 2), name="%s_d3b" % name)
    bp = _pool(net, (3, 3), (2, 2), (0, 0), "max")
    return sym.Concat(b3, bd, bp, name="%s_concat" % name)


def _inception_b(net, f7, name):
    """17x17 module with factorized 7x7 convolutions."""
    b1 = _conv(net, 192, (1, 1), name="%s_1x1" % name)
    b7 = _conv(net, f7, (1, 1), name="%s_7r" % name)
    b7 = _conv(b7, f7, (1, 7), pad=(0, 3), name="%s_7a" % name)
    b7 = _conv(b7, 192, (7, 1), pad=(3, 0), name="%s_7b" % name)
    bd = _conv(net, f7, (1, 1), name="%s_d7r" % name)
    bd = _conv(bd, f7, (7, 1), pad=(3, 0), name="%s_d7a" % name)
    bd = _conv(bd, f7, (1, 7), pad=(0, 3), name="%s_d7b" % name)
    bd = _conv(bd, f7, (7, 1), pad=(3, 0), name="%s_d7c" % name)
    bd = _conv(bd, 192, (1, 7), pad=(0, 3), name="%s_d7d" % name)
    bp = _pool(net, (3, 3), (1, 1), (1, 1), "avg")
    bp = _conv(bp, 192, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b7, bd, bp, name="%s_concat" % name)


def _reduction_b(net, name):
    """17->8 reduction."""
    b3 = _conv(net, 192, (1, 1), name="%s_3r" % name)
    b3 = _conv(b3, 320, (3, 3), stride=(2, 2), name="%s_3" % name)
    b7 = _conv(net, 192, (1, 1), name="%s_7r" % name)
    b7 = _conv(b7, 192, (1, 7), pad=(0, 3), name="%s_7a" % name)
    b7 = _conv(b7, 192, (7, 1), pad=(3, 0), name="%s_7b" % name)
    b7 = _conv(b7, 192, (3, 3), stride=(2, 2), name="%s_7c" % name)
    bp = _pool(net, (3, 3), (2, 2), (0, 0), "max")
    return sym.Concat(b3, b7, bp, name="%s_concat" % name)


def _inception_c(net, name):
    """8x8 module with expanded filter-bank outputs."""
    b1 = _conv(net, 320, (1, 1), name="%s_1x1" % name)
    b3 = _conv(net, 384, (1, 1), name="%s_3r" % name)
    b3a = _conv(b3, 384, (1, 3), pad=(0, 1), name="%s_3a" % name)
    b3b = _conv(b3, 384, (3, 1), pad=(1, 0), name="%s_3b" % name)
    bd = _conv(net, 448, (1, 1), name="%s_dr" % name)
    bd = _conv(bd, 384, (3, 3), pad=(1, 1), name="%s_d3" % name)
    bda = _conv(bd, 384, (1, 3), pad=(0, 1), name="%s_da" % name)
    bdb = _conv(bd, 384, (3, 1), pad=(1, 0), name="%s_db" % name)
    bp = _pool(net, (3, 3), (1, 1), (1, 1), "avg")
    bp = _conv(bp, 192, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b3a, b3b, bda, bdb, bp, name="%s_concat" % name)


def get_symbol(num_classes=1000, dtype="float32", **kwargs):
    data = sym.var("data")
    # stem: 299x299 -> 35x35
    net = _conv(data, 32, (3, 3), stride=(2, 2), name="stem1")
    net = _conv(net, 32, (3, 3), name="stem2")
    net = _conv(net, 64, (3, 3), pad=(1, 1), name="stem3")
    net = _pool(net, (3, 3), (2, 2), (0, 0), "max")
    net = _conv(net, 80, (1, 1), name="stem4")
    net = _conv(net, 192, (3, 3), name="stem5")
    net = _pool(net, (3, 3), (2, 2), (0, 0), "max")
    # 3x inception-A
    net = _inception_a(net, 64, 48, 64, 64, 96, 32, "mixed0")
    net = _inception_a(net, 64, 48, 64, 64, 96, 64, "mixed1")
    net = _inception_a(net, 64, 48, 64, 64, 96, 64, "mixed2")
    net = _reduction_a(net, 64, 96, "mixed3")
    # 4x inception-B
    net = _inception_b(net, 128, "mixed4")
    net = _inception_b(net, 160, "mixed5")
    net = _inception_b(net, 160, "mixed6")
    net = _inception_b(net, 192, "mixed7")
    net = _reduction_b(net, "mixed8")
    # 2x inception-C
    net = _inception_c(net, "mixed9")
    net = _inception_c(net, "mixed10")
    net = sym.Pooling(net, kernel=(8, 8), pool_type="avg", global_pool=True)
    net = sym.Dropout(net, p=0.5)
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")

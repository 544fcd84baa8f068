"""Inception-BN symbol builder (parity: example/image-classification/symbols/
inception-bn.py; GoogLeNet v2 — Ioffe & Szegedy 2015).

The port's copy of ``mxnet_tpu/models/inception_bn.py``: the same graph
and names."""
from __future__ import annotations

from .. import symbol as sym


def _conv(data, num_filter, kernel, stride=(1, 1), pad=(0, 0), name=None):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name="conv_%s" % name)
    bn = sym.BatchNorm(c, name="bn_%s" % name)
    return sym.Activation(bn, act_type="relu")


def _inception(data, f1, f3r, f3, fd3r, fd3, proj, pool, name):
    """Inception module with 1x1 / 3x3 / double-3x3 / pool-proj branches."""
    b1 = _conv(data, f1, (1, 1), name="%s_1x1" % name)
    b3 = _conv(data, f3r, (1, 1), name="%s_3x3r" % name)
    b3 = _conv(b3, f3, (3, 3), pad=(1, 1), name="%s_3x3" % name)
    bd = _conv(data, fd3r, (1, 1), name="%s_d3x3r" % name)
    bd = _conv(bd, fd3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    bd = _conv(bd, fd3, (3, 3), pad=(1, 1), name="%s_d3x3b" % name)
    bp = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type=pool)
    bp = _conv(bp, proj, (1, 1), name="%s_proj" % name)
    return sym.Concat(b1, b3, bd, bp, name="ch_concat_%s" % name)


def _inception_down(data, f3r, f3, fd3r, fd3, name):
    """Stride-2 reduction module (3x3 / double-3x3 / max-pool branches)."""
    b3 = _conv(data, f3r, (1, 1), name="%s_3x3r" % name)
    b3 = _conv(b3, f3, (3, 3), stride=(2, 2), pad=(1, 1), name="%s_3x3" % name)
    bd = _conv(data, fd3r, (1, 1), name="%s_d3x3r" % name)
    bd = _conv(bd, fd3, (3, 3), pad=(1, 1), name="%s_d3x3a" % name)
    bd = _conv(bd, fd3, (3, 3), stride=(2, 2), pad=(1, 1),
               name="%s_d3x3b" % name)
    bp = sym.Pooling(data, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                     pool_type="max")
    return sym.Concat(b3, bd, bp, name="ch_concat_%s" % name)


def get_symbol(num_classes=1000, dtype="float32", **kwargs):
    data = sym.var("data")
    net = _conv(data, 64, (7, 7), stride=(2, 2), pad=(3, 3), name="1")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = _conv(net, 64, (1, 1), name="2_red")
    net = _conv(net, 192, (3, 3), pad=(1, 1), name="2")
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = _inception(net, 64, 64, 64, 64, 96, 32, "avg", "3a")
    net = _inception(net, 64, 64, 96, 64, 96, 64, "avg", "3b")
    net = _inception_down(net, 128, 160, 64, 96, "3c")
    net = _inception(net, 224, 64, 96, 96, 128, 128, "avg", "4a")
    net = _inception(net, 192, 96, 128, 96, 128, 128, "avg", "4b")
    net = _inception(net, 160, 128, 160, 128, 160, 128, "avg", "4c")
    net = _inception(net, 96, 128, 192, 160, 192, 128, "avg", "4d")
    net = _inception_down(net, 128, 192, 192, 256, "4e")
    net = _inception(net, 352, 192, 320, 160, 224, 128, "avg", "5a")
    net = _inception(net, 352, 192, 320, 192, 224, 128, "max", "5b")
    net = sym.Pooling(net, kernel=(7, 7), stride=(1, 1), pool_type="avg",
                      global_pool=True)
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")

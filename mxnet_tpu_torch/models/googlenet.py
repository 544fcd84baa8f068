"""GoogLeNet / Inception-v1 symbol builder (parity:
example/image-classification/symbols/googlenet.py; architecture from
Szegedy et al. 2014, "Going Deeper with Convolutions").

The port's copy of ``mxnet_tpu/models/googlenet.py``: the four inception
branches are built from a spec list and concatenated on the channel
axis; every conv is conv+relu (v1 predates BatchNorm)."""
from __future__ import annotations

from .. import symbol as sym


def conv_relu(data, num_filter, kernel, name, stride=(1, 1), pad=(0, 0)):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, name=name)
    return sym.Activation(c, act_type="relu", name=name + "_relu")


def inception(data, f1, f3r, f3, f5r, f5, fpool, name):
    """Four parallel branches: 1x1 | 1x1->3x3 | 1x1->5x5 | pool->1x1."""
    b1 = conv_relu(data, f1, (1, 1), name + "_1x1")
    b3 = conv_relu(data, f3r, (1, 1), name + "_3x3r")
    b3 = conv_relu(b3, f3, (3, 3), name + "_3x3", pad=(1, 1))
    b5 = conv_relu(data, f5r, (1, 1), name + "_5x5r")
    b5 = conv_relu(b5, f5, (5, 5), name + "_5x5", pad=(2, 2))
    bp = sym.Pooling(data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max", name=name + "_pool")
    bp = conv_relu(bp, fpool, (1, 1), name + "_proj")
    return sym.Concat(b1, b3, b5, bp, dim=1, name=name + "_out")


# (f1, f3r, f3, f5r, f5, fpool) per module, grouped by stage
_STAGE3 = [(64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64)]
_STAGE4 = [(192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64),
           (128, 128, 256, 24, 64, 64), (112, 144, 288, 32, 64, 64),
           (256, 160, 320, 32, 128, 128)]
_STAGE5 = [(256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128)]


def get_symbol(num_classes=1000, **kwargs):
    data = sym.var("data")
    net = conv_relu(data, 64, (7, 7), "conv1", stride=(2, 2), pad=(3, 3))
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    net = conv_relu(net, 64, (1, 1), "conv2r")
    net = conv_relu(net, 192, (3, 3), "conv2", pad=(1, 1))
    net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                      pool_type="max")
    for stage, specs in (("3", _STAGE3), ("4", _STAGE4), ("5", _STAGE5)):
        for i, spec in enumerate(specs):
            net = inception(net, *spec, name="in%s%s" % (stage, chr(97 + i)))
        if stage != "5":
            net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                              pool_type="max")
    net = sym.Pooling(net, global_pool=True, kernel=(7, 7), pool_type="avg")
    net = sym.Flatten(net)
    net = sym.Dropout(net, p=0.4)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")

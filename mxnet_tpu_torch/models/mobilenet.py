"""MobileNet-v1 symbol builder (parity:
example/image-classification/symbols/mobilenet.py; architecture from
Howard et al. 2017).

The port's copy of ``mxnet_tpu/models/mobilenet.py``: each block is a
depthwise 3x3 (num_group == channels) followed by a pointwise 1x1, both
conv+BN+relu."""
from __future__ import annotations

from .. import symbol as sym


def conv_block(data, num_filter, name, kernel=(3, 3), stride=(1, 1),
               pad=(1, 1), num_group=1):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, num_group=num_group,
                        no_bias=True, name=name)
    bn = sym.BatchNorm(c, fix_gamma=False, name=name + "_bn")
    return sym.Activation(bn, act_type="relu", name=name + "_relu")


def dw_separable(data, in_ch, out_ch, stride, name):
    dw = conv_block(data, in_ch, name + "_dw", stride=stride,
                    num_group=in_ch)
    return conv_block(dw, out_ch, name + "_pw", kernel=(1, 1), pad=(0, 0))


# (output channels, stride) for the 13 separable blocks
_BLOCKS = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2),
           (512, 1), (512, 1), (512, 1), (512, 1), (512, 1), (1024, 2),
           (1024, 1)]


def get_symbol(num_classes=1000, alpha=1.0, **kwargs):
    def w(ch):
        return max(int(ch * alpha), 8)

    data = sym.var("data")
    net = conv_block(data, w(32), "conv1", stride=(2, 2))
    in_ch = w(32)
    for i, (out_ch, s) in enumerate(_BLOCKS):
        net = dw_separable(net, in_ch, w(out_ch), (s, s), "sep%d" % (i + 1))
        in_ch = w(out_ch)
    net = sym.Pooling(net, global_pool=True, kernel=(7, 7), pool_type="avg")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")

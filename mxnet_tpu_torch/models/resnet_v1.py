"""ResNet-v1 symbol builder (parity:
example/image-classification/symbols/resnet-v1.py; original
post-activation ordering from He et al. 2015: conv+BN+relu inside the
unit, add then relu).

The port's copy of ``mxnet_tpu/models/resnet_v1.py``; it shares depth
configurations with the pre-activation builder (``resnet.py``)."""
from __future__ import annotations

from .. import symbol as sym

from .resnet import depth_config


def conv_bn(data, num_filter, kernel, stride, pad, name, relu=True,
            bn_name=None):
    c = sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                        stride=stride, pad=pad, no_bias=True, name=name)
    bn = sym.BatchNorm(c, fix_gamma=False, eps=2e-5, momentum=0.9,
                       name=bn_name or (name + "_bn"))
    if relu:
        bn = sym.Activation(bn, act_type="relu", name=name + "_relu")
    return bn


def residual_unit_v1(data, num_filter, stride, dim_match, name,
                     bottle_neck=True):
    # v1 places the stride on the FIRST conv of the branch (resnet-v1.py:49
    # strides conv1; the v1.5 variant that strides the 3x3 lives in torch-
    # land, not here)
    if bottle_neck:
        body = conv_bn(data, num_filter // 4, (1, 1), stride, (0, 0),
                       name + "_conv1")
        body = conv_bn(body, num_filter // 4, (3, 3), (1, 1), (1, 1),
                       name + "_conv2")
        body = conv_bn(body, num_filter, (1, 1), (1, 1), (0, 0),
                       name + "_conv3", relu=False)
    else:
        body = conv_bn(data, num_filter, (3, 3), stride, (1, 1),
                       name + "_conv1")
        body = conv_bn(body, num_filter, (3, 3), (1, 1), (1, 1),
                       name + "_conv2", relu=False)
    if dim_match:
        shortcut = data
    else:
        # reference param names: conv '<unit>_conv1sc', its BN '<unit>_sc'
        # (resnet-v1.py:64-66) so v1 checkpoints load by name
        shortcut = conv_bn(data, num_filter, (1, 1), stride, (0, 0),
                           name + "_conv1sc", relu=False,
                           bn_name=name + "_sc")
    return sym.Activation(body + shortcut, act_type="relu",
                          name=name + "_out")


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               **kwargs):
    shape = [int(x) for x in image_shape.split(",")] \
        if isinstance(image_shape, str) else list(image_shape)
    height = shape[1]
    units, filters, bottle_neck = depth_config(num_layers, height)
    # no bn_data layer here: that input-normalizing BatchNorm is a v2
    # (pre-activation) feature; the reference v1 stem starts at conv0
    net = sym.var("data")
    if height <= 32:  # CIFAR-style stem
        net = conv_bn(net, filters[0], (3, 3), (1, 1), (1, 1), "conv0")
    else:
        net = conv_bn(net, filters[0], (7, 7), (2, 2), (3, 3), "conv0")
        net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max")
    for i, n in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        net = residual_unit_v1(net, filters[i + 1], stride, False,
                               "stage%d_unit1" % (i + 1), bottle_neck)
        for j in range(1, n):
            net = residual_unit_v1(net, filters[i + 1], (1, 1), True,
                                   "stage%d_unit%d" % (i + 1, j + 1),
                                   bottle_neck)
    net = sym.Pooling(net, global_pool=True, kernel=(7, 7), pool_type="avg")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")

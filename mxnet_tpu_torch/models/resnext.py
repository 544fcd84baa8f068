"""ResNeXt symbol builder (parity:
example/image-classification/symbols/resnext.py; architecture from Xie
et al. 2016, "Aggregated Residual Transformations").

The port's copy of ``mxnet_tpu/models/resnext.py``: a post-activation
bottleneck whose 3x3 conv is grouped (cardinality branches)."""
from __future__ import annotations

from .. import symbol as sym

from .resnet import depth_config


def resnext_unit(data, num_filter, stride, dim_match, name,
                 num_group=32, bottleneck_width=4):
    # width of the grouped 3x3: cardinality * base width, scaled per stage
    width = int(num_filter * bottleneck_width * num_group / 256)

    c1 = sym.Convolution(data, num_filter=width, kernel=(1, 1),
                         no_bias=True, name=name + "_conv1")
    b1 = sym.BatchNorm(c1, fix_gamma=False, eps=2e-5, name=name + "_bn1")
    a1 = sym.Activation(b1, act_type="relu", name=name + "_relu1")
    c2 = sym.Convolution(a1, num_filter=width, kernel=(3, 3), stride=stride,
                         pad=(1, 1), num_group=num_group, no_bias=True,
                         name=name + "_conv2")
    b2 = sym.BatchNorm(c2, fix_gamma=False, eps=2e-5, name=name + "_bn2")
    a2 = sym.Activation(b2, act_type="relu", name=name + "_relu2")
    c3 = sym.Convolution(a2, num_filter=num_filter, kernel=(1, 1),
                         no_bias=True, name=name + "_conv3")
    b3 = sym.BatchNorm(c3, fix_gamma=False, eps=2e-5, name=name + "_bn3")
    if dim_match:
        shortcut = data
    else:
        sc = sym.Convolution(data, num_filter=num_filter, kernel=(1, 1),
                             stride=stride, no_bias=True, name=name + "_sc")
        shortcut = sym.BatchNorm(sc, fix_gamma=False, eps=2e-5,
                                 name=name + "_sc_bn")
    return sym.Activation(b3 + shortcut, act_type="relu",
                          name=name + "_out")


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               num_group=32, bottleneck_width=4, **kwargs):
    shape = [int(x) for x in image_shape.split(",")] \
        if isinstance(image_shape, str) else list(image_shape)
    height = shape[1]
    units, filters, bottle_neck = depth_config(num_layers, height)
    if not bottle_neck:
        raise ValueError("ResNeXt is defined for bottleneck depths "
                         "(>=50 at ImageNet scale); got %d" % num_layers)
    data = sym.var("data")
    if height <= 32:  # CIFAR-style stem: no aggressive downsampling
        net = sym.Convolution(data, num_filter=filters[0], kernel=(3, 3),
                              stride=(1, 1), pad=(1, 1), no_bias=True,
                              name="conv0")
        net = sym.BatchNorm(net, fix_gamma=False, eps=2e-5, name="bn0")
        net = sym.Activation(net, act_type="relu", name="relu0")
    else:
        net = sym.Convolution(data, num_filter=filters[0], kernel=(7, 7),
                              stride=(2, 2), pad=(3, 3), no_bias=True,
                              name="conv0")
        net = sym.BatchNorm(net, fix_gamma=False, eps=2e-5, name="bn0")
        net = sym.Activation(net, act_type="relu", name="relu0")
        net = sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max")
    for i, n in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        net = resnext_unit(net, filters[i + 1], stride, False,
                           "stage%d_unit1" % (i + 1), num_group,
                           bottleneck_width)
        for j in range(1, n):
            net = resnext_unit(net, filters[i + 1], (1, 1), True,
                               "stage%d_unit%d" % (i + 1, j + 1), num_group,
                               bottleneck_width)
    net = sym.Pooling(net, global_pool=True, kernel=(7, 7), pool_type="avg")
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(net, name="softmax")

"""ResNet v2 (pre-activation) symbol builder.

Parity target: example/image-classification/symbols/resnet.py — same
depths, same layer names (so reference checkpoints load by name), same
`get_symbol` CLI surface.  The construction here is table-driven: each
residual unit is a small conv plan walked by one loop, with the BN->relu
pre-activation pair emitted before every conv (He et al. 2016,
"Identity Mappings in Deep Residual Networks").

The port's copy of ``mxnet_tpu/models/resnet.py`` over the port's
``symbol``: the same graph, names and op sequence, so weights and BN
moving statistics carry across between the two packages by name.  The
conv workspace and memonger knobs are accepted and ignored, as there.
A ``dtype`` other than float32 casts the input to it after ``data`` and
the logits back to float32 before ``SoftmaxOutput``: type inference then
gives half-width conv and FC weights and float32 BatchNorm parameters
and moving statistics.
"""
from __future__ import annotations

from .. import symbol as sym

_BN = dict(fix_gamma=False, eps=2e-5, momentum=0.9)


def _conv_plan(num_filter, stride, bottle_neck):
    """Per-unit conv specs: (filters, kernel, stride, pad) per conv."""
    if bottle_neck:
        # 1x1 reduce -> strided 3x3 -> 1x1 expand (stride placement per
        # the reference's v2 builder: on the middle conv)
        return [(num_filter // 4, (1, 1), (1, 1), (0, 0)),
                (num_filter // 4, (3, 3), stride, (1, 1)),
                (num_filter, (1, 1), (1, 1), (0, 0))]
    # basic block: strided 3x3 -> 3x3
    return [(num_filter, (3, 3), stride, (1, 1)),
            (num_filter, (3, 3), (1, 1), (1, 1))]


def residual_unit(data, num_filter, stride, dim_match, name,
                  bottle_neck=True, bn_mom=0.9, workspace=None,
                  memonger=False):
    """Pre-activation residual unit.

    The first BN->relu activation is shared with the projection
    shortcut (when one is needed), exactly as in the reference graph —
    that sharing is what makes v2 "full pre-activation" rather than a
    plain reordering.  `workspace`/`memonger` are accepted and ignored
    for signature compatibility.
    """
    bn = dict(_BN, momentum=bn_mom)
    body, entry_act = data, None
    for k, (nf, kern, st, pad) in enumerate(_conv_plan(num_filter, stride,
                                                       bottle_neck), 1):
        body = sym.BatchNorm(body, name=f"{name}_bn{k}", **bn)
        body = sym.Activation(body, act_type="relu", name=f"{name}_relu{k}")
        entry_act = entry_act if entry_act is not None else body
        body = sym.Convolution(body, num_filter=nf, kernel=kern, stride=st,
                               pad=pad, no_bias=True, name=f"{name}_conv{k}")
    if dim_match:
        return body + data
    proj = sym.Convolution(entry_act, num_filter=num_filter, kernel=(1, 1),
                           stride=stride, no_bias=True, name=f"{name}_sc")
    return body + proj


def depth_config(num_layers, height):
    """(units, filter_list, bottle_neck) for a given depth and input size
    (the JAX package shares it with its v1 builder)."""
    if height <= 28:
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no experiments done on num_layers %d" %
                             num_layers)
        units = per_unit * 3
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        unit_map = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                    101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
                    200: [3, 24, 36, 3], 269: [3, 30, 48, 8]}
        if num_layers not in unit_map:
            raise ValueError("no experiments done on num_layers %d" %
                             num_layers)
        units = unit_map[num_layers]
    return units, filter_list, bottle_neck


def _stem(data, width, small_input):
    """Input stem: a bare 3x3 conv at CIFAR scale, the classic
    7x7/s2 + BN + relu + maxpool at ImageNet scale."""
    if small_input:
        return sym.Convolution(data, num_filter=width, kernel=(3, 3),
                               stride=(1, 1), pad=(1, 1), no_bias=True,
                               name="conv0")
    net = sym.Convolution(data, num_filter=width, kernel=(7, 7),
                          stride=(2, 2), pad=(3, 3), no_bias=True,
                          name="conv0")
    net = sym.BatchNorm(net, name="bn0", **_BN)
    net = sym.Activation(net, act_type="relu", name="relu0")
    return sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                       pool_type="max")


def get_symbol(num_classes, num_layers, image_shape, conv_workspace=256,
               dtype="float32", **kwargs):
    """Build a ResNet-v2 symbol by depth for the given image shape."""
    shape = [int(x) for x in image_shape.split(",")] \
        if isinstance(image_shape, str) else list(image_shape)
    height = shape[1]
    units, filters, bottle_neck = depth_config(num_layers, height)

    net = sym.var("data")
    if dtype != "float32":
        net = sym.Cast(net, dtype=dtype)
    # v2 normalizes the raw input with a scale-frozen BN before conv0
    net = sym.BatchNorm(net, fix_gamma=True, eps=2e-5, momentum=0.9,
                        name="bn_data")
    net = _stem(net, filters[0], height <= 32)

    for i, n in enumerate(units):
        stride = (1, 1) if i == 0 else (2, 2)
        for j in range(n):
            net = residual_unit(net, filters[i + 1],
                                stride if j == 0 else (1, 1), j > 0,
                                f"stage{i + 1}_unit{j + 1}", bottle_neck)

    # the trunk ends un-activated (units emit conv+shortcut), so one
    # final BN->relu precedes global pooling
    net = sym.BatchNorm(net, name="bn1", **_BN)
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.Pooling(net, global_pool=True, kernel=(7, 7), pool_type="avg",
                      name="pool1")
    net = sym.FullyConnected(sym.Flatten(net), num_hidden=num_classes,
                             name="fc1")
    if dtype != "float32":
        net = sym.Cast(net, dtype="float32")
    return sym.SoftmaxOutput(net, name="softmax")

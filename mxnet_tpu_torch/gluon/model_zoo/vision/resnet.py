"""ResNet v1 and v2 (He et al. 2015, 2016), depths 18 to 152.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/resnet.py`` (ref:
python/mxnet/gluon/model_zoo/vision/resnet.py): the same blocks, names
and parameter shapes, so one ``{name: array}`` dict sets both packages'
nets.  One residual unit per version covers the basic and bottleneck
branches; the public Basic*/Bottleneck* classes configure it.  In
training, every BatchNorm runs the ``bn_channel_sums`` kernel, the stem's
max pool and the global average pool the pooling-backward kernels.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["ResNetV1", "ResNetV2", "BasicBlockV1", "BasicBlockV2",
           "BottleneckV1", "BottleneckV2", "get_resnet",
           "resnet18_v1", "resnet34_v1", "resnet50_v1", "resnet101_v1",
           "resnet152_v1",
           "resnet18_v2", "resnet34_v2", "resnet50_v2", "resnet101_v2",
           "resnet152_v2"]

# depth -> (bottleneck?, per-stage unit counts, per-stage channels)
resnet_spec = {
    18: (False, [2, 2, 2, 2], [64, 64, 128, 256, 512]),
    34: (False, [3, 4, 6, 3], [64, 64, 128, 256, 512]),
    50: (True, [3, 4, 6, 3], [64, 256, 512, 1024, 2048]),
    101: (True, [3, 4, 23, 3], [64, 256, 512, 1024, 2048]),
    152: (True, [3, 8, 36, 3], [64, 256, 512, 1024, 2048]),
}


def _conv(channels, kernel, stride=1, in_channels=0):
    pad = (kernel - 1) // 2
    return nn.Conv2D(channels, kernel_size=kernel, strides=stride,
                     padding=pad, use_bias=False, in_channels=in_channels)


class _ResidualV1(HybridBlock):
    """Post-activation residual unit: body -> add shortcut -> relu.

    basic: [3x3/s, BN, relu, 3x3, BN]; bottleneck: [1x1/s, BN, relu,
    3x3, BN, relu, 1x1, BN].  The projection shortcut (1x1/s + BN)
    appears whenever channels change.
    """

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 bottleneck=False, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        if bottleneck:
            plan = [(channels // 4, 1, stride), (channels // 4, 3, 1),
                    (channels, 1, 1)]
        else:
            plan = [(channels, 3, stride), (channels, 3, 1)]
        for i, (ch, k, s) in enumerate(plan):
            self.body.add(_conv(ch, k, s,
                                in_channels if i == 0 and not bottleneck
                                else 0))
            self.body.add(nn.BatchNorm())
            if i + 1 < len(plan):
                self.body.add(nn.Activation("relu"))
        self.downsample = None
        if downsample:
            self.downsample = nn.HybridSequential(prefix="")
            self.downsample.add(nn.Conv2D(
                channels, kernel_size=1, strides=stride, use_bias=False,
                in_channels=in_channels))
            self.downsample.add(nn.BatchNorm())

    def hybrid_forward(self, F, x):
        shortcut = x if self.downsample is None else self.downsample(x)
        return F.Activation(self.body(x) + shortcut, act_type="relu")


class _ResidualV2(HybridBlock):
    """Pre-activation residual unit: BN-relu precedes each conv, and the
    projection shortcut taps the PRE-ACTIVATED input (He 2016)."""

    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 bottleneck=False, **kwargs):
        super().__init__(**kwargs)
        if bottleneck:
            plan = [(channels // 4, 1, 1), (channels // 4, 3, stride),
                    (channels, 1, 1)]
        else:
            plan = [(channels, 3, stride), (channels, 3, 1)]
        self._norms = []
        self._convs = []
        for i, (ch, k, s) in enumerate(plan):
            bn = nn.BatchNorm()
            conv = _conv(ch, k, s,
                         in_channels if i == 0 and not bottleneck else 0)
            setattr(self, "bn%d" % (i + 1), bn)
            setattr(self, "conv%d" % (i + 1), conv)
            self._norms.append(bn)
            self._convs.append(conv)
        self.downsample = nn.Conv2D(
            channels, 1, stride, use_bias=False,
            in_channels=in_channels) if downsample else None

    def hybrid_forward(self, F, x):
        shortcut = x
        for i, (bn, conv) in enumerate(zip(self._norms, self._convs)):
            x = F.Activation(bn(x), act_type="relu")
            if i == 0 and self.downsample is not None:
                shortcut = self.downsample(x)
            x = conv(x)
        return x + shortcut


class BasicBlockV1(_ResidualV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, downsample, in_channels,
                         bottleneck=False, **kwargs)


class BottleneckV1(_ResidualV1):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, downsample, in_channels,
                         bottleneck=True, **kwargs)


class BasicBlockV2(_ResidualV2):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, downsample, in_channels,
                         bottleneck=False, **kwargs)


class BottleneckV2(_ResidualV2):
    def __init__(self, channels, stride, downsample=False, in_channels=0,
                 **kwargs):
        super().__init__(channels, stride, downsample, in_channels,
                         bottleneck=True, **kwargs)


def _stage(block, units, channels, stride, index, in_channels):
    stage = nn.HybridSequential(prefix="stage%d_" % index)
    with stage.name_scope():
        stage.add(block(channels, stride, channels != in_channels,
                        in_channels=in_channels, prefix=""))
        for _ in range(units - 1):
            stage.add(block(channels, 1, False, in_channels=channels,
                            prefix=""))
    return stage


class _ResNetBase(HybridBlock):
    version = None

    def __init__(self, block, layers, channels, classes=1000,
                 thumbnail=False, **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(channels) - 1
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            if self.version == 2:
                # v2 normalizes the raw input (frozen affine)
                self.features.add(nn.BatchNorm(scale=False, center=False))
            if thumbnail:  # CIFAR-size stem
                self.features.add(_conv(channels[0], 3))
            else:
                self.features.add(nn.Conv2D(channels[0], 7, 2, 3,
                                            use_bias=False))
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
                self.features.add(nn.MaxPool2D(3, 2, 1))
            width = channels[0]
            for i, units in enumerate(layers):
                self.features.add(_stage(block, units, channels[i + 1],
                                         1 if i == 0 else 2, i + 1, width))
                width = channels[i + 1]
            if self.version == 2:
                self.features.add(nn.BatchNorm())
                self.features.add(nn.Activation("relu"))
            self.features.add(nn.GlobalAvgPool2D())
            if self.version == 2:
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes, in_units=width)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


class ResNetV1(_ResNetBase):
    version = 1


class ResNetV2(_ResNetBase):
    version = 2


# the net and block classes of each version (1, 2), by index version - 1
resnet_net_versions = [ResNetV1, ResNetV2]
resnet_block_versions = [
    {"basic_block": BasicBlockV1, "bottle_neck": BottleneckV1},
    {"basic_block": BasicBlockV2, "bottle_neck": BottleneckV2},
]


def get_resnet(version, num_layers, pretrained=False, ctx=None, **kwargs):
    if num_layers not in resnet_spec:
        raise AssertionError("invalid resnet depth %d; options: %s"
                             % (num_layers, sorted(resnet_spec)))
    if version not in (1, 2):
        raise AssertionError("invalid resnet version %d" % version)
    bottleneck, layers, channels = resnet_spec[num_layers]
    blocks = resnet_block_versions[version - 1]
    net = resnet_net_versions[version - 1](
        blocks["bottle_neck" if bottleneck else "basic_block"], layers,
        channels, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "resnet%d_v%d" % (num_layers, version), ctx)
    return net


def _entry(version, depth):
    def build(**kwargs):
        return get_resnet(version, depth, **kwargs)
    return build


resnet18_v1 = _entry(1, 18)
resnet34_v1 = _entry(1, 34)
resnet50_v1 = _entry(1, 50)
resnet101_v1 = _entry(1, 101)
resnet152_v1 = _entry(1, 152)
resnet18_v2 = _entry(2, 18)
resnet34_v2 = _entry(2, 34)
resnet50_v2 = _entry(2, 50)
resnet101_v2 = _entry(2, 101)
resnet152_v2 = _entry(2, 152)

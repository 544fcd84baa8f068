"""SqueezeNet 1.0 and 1.1 (Iandola et al. 2016).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/squeezenet.py``: each
version is one plan of stem, pool and fire rows.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["SqueezeNet", "squeezenet1_0", "squeezenet1_1"]

# rows: ("stem", channels, kernel) | ("pool",) | ("fire", squeeze, e1, e3)
_PLANS = {
    "1.0": (("stem", 96, 7), ("pool",),
            ("fire", 16, 64, 64), ("fire", 16, 64, 64),
            ("fire", 32, 128, 128), ("pool",),
            ("fire", 32, 128, 128), ("fire", 48, 192, 192),
            ("fire", 48, 192, 192), ("fire", 64, 256, 256), ("pool",),
            ("fire", 64, 256, 256)),
    "1.1": (("stem", 64, 3), ("pool",),
            ("fire", 16, 64, 64), ("fire", 16, 64, 64), ("pool",),
            ("fire", 32, 128, 128), ("fire", 32, 128, 128), ("pool",),
            ("fire", 48, 192, 192), ("fire", 48, 192, 192),
            ("fire", 64, 256, 256), ("fire", 64, 256, 256)),
}


def _relu_conv(channels, kernel, padding=0):
    out = nn.HybridSequential(prefix="")
    out.add(nn.Conv2D(channels, kernel, padding=padding))
    out.add(nn.Activation("relu"))
    return out


class _FireExpand(HybridBlock):
    """Parallel 1x1 + 3x3 expand paths, concatenated on channels."""

    def __init__(self, e1, e3, **kwargs):
        super().__init__(**kwargs)
        self.p1 = _relu_conv(e1, 1)
        self.p3 = _relu_conv(e3, 3, 1)

    def hybrid_forward(self, F, x):
        return F.concat(self.p1(x), self.p3(x), dim=1)


def _fire(squeeze, e1, e3):
    out = nn.HybridSequential(prefix="")
    out.add(_relu_conv(squeeze, 1))
    out.add(_FireExpand(e1, e3))
    return out


class SqueezeNet(HybridBlock):
    def __init__(self, version, classes=1000, **kwargs):
        super().__init__(**kwargs)
        if version not in _PLANS:
            raise AssertionError(
                "unsupported SqueezeNet version %s" % version)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for row in _PLANS[version]:
                if row[0] == "stem":
                    self.features.add(nn.Conv2D(row[1], kernel_size=row[2],
                                                strides=2))
                    self.features.add(nn.Activation("relu"))
                elif row[0] == "pool":
                    self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                                   ceil_mode=True))
                else:
                    self.features.add(_fire(*row[1:]))
            self.features.add(nn.Dropout(0.5))
            # classifier is a 1x1 conv + global average (no dense head)
            self.output = nn.HybridSequential(prefix="")
            self.output.add(nn.Conv2D(classes, kernel_size=1))
            self.output.add(nn.Activation("relu"))
            self.output.add(nn.GlobalAvgPool2D())
            self.output.add(nn.Flatten())

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def _entry(version):
    def build(pretrained=False, ctx=None, **kwargs):
        net = SqueezeNet(version, **kwargs)
        if pretrained:
            from ..model_store import load_pretrained
            load_pretrained(net, "squeezenet" + version, ctx)
        return net
    return build


squeezenet1_0 = _entry("1.0")
squeezenet1_1 = _entry("1.1")

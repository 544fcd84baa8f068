"""MobileNet v1 (Howard et al. 2017), width multipliers 1.0 to 0.25.

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/mobilenet.py``: the
body is one table of (depthwise, pointwise, stride) rows; a depthwise
convolution is a grouped cuDNN convolution.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["MobileNet", "get_mobilenet", "mobilenet1_0", "mobilenet0_75",
           "mobilenet0_5", "mobilenet0_25"]

# (dw_channels, out_channels, stride) at multiplier 1.0
_BODY = ((32, 64, 1),
         (64, 128, 2), (128, 128, 1),
         (128, 256, 2), (256, 256, 1),
         (256, 512, 2),
         (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
         (512, 512, 1),
         (512, 1024, 2), (1024, 1024, 1))


class MobileNet(HybridBlock):
    def __init__(self, multiplier=1.0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                self._unit(int(32 * multiplier), kernel=3, stride=2, pad=1)
                for dw, out, stride in _BODY:
                    dw, out = int(dw * multiplier), int(out * multiplier)
                    # depthwise 3x3 then pointwise 1x1
                    self._unit(dw, kernel=3, stride=stride, pad=1,
                               groups=dw)
                    self._unit(out)
                self.features.add(nn.GlobalAvgPool2D())
                self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def _unit(self, channels, kernel=1, stride=1, pad=0, groups=1):
        self.features.add(nn.Conv2D(channels, kernel, stride, pad,
                                    groups=groups, use_bias=False))
        self.features.add(nn.BatchNorm(scale=True))
        self.features.add(nn.Activation("relu"))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_mobilenet(multiplier, pretrained=False, ctx=None, **kwargs):
    net = MobileNet(multiplier, **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        tag = "{0:.2f}".format(multiplier)
        if tag in ("1.00", "0.50"):
            tag = tag[:-1]
        load_pretrained(net, "mobilenet%s" % tag, ctx)
    return net


def _entry(multiplier):
    def build(**kwargs):
        return get_mobilenet(multiplier, **kwargs)
    return build


mobilenet1_0 = _entry(1.0)
mobilenet0_75 = _entry(0.75)
mobilenet0_5 = _entry(0.5)
mobilenet0_25 = _entry(0.25)

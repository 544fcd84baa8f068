"""VGG 11/13/16/19, with and without BatchNorm (Simonyan & Zisserman
2014).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/vgg.py``: the feature
extractor is built from the per-depth stage table.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["VGG", "get_vgg", "vgg11", "vgg13", "vgg16", "vgg19",
           "vgg11_bn", "vgg13_bn", "vgg16_bn", "vgg19_bn"]

# depth -> convs per stage; stage channels are fixed across depths
vgg_spec = {11: ([1, 1, 2, 2, 2], [64, 128, 256, 512, 512]),
            13: ([2, 2, 2, 2, 2], [64, 128, 256, 512, 512]),
            16: ([2, 2, 3, 3, 3], [64, 128, 256, 512, 512]),
            19: ([2, 2, 4, 4, 4], [64, 128, 256, 512, 512])}


class VGG(HybridBlock):
    def __init__(self, layers, filters, classes=1000, batch_norm=False,
                 **kwargs):
        super().__init__(**kwargs)
        assert len(layers) == len(filters)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            for repeat, width in zip(layers, filters):
                self._stage(repeat, width, batch_norm)
            for _ in range(2):
                self.features.add(nn.Dense(4096, activation="relu",
                                           weight_initializer="normal"))
                self.features.add(nn.Dropout(rate=0.5))
            self.output = nn.Dense(classes, weight_initializer="normal")

    def _stage(self, repeat, width, batch_norm):
        for _ in range(repeat):
            self.features.add(nn.Conv2D(width, kernel_size=3, padding=1))
            if batch_norm:
                self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
        self.features.add(nn.MaxPool2D(strides=2))

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_vgg(num_layers, pretrained=False, ctx=None, **kwargs):
    net = VGG(*vgg_spec[num_layers], **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        bn = "_bn" if kwargs.get("batch_norm") else ""
        load_pretrained(net, "vgg%d%s" % (num_layers, bn), ctx)
    return net


def _entry(depth, batch_norm):
    def build(**kwargs):
        if batch_norm:
            kwargs["batch_norm"] = True
        return get_vgg(depth, **kwargs)
    return build


vgg11, vgg13, vgg16, vgg19 = (_entry(d, False) for d in (11, 13, 16, 19))
vgg11_bn, vgg13_bn, vgg16_bn, vgg19_bn = (
    _entry(d, True) for d in (11, 13, 16, 19))

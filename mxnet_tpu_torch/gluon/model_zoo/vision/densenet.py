"""DenseNet 121/161/169/201 (Huang et al. 2016).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/densenet.py``: dense
blocks concatenate each layer's growth onto the running feature map;
transitions halve channels and spatial size between blocks.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["DenseNet", "get_densenet", "densenet121", "densenet161",
           "densenet169", "densenet201"]

# depth -> (stem channels, growth rate, layers per block)
densenet_spec = {121: (64, 32, [6, 12, 24, 16]),
                 161: (96, 48, [6, 12, 36, 24]),
                 169: (64, 32, [6, 12, 32, 32]),
                 201: (64, 32, [6, 12, 48, 32])}


def _bn_relu_conv(seq, channels, kernel, padding=0):
    seq.add(nn.BatchNorm())
    seq.add(nn.Activation("relu"))
    seq.add(nn.Conv2D(channels, kernel_size=kernel, padding=padding,
                      use_bias=False))


class _DenseLayer(HybridBlock):
    """Bottleneck (1x1 to bn_size*growth) then 3x3 to growth channels;
    the output rides alongside the input via channel concat."""

    def __init__(self, growth_rate, bn_size, dropout, **kwargs):
        super().__init__(**kwargs)
        self.body = nn.HybridSequential(prefix="")
        _bn_relu_conv(self.body, bn_size * growth_rate, 1)
        _bn_relu_conv(self.body, growth_rate, 3, padding=1)
        if dropout:
            self.body.add(nn.Dropout(dropout))

    def hybrid_forward(self, F, x):
        return F.concat(x, self.body(x), dim=1)


class DenseNet(HybridBlock):
    def __init__(self, num_init_features, growth_rate, block_config,
                 bn_size=4, dropout=0, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            self.features.add(nn.Conv2D(
                num_init_features, kernel_size=7, strides=2, padding=3,
                use_bias=False))
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.MaxPool2D(pool_size=3, strides=2,
                                           padding=1))
            width = num_init_features
            last = len(block_config) - 1
            for i, n_layers in enumerate(block_config):
                block = nn.HybridSequential(prefix="stage%d_" % (i + 1))
                with block.name_scope():
                    for _ in range(n_layers):
                        block.add(_DenseLayer(growth_rate, bn_size,
                                              dropout))
                self.features.add(block)
                width += n_layers * growth_rate
                if i != last:
                    width //= 2
                    transition = nn.HybridSequential(prefix="")
                    _bn_relu_conv(transition, width, 1)
                    transition.add(nn.AvgPool2D(pool_size=2, strides=2))
                    self.features.add(transition)
            self.features.add(nn.BatchNorm())
            self.features.add(nn.Activation("relu"))
            self.features.add(nn.AvgPool2D(pool_size=7))
            self.features.add(nn.Flatten())
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def get_densenet(num_layers, pretrained=False, ctx=None, **kwargs):
    net = DenseNet(*densenet_spec[num_layers], **kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "densenet%d" % num_layers, ctx)
    return net


def _entry(depth):
    def build(**kwargs):
        return get_densenet(depth, **kwargs)
    return build


densenet121 = _entry(121)
densenet161 = _entry(161)
densenet169 = _entry(169)
densenet201 = _entry(201)

"""AlexNet (Krizhevsky et al. 2012).

Counterpart of ``mxnet_tpu/gluon/model_zoo/vision/alexnet.py``: the same
layer stack, built from a table of convolution stages.
"""
from __future__ import annotations

from ...block import HybridBlock
from ... import nn

__all__ = ["AlexNet", "alexnet"]

# (channels, kernel, stride, pad, pool-after?)
_CONV_PLAN = (
    (64, 11, 4, 2, True),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, False),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, True),
)


class AlexNet(HybridBlock):
    def __init__(self, classes=1000, **kwargs):
        super().__init__(**kwargs)
        with self.name_scope():
            self.features = nn.HybridSequential(prefix="")
            with self.features.name_scope():
                for ch, k, s, p, pool in _CONV_PLAN:
                    self.features.add(nn.Conv2D(
                        ch, kernel_size=k, strides=s, padding=p,
                        activation="relu"))
                    if pool:
                        self.features.add(
                            nn.MaxPool2D(pool_size=3, strides=2))
                self.features.add(nn.Flatten())
                for _ in range(2):
                    self.features.add(nn.Dense(4096, activation="relu"))
                    self.features.add(nn.Dropout(0.5))
            self.output = nn.Dense(classes)

    def hybrid_forward(self, F, x):
        return self.output(self.features(x))


def alexnet(pretrained=False, ctx=None, **kwargs):
    net = AlexNet(**kwargs)
    if pretrained:
        from ..model_store import load_pretrained
        load_pretrained(net, "alexnet", ctx)
    return net

"""AlexNet symbol builder (one-column variant, Krizhevsky et al. 2012).

Parity target: example/image-classification/symbols/alexnet.py — same
graph, same parameter names (conv1..conv5, fc1..fc3).  The port's copy
of ``mxnet_tpu/models/alexnet.py``: the feature extractor is a spec
table walked by one loop."""
from __future__ import annotations

from .. import symbol as sym

# (num_filter, kernel, stride, pad, lrn_after, pool_after) per conv layer
_FEATURES = (
    (96, (11, 11), (4, 4), (0, 0), True, True),
    (256, (5, 5), (1, 1), (2, 2), True, True),
    (384, (3, 3), (1, 1), (1, 1), False, False),
    (384, (3, 3), (1, 1), (1, 1), False, False),
    (256, (3, 3), (1, 1), (1, 1), False, True),
)


def get_symbol(num_classes=1000, dtype="float32", **kwargs):
    net = sym.var("data")
    for idx, (nf, kern, stride, pad, lrn, pool) in enumerate(_FEATURES, 1):
        net = sym.Convolution(net, num_filter=nf, kernel=kern, stride=stride,
                              pad=pad, name=f"conv{idx}")
        net = sym.Activation(net, act_type="relu")
        if lrn:
            net = sym.LRN(net, alpha=1e-4, beta=0.75, knorm=2, nsize=5)
        if pool:
            net = sym.Pooling(net, pool_type="max", kernel=(3, 3),
                              stride=(2, 2))
    net = sym.Flatten(net)
    for idx in (1, 2):  # two dropout-regularized 4096-wide hidden layers
        net = sym.FullyConnected(net, num_hidden=4096, name=f"fc{idx}")
        net = sym.Activation(net, act_type="relu")
        net = sym.Dropout(net, p=0.5)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(net, name="softmax")

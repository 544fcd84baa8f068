"""VGG symbol builder (parity: example/image-classification/symbols/vgg.py;
architecture from Simonyan & Zisserman 2014, configurations 11/13/16/19).

The port's copy of ``mxnet_tpu/models/vgg.py``: the same graph and names.
"""
from __future__ import annotations

from .. import symbol as sym

# layers-per-stage for each depth; every stage doubles filters up to 512
_CONFIGS = {
    11: (1, 1, 2, 2, 2),
    13: (2, 2, 2, 2, 2),
    16: (2, 2, 3, 3, 3),
    19: (2, 2, 4, 4, 4),
}
_FILTERS = (64, 128, 256, 512, 512)


def get_symbol(num_classes=1000, num_layers=16, batch_norm=False,
               dtype="float32", **kwargs):
    if num_layers not in _CONFIGS:
        raise ValueError("VGG depth must be one of %s" % list(_CONFIGS))
    net = sym.var("data")
    for stage, (reps, filters) in enumerate(
            zip(_CONFIGS[num_layers], _FILTERS)):
        for rep in range(reps):
            net = sym.Convolution(net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=filters,
                                  name="conv%d_%d" % (stage + 1, rep + 1))
            if batch_norm:
                net = sym.BatchNorm(net, name="bn%d_%d" % (stage + 1, rep + 1))
            net = sym.Activation(net, act_type="relu")
        net = sym.Pooling(net, pool_type="max", kernel=(2, 2), stride=(2, 2))
    net = sym.Flatten(net)
    net = sym.FullyConnected(net, num_hidden=4096, name="fc6")
    net = sym.Activation(net, act_type="relu")
    net = sym.Dropout(net, p=0.5)
    net = sym.FullyConnected(net, num_hidden=4096, name="fc7")
    net = sym.Activation(net, act_type="relu")
    net = sym.Dropout(net, p=0.5)
    net = sym.FullyConnected(net, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(net, name="softmax")

"""Gluon convolution and pooling layers.

Counterpart of ``mxnet_tpu/gluon/nn/conv_layers.py`` (ref: python/mxnet/
gluon/nn/conv_layers.py): Conv1D/2D/3D and their Transpose forms,
Max/Avg/GlobalMax/GlobalAvg pooling in 1-D, 2-D and 3-D, and
ReflectionPad2D, with the reference's parameter names, shapes and
``__repr__``.  One ``_Conv`` and one ``_Pooling`` carry the behaviour;
the public classes pin dimensionality and pool type.  They run the
port's ``Convolution``/``Deconvolution`` (cuDNN), ``Pooling`` (2-D
pooling's input gradient in the hand-written kernels) and ``Pad`` ops.
"""
from __future__ import annotations

from ..block import HybridBlock
from .basic_layers import Activation, _resolve_init

__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose", "MaxPool1D", "MaxPool2D",
           "MaxPool3D", "AvgPool1D", "AvgPool2D", "AvgPool3D",
           "GlobalMaxPool1D", "GlobalMaxPool2D", "GlobalMaxPool3D",
           "GlobalAvgPool1D", "GlobalAvgPool2D", "GlobalAvgPool3D",
           "ReflectionPad2D"]

_LAYOUTS = {1: "NCW", 2: "NCHW", 3: "NCDHW"}


def _ntuple(value, n):
    return (value,) * n if isinstance(value, int) else tuple(value)


class _Conv(HybridBlock):
    """Shared conv/deconv machinery; dimensionality comes entirely from
    the kernel tuple handed in by the public classes."""

    def __init__(self, channels, kernel_size, strides, padding, dilation,
                 groups, layout, in_channels=0, activation=None,
                 use_bias=True, weight_initializer=None,
                 bias_initializer="zeros", op_name="Convolution", adj=None,
                 prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        with self.name_scope():
            ndim = len(kernel_size)
            self._channels = channels
            self._in_channels = in_channels
            self._op_name = op_name
            self._kwargs = {
                "kernel": kernel_size,
                "stride": _ntuple(strides, ndim),
                "dilate": _ntuple(dilation, ndim),
                "pad": _ntuple(padding, ndim),
                "num_filter": channels, "num_group": groups,
                "no_bias": not use_bias, "layout": layout}
            if adj is not None:
                self._kwargs["adj"] = adj

            if op_name == "Convolution":  # OIHW
                wshape = (channels, in_channels // groups) + kernel_size
            else:  # Deconvolution: IOHW
                wshape = (in_channels, channels // groups) + kernel_size
            if in_channels == 0:
                wshape = (0,) * len(wshape)  # defer until first forward
            self.weight = self.params.get(
                "weight", shape=wshape, init=weight_initializer,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(channels,),
                init=_resolve_init(bias_initializer),
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        op = getattr(F, self._op_name)
        args = (x, weight) if bias is None else (x, weight, bias)
        out = op(*args, name="fwd", **self._kwargs)
        return out if self.act is None else self.act(out)

    def _alias(self):
        return "conv"

    def __repr__(self):
        shape = self.weight.shape
        return "{}({} -> {}, kernel_size={}, stride={})".format(
            type(self).__name__, shape[1] if shape[1] else None, shape[0],
            self._kwargs["kernel"], self._kwargs["stride"])


def _conv_class(name, ndim, transpose):
    scalar_default = 1 if ndim == 1 else (1,) * ndim
    pad_default = 0 if ndim == 1 else (0,) * ndim

    if transpose:
        def __init__(self, channels, kernel_size, strides=scalar_default,
                     padding=pad_default, output_padding=pad_default,
                     dilation=scalar_default, groups=1,
                     layout=_LAYOUTS[ndim], activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kwargs):
            _Conv.__init__(self, channels, _ntuple(kernel_size, ndim),
                           strides, padding, dilation, groups, layout,
                           in_channels, activation, use_bias,
                           weight_initializer, bias_initializer,
                           op_name="Deconvolution",
                           adj=_ntuple(output_padding, ndim), **kwargs)
    else:
        def __init__(self, channels, kernel_size, strides=scalar_default,
                     padding=pad_default, dilation=scalar_default, groups=1,
                     layout=_LAYOUTS[ndim], activation=None, use_bias=True,
                     weight_initializer=None, bias_initializer="zeros",
                     in_channels=0, **kwargs):
            _Conv.__init__(self, channels, _ntuple(kernel_size, ndim),
                           strides, padding, dilation, groups, layout,
                           in_channels, activation, use_bias,
                           weight_initializer, bias_initializer, **kwargs)

    return type(name, (_Conv,), {"__init__": __init__})


Conv1D = _conv_class("Conv1D", 1, False)
Conv2D = _conv_class("Conv2D", 2, False)
Conv3D = _conv_class("Conv3D", 3, False)
Conv1DTranspose = _conv_class("Conv1DTranspose", 1, True)
Conv2DTranspose = _conv_class("Conv2DTranspose", 2, True)
Conv3DTranspose = _conv_class("Conv3DTranspose", 3, True)


class _Pooling(HybridBlock):
    def __init__(self, pool_size, strides, padding, ceil_mode, global_pool,
                 pool_type, **kwargs):
        super().__init__(**kwargs)
        ndim = len(pool_size)
        self._kwargs = {
            "kernel": pool_size,
            "stride": _ntuple(strides if strides is not None else pool_size,
                              ndim),
            "pad": _ntuple(padding, ndim),
            "global_pool": global_pool, "pool_type": pool_type,
            "pooling_convention": "full" if ceil_mode else "valid"}

    def _alias(self):
        return "pool"

    def hybrid_forward(self, F, x):
        return F.Pooling(x, name="fwd", **self._kwargs)

    def __repr__(self):
        return ("{}(size={}, stride={}, padding={}, ceil_mode={})"
                .format(type(self).__name__, self._kwargs["kernel"],
                        self._kwargs["stride"], self._kwargs["pad"],
                        self._kwargs["pooling_convention"] == "full"))


def _pool_class(name, ndim, pool_type):
    size_default = 2 if ndim == 1 else (2,) * ndim

    def __init__(self, pool_size=size_default, strides=None, padding=0,
                 layout=_LAYOUTS[ndim], ceil_mode=False, **kwargs):
        _Pooling.__init__(self, _ntuple(pool_size, ndim), strides, padding,
                          ceil_mode, False, pool_type, **kwargs)

    return type(name, (_Pooling,), {"__init__": __init__})


def _global_pool_class(name, ndim, pool_type):
    def __init__(self, layout=_LAYOUTS[ndim], **kwargs):
        _Pooling.__init__(self, (1,) * ndim, None, 0, True, True,
                          pool_type, **kwargs)

    return type(name, (_Pooling,), {"__init__": __init__})


MaxPool1D = _pool_class("MaxPool1D", 1, "max")
MaxPool2D = _pool_class("MaxPool2D", 2, "max")
MaxPool3D = _pool_class("MaxPool3D", 3, "max")
AvgPool1D = _pool_class("AvgPool1D", 1, "avg")
AvgPool2D = _pool_class("AvgPool2D", 2, "avg")
AvgPool3D = _pool_class("AvgPool3D", 3, "avg")
GlobalMaxPool1D = _global_pool_class("GlobalMaxPool1D", 1, "max")
GlobalMaxPool2D = _global_pool_class("GlobalMaxPool2D", 2, "max")
GlobalMaxPool3D = _global_pool_class("GlobalMaxPool3D", 3, "max")
GlobalAvgPool1D = _global_pool_class("GlobalAvgPool1D", 1, "avg")
GlobalAvgPool2D = _global_pool_class("GlobalAvgPool2D", 2, "avg")
GlobalAvgPool3D = _global_pool_class("GlobalAvgPool3D", 3, "avg")


class ReflectionPad2D(HybridBlock):
    """Reflection padding on the spatial dims of NCHW input."""

    def __init__(self, padding=0, **kwargs):
        super().__init__(**kwargs)
        if isinstance(padding, int):
            padding = (0, 0, 0, 0) + (padding,) * 4
        self._padding = padding

    def hybrid_forward(self, F, x):
        return F.Pad(x, mode="reflect", pad_width=self._padding)

"""Basic Gluon layers.

Counterpart of ``mxnet_tpu/gluon/nn/basic_layers.py`` (ref:
python/mxnet/gluon/nn/basic_layers.py): Sequential/HybridSequential,
Dense, Dropout, Embedding, BatchNorm, InstanceNorm, LayerNorm, Flatten,
the Lambda wrappers and the activations, each over the port's registered
ops so that imperative and hybridized runs compute the same functions.
"""
from __future__ import annotations

import warnings

import numpy as np

from ..block import Block, HybridBlock
from ..utils import _indent

__all__ = ["Sequential", "HybridSequential", "Dense", "Dropout",
           "Embedding", "BatchNorm", "InstanceNorm", "LayerNorm", "Flatten",
           "Lambda", "HybridLambda", "Activation", "LeakyReLU"]


def _resolve_init(init):
    from ... import initializer as init_mod
    if isinstance(init, str):
        return {"zeros": init_mod.Zero(), "ones": init_mod.One()}.get(
            init, init)
    return init


class _ChainMixin:
    """add/index/len/repr shared by the two sequential containers."""

    def add(self, *blocks):
        for block in blocks:
            self.register_child(block)

    def __getitem__(self, key):
        return self._children[key]

    def __len__(self):
        return len(self._children)

    def __repr__(self):
        body = "\n".join("  (%d): %s" % (i, _indent(str(block), 2))
                         for i, block in enumerate(self._children))
        return "%s(\n%s\n)" % (type(self).__name__, body)


class Sequential(_ChainMixin, Block):
    """Imperative stack of child blocks."""

    def forward(self, x):
        for block in self._children:
            x = block(x)
        return x

    def hybridize(self, active=True, **kwargs):
        if self._children and all(isinstance(c, HybridBlock)
                                  for c in self._children):
            warnings.warn(
                "All children of this Sequential layer are HybridBlocks. "
                "Consider using HybridSequential for the best "
                "performance.", stacklevel=2)
        super().hybridize(active, **kwargs)


class HybridSequential(_ChainMixin, HybridBlock):
    """Hybridizable stack of child blocks."""

    def hybrid_forward(self, F, x):
        for block in self._children:
            x = block(x)
        return x


class Activation(HybridBlock):
    def __init__(self, activation, **kwargs):
        self._act_type = activation
        super().__init__(**kwargs)

    def _alias(self):
        return self._act_type

    def hybrid_forward(self, F, x):
        return F.Activation(x, act_type=self._act_type, name="fwd")

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._act_type)


class LeakyReLU(HybridBlock):
    def __init__(self, alpha, **kwargs):
        super().__init__(**kwargs)
        self._alpha = alpha

    def hybrid_forward(self, F, x):
        return F.LeakyReLU(x, act_type="leaky", slope=self._alpha,
                           name="fwd")


class Dense(HybridBlock):
    """Fully connected layer, optionally flattening trailing dims."""

    def __init__(self, units, activation=None, use_bias=True, flatten=True,
                 dtype="float32", weight_initializer=None,
                 bias_initializer="zeros", in_units=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._units = units
        self._flatten = flatten
        with self.name_scope():
            self.weight = self.params.get(
                "weight", shape=(units, in_units),
                init=weight_initializer, dtype=dtype,
                allow_deferred_init=True)
            self.bias = self.params.get(
                "bias", shape=(units,),
                init=_resolve_init(bias_initializer), dtype=dtype,
                allow_deferred_init=True) if use_bias else None
            self.act = Activation(activation, prefix=activation + "_") \
                if activation is not None else None

    def hybrid_forward(self, F, x, weight, bias=None):
        if bias is None:
            out = F.FullyConnected(x, weight, no_bias=True,
                                   num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        else:
            out = F.FullyConnected(x, weight, bias, num_hidden=self._units,
                                   flatten=self._flatten, name="fwd")
        return out if self.act is None else self.act(out)

    def __repr__(self):
        shape = self.weight.shape
        return "%s(%s -> %s, %s)" % (
            type(self).__name__, shape[1] if shape[1] else None, shape[0],
            self.act if self.act else "linear")


class Dropout(HybridBlock):
    def __init__(self, rate, axes=(), **kwargs):
        super().__init__(**kwargs)
        self._rate = rate
        self._axes = axes

    def hybrid_forward(self, F, x):
        return F.Dropout(x, p=self._rate, axes=self._axes, name="fwd")

    def __repr__(self):
        return "%s(p = %s)" % (type(self).__name__, self._rate)


def _affine_pair(layer, in_channels, scale, center, gamma_init, beta_init):
    """Declare the gamma/beta parameter pair every norm layer carries;
    a disabled side becomes a frozen constant (grad_req='null')."""
    layer.gamma = layer.params.get(
        "gamma", grad_req="write" if scale else "null",
        shape=(in_channels,), init=_resolve_init(gamma_init),
        allow_deferred_init=True, differentiable=scale)
    layer.beta = layer.params.get(
        "beta", grad_req="write" if center else "null",
        shape=(in_channels,), init=_resolve_init(beta_init),
        allow_deferred_init=True, differentiable=center)


class BatchNorm(HybridBlock):
    """Batch normalization with tracked running statistics."""

    def __init__(self, axis=1, momentum=0.9, epsilon=1e-5, center=True,
                 scale=True, use_global_stats=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 running_mean_initializer="zeros",
                 running_variance_initializer="ones", in_channels=0,
                 **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"axis": axis, "eps": epsilon, "momentum": momentum,
                        "fix_gamma": not scale,
                        "use_global_stats": use_global_stats}
        if in_channels != 0:
            self.in_channels = in_channels
        _affine_pair(self, in_channels, scale, center, gamma_initializer,
                     beta_initializer)
        for name, init in (("running_mean", running_mean_initializer),
                           ("running_var", running_variance_initializer)):
            setattr(self, name, self.params.get(
                name, grad_req="null", shape=(in_channels,),
                init=_resolve_init(init), allow_deferred_init=True,
                differentiable=False))

    def cast(self, dtype):
        # f16 statistics lose too much precision: the BatchNorm type rule
        # keeps gamma, beta and the moving statistics f32 for f16 data
        if np.dtype(dtype).name == "float16":
            dtype = "float32"
        super().cast(dtype)

    def hybrid_forward(self, F, x, gamma, beta, running_mean, running_var):
        return F.BatchNorm(x, gamma, beta, running_mean, running_var,
                           name="fwd", **self._kwargs)

    def __repr__(self):
        channels = self.gamma.shape[0]
        opts = ", ".join("%s=%r" % kv for kv in self._kwargs.items())
        return "%s(%s, in_channels=%s)" % (
            type(self).__name__, opts, channels if channels else None)


class InstanceNorm(HybridBlock):
    """Normalization over each sample's spatial axes, per channel."""

    def __init__(self, axis=1, epsilon=1e-5, center=True, scale=False,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"eps": epsilon}
        _affine_pair(self, in_channels, scale, center, gamma_initializer,
                     beta_initializer)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.InstanceNorm(x, gamma, beta, name="fwd", **self._kwargs)


class LayerNorm(HybridBlock):
    """Normalization over one axis (default: last)."""

    def __init__(self, axis=-1, epsilon=1e-5, center=True, scale=True,
                 beta_initializer="zeros", gamma_initializer="ones",
                 in_channels=0, **kwargs):
        super().__init__(**kwargs)
        self._axis = axis
        self._epsilon = epsilon
        _affine_pair(self, in_channels, scale, center, gamma_initializer,
                     beta_initializer)

    def hybrid_forward(self, F, x, gamma, beta):
        return F.LayerNorm(x, gamma, beta, axis=self._axis,
                           eps=self._epsilon)


class Embedding(HybridBlock):
    def __init__(self, input_dim, output_dim, dtype="float32",
                 weight_initializer=None, **kwargs):
        super().__init__(**kwargs)
        self._kwargs = {"input_dim": input_dim, "output_dim": output_dim,
                        "dtype": dtype}
        self.weight = self.params.get(
            "weight", shape=(input_dim, output_dim),
            init=weight_initializer, allow_deferred_init=True)

    def hybrid_forward(self, F, x, weight):
        return F.Embedding(x, weight, name="fwd", **self._kwargs)

    def __repr__(self):
        return "%s(%s -> %s, %s)" % (
            type(self).__name__, self._kwargs["input_dim"],
            self._kwargs["output_dim"], self._kwargs["dtype"])


class Flatten(HybridBlock):
    def hybrid_forward(self, F, x):
        return F.Flatten(x)

    def __repr__(self):
        return type(self).__name__


def _named_function(function, *namespaces):
    """Resolve a str to an op in the given namespaces, or pass a callable
    through; returns (callable-or-name, display_name)."""
    if callable(function):
        return function, getattr(function, "__name__", "custom")
    if isinstance(function, str):
        for ns in namespaces:
            if not hasattr(ns, function):
                raise AssertionError(
                    "Function name %s is not found in %s."
                    % (function, ns.__name__.split(".")[-1]))
        return function, function
    raise ValueError("Unrecognized function in lambda: {} of type {}"
                     .format(function, type(function)))


class Lambda(Block):
    """Wrap an ndarray function (by name) or any callable as a Block."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        from ... import ndarray as nd
        fn, self._func_name = _named_function(function, nd)
        self._func_impl = getattr(nd, fn) if isinstance(fn, str) else fn

    def forward(self, *args):
        return self._func_impl(*args)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._func_name)


class HybridLambda(HybridBlock):
    """Wrap an F-generic function (by name, resolved per backend) or a
    callable taking (F, x, ...) as a HybridBlock."""

    def __init__(self, function, prefix=None):
        super().__init__(prefix=prefix)
        from ... import ndarray as nd
        from ... import symbol as sym
        fn, self._func_name = _named_function(function, nd, sym)
        if isinstance(fn, str):
            self._func = lambda F, *args: getattr(F, fn)(*args)
        else:
            self._func = fn

    def hybrid_forward(self, F, x, *args):
        return self._func(F, x, *args)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, self._func_name)

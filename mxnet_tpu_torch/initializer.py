"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: the same registry, the same
name rules (``InitDesc`` plus a suffix -> rule table: ``_weight`` takes
the initializer's own rule, ``_bias``/``_beta``/``moving_mean`` are 0,
``_gamma``/``moving_var`` are 1), and ``Zero``, ``One``, ``Constant``,
``Uniform``, ``Normal`` and ``Xavier``.  Random fills draw on the host
from ``random.generator("cpu")`` (seeded by ``mx.random.seed``) and are
copied into the array wherever it lives, so a seed gives the same weights
on the card and on the host.
"""
from __future__ import annotations

import json
import math

import torch

from .ndarray import NDArray
from . import random as _random


class InitDesc(str):
    """A parameter name carrying its symbol attrs and the global default."""

    def __new__(cls, name, attrs=None, global_init=None):
        self = super().__new__(cls, name)
        self.attrs = attrs or {}
        self.global_init = global_init
        return self


_REGISTRY = {}


def register(*aliases):
    """Register an Initializer class under its lowercase name + aliases."""
    def _add(cls, extra=()):
        for key in (cls.__name__.lower(), *extra):
            _REGISTRY[key] = cls
        return cls

    if len(aliases) == 1 and isinstance(aliases[0], type):
        return _add(aliases[0])
    return lambda cls: _add(cls, aliases)


def _from_dumps(blob):
    """Rebuild an initializer from its ``dumps()`` JSON blob."""
    kind, kwargs = json.loads(blob)
    return _REGISTRY[kind.lower()](**kwargs)


def create(name, **kwargs):
    """Instantiate a registered initializer by name."""
    cls = _REGISTRY.get(str(name).lower())
    if cls is None:
        raise ValueError("unknown initializer %r; registered: %s"
                         % (name, sorted(_REGISTRY)))
    return cls(**kwargs)


# Suffix dispatch, first match wins: (name suffixes, handler name).
_SUFFIX_RULES = (
    (("weight", "parameters"), "_init_weight"),
    (("bias",), "_init_bias"),
    (("gamma",), "_init_gamma"),
    (("beta",), "_init_beta"),
    (("min",), "_init_zero"),
    (("max",), "_init_one"),
    (("moving_mean", "running_mean", "moving_avg"), "_init_zero"),
    (("moving_var", "running_var"), "_init_one"),
    (("moving_inv_var",), "_init_zero"),
)


def _fill(arr, value):
    """Write a number or a host tensor into ``arr`` in place."""
    with torch.no_grad():
        if isinstance(value, torch.Tensor):
            arr.tensor.copy_(value)
        else:
            arr.tensor.fill_(value)


class Initializer:
    """Base initializer: routes a named array to the right fill rule."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def _dispatch(self, name, arr):
        for suffixes, handler in _SUFFIX_RULES:
            if name.endswith(suffixes):
                getattr(self, handler)(name, arr)
                return
        self._init_default(name, arr)

    def __call__(self, desc, arr):
        if not isinstance(arr, NDArray):
            raise TypeError("arr must be NDArray")
        if not isinstance(desc, InitDesc):
            if not isinstance(desc, str):
                raise TypeError("name must be string")
            self._dispatch(desc, arr)
            return
        if desc.global_init is None:
            desc.global_init = self
        override = desc.attrs.get("__init__", "")
        if override:
            # a per-parameter initializer attached via symbol attrs wins
            _from_dumps(override)._init_weight(desc, arr)
        else:
            self._dispatch(desc, arr)

    def _init_zero(self, _, arr):
        _fill(arr, 0.0)

    def _init_one(self, _, arr):
        _fill(arr, 1.0)

    _init_bias = _init_zero
    _init_beta = _init_zero
    _init_gamma = _init_one

    def _init_weight(self, name, arr):
        raise NotImplementedError(
            "%s does not define a weight rule" % type(self).__name__)

    def _init_default(self, name, _):
        raise ValueError(
            "no initialization rule matches parameter name %r" % str(name))

    def __eq__(self, other):
        if not isinstance(other, Initializer):
            return NotImplemented
        return type(self) is type(other) and self._kwargs == other._kwargs


def _host_uniform(shape, low, high):
    out = torch.empty(shape, dtype=torch.float32)
    return out.uniform_(low, high, generator=_random.generator("cpu"))


def _host_normal(shape, std):
    out = torch.empty(shape, dtype=torch.float32)
    return out.normal_(0.0, std, generator=_random.generator("cpu"))


@register("zeros")
class Zero(Initializer):
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        _fill(arr, 0.0)


@register("ones")
class One(Initializer):
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        _fill(arr, 1.0)


@register
class Constant(Initializer):
    def __init__(self, value=0.0):
        super().__init__(value=value)
        self.value = value

    def _init_weight(self, _, arr):
        _fill(arr, self.value)


@register
class Uniform(Initializer):
    def __init__(self, scale=0.07):
        super().__init__(scale=scale)
        self.scale = scale

    def _init_weight(self, _, arr):
        _fill(arr, _host_uniform(arr.shape, -self.scale, self.scale))


@register
class Normal(Initializer):
    def __init__(self, sigma=0.01):
        super().__init__(sigma=sigma)
        self.sigma = sigma

    def _init_weight(self, _, arr):
        _fill(arr, _host_normal(arr.shape, self.sigma))


def _fans(shape, name):
    """(fan_in, fan_out) of a weight, folding spatial dims into both."""
    if len(shape) < 2:
        raise ValueError(
            "Xavier-family initializers need a >=2-D weight; %r is %s"
            % (str(name), (shape,)))
    receptive = math.prod(shape[2:]) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


@register
class Xavier(Initializer):
    """Variance-scaled random fill (Glorot/He family)."""

    _FACTORS = {
        "avg": lambda fi, fo: (fi + fo) / 2.0,
        "in": lambda fi, fo: fi,
        "out": lambda fi, fo: fo,
    }

    def __init__(self, rnd_type="uniform", factor_type="avg", magnitude=3):
        super().__init__(rnd_type=rnd_type, factor_type=factor_type,
                         magnitude=magnitude)
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = float(magnitude)

    def _init_weight(self, name, arr):
        fan_in, fan_out = _fans(arr.shape, name)
        try:
            factor = self._FACTORS[self.factor_type](fan_in, fan_out)
        except KeyError:
            raise ValueError(
                "factor_type must be one of %s; got %r"
                % (sorted(self._FACTORS), self.factor_type))
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            sample = _host_uniform(arr.shape, -scale, scale)
        elif self.rnd_type == "gaussian":
            sample = _host_normal(arr.shape, scale)
        else:
            raise ValueError(
                "rnd_type must be 'uniform' or 'gaussian'; got %r"
                % self.rnd_type)
        _fill(arr, sample)

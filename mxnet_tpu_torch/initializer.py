"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: the same registry, the same
name rules (``InitDesc`` plus a suffix -> rule table: ``_weight`` takes
the initializer's own rule, ``_bias``/``_beta``/``moving_mean`` are 0,
``_gamma``/``moving_var`` are 1; a bare-string name also takes the
legacy ``upsampling``/``stn_loc`` prefix rules), every initializer of the
JAX package (``Zero``, ``One``, ``Constant``, ``Uniform``, ``Normal``,
``Orthogonal``, ``Xavier``, ``MSRAPrelu``, ``Bilinear``, ``LSTMBias``,
``FusedRNN``), and ``Load`` and ``Mixed``.  Random fills draw on the host
from ``random.generator("cpu")`` (seeded by ``mx.random.seed``) and are
copied into the array wherever it lives, so a seed gives the same weights
on the card and on the host.
"""
from __future__ import annotations

import json
import logging
import math
import re

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


# Extra prefix rules only the legacy (bare string name) path honours.
_LEGACY_PREFIX_RULES = (
    ("upsampling", None, "_init_bilinear"),
    ("stn_loc", "weight", "_init_zero"),
    ("stn_loc", "bias", "_init_loc_bias"),
)


def _triangle(n, f, c):
    """1-D bilinear interpolation profile of length n."""
    return 1.0 - torch.abs(torch.arange(n, dtype=torch.float64) / f - c)


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

    def _dispatch(self, name, arr, prefix_rules=()):
        for prefix, suffix, handler in prefix_rules:
            if name.startswith(prefix) and \
                    (suffix is None or name.endswith(suffix)):
                getattr(self, handler)(name, arr)
                return
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
            self._dispatch(desc, arr, prefix_rules=_LEGACY_PREFIX_RULES)
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

    def _init_bilinear(self, _, arr):
        # separable kernel: outer product of per-axis triangle profiles
        h, w = arr.shape[2], arr.shape[3]
        f = math.ceil(w / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        kernel = torch.outer(_triangle(h, f, c), _triangle(w, f, c))
        _fill(arr, kernel.float().expand(arr.shape))

    def _init_loc_bias(self, _, arr):
        if arr.shape[0] != 6:
            raise AssertionError("stn_loc bias needs 6 values")
        _fill(arr, torch.tensor([1.0, 0, 0, 0, 1.0, 0]))  # identity affine

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


class Load:
    """Fill parameters from a saved dict (or ``.params`` file), falling
    back to ``default_init`` for names it lacks."""

    def __init__(self, param, default_init=None, verbose=False):
        if isinstance(param, str):
            from .ndarray import load as nd_load
            param = nd_load(param)
        # strip the save format's "arg:"/"aux:" tags
        self.param = {(k[4:] if k[:4] in ("arg:", "aux:") else k): v
                      for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name, arr):
        loaded = self.param.get(name)
        if loaded is None:
            if self.default_init is None:
                raise ValueError(
                    "parameter %r is absent from the loaded dict and no "
                    "default initializer was given" % name)
            self.default_init(name, arr)
            return
        if arr.shape != loaded.shape:
            raise ValueError(
                "loaded parameter %r has shape %s but the target needs %s"
                % (name, loaded.shape, arr.shape))
        _fill(arr, loaded.tensor if isinstance(loaded, NDArray)
              else torch.as_tensor(loaded))
        if self.verbose:
            logging.info("Initialized %s by loading", name)


class Mixed:
    """First-matching-regex dispatch over a list of initializers."""

    def __init__(self, patterns, initializers):
        if len(patterns) != len(initializers):
            raise AssertionError("one initializer per pattern")
        self.map = [(re.compile(p), init)
                    for p, init in zip(patterns, initializers)]

    def __call__(self, name, arr):
        for pattern, init in self.map:
            if pattern.match(name):
                init(name, arr)
                return
        raise ValueError(
            "parameter name %r matched none of the Mixed patterns" % name)


@register("zeros")
class Zero(Initializer):
    def __init__(self):
        super().__init__()

    def _init_weight(self, _, arr):
        _fill(arr, 0.0)


zeros_init = Zero


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


@register
class Orthogonal(Initializer):
    """Scaled orthonormal basis from the SVD of a random matrix."""

    def __init__(self, scale=1.414, rand_type="uniform"):
        super().__init__(scale=scale, rand_type=rand_type)
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, _, arr):
        rows = arr.shape[0]
        cols = math.prod(arr.shape[1:])
        if self.rand_type == "uniform":
            seed = _host_uniform((rows, cols), -1.0, 1.0)
        else:
            seed = _host_normal((rows, cols), 1.0)
        u, _s, vt = torch.linalg.svd(seed.double(), full_matrices=False)
        basis = u if u.shape == seed.shape else vt
        _fill(arr, (self.scale * basis).reshape(arr.shape).float())


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


@register
class MSRAPrelu(Xavier):
    """He initialization adjusted for a PReLU negative slope."""

    def __init__(self, factor_type="avg", slope=0.25):
        super().__init__("gaussian", factor_type, 2.0 / (1 + slope ** 2))
        self._kwargs = {"factor_type": factor_type, "slope": slope}


@register
class Bilinear(Initializer):
    def __init__(self):
        super().__init__()

    _init_weight = Initializer._init_bilinear


@register
class LSTMBias(Initializer):
    """Zero bias with the forget gate offset to ``forget_bias``; the gate
    layout is [i, f, c, o] blocks of num_hidden each."""

    def __init__(self, forget_bias=1.0):
        super().__init__(forget_bias=forget_bias)
        self.forget_bias = forget_bias

    def _init_weight(self, _, arr):
        num_hidden = arr.shape[0] // 4
        bias = torch.zeros(arr.shape, dtype=torch.float32)
        bias[num_hidden:2 * num_hidden] = self.forget_bias
        _fill(arr, bias)


@register
class FusedRNN(Initializer):
    """Initialize a fused RNN's flat parameter vector gate by gate: unpack
    it with a ``FusedRNNCell``, apply ``init`` (or the global default) to
    each piece, force the LSTM forget-gate biases to ``forget_bias``, and
    repack."""

    def __init__(self, init, num_hidden, num_layers, mode,
                 bidirectional=False, forget_bias=1.0):
        if isinstance(init, str):
            init = _from_dumps(init)
        super().__init__(init=init.dumps() if init is not None else None,
                         num_hidden=num_hidden, num_layers=num_layers,
                         mode=mode, bidirectional=bidirectional,
                         forget_bias=forget_bias)
        self._init = init
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._forget_bias = forget_bias

    def _init_weight(self, desc, arr):
        from .rnn import rnn_cell
        cell = rnn_cell.FusedRNNCell(
            self._num_hidden, self._num_layers, self._mode,
            self._bidirectional, forget_bias=self._forget_bias, prefix="")
        pieces = cell.unpack_weights(
            {cell._parameter_prefix + "parameters": arr})
        fallback = getattr(desc, "global_init", None) or self._init
        for name, piece in pieces.items():
            if self._mode == "lstm" and name.endswith("_f_bias"):
                _fill(piece, self._forget_bias)
                continue
            chosen = self._init if self._init is not None else fallback
            chosen(InitDesc(name, global_init=fallback), piece)
        _fill(arr, cell.pack_weights(pieces)["parameters"].tensor)

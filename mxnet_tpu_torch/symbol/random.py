"""mx.sym.random: symbolic random sampling (ref:
python/mxnet/symbol/random.py).

Counterpart of ``mxnet_tpu/symbol/random.py``: ``mx.nd.random``'s
surface, building graph nodes.  A bound graph draws on its executor's
device from the port's generator of that device.
"""
from __future__ import annotations

from .symbol import Symbol, _create

__all__ = ['uniform', 'normal', 'poisson', 'exponential', 'gamma',
           'multinomial', 'negative_binomial',
           'generalized_negative_binomial', 'shuffle', 'randint']


def _helper(random_op, sampler_op, params, shape, dtype, kwargs):
    name = kwargs.pop("name", None)
    if any(isinstance(p, Symbol) for p in params.values()):
        if sampler_op is None:
            raise ValueError("Symbol distribution parameters are not "
                             "supported for this sampler")
        if not all(isinstance(p, Symbol) for p in params.values()):
            raise ValueError("Distribution parameters must all have the "
                             "same type, but got both %s" %
                             ([type(p).__name__ for p in params.values()],))
        attrs = dict(kwargs)
        if shape is not None:
            attrs["shape"] = shape
        if dtype is not None:
            attrs["dtype"] = dtype
        return _create(sampler_op, list(params.values()), attrs, name=name)
    attrs = dict(params)
    attrs.update(kwargs)
    if shape is not None:
        attrs["shape"] = shape
    if dtype is not None:
        attrs["dtype"] = dtype
    return _create(random_op, [], attrs, name=name)


def uniform(low=0, high=1, shape=None, dtype=None, **kwargs):
    return _helper("_random_uniform", "_sample_uniform_tensor",
                   {"low": low, "high": high}, shape, dtype, kwargs)


def normal(loc=0, scale=1, shape=None, dtype=None, **kwargs):
    if isinstance(loc, Symbol) or isinstance(scale, Symbol):
        return _helper("_random_normal", "_sample_normal_tensor",
                       {"mu": loc, "sigma": scale}, shape, dtype, kwargs)
    return _helper("_random_normal", None, {"loc": loc, "scale": scale},
                   shape, dtype, kwargs)


def poisson(lam=1, shape=None, dtype=None, **kwargs):
    return _helper("_random_poisson", "_sample_poisson", {"lam": lam},
                   shape, dtype, kwargs)


def exponential(scale=1, shape=None, dtype=None, **kwargs):
    return _helper("_random_exponential", "_sample_exponential",
                   {"lam": 1.0 / scale}, shape, dtype, kwargs)


def gamma(alpha=1, beta=1, shape=None, dtype=None, **kwargs):
    return _helper("_random_gamma", "_sample_gamma",
                   {"alpha": alpha, "beta": beta}, shape, dtype, kwargs)


def negative_binomial(k=1, p=1, shape=None, dtype=None, **kwargs):
    return _helper("_random_negative_binomial", "_sample_negative_binomial",
                   {"k": k, "p": p}, shape, dtype, kwargs)


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype=None,
                                  **kwargs):
    return _helper("_random_generalized_negative_binomial",
                   "_sample_generalized_negative_binomial",
                   {"mu": mu, "alpha": alpha}, shape, dtype, kwargs)


def randint(low, high, shape=None, dtype=None, **kwargs):
    return _helper("_random_randint", None, {"low": low, "high": high},
                   shape, dtype, kwargs)


def multinomial(data, shape=None, get_prob=False, dtype='int32', **kwargs):
    name = kwargs.pop("name", None)
    attrs = {"get_prob": get_prob, "dtype": dtype}
    if shape is not None:
        attrs["shape"] = shape
    attrs.update(kwargs)
    return _create("_sample_multinomial", [data], attrs, name=name)


def shuffle(data, **kwargs):
    name = kwargs.pop("name", None)
    return _create("_shuffle", [data], dict(kwargs), name=name)

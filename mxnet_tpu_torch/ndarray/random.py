"""mx.nd.random: random sampling (ref: python/mxnet/ndarray/random.py).

Counterpart of ``mxnet_tpu/ndarray/random.py``.  Each sampler follows the
reference's dispatch (``_random_helper``): scalar distribution parameters
go to the ``_random_*`` op, NDArray parameters to the ``_sample_*`` op,
and a mix of the two raises ``ValueError``.  The draws come from the
port's generator of the output's device (``mx.random.seed``).
"""
from __future__ import annotations

from .ndarray import NDArray, _invoke

__all__ = ['uniform', 'normal', 'poisson', 'exponential', 'gamma',
           'multinomial', 'negative_binomial',
           'generalized_negative_binomial', 'shuffle', 'randint']


def _helper(random_op, sampler_op, params, shape, dtype, ctx, out, kwargs):
    if any(isinstance(p, NDArray) for p in params.values()):
        if sampler_op is None:
            raise ValueError("NDArray distribution parameters are not "
                             "supported for this sampler")
        if not all(isinstance(p, NDArray) for p in params.values()):
            raise ValueError("Distribution parameters must all have the "
                             "same type, but got both %s" %
                             ([type(p).__name__ for p in params.values()],))
        attrs = dict(kwargs)
        if shape is not None:
            attrs["shape"] = shape
        if dtype is not None:
            attrs["dtype"] = dtype
        return _invoke(sampler_op, list(params.values()), attrs, out=out)
    attrs = dict(params)
    attrs.update(kwargs)
    if shape is not None:
        attrs["shape"] = shape
    if dtype is not None:
        attrs["dtype"] = dtype
    if ctx is not None:
        attrs["ctx"] = str(ctx)
    return _invoke(random_op, [], attrs, out=out)


def uniform(low=0, high=1, shape=None, dtype=None, ctx=None, out=None,
            **kwargs):
    """Draw samples from a uniform distribution on [low, high)."""
    return _helper("_random_uniform", "_sample_uniform_tensor",
                   {"low": low, "high": high}, shape, dtype, ctx, out, kwargs)


def normal(loc=0, scale=1, shape=None, dtype=None, ctx=None, out=None,
           **kwargs):
    """Draw samples from a normal distribution N(loc, scale^2)."""
    if isinstance(loc, NDArray) or isinstance(scale, NDArray):
        return _helper("_random_normal", "_sample_normal_tensor",
                       {"mu": loc, "sigma": scale}, shape, dtype, ctx, out,
                       kwargs)
    return _helper("_random_normal", None, {"loc": loc, "scale": scale},
                   shape, dtype, ctx, out, kwargs)


def poisson(lam=1, shape=None, dtype=None, ctx=None, out=None, **kwargs):
    """Draw samples from a Poisson distribution (float output)."""
    return _helper("_random_poisson", "_sample_poisson", {"lam": lam}, shape,
                   dtype, ctx, out, kwargs)


def exponential(scale=1, shape=None, dtype=None, ctx=None, out=None,
                **kwargs):
    """Draw samples from an exponential distribution with mean ``scale``
    (an NDArray ``scale`` is the rate, as in the reference)."""
    return _helper("_random_exponential", "_sample_exponential",
                   {"lam": 1.0 / scale}, shape, dtype, ctx, out, kwargs)


def gamma(alpha=1, beta=1, shape=None, dtype=None, ctx=None, out=None,
          **kwargs):
    """Draw samples from a gamma distribution (shape alpha, scale beta)."""
    return _helper("_random_gamma", "_sample_gamma",
                   {"alpha": alpha, "beta": beta}, shape, dtype, ctx, out,
                   kwargs)


def negative_binomial(k=1, p=1, shape=None, dtype=None, ctx=None, out=None,
                      **kwargs):
    """Draw samples from a negative binomial distribution."""
    return _helper("_random_negative_binomial", "_sample_negative_binomial",
                   {"k": k, "p": p}, shape, dtype, ctx, out, kwargs)


def generalized_negative_binomial(mu=1, alpha=1, shape=None, dtype=None,
                                  ctx=None, out=None, **kwargs):
    """Draw samples from a generalized negative binomial distribution."""
    return _helper("_random_generalized_negative_binomial",
                   "_sample_generalized_negative_binomial",
                   {"mu": mu, "alpha": alpha}, shape, dtype, ctx, out, kwargs)


def randint(low, high, shape=None, dtype=None, ctx=None, out=None, **kwargs):
    """Draw random integers from [low, high)."""
    return _helper("_random_randint", None, {"low": low, "high": high},
                   shape, dtype, ctx, out, kwargs)


def multinomial(data, shape=None, get_prob=False, out=None, dtype='int32',
                **kwargs):
    """Sample indices from the categorical distributions given by
    ``data``'s last axis."""
    attrs = {"get_prob": get_prob, "dtype": dtype}
    if shape is not None:
        attrs["shape"] = shape
    attrs.update(kwargs)
    return _invoke("_sample_multinomial", [data], attrs, out=out)


def shuffle(data, **kwargs):
    """Shuffle ``data`` along its first axis."""
    return _invoke("_shuffle", [data], dict(kwargs))

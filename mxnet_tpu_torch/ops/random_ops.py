"""Random sampling operators.

Counterpart of ``mxnet_tpu/ops/random_ops.py`` (ref: src/operator/random/:
sample_uniform/normal/gamma/exponential/poisson/negative_binomial/
generalized_negative_binomial, multinomial, shuffle).  The JAX package
threads a functional PRNG key into each op; here every op draws from the
port's generator of the device it computes on (``random.generator``,
seeded by ``mx.random.seed``), never from torch's default generator, so
``torch.manual_seed`` leaves the draws alone.  The bits differ from
JAX's; the distributions, shapes, dtypes and supports are the JAX
package's.

- The zero-input ``_random_*`` ops take their device from the registry
  (``takes_device``): the ``ctx`` attr or the current context
  imperatively, the executor's device inside a bound graph (the attr is
  ignored there, as the JAX package's jitted graph ignores it).
- The tensor-parameter ``_sample_*`` ops give one draw per parameter
  element and ``shape``: output shape ``param.shape + shape``.  Their
  dtype follows the JAX package's rule: float32 unless ``dtype`` says
  otherwise for uniform and normal, the parameter's dtype otherwise.
- Negative binomials are gamma-Poisson mixtures, as in the JAX package.
- Gradients: the port's outputs are the JAX package's functions of the
  draw, so autograd gives the same reparameterized gradients (uniform
  and normal in their parameters, the exponential in its rate, the
  gamma in alpha through torch's implicit-reparameterization rule), a
  zero gradient where the output is a count, and none for an index.
- Shape inference runs the ops on ``meta`` tensors; there they draw
  nothing.
"""
from __future__ import annotations

import torch

from .. import random as _random
from ..base import torch_dtype
from .registry import pBool, pDtype, pFloat, pInt, pShape, pStr, register

_SAMPLE_PARAMS = {"shape": (pShape, None), "ctx": (pStr, None),
                  "dtype": (pDtype, None)}
_MULTI_PARAMS = {"shape": (pShape, None), "dtype": (pDtype, None)}
_LOW_PRECISION = (torch.float16, torch.bfloat16)


def _shape_of(shape):
    return tuple(shape) if shape else (1,)


def _draw_dtype(dt):
    """Draw half-width floats in f32 and round: every device has the f32
    samplers."""
    return torch.float32 if dt in _LOW_PRECISION else dt


def _below(out, high):
    """Keep a uniform draw below ``high`` after rounding (an f32 ``u *
    range + low`` or its half-width cast may round up to it)."""
    top = torch.nextafter(torch.tensor(high, dtype=out.dtype),
                          torch.tensor(float("-inf"), dtype=out.dtype))
    return torch.where(out >= high, top.item(), out)


def _std_gamma(alpha, device):
    """Gamma(alpha, 1) draws, one per element of the f32/f64 tensor
    ``alpha``, differentiable in alpha."""
    return torch._standard_gamma(alpha, generator=_random.generator(device))


def _poisson(rate, device):
    """Poisson counts at ``rate``; autograd gives the rate a zero
    gradient, as the JAX package's integer draw does."""
    return torch.poisson(rate, generator=_random.generator(device))


# ---------------------------------------------------------------------------
# Scalar-parameter samplers (no tensor input)
# ---------------------------------------------------------------------------

def _dtype_of(dtype):
    return torch_dtype(dtype or "float32")


def _uniform(low=0.0, high=1.0, shape=None, ctx=None, dtype=None,
             _device=None):
    shape, dt = _shape_of(shape), _dtype_of(dtype)
    if _device.type == "meta":
        return torch.empty(shape, dtype=dt, device=_device)
    out = torch.empty(shape, dtype=_draw_dtype(dt), device=_device).uniform_(
        low, high, generator=_random.generator(_device))
    return _below(out.to(dt), high)


register("_random_uniform", _uniform, num_inputs=0, takes_device=True,
         needs_rng=True, aliases=("uniform", "random_uniform"),
         params=dict(_SAMPLE_PARAMS, low=(pFloat, 0.0), high=(pFloat, 1.0)))


def _normal(loc=0.0, scale=1.0, shape=None, ctx=None, dtype=None,
            _device=None):
    shape, dt = _shape_of(shape), _dtype_of(dtype)
    if _device.type == "meta":
        return torch.empty(shape, dtype=dt, device=_device)
    return torch.empty(shape, dtype=_draw_dtype(dt), device=_device).normal_(
        loc, scale, generator=_random.generator(_device)).to(dt)


register("_random_normal", _normal, num_inputs=0, takes_device=True,
         needs_rng=True, aliases=("normal", "random_normal"),
         params=dict(_SAMPLE_PARAMS, loc=(pFloat, 0.0), scale=(pFloat, 1.0)))


def _gamma(alpha=1.0, beta=1.0, shape=None, ctx=None, dtype=None,
           _device=None):
    shape, dt = _shape_of(shape), _dtype_of(dtype)
    if _device.type == "meta":
        return torch.empty(shape, dtype=dt, device=_device)
    a = torch.full(shape, float(alpha), dtype=_draw_dtype(dt), device=_device)
    return (_std_gamma(a, _device) * beta).to(dt)


register("_random_gamma", _gamma, num_inputs=0, takes_device=True,
         needs_rng=True, aliases=("random_gamma",),
         params=dict(_SAMPLE_PARAMS, alpha=(pFloat, 1.0), beta=(pFloat, 1.0)))


def _exponential(lam=1.0, shape=None, ctx=None, dtype=None, _device=None):
    shape, dt = _shape_of(shape), _dtype_of(dtype)
    if _device.type == "meta":
        return torch.empty(shape, dtype=dt, device=_device)
    return torch.empty(shape, dtype=_draw_dtype(dt), device=_device
                       ).exponential_(lam, generator=_random.generator(
                           _device)).to(dt)


register("_random_exponential", _exponential, num_inputs=0,
         takes_device=True, needs_rng=True, aliases=("random_exponential",),
         params=dict(_SAMPLE_PARAMS, lam=(pFloat, 1.0)))


def _poisson_op(lam=1.0, shape=None, ctx=None, dtype=None, _device=None):
    shape, dt = _shape_of(shape), _dtype_of(dtype)
    if _device.type == "meta":
        return torch.empty(shape, dtype=dt, device=_device)
    rate = torch.full(shape, float(lam), dtype=torch.float32, device=_device)
    return _poisson(rate, _device).to(dt)


register("_random_poisson", _poisson_op, num_inputs=0, takes_device=True,
         needs_rng=True, aliases=("random_poisson",),
         params=dict(_SAMPLE_PARAMS, lam=(pFloat, 1.0)))


def _negative_binomial(k=1, p=1.0, shape=None, ctx=None, dtype=None,
                       _device=None):
    shape, dt = _shape_of(shape), _dtype_of(dtype)
    if _device.type == "meta":
        return torch.empty(shape, dtype=dt, device=_device)
    kk = torch.full(shape, float(k), dtype=torch.float32, device=_device)
    lam = _std_gamma(kk, _device) * ((1 - p) / p)
    return _poisson(lam, _device).to(dt)


register("_random_negative_binomial", _negative_binomial, num_inputs=0,
         takes_device=True, needs_rng=True,
         aliases=("random_negative_binomial",),
         params=dict(_SAMPLE_PARAMS, k=(pInt, 1), p=(pFloat, 1.0)))


def _gen_negative_binomial(mu=1.0, alpha=1.0, shape=None, ctx=None,
                           dtype=None, _device=None):
    shape, dt = _shape_of(shape), _dtype_of(dtype)
    if _device.type == "meta":
        return torch.empty(shape, dtype=dt, device=_device)
    r = torch.full(shape, 1.0 / alpha, dtype=torch.float32, device=_device)
    lam = _std_gamma(r, _device) * (mu * alpha)
    return _poisson(lam, _device).to(dt)


register("_random_generalized_negative_binomial", _gen_negative_binomial,
         num_inputs=0, takes_device=True, needs_rng=True,
         aliases=("random_generalized_negative_binomial",),
         params=dict(_SAMPLE_PARAMS, mu=(pFloat, 1.0), alpha=(pFloat, 1.0)))


def _randint(low=0, high=1, shape=None, ctx=None, dtype="int32",
             _device=None):
    shape, dt = _shape_of(shape), torch_dtype(dtype or "int32")
    if _device.type == "meta":
        return torch.empty(shape, dtype=dt, device=_device)
    return torch.randint(int(low), int(high), shape, dtype=dt,
                         device=_device,
                         generator=_random.generator(_device))


register("_random_randint", _randint, num_inputs=0, takes_device=True,
         needs_rng=True,
         params=dict(_SAMPLE_PARAMS, low=(pInt, 0), high=(pInt, 1),
                     dtype=(pDtype, "int32")))


# ---------------------------------------------------------------------------
# Samplers over a tensor input
# ---------------------------------------------------------------------------

def _multinomial(data, shape=None, get_prob=False, dtype="int32"):
    """``shape[0]`` draws from each row of the (unnormalized) probabilities
    ``data``, clamped at 1e-37; with ``get_prob`` also ``log p[idx]`` in
    f32, differentiable in ``data``."""
    n = int(shape[0]) if shape else 1
    k = data.shape[-1]
    logp = torch.log(torch.clamp_min(data, 1e-37))
    rows = data.reshape(-1, k)
    if data.device.type == "meta":
        idx = torch.empty((rows.shape[0], n), dtype=torch.int64,
                          device=data.device)
    else:
        with torch.no_grad():
            idx = torch.multinomial(torch.clamp_min(rows.detach().float(),
                                                    1e-37),
                                    n, replacement=True,
                                    generator=_random.generator(data.device))
    lead = tuple(data.shape[:-1])
    out_shape = lead if shape is None or shape == () else lead + (n,)
    out = idx.reshape(out_shape).to(torch_dtype(dtype))
    if get_prob:
        prob = torch.gather(logp.reshape(-1, k), 1, idx)
        return out, prob.reshape(out_shape).to(torch.float32)
    return out


register("_sample_multinomial", _multinomial, num_inputs=1, needs_rng=True,
         aliases=("sample_multinomial",),
         num_outputs=lambda attrs: 2 if attrs.get("get_prob") else 1,
         params={"shape": (pShape, None), "get_prob": (pBool, False),
                 "dtype": (pDtype, "int32")})


def _multi_shapes(param, shape):
    """(out shape, the parameter's broadcast shape): one draw per
    parameter element and ``shape``."""
    s = tuple(shape) if shape else ()
    return tuple(param.shape) + s, tuple(param.shape) + (1,) * len(s)


def _multi_dtype(dtype, param):
    return torch_dtype(dtype) if dtype else param.dtype


def _sample_uniform(low, high, shape=None, dtype=None):
    out_shape, bshape = _multi_shapes(low, shape)
    dt = _dtype_of(dtype)
    lo, hi = low.reshape(bshape), high.reshape(bshape)
    if low.device.type == "meta":
        return torch.empty(out_shape, device=low.device,
                           dtype=torch.promote_types(dt, lo.dtype))
    u = torch.empty(out_shape, dtype=_draw_dtype(dt), device=low.device
                    ).uniform_(generator=_random.generator(low.device)).to(dt)
    out = u * (hi - lo) + lo
    # u < 1, but ``u * (hi - lo) + lo`` may round up to hi: keep [lo, hi)
    top = torch.nextafter(hi.detach().to(out.dtype), lo.detach().to(
        out.dtype))
    return torch.where(out < hi, out, top)


register("_sample_uniform", _sample_uniform, num_inputs=2, needs_rng=True,
         input_names=("low", "high"),
         aliases=("sample_uniform", "_sample_uniform_tensor"),
         params=dict(_MULTI_PARAMS))


def _sample_normal(mu, sigma, shape=None, dtype=None):
    out_shape, bshape = _multi_shapes(mu, shape)
    dt = _dtype_of(dtype)
    if mu.device.type == "meta":
        return torch.empty(out_shape, device=mu.device,
                           dtype=torch.promote_types(dt, mu.dtype))
    z = torch.empty(out_shape, dtype=_draw_dtype(dt), device=mu.device
                    ).normal_(generator=_random.generator(mu.device)).to(dt)
    return z * sigma.reshape(bshape) + mu.reshape(bshape)


register("_sample_normal", _sample_normal, num_inputs=2, needs_rng=True,
         input_names=("mu", "sigma"),
         aliases=("sample_normal", "_sample_normal_tensor"),
         params=dict(_MULTI_PARAMS))


def _sample_gamma(alpha, beta, shape=None, dtype=None):
    out_shape, bshape = _multi_shapes(alpha, shape)
    dt = _multi_dtype(dtype, alpha)
    if alpha.device.type == "meta":
        return torch.empty(out_shape, dtype=dt, device=alpha.device)
    a = alpha.reshape(bshape).to(_draw_dtype(dt)).expand(out_shape)
    g = _std_gamma(a.contiguous(), alpha.device).to(dt)
    return g * beta.reshape(bshape).to(dt)


register("_sample_gamma", _sample_gamma, num_inputs=2, needs_rng=True,
         input_names=("alpha", "beta"), aliases=("sample_gamma",),
         params=dict(_MULTI_PARAMS))


def _sample_exponential(lam, shape=None, dtype=None):
    out_shape, bshape = _multi_shapes(lam, shape)
    dt = _multi_dtype(dtype, lam)
    if lam.device.type == "meta":
        return torch.empty(out_shape, dtype=dt, device=lam.device)
    e = torch.empty(out_shape, dtype=_draw_dtype(dt), device=lam.device
                    ).exponential_(1.0, generator=_random.generator(
                        lam.device)).to(dt)
    return e / lam.reshape(bshape).to(dt)


register("_sample_exponential", _sample_exponential, num_inputs=1,
         needs_rng=True, input_names=("lam",),
         aliases=("sample_exponential",), params=dict(_MULTI_PARAMS))


def _sample_poisson(lam, shape=None, dtype=None):
    out_shape, bshape = _multi_shapes(lam, shape)
    dt = _multi_dtype(dtype, lam)
    if lam.device.type == "meta":
        return torch.empty(out_shape, dtype=dt, device=lam.device)
    rate = lam.reshape(bshape).float().expand(out_shape)
    return _poisson(rate.contiguous(), lam.device).to(dt)


register("_sample_poisson", _sample_poisson, num_inputs=1, needs_rng=True,
         input_names=("lam",), aliases=("sample_poisson",),
         params=dict(_MULTI_PARAMS))


def _sample_negative_binomial(k, p, shape=None, dtype=None):
    out_shape, bshape = _multi_shapes(k, shape)
    dt = _multi_dtype(dtype, p)
    if k.device.type == "meta":
        return torch.empty(out_shape, dtype=dt, device=k.device)
    kk = k.reshape(bshape).float().expand(out_shape)
    pp = p.reshape(bshape).float().expand(out_shape)
    lam = _std_gamma(kk.contiguous(), k.device) * (1 - pp) / pp
    return _poisson(lam, k.device).to(dt)


register("_sample_negative_binomial", _sample_negative_binomial,
         num_inputs=2, needs_rng=True, input_names=("k", "p"),
         aliases=("sample_negative_binomial",), params=dict(_MULTI_PARAMS))


def _sample_gen_negative_binomial(mu, alpha, shape=None, dtype=None):
    out_shape, bshape = _multi_shapes(mu, shape)
    dt = _multi_dtype(dtype, mu)
    if mu.device.type == "meta":
        return torch.empty(out_shape, dtype=dt, device=mu.device)
    r = 1.0 / alpha.reshape(bshape).float().expand(out_shape)
    mub = mu.reshape(bshape).float().expand(out_shape)
    lam = _std_gamma(r.contiguous(), mu.device) * mub / r
    return _poisson(lam, mu.device).to(dt)


register("_sample_generalized_negative_binomial",
         _sample_gen_negative_binomial, num_inputs=2, needs_rng=True,
         input_names=("mu", "alpha"),
         aliases=("sample_generalized_negative_binomial",),
         params=dict(_MULTI_PARAMS))


def _shuffle(data):
    """The rows of ``data`` in a random order (differentiable: the
    gradient goes back to each row's source)."""
    if data.device.type == "meta":
        return data.clone()
    perm = torch.randperm(data.shape[0], device=data.device,
                          generator=_random.generator(data.device))
    return data[perm]


register("_shuffle", _shuffle, num_inputs=1, needs_rng=True,
         aliases=("shuffle",))

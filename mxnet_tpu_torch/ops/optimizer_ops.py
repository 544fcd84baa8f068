"""Optimizer update operators.

Counterpart of ``mxnet_tpu/ops/optimizer_ops.py`` (ref:
optimizer_op-inl.h): ``sgd_update``, ``sgd_mom_update``, their
multi-precision forms ``mp_sgd_update``/``mp_sgd_mom_update`` (f32
master weights beside half-width storage), ``adam_update``,
``rmsprop_update``, ``rmspropalex_update`` (centered RMSProp),
``ftrl_update``, ``signsgd_update`` and ``signum_update``, and, from
``mxnet_tpu/ops/extra.py``, ``adamax_update``, ``ftml_update``,
``nadam_update``, ``nag_mom_update`` and ``sgld_update``.  The JAX
package returns new arrays and rebinds the handles; here the functions
the optimizers call are in-place tensor arithmetic on the weight and
state storage, which saves a copy of every parameter per step.  Their
scalar arguments may be Python floats or 0-d tensors: the fused train
step passes the learning rate and weight decay as device tensors, so
that a CUDA graph of the step reads them as data.  The registered ops
(``mx.nd.sgd_mom_update(w, g, mom, out=w, ...)``) run the same
arithmetic on copies and return the new weight, with the new states as
state outputs that ``mutate_map`` writes back into the state inputs, as
the reference's do.  A row_sparse gradient updates lazily (ref:
SGDUpdateRspImpl, AdamUpdateRspImpl): ``sgd_update_rsp``,
``sgd_mom_update_rsp`` and ``adam_update_rsp`` apply the same math to the
gradient's rows alone, weight and states, in place, and the registered
``sgd_update``, ``sgd_mom_update`` and ``adam_update`` take that path
for a row_sparse gradient unless ``lazy_update=False``, which declines
to the dense math on the densified gradient.  The math is the
reference's, operation for operation:

    g = clip(grad * rescale_grad, clip_gradient)
    sgd:      weight -= lr * (g + wd * weight)
    sgd_mom:  mom = momentum * mom - lr * (g + wd * weight); weight += mom
    mp_*:     the same on the f32 copy ``weight32`` of a half-width
              weight, with g taken in f32; then weight = weight32
    adam:     g += wd * weight; mean = beta1 * mean + (1 - beta1) * g;
              var = beta2 * var + (1 - beta2) * g**2;
              weight -= lr * mean / (sqrt(var) + epsilon)
    rmsprop:  g += wd * weight; n = (1 - gamma1) * g**2 + gamma1 * n;
              weight -= lr * g / sqrt(n + epsilon)
    ftrl:     n' = n + g**2; z += g - (sqrt(n') - sqrt(n)) / lr * weight;
              weight = -(z - sign(z) * lamda1) / ((beta + sqrt(n')) / lr
              + wd) where |z| > lamda1, else 0
    signsgd:  weight -= lr * (sign(g) + wd * weight)
    signum:   mom = momentum * mom - (1 - momentum) * (g + wd * weight);
              weight = (1 - lr * wd_lh) * weight + lr * sign(mom)
"""
from __future__ import annotations

import math

import torch

from .. import random as _random
from .registry import pBool, pFloat, pInt, register


def _clipped(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


def _clip_weights(weight, clip_weights):
    if clip_weights is not None and clip_weights > 0:
        weight.clamp_(-clip_weights, clip_weights)


@torch.no_grad()
def sgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
               clip_gradient=-1.0):
    """In place: ``weight -= lr * (g + wd * weight)``."""
    g = _clipped(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (g + wd * weight))


@torch.no_grad()
def sgd_mom_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                   rescale_grad=1.0, clip_gradient=-1.0):
    """In place: ``mom = momentum*mom - lr*(g + wd*weight); weight +=
    mom``."""
    g = _clipped(grad, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_(lr * (g + wd * weight))
    weight.add_(mom)


@torch.no_grad()
def mp_sgd_update(weight, grad, weight32, lr=0.01, wd=0.0, rescale_grad=1.0,
                  clip_gradient=-1.0):
    """``sgd_update`` of the f32 master ``weight32`` from the gradient
    taken in f32, then ``weight = weight32`` in weight's dtype."""
    sgd_update(weight32, grad.float(), lr=lr, wd=wd,
               rescale_grad=rescale_grad, clip_gradient=clip_gradient)
    weight.copy_(weight32)


@torch.no_grad()
def mp_sgd_mom_update(weight, grad, mom, weight32, lr=0.01, momentum=0.0,
                      wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """``sgd_mom_update`` of the f32 master ``weight32`` (f32 momentum)
    from the gradient taken in f32, then ``weight = weight32``."""
    sgd_mom_update(weight32, grad.float(), mom, lr=lr, momentum=momentum,
                   wd=wd, rescale_grad=rescale_grad,
                   clip_gradient=clip_gradient)
    weight.copy_(weight32)


@torch.no_grad()
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """In place on weight, mean and var (``lr`` carries the optimizer's
    bias correction, as in the reference)."""
    g = _clipped(grad, rescale_grad, clip_gradient) + wd * weight
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * torch.square(g))
    weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))


@torch.no_grad()
def rmsprop_update(weight, grad, n, lr=0.001, gamma1=0.95, epsilon=1e-8,
                   wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   clip_weights=-1.0):
    """In place on weight and n (Tieleman and Hinton's RMSProp)."""
    g = _clipped(grad, rescale_grad, clip_gradient) + wd * weight
    n.mul_(gamma1).add_((1 - gamma1) * torch.square(g))
    weight.sub_(lr * g / torch.sqrt(n + epsilon))
    _clip_weights(weight, clip_weights)


@torch.no_grad()
def rmspropalex_update(weight, grad, n, g_state, delta, lr=0.001,
                       gamma1=0.95, gamma2=0.9, epsilon=1e-8, wd=0.0,
                       rescale_grad=1.0, clip_gradient=-1.0,
                       clip_weights=-1.0):
    """In place on weight, n, g_state and delta (Graves' centered
    RMSProp)."""
    grd = _clipped(grad, rescale_grad, clip_gradient) + wd * weight
    n.mul_(gamma1).add_((1 - gamma1) * torch.square(grd))
    g_state.mul_(gamma1).add_((1 - gamma1) * grd)
    delta.mul_(gamma2).sub_(
        lr * grd / torch.sqrt(n - torch.square(g_state) + epsilon))
    weight.add_(delta)
    _clip_weights(weight, clip_weights)


@torch.no_grad()
def ftrl_update(weight, grad, z, n, lr=0.1, lamda1=0.01, beta=1.0, wd=0.0,
                rescale_grad=1.0, clip_gradient=-1.0):
    """In place on weight, z and n (McMahan et al.'s FTRL-proximal)."""
    g = _clipped(grad, rescale_grad, clip_gradient)
    new_n = n + torch.square(g)
    z.copy_(z + g - (torch.sqrt(new_n) - torch.sqrt(n)) / lr * weight)
    n.copy_(new_n)
    weight.copy_(torch.where(
        torch.abs(z) > lamda1,
        -(z - torch.sign(z) * lamda1) / ((beta + torch.sqrt(new_n)) / lr
                                         + wd),
        torch.zeros_like(weight)))


@torch.no_grad()
def signsgd_update(weight, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """In place: ``weight -= lr * (sign(g) + wd * weight)``."""
    g = _clipped(grad, rescale_grad, clip_gradient)
    weight.sub_(lr * (torch.sign(g) + wd * weight))


@torch.no_grad()
def signum_update(weight, grad, mom, lr=0.01, momentum=0.0, wd=0.0,
                  rescale_grad=1.0, clip_gradient=-1.0, wd_lh=0.0):
    """In place on weight and mom (Bernstein et al.'s Signum)."""
    g = _clipped(grad, rescale_grad, clip_gradient)
    mom.mul_(momentum).sub_((1 - momentum) * (g + wd * weight))
    weight.mul_(1 - lr * wd_lh).add_(lr * torch.sign(mom))


@torch.no_grad()
def sgd_update_rsp(weight, rows, grad, lr=0.01, wd=0.0, rescale_grad=1.0,
                   clip_gradient=-1.0):
    """``sgd_update`` of the rows ``rows`` of ``weight`` from their
    gradient rows ``grad``, in place.  A row named twice carries equal
    gradient rows (the static-shape retain and pull keep duplicates), so
    both writes put the same value."""
    g = _clipped(grad, rescale_grad, clip_gradient)
    wr = weight[rows]
    weight[rows] = wr - lr * (g + wd * wr)


@torch.no_grad()
def sgd_mom_update_rsp(weight, rows, grad, mom, lr=0.01, momentum=0.0,
                       wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """``sgd_mom_update`` of the gradient's rows of weight and mom, in
    place; the other rows keep their momentum."""
    g = _clipped(grad, rescale_grad, clip_gradient)
    wr = weight[rows]
    new_mom = momentum * mom[rows] - lr * (g + wd * wr)
    weight[rows] = wr + new_mom
    mom[rows] = new_mom


@torch.no_grad()
def adam_update_rsp(weight, rows, grad, mean, var, lr=0.001, beta1=0.9,
                    beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                    clip_gradient=-1.0):
    """``adam_update`` of the gradient's rows of weight, mean and var, in
    place; the other rows keep their moments."""
    wr = weight[rows]
    g = _clipped(grad, rescale_grad, clip_gradient) + wd * wr
    new_mean = beta1 * mean[rows] + (1 - beta1) * g
    new_var = beta2 * var[rows] + (1 - beta2) * torch.square(g)
    weight[rows] = wr - lr * new_mean / (torch.sqrt(new_var) + epsilon)
    mean[rows] = new_mean
    var[rows] = new_var


_COMMON = {"lr": (pFloat, 0.01), "wd": (pFloat, 0.0),
           "rescale_grad": (pFloat, 1.0), "clip_gradient": (pFloat, -1.0)}
_LAZY = dict(_COMMON, lazy_update=(pBool, True))


def _functional(update, n_states):
    """The registered op of in-place ``update``: new weight, then the
    ``n_states`` new states, computed on copies of the inputs."""
    def impl(weight, grad, *states, lazy_update=True, **attrs):
        new = [t.clone() for t in (weight,) + states]
        update(new[0], grad, *new[1:1 + n_states], **attrs)
        return tuple(new) if n_states else new[0]
    return impl


def _lazy(update_rsp, n_states):
    """The sparse implementation of a registered update op: for a
    row_sparse gradient, the new weight (a copy updated at the gradient's
    rows) and the states updated in place at those rows; ``NotImplemented``
    under ``lazy_update=False`` (the dense math on the densified gradient,
    every row decaying)."""
    def sparse_impl(inputs, attrs):
        attrs = dict(attrs)
        if not attrs.pop("lazy_update", True):
            return NotImplemented
        weight = inputs[0].tensor.clone()
        grad = inputs[1]
        states = [s.tensor for s in inputs[2:2 + n_states]]
        update_rsp(weight, grad.indices.tensor.long(), grad.data.tensor,
                   *states, **attrs)
        return (weight, *states) if n_states else weight
    return sparse_impl


def _register(name, update, n_states, params, lazy=None):
    pattern = ("default", "row_sparse") + ("default",) * n_states
    register(name, _functional(update, n_states), num_inputs=2 + n_states,
             mutate_map=tuple(range(2, 2 + n_states)), params=params,
             sparse_impl=lazy and _lazy(lazy, n_states),
             sparse_pattern=pattern if lazy else None)


_register("sgd_update", sgd_update, 0, _LAZY, lazy=sgd_update_rsp)
_register("sgd_mom_update", sgd_mom_update, 1,
          dict(_LAZY, momentum=(pFloat, 0.0)), lazy=sgd_mom_update_rsp)
_register("mp_sgd_update", mp_sgd_update, 1, _LAZY)
_register("mp_sgd_mom_update", mp_sgd_mom_update, 2,
          dict(_LAZY, momentum=(pFloat, 0.0)))
_register("adam_update", adam_update, 2,
          dict(_LAZY, lr=(pFloat, 0.001), beta1=(pFloat, 0.9),
               beta2=(pFloat, 0.999), epsilon=(pFloat, 1e-8)),
          lazy=adam_update_rsp)
_RMSPROP = dict(_COMMON, lr=(pFloat, 0.001), gamma1=(pFloat, 0.95),
                epsilon=(pFloat, 1e-8), clip_weights=(pFloat, -1.0))
_register("rmsprop_update", rmsprop_update, 1, _RMSPROP)
_register("rmspropalex_update", rmspropalex_update, 3,
          dict(_RMSPROP, gamma2=(pFloat, 0.9)))
_register("ftrl_update", ftrl_update, 2,
          dict(_COMMON, lr=(pFloat, 0.1), lamda1=(pFloat, 0.01),
               beta=(pFloat, 1.0)))
_register("signsgd_update", signsgd_update, 0, _COMMON)
_register("signum_update", signum_update, 1,
          dict(_COMMON, momentum=(pFloat, 0.0), wd_lh=(pFloat, 0.0)))


# ---------------------------------------------------------------------------
# The remaining update ops (ref: optimizer_op-inl.h; the JAX package's
# ops/extra.py): functional, the new weight first, then the new states,
# which mutate_map writes back into the state inputs.  The optimizers do
# not call them.
# ---------------------------------------------------------------------------

def _decayed(grad, weight, rescale_grad, wd, clip):
    """``g = grad * rescale_grad + wd * weight``, then clipped."""
    g = grad * rescale_grad + wd * weight
    if clip > 0:
        g = torch.clamp(g, -clip, clip)
    return g


def _ftml_update(weight, grad, d, v, z, lr=None, t=1, beta1=0.6,
                 beta2=0.999, epsilon=1e-8, wd=0.0, rescale_grad=1.0,
                 clip_grad=-1.0):
    g = _decayed(grad, weight, rescale_grad, wd, clip_grad)
    v_t = beta2 * v + (1 - beta2) * g * g
    d_t = (1 - beta1 ** t) / lr * \
        (torch.sqrt(v_t / (1 - beta2 ** t)) + epsilon)
    sigma_t = d_t - beta1 * d
    z_t = beta1 * z + (1 - beta1) * g - sigma_t * weight
    return -z_t / d_t, d_t, v_t, z_t


register("ftml_update", _ftml_update,
         input_names=("weight", "grad", "d", "v", "z"), mutate_map=(2, 3, 4),
         params={"lr": (pFloat, None), "t": (pInt, 1),
                 "beta1": (pFloat, 0.6), "beta2": (pFloat, 0.999),
                 "epsilon": (pFloat, 1e-8), "wd": (pFloat, 0.0),
                 "rescale_grad": (pFloat, 1.0), "clip_grad": (pFloat, -1.0)})


def _nag_mom_update(weight, grad, mom, lr=None, momentum=0.0, wd=0.0,
                    rescale_grad=1.0, clip_gradient=-1.0):
    g = _decayed(grad, weight, rescale_grad, wd, clip_gradient)
    mom_t = momentum * mom + g
    return weight - lr * (momentum * mom_t + g), mom_t


register("nag_mom_update", _nag_mom_update,
         input_names=("weight", "grad", "mom"), mutate_map=(2,),
         params={"lr": (pFloat, None), "momentum": (pFloat, 0.0),
                 "wd": (pFloat, 0.0), "rescale_grad": (pFloat, 1.0),
                 "clip_gradient": (pFloat, -1.0)})


def _sgld_update(weight, grad, lr=None, wd=0.0, rescale_grad=1.0,
                 clip_gradient=-1.0):
    """``weight - lr / 2 * g + N(0, lr)`` noise from the weight's device's
    generator."""
    g = _decayed(grad, weight, rescale_grad, wd, clip_gradient)
    noise = torch.empty_like(weight).normal_(
        generator=_random.generator(weight.device))
    return weight - lr / 2 * g + noise * math.sqrt(lr)


register("sgld_update", _sgld_update, input_names=("weight", "grad"),
         needs_rng=True,
         params={"lr": (pFloat, None), "wd": (pFloat, 0.0),
                 "rescale_grad": (pFloat, 1.0),
                 "clip_gradient": (pFloat, -1.0)})


def _adamax_update(weight, grad, mean, var, lr=None, beta1=0.9, beta2=0.999,
                   t=1, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                   epsilon=1e-8):
    g = _decayed(grad, weight, rescale_grad, wd, clip_gradient)
    m_t = beta1 * mean + (1 - beta1) * g
    u_t = torch.maximum(beta2 * var, torch.abs(g))
    return weight - lr / (1 - beta1 ** t) * m_t / (u_t + epsilon), m_t, u_t


_ADAM_LIKE = {"lr": (pFloat, None), "beta1": (pFloat, 0.9),
              "beta2": (pFloat, 0.999), "t": (pInt, 1), "wd": (pFloat, 0.0),
              "rescale_grad": (pFloat, 1.0), "clip_gradient": (pFloat, -1.0),
              "epsilon": (pFloat, 1e-8)}
register("adamax_update", _adamax_update,
         input_names=("weight", "grad", "mean", "var"), mutate_map=(2, 3),
         params=dict(_ADAM_LIKE))


def _nadam_update(weight, grad, mean, var, lr=None, beta1=0.9, beta2=0.999,
                  t=1, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0,
                  epsilon=1e-8, schedule_decay=0.004):
    g = _decayed(grad, weight, rescale_grad, wd, clip_gradient)
    mu_t = beta1 * (1 - 0.5 * 0.96 ** (t * schedule_decay))
    mu_t1 = beta1 * (1 - 0.5 * 0.96 ** ((t + 1) * schedule_decay))
    g_hat = g / (1 - mu_t)
    m_t = beta1 * mean + (1 - beta1) * g
    m_hat = m_t / (1 - mu_t1)
    v_t = beta2 * var + (1 - beta2) * g * g
    v_hat = v_t / (1 - beta2 ** t)
    m_bar = (1 - mu_t) * g_hat + mu_t1 * m_hat
    return weight - lr * m_bar / (torch.sqrt(v_hat) + epsilon), m_t, v_t


register("nadam_update", _nadam_update,
         input_names=("weight", "grad", "mean", "var"), mutate_map=(2, 3),
         params=dict(_ADAM_LIKE, schedule_decay=(pFloat, 0.004)))

"""Optimizer update operators.

Counterpart of ``sgd_update``, ``sgd_mom_update`` and ``adam_update`` of
``mxnet_tpu/ops/optimizer_ops.py`` (ref: optimizer_op-inl.h).  The JAX
package returns new arrays and rebinds the handles; here the functions
the optimizers call are in-place tensor arithmetic on the weight and
momentum storage, which saves a copy of every parameter per step.  The
registered ops (``mx.nd.sgd_mom_update(w, g, mom, out=w, ...)``) run the
same arithmetic on copies and return the new weight, with the new states
as state outputs that ``mutate_map`` writes back into the state inputs,
as the reference's do.  The math is the reference's, operation for
operation:

    g = clip(grad * rescale_grad, clip_gradient)
    sgd:     weight -= lr * (g + wd * weight)
    sgd_mom: mom = momentum * mom - lr * (g + wd * weight); weight += mom
    adam:    g += wd * weight; mean = beta1 * mean + (1 - beta1) * g;
             var = beta2 * var + (1 - beta2) * g**2;
             weight -= lr * mean / (sqrt(var) + epsilon)
"""
from __future__ import annotations

import torch

from .registry import pBool, pFloat, register


def _clipped(grad, rescale_grad, clip_gradient):
    g = grad * rescale_grad
    if clip_gradient is not None and clip_gradient >= 0:
        g = torch.clamp(g, -clip_gradient, clip_gradient)
    return g


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
def adam_update(weight, grad, mean, var, lr=0.001, beta1=0.9, beta2=0.999,
                epsilon=1e-8, wd=0.0, rescale_grad=1.0, clip_gradient=-1.0):
    """In place on weight, mean and var (``lr`` carries the optimizer's
    bias correction, as in the reference)."""
    g = _clipped(grad, rescale_grad, clip_gradient) + wd * weight
    mean.mul_(beta1).add_((1 - beta1) * g)
    var.mul_(beta2).add_((1 - beta2) * torch.square(g))
    weight.sub_(lr * mean / (torch.sqrt(var) + epsilon))


_COMMON = {"lr": (pFloat, 0.01), "wd": (pFloat, 0.0),
           "rescale_grad": (pFloat, 1.0), "clip_gradient": (pFloat, -1.0),
           "lazy_update": (pBool, True)}


def _functional(update, n_states):
    """The registered op of in-place ``update``: new weight, then the
    ``n_states`` new states, computed on copies of the inputs."""
    def impl(weight, grad, *states, lazy_update=True, **attrs):
        new = [t.clone() for t in (weight,) + states]
        update(new[0], grad, *new[1:1 + n_states], **attrs)
        return tuple(new) if n_states else new[0]
    return impl


register("sgd_update", _functional(sgd_update, 0), num_inputs=2,
         params=_COMMON)
register("sgd_mom_update", _functional(sgd_mom_update, 1), num_inputs=3,
         mutate_map=(2,), params=dict(_COMMON, momentum=(pFloat, 0.0)))
register("adam_update", _functional(adam_update, 2), num_inputs=4,
         mutate_map=(2, 3),
         params=dict(_COMMON, lr=(pFloat, 0.001), beta1=(pFloat, 0.9),
                     beta2=(pFloat, 0.999), epsilon=(pFloat, 1e-8)))

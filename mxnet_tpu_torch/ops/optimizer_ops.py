"""Optimizer update operators.

Counterpart of ``sgd_update``, ``sgd_mom_update`` and ``adam_update`` of
``mxnet_tpu/ops/optimizer_ops.py`` (ref: optimizer_op-inl.h).  The JAX
package returns new arrays and rebinds the handles; here the updates are
in-place tensor arithmetic on the weight and momentum storage, which
saves a copy of every parameter per step.  The math is the reference's,
operation for operation:

    g = clip(grad * rescale_grad, clip_gradient)
    sgd:     weight -= lr * (g + wd * weight)
    sgd_mom: mom = momentum * mom - lr * (g + wd * weight); weight += mom
    adam:    g += wd * weight; mean = beta1 * mean + (1 - beta1) * g;
             var = beta2 * var + (1 - beta2) * g**2;
             weight -= lr * mean / (sqrt(var) + epsilon)
"""
from __future__ import annotations

import torch


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

"""Gluon losses.

Counterpart of ``mxnet_tpu/gluon/loss.py``, with its chassis: every
concrete loss implements one ``_elemwise(F, pred, *targets)`` hook
returning the per-element loss surface, and :class:`Loss` applies the
constant weight, the optional per-sample weight and the mean over every
axis but the batch axis.  Ported: ``L2Loss``, ``L1Loss`` and
``SoftmaxCrossEntropyLoss``; the others wait (ROADMAP).
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SoftmaxCrossEntropyLoss",
           "SoftmaxCELoss"]


class Loss(HybridBlock):
    """Base: subclasses define ``_elemwise``; weighting and reduction live
    here so every loss treats ``weight``/``sample_weight`` identically."""

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "{}(batch_axis={}, w={})".format(
            type(self).__name__, self._batch_axis, self._weight)

    def _elemwise(self, F, pred, label):
        raise NotImplementedError

    def hybrid_forward(self, F, pred, label, sample_weight=None):
        surface = self._elemwise(F, pred, label)
        if sample_weight is not None:
            surface = F.broadcast_mul(surface, sample_weight)
        if self._weight is not None:
            if not isinstance(self._weight, (int, float)):
                raise TypeError("weight must be a number")
            surface = surface * self._weight
        return F.mean(surface, axis=self._batch_axis, exclude=True)


def _match(F, target, like):
    """Give target the prediction's shape (labels often arrive flat)."""
    if hasattr(like, "shape"):
        return target.reshape(like.shape)
    return F.reshape_like(target, like)


class L2Loss(Loss):
    def __init__(self, weight=1.0, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _elemwise(self, F, pred, label):
        # the 1/2 folds into the surface, as in the reference
        return F.square(pred - _match(F, label, pred)) * 0.5


class L1Loss(Loss):
    def __init__(self, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)

    def _elemwise(self, F, pred, label):
        return F.abs(pred - _match(F, label, pred))


class SoftmaxCrossEntropyLoss(Loss):
    def __init__(self, axis=-1, sparse_label=True, from_logits=False,
                 weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._axis = axis
        self._sparse_label = sparse_label
        self._from_logits = from_logits

    def _elemwise(self, F, pred, label):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, axis=self._axis)
        if self._sparse_label:
            return -F.pick(logp, label, axis=self._axis, keepdims=True)
        return -F.sum(logp * _match(F, label, logp), axis=self._axis,
                      keepdims=True)


SoftmaxCELoss = SoftmaxCrossEntropyLoss

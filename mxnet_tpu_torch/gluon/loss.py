"""Gluon losses (ref: python/mxnet/gluon/loss.py).

Counterpart of ``mxnet_tpu/gluon/loss.py``, with its chassis: every
concrete loss implements one ``_elemwise(F, pred, *targets)`` hook
returning the per-element (or per-sequence) loss surface, and
:class:`Loss` applies the constant weight, the optional per-sample weight
(a keyword or the argument after the targets) and, unless the loss has
already reduced to one value per sample (``_reduce_mean``), the mean over
every axis but the batch axis.  The formulas are the JAX package's
numerically stable ones (log-sum-exp BCE, softplus via ``softrelu``).

``CTCLoss`` passes its length arguments to the op without setting
``use_data_lengths``/``use_label_lengths``, as the JAX package does, so
the lengths are ignored there.
"""
from __future__ import annotations

from .block import HybridBlock

__all__ = ["Loss", "L2Loss", "L1Loss", "SigmoidBinaryCrossEntropyLoss",
           "SigmoidBCELoss", "SoftmaxCrossEntropyLoss", "SoftmaxCELoss",
           "KLDivLoss", "CTCLoss", "HuberLoss", "HingeLoss",
           "SquaredHingeLoss", "LogisticLoss", "TripletLoss"]

_EPS = 1e-12


class Loss(HybridBlock):
    """Base: subclasses define ``_elemwise``; weighting and reduction live
    here so every loss treats ``weight``/``sample_weight`` identically."""

    # set False on losses whose _elemwise already reduced to per-sample
    _reduce_mean = True
    # how many target tensors _elemwise consumes after pred; a further
    # positional argument is the reference's positional sample_weight
    _num_targets = 1

    def __init__(self, weight, batch_axis, **kwargs):
        super().__init__(**kwargs)
        self._weight = weight
        self._batch_axis = batch_axis

    def __repr__(self):
        return "{}(batch_axis={}, w={})".format(
            type(self).__name__, self._batch_axis, self._weight)

    def _elemwise(self, F, pred, *targets):
        raise NotImplementedError

    def hybrid_forward(self, F, pred, *args, sample_weight=None, **kwargs):
        targets, extra = args[:self._num_targets], args[self._num_targets:]
        if extra and sample_weight is None:
            sample_weight = extra[0]
        surface = self._elemwise(F, pred, *targets, **kwargs)
        if sample_weight is not None:
            surface = F.broadcast_mul(surface, sample_weight)
        if self._weight is not None:
            if not isinstance(self._weight, (int, float)):
                raise TypeError("weight must be a number")
            surface = surface * self._weight
        if self._reduce_mean:
            return F.mean(surface, axis=self._batch_axis, exclude=True)
        return surface


def _match(F, target, like):
    """Give target the prediction's shape (labels often arrive flat)."""
    if hasattr(like, "shape"):
        return target.reshape(like.shape)
    return F.reshape_like(target, like)


def _binary_ce_from_logits(F, logits, target):
    # max(x,0) - x*z + log(1+exp(-|x|)): the stable BCE spelling
    return F.relu(logits) - logits * target \
        + F.Activation(-F.abs(logits), act_type="softrelu")


# ---------------------------------------------------------------------------
# regression

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


class HuberLoss(Loss):
    """L2 inside rho, L1 outside (smooth-L1 scaled by rho)."""

    def __init__(self, rho=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._rho = rho

    def _elemwise(self, F, pred, label):
        residual = F.abs(pred - _match(F, label, pred))
        return F.where(residual > self._rho,
                       residual - 0.5 * self._rho,
                       (0.5 / self._rho) * F.square(residual))


# ---------------------------------------------------------------------------
# classification

class SigmoidBinaryCrossEntropyLoss(Loss):
    def __init__(self, from_sigmoid=False, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_sigmoid = from_sigmoid

    def _elemwise(self, F, pred, label):
        label = _match(F, label, pred)
        if self._from_sigmoid:
            return -(F.log(pred + _EPS) * label
                     + F.log(1.0 - pred + _EPS) * (1.0 - label))
        return _binary_ce_from_logits(F, pred, label)


SigmoidBCELoss = SigmoidBinaryCrossEntropyLoss


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


class KLDivLoss(Loss):
    def __init__(self, from_logits=True, axis=-1, weight=None, batch_axis=0,
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._from_logits = from_logits
        self._axis = axis

    def _elemwise(self, F, pred, label):
        logp = pred if self._from_logits \
            else F.log_softmax(pred, self._axis)
        return label * (F.log(label + _EPS) - logp)


class HingeLoss(Loss):
    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _elemwise(self, F, pred, label):
        return F.relu(self._margin - pred * _match(F, label, pred))


class SquaredHingeLoss(HingeLoss):
    def _elemwise(self, F, pred, label):
        return F.square(super()._elemwise(F, pred, label))


class LogisticLoss(Loss):
    def __init__(self, weight=None, batch_axis=0, label_format="signed",
                 **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        if label_format not in ("signed", "binary"):
            raise ValueError("label_format can only be signed or binary, "
                             "received %s." % label_format)
        self._label_format = label_format

    def _elemwise(self, F, pred, label):
        label = _match(F, label, pred)
        if self._label_format == "signed":
            label = (label + 1.0) / 2.0  # {-1,1} -> {0,1}
        return _binary_ce_from_logits(F, pred, label)


# ---------------------------------------------------------------------------
# structured

class CTCLoss(Loss):
    """Connectionist Temporal Classification (ref kernels:
    src/operator/contrib/ctc_loss — here the framework's CTCLoss op).
    Already per-sequence; no spatial mean applies."""

    _reduce_mean = False

    def __init__(self, layout="NTC", label_layout="NT", weight=None,
                 **kwargs):
        assert layout in ("NTC", "TNC")
        assert label_layout in ("NT", "TN")
        self._layout = layout
        self._label_layout = label_layout
        super().__init__(weight, label_layout.find("N"), **kwargs)

    def _elemwise(self, F, pred, label, pred_lengths=None,
                  label_lengths=None):
        if self._layout == "NTC":
            pred = F.swapaxes(pred, 0, 1)
        if self._batch_axis == 1:
            label = F.swapaxes(label, 0, 1)
        extra = {}
        if pred_lengths is not None:
            extra["data_lengths"] = pred_lengths
        if label_lengths is not None:
            extra["label_lengths"] = label_lengths
        return F.CTCLoss(pred, label, **extra)

    def hybrid_forward(self, F, pred, label, pred_lengths=None,
                       label_lengths=None, sample_weight=None):
        return super().hybrid_forward(
            F, pred, label, pred_lengths=pred_lengths,
            label_lengths=label_lengths, sample_weight=sample_weight)


class TripletLoss(Loss):
    """max(0, margin + |a-p|^2 - |a-n|^2), distances summed per sample."""

    _reduce_mean = False
    _num_targets = 2

    def __init__(self, margin=1, weight=None, batch_axis=0, **kwargs):
        super().__init__(weight, batch_axis, **kwargs)
        self._margin = margin

    def _elemwise(self, F, pred, positive, negative):
        gap = F.square(pred - _match(F, positive, pred)) \
            - F.square(pred - _match(F, negative, pred))
        return F.relu(F.sum(gap, axis=self._batch_axis, exclude=True)
                      + self._margin)

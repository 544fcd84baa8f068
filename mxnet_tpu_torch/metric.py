"""Evaluation metrics.

Counterpart of part of ``mxnet_tpu/metric.py``: the ``EvalMetric`` base
(a running weighted average of a per-batch ``_measure(label, pred) ->
(contribution, weight)`` over numpy arrays), the registry and ``create``,
``CompositeEvalMetric``, ``Accuracy``, ``CrossEntropy`` and
``Perplexity``.  Labels and
predictions come to the host once per batch at the measure boundary.
"""
from __future__ import annotations

import numpy as np

from .ndarray import NDArray


def _host(array):
    """Bring one label/pred onto the host as a numpy array."""
    if isinstance(array, NDArray):
        return array.asnumpy()
    return np.asarray(array)


def check_label_shapes(labels, preds, shape=0):
    """Validate that labels and preds pair up (count, or full shape)."""
    a = labels.shape if shape else len(labels)
    b = preds.shape if shape else len(preds)
    if a != b:
        raise ValueError(
            "Shape of labels {} does not match shape of predictions {}"
            .format(a, b))


class EvalMetric:
    """Running (weighted) average of a per-batch measure."""

    def __init__(self, name, output_names=None, label_names=None, **kwargs):
        self.name = str(name)
        self.output_names = output_names
        self.label_names = label_names
        self._init_kwargs = kwargs
        self.reset()

    def _measure(self, label, pred):
        raise NotImplementedError(
            "%s must implement _measure or override update"
            % type(self).__name__)

    def update(self, labels, preds):
        check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            contribution, weight = self._measure(_host(label), _host(pred))
            self.sum_metric += contribution
            self.num_inst += weight

    def reset(self):
        self.sum_metric = 0.0
        self.num_inst = 0

    def get(self):
        value = (self.sum_metric / self.num_inst if self.num_inst
                 else float("nan"))
        return (self.name, value)

    def get_name_value(self):
        names, values = self.get()
        if not isinstance(names, list):
            names, values = [names], [values]
        return list(zip(names, values))

    def __str__(self):
        return "EvalMetric: {}".format(dict(self.get_name_value()))


_REGISTRY = {}


def register(*aliases):
    """Class decorator registering a metric under its name plus aliases."""
    def _add(cls, extra=()):
        for key in (cls.__name__.lower(), *extra):
            _REGISTRY[key] = cls
        return cls

    if len(aliases) == 1 and isinstance(aliases[0], type):
        return _add(aliases[0])
    return lambda cls: _add(cls, aliases)


def create(metric, *args, **kwargs):
    """Build a metric from a name, instance, or list of them."""
    if isinstance(metric, EvalMetric):
        return metric
    if isinstance(metric, (list, tuple)):
        out = CompositeEvalMetric()
        for m in metric:
            out.add(create(m, *args, **kwargs))
        return out
    if isinstance(metric, str):
        cls = _REGISTRY.get(metric.lower())
        if cls is None:
            raise ValueError("unknown metric %r; registered: %s"
                             % (metric, sorted(_REGISTRY)))
        return cls(*args, **kwargs)
    raise TypeError("invalid metric type %s" % type(metric))


@register("composite")
class CompositeEvalMetric(EvalMetric):
    """Fan updates out to a list of child metrics; report all of them."""

    def __init__(self, metrics=None, name="composite",
                 output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)
        self.metrics = [create(m) for m in (metrics or [])]

    def add(self, metric):
        self.metrics.append(create(metric))

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def reset(self):
        for m in getattr(self, "metrics", ()):
            m.reset()

    def get(self):
        names, values = [], []
        for m in self.metrics:
            name, value = m.get()
            names.extend([name] if isinstance(name, str) else name)
            values.extend([value] if np.isscalar(value) else value)
        return (names, values)


@register("acc")
class Accuracy(EvalMetric):
    """Fraction of predictions equal to the label (class scores are
    argmax'd over ``axis``)."""

    def __init__(self, axis=1, name="accuracy",
                 output_names=None, label_names=None):
        super().__init__(name, axis=axis, output_names=output_names,
                         label_names=label_names)
        self.axis = axis

    def _measure(self, label, pred):
        if pred.ndim > 1 and pred.shape != label.shape:
            pred = pred.argmax(axis=self.axis)
        label = label.astype(np.int64).ravel()
        pred = pred.astype(np.int64).ravel()
        check_label_shapes(label, pred, shape=1)
        return float((pred == label).sum()), label.size


@register("ce", "crossentropy")
class CrossEntropy(EvalMetric):
    """Summed -log(prob of the true class + eps) per sample."""

    def __init__(self, eps=1e-12, name="cross-entropy",
                 output_names=None, label_names=None):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def _measure(self, label, pred):
        label = label.astype(np.int64).ravel()
        assert label.shape[0] == pred.shape[0], (label.shape, pred.shape)
        prob = pred[np.arange(label.shape[0]), label]
        return float(-np.log(prob + self.eps).sum()), prob.shape[0]


@register
class Perplexity(EvalMetric):
    """exp(mean negative log prob of the true class), optionally masking
    one ignore label (ref: metric.py:302).  Accumulates ``perplexity *
    tokens`` so batches of unequal size combine as a token-weighted
    mean."""

    def __init__(self, ignore_label, axis=-1, name="perplexity",
                 output_names=None, label_names=None):
        super().__init__(name, ignore_label=ignore_label, axis=axis,
                         output_names=output_names, label_names=label_names)
        self.ignore_label = ignore_label
        self.axis = axis

    def _pair_nll(self, label, pred):
        """(total nll, token count) for one output/label pair."""
        classes = pred.shape[-1]
        if label.size * classes != pred.size:
            raise ValueError("shape mismatch: %s vs. %s"
                             % (label.shape, pred.shape))
        flat = label.astype(np.int64).ravel()
        prob = pred.reshape(-1, classes)[np.arange(flat.size), flat]
        tokens = flat.size
        if self.ignore_label is not None:
            keep = flat != self.ignore_label
            prob = np.where(keep, prob, 1.0)
            tokens = int(keep.sum())
        return float(-np.log(np.maximum(prob, 1e-10)).sum()), tokens

    def update(self, labels, preds):
        # pool nll and tokens over every pair BEFORE exponentiating: exp is
        # nonlinear, so per-pair perplexities cannot be averaged
        check_label_shapes(labels, preds)
        nll, tokens = 0.0, 0
        for label, pred in zip(labels, preds):
            pair_nll, pair_tokens = self._pair_nll(_host(label), _host(pred))
            nll += pair_nll
            tokens += pair_tokens
        if tokens > 0:
            self.sum_metric += float(np.exp(nll / tokens)) * tokens
            self.num_inst += tokens

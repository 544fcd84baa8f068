"""Evaluation metrics.

Counterpart of ``mxnet_tpu/metric.py``: the ``EvalMetric`` base (a
running weighted average of a per-batch ``_measure(label, pred) ->
(contribution, weight)`` over numpy arrays), the registry and ``create``,
``CompositeEvalMetric``, ``Accuracy``, ``TopKAccuracy``, ``F1``, the
likelihood family (``CrossEntropy``, ``NegativeLogLikelihood``,
``Perplexity``), the regression measures (``MAE``, ``MSE``, ``RMSE``,
``PearsonCorrelation``), ``Loss`` with its ``Torch``/``Caffe`` aliases,
``CustomMetric`` and ``np_metric``.  Labels and predictions come to the
host once per batch at the measure boundary.
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

    def update_dict(self, label, pred):
        """Update from {name: array} dicts (Module's named outputs)."""
        preds = ([pred[k] for k in self.output_names]
                 if self.output_names is not None else list(pred.values()))
        labels = ([label[k] for k in self.label_names]
                  if self.label_names is not None else list(label.values()))
        self.update(labels, preds)

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

    def get_config(self):
        """The metric's constructor arguments with its class and names
        (ref: EvalMetric.get_config)."""
        config = dict(self._init_kwargs)
        config.update(metric=type(self).__name__, name=self.name,
                      output_names=self.output_names,
                      label_names=self.label_names)
        return config

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

    def get_metric(self, index):
        return self.metrics[index]

    def update(self, labels, preds):
        for m in self.metrics:
            m.update(labels, preds)

    def update_dict(self, labels, preds):
        for m in self.metrics:
            m.update_dict(labels, preds)

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


@register("top_k_accuracy", "top_k_acc")
class TopKAccuracy(EvalMetric):
    """Fraction of samples whose label lands in the top-k scores."""

    def __init__(self, top_k=1, name="top_k_accuracy",
                 output_names=None, label_names=None):
        if top_k <= 1:
            raise AssertionError(
                "Please use Accuracy if top_k is no more than 1")
        super().__init__("%s_%d" % (name, top_k), top_k=top_k,
                         output_names=output_names, label_names=label_names)
        self.top_k = top_k

    def _measure(self, label, pred):
        if pred.ndim > 2:
            raise AssertionError("Predictions should be no more than 2 dims")
        label = label.astype(np.int64).ravel()
        if pred.ndim == 1:
            hits = (pred.astype(np.int64) == label).sum()
        else:
            k = min(self.top_k, pred.shape[1])
            top = np.argpartition(pred.astype(np.float32), -k, axis=1)[:, -k:]
            hits = (top == label[:, None]).any(axis=1).sum()
        return float(hits), label.size


@register
class F1(EvalMetric):
    """Mean per-batch F1 for binary {0,1} labels."""

    def __init__(self, name="f1", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _measure(self, label, pred):
        label = label.astype(np.int64).ravel()
        decided = pred.argmax(axis=1).ravel()
        check_label_shapes(label, decided, shape=1)
        if np.unique(label).size > 2:
            raise ValueError(
                "F1 currently only supports binary classification.")
        tp = float(np.sum((decided == 1) & (label == 1)))
        fp = float(np.sum((decided == 1) & (label == 0)))
        fn = float(np.sum((decided == 0) & (label == 1)))
        precision = tp / (tp + fp) if tp + fp else 0.0
        recall = tp / (tp + fn) if tp + fn else 0.0
        denom = precision + recall
        return (2.0 * precision * recall / denom if denom else 0.0), 1


class _PickedLogProb(EvalMetric):
    """Summed -log(prob of the true class + eps) per sample."""

    def __init__(self, eps, name, output_names, label_names):
        super().__init__(name, eps=eps, output_names=output_names,
                         label_names=label_names)
        self.eps = eps

    def _measure(self, label, pred):
        label = label.astype(np.int64).ravel()
        if label.shape[0] != pred.shape[0]:
            raise ValueError("%d labels for %d predictions"
                             % (label.shape[0], pred.shape[0]))
        prob = pred[np.arange(label.shape[0]), label]
        return float(-np.log(prob + self.eps).sum()), prob.shape[0]


@register("ce", "crossentropy")
class CrossEntropy(_PickedLogProb):
    def __init__(self, eps=1e-12, name="cross-entropy",
                 output_names=None, label_names=None):
        super().__init__(eps, name, output_names, label_names)


@register("nll_loss", "negativeloglikelihood")
class NegativeLogLikelihood(_PickedLogProb):
    def __init__(self, eps=1e-12, name="nll-loss",
                 output_names=None, label_names=None):
        super().__init__(eps, name, output_names, label_names)


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


class _Regression(EvalMetric):
    """Elementwise regression measures over (batch, -1) views."""

    @staticmethod
    def _as_2d(a):
        return a.reshape(a.shape[0], -1) if a.ndim > 1 else a[:, None]

    def _measure(self, label, pred):
        return self._residual(self._as_2d(label), self._as_2d(pred)), 1


@register
class MAE(_Regression):
    def __init__(self, name="mae", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _residual(self, label, pred):
        return float(np.abs(label - pred).mean())


@register
class MSE(_Regression):
    def __init__(self, name="mse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _residual(self, label, pred):
        return float(np.square(label - pred).mean())


@register
class RMSE(_Regression):
    def __init__(self, name="rmse", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _residual(self, label, pred):
        return float(np.sqrt(np.square(label - pred).mean()))


@register("pearsonr")
class PearsonCorrelation(EvalMetric):
    def __init__(self, name="pearsonr", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def _measure(self, label, pred):
        check_label_shapes(label, pred, shape=1)
        return float(np.corrcoef(pred.ravel(), label.ravel())[0, 1]), 1


@register
class Loss(EvalMetric):
    """Mean of the raw output values (a net that emits its loss)."""

    def __init__(self, name="loss", output_names=None, label_names=None):
        super().__init__(name, output_names=output_names,
                         label_names=label_names)

    def update(self, _labels, preds):
        for pred in preds:
            host = _host(pred)
            self.sum_metric += float(host.sum())
            self.num_inst += host.size


@register
class Torch(Loss):
    """``Loss`` under the name configs and checkpoints use."""

    def __init__(self, name="torch", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class Caffe(Loss):
    """``Loss`` under the name configs and checkpoints use."""

    def __init__(self, name="caffe", output_names=None, label_names=None):
        super().__init__(name, output_names, label_names)


@register
class CustomMetric(EvalMetric):
    """A ``feval(label_np, pred_np)`` callable as a metric: it returns a
    bare value (weight 1) or ``(sum, count)``."""

    def __init__(self, feval, name=None, allow_extra_outputs=False,
                 output_names=None, label_names=None):
        if name is None:
            name = feval.__name__
            if "<" in name:  # a lambda
                name = "custom(%s)" % name
        super().__init__(name, feval=feval,
                         allow_extra_outputs=allow_extra_outputs,
                         output_names=output_names, label_names=label_names)
        self._feval = feval
        self._allow_extra_outputs = allow_extra_outputs

    def update(self, labels, preds):
        if not self._allow_extra_outputs:
            check_label_shapes(labels, preds)
        for label, pred in zip(labels, preds):
            result = self._feval(_host(label), _host(pred))
            if isinstance(result, tuple):
                contribution, weight = result
            else:
                contribution, weight = result, 1
            self.sum_metric += contribution
            self.num_inst += weight


def np_metric(name=None, allow_extra_outputs=False):
    """Decorator turning a numpy feval into a CustomMetric instance."""
    def _wrap(numpy_feval):
        feval_name = name or numpy_feval.__name__
        numpy_feval.__name__ = feval_name
        return CustomMetric(numpy_feval, feval_name, allow_extra_outputs)
    return _wrap


np_ = np_metric

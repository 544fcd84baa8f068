"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (API: python/mxnet/gluon/
trainer.py:27) on one device: ``step`` scales the gradients by
``rescale_grad / batch_size`` and applies the optimizer to every
trainable Parameter in place.  Gradient aggregation across devices needs
the KVStore, which is not ported yet: ``allreduce_grads`` has nothing to
reduce on one device, and Parameters on more than one context raise.
"""
from __future__ import annotations

from ..base import MXNetError
from .. import optimizer as opt
from .parameter import Parameter, ParameterDict


def _as_parameter_list(params):
    """Normalize the params argument to an ordered list of Parameters."""
    if isinstance(params, (dict, ParameterDict)):
        params = list(params.values())
    if not isinstance(params, (list, tuple)):
        raise ValueError(
            "Trainer needs a list/dict of Parameters; got %s" % type(params))
    for p in params:
        if not isinstance(p, Parameter):
            raise ValueError("Trainer needs Parameters; the sequence "
                             "contains a %s" % type(p))
    return list(params)


class Trainer:
    def __init__(self, params, optimizer, optimizer_params=None,
                 kvstore="device", compression_params=None):
        self._params = _as_parameter_list(params)
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        contexts = None
        for p in self._params:
            ctx = p.list_ctx()
            if contexts is not None and contexts != ctx:
                raise AssertionError(
                    "Parameter %r lives on %s but earlier parameters live "
                    "on %s; a Trainer requires one shared context set"
                    % (p.name, ctx, contexts))
            contexts = ctx
        if contexts is not None and len(contexts) > 1:
            raise MXNetError("Trainer over %d contexts needs the KVStore, "
                             "which is not ported yet" % len(contexts))
        self._init_optimizer(optimizer, optimizer_params)

    def _init_optimizer(self, optimizer, optimizer_params):
        param_dict = dict(enumerate(self._params))
        if isinstance(optimizer, opt.Optimizer):
            if optimizer_params:
                raise AssertionError(
                    "optimizer_params cannot be combined with an Optimizer "
                    "instance; configure the instance directly")
            self._optimizer = optimizer
            optimizer.param_dict = param_dict
        else:
            self._optimizer = opt.create(optimizer, param_dict=param_dict,
                                         **optimizer_params)
        self._updater = opt.get_updater(self._optimizer)

    @property
    def learning_rate(self):
        return self._optimizer.lr

    @learning_rate.setter
    def learning_rate(self, lr):
        self._optimizer.set_learning_rate(lr)

    def set_learning_rate(self, lr):
        self.learning_rate = lr

    def _trainable(self):
        for i, p in enumerate(self._params):
            if p.grad_req != "null":
                yield i, p

    def step(self, batch_size, ignore_stale_grad=False):
        """One optimization step: aggregate gradients (nothing to do on
        one device), then update with gradients scaled by
        ``rescale_grad / batch_size`` (ref semantics: trainer.py:156)."""
        self.allreduce_grads()
        self.update(batch_size, ignore_stale_grad)

    def allreduce_grads(self):
        """Sum each gradient over the devices: one device holds the sum
        already."""

    def update(self, batch_size, ignore_stale_grad=False):
        self._optimizer.rescale_grad = self._scale / batch_size
        for i, p in self._trainable():
            self._updater(i, p.grad(), p.data())

    def save_states(self, fname):
        with open(fname, "wb") as f:
            f.write(self._updater.get_states(dump_optimizer=True))

    def load_states(self, fname):
        with open(fname, "rb") as f:
            self._updater.set_states(f.read())
        self._optimizer = self._updater.optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))

"""Gluon Trainer.

Counterpart of ``mxnet_tpu/gluon/trainer.py`` (API: python/mxnet/gluon/
trainer.py:27): ``step`` reduces the gradients through a KVStore, then
updates every trainable Parameter with gradients scaled by
``rescale_grad / batch_size``.  Over several contexts the store is made
at the first step (``kvstore``, ``'device'`` by default, with
``compression_params``; one context needs none): a collective or
distributed store all-reduces the gradients in one batched
``push_pull_list`` and each context's Updater applies the update, so the
replicas stay equal; another store updates the weights itself and each
context pulls them.  ``allreduce_grads`` and ``update`` split the step;
``update`` raises when the store updates.
"""
from __future__ import annotations

from .. import optimizer as opt
from ..model import _create_kvstore
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
        self._compression_params = compression_params
        optimizer_params = dict(optimizer_params or {})
        self._scale = float(optimizer_params.get("rescale_grad", 1.0))
        self._contexts = self._shared_contexts()
        self._init_optimizer(optimizer, optimizer_params)
        self._kv_initialized = False
        self._kvstore = kvstore
        self._update_on_kvstore = False

    def _shared_contexts(self):
        """Every Parameter must live on one common context list."""
        contexts = None
        for p in self._params:
            ctx = p.list_ctx()
            if contexts is not None and contexts != ctx:
                raise AssertionError(
                    "Parameter %r lives on %s but earlier parameters live "
                    "on %s; a Trainer requires one shared context set"
                    % (p.name, ctx, contexts))
            contexts = ctx
        return contexts or []

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
        # one Updater a context, so each context's states stay on it
        self._updaters = [opt.get_updater(self._optimizer)
                          for _ in self._contexts or [None]]

    def _ensure_kv(self):
        """Make the store at the first step (ref: trainer.py _init_kvstore)."""
        if self._kv_initialized:
            return
        arg_arrays = {p.name: p.data(self._contexts[0])
                      for p in self._params}
        kvstore, update_on_kvstore = _create_kvstore(
            self._kvstore, len(self._contexts), arg_arrays)
        # a dist store reduces; each worker applies the optimizer itself
        self._update_on_kvstore = bool(kvstore) and update_on_kvstore \
            and "dist" not in kvstore.type
        self._kvstore = kvstore or None
        if kvstore:
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            for i, p in enumerate(self._params):
                replicas = p.list_data()
                kvstore.init(i, replicas[0])
                if self._update_on_kvstore:
                    kvstore.pull(i, replicas, priority=-i)
            if self._update_on_kvstore:
                kvstore.set_optimizer(self._optimizer)
        self._kv_initialized = True

    def _begin(self, batch_size):
        self._ensure_kv()
        self._optimizer.rescale_grad = self._scale / batch_size

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
        """One optimization step: reduce the gradients, then update
        (ref semantics: trainer.py:156)."""
        self._begin(batch_size)
        self._allreduce_grads()
        self._update(ignore_stale_grad)

    def allreduce_grads(self):
        """Sum each gradient over the contexts (and processes), into
        every context's gradient."""
        self._ensure_kv()
        self._allreduce_grads()

    def _allreduce_grads(self):
        kv = self._kvstore
        if not kv:
            return
        if not self._update_on_kvstore and hasattr(kv, "push_pull_list"):
            # every gradient in one reduction per dtype group, back into
            # the same buffers
            items = list(self._trainable())
            grads = [p.list_grad() for _, p in items]
            kv.push_pull_list([i for i, _ in items], grads, grads)
            return
        for i, p in self._trainable():
            kv.push(i, p.list_grad(), priority=-i)
            if not self._update_on_kvstore:
                kv.pull(i, p.list_grad(), priority=-i)

    def update(self, batch_size, ignore_stale_grad=False):
        self._ensure_kv()
        if self._update_on_kvstore:
            # checked before rescale_grad changes: the store shares this
            # optimizer
            raise AssertionError(
                "update() is owned by the kvstore in update_on_kvstore "
                "mode; call step(), or create the Trainer with a local "
                "update configuration")
        self._begin(batch_size)
        self._update(ignore_stale_grad)

    def _update(self, ignore_stale_grad=False):
        for i, p in self._trainable():
            if self._update_on_kvstore:
                # the store updated; each context fetches the weights
                self._kvstore.pull(i, p.list_data(), priority=-i)
                continue
            for updater, weight, grad in zip(
                    self._updaters, p.list_data(), p.list_grad()):
                updater(i, grad, weight)

    def save_states(self, fname):
        self._ensure_kv()
        if self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname, dump_optimizer=True)
            return
        with open(fname, "wb") as f:
            f.write(self._updaters[0].get_states(dump_optimizer=True))

    def load_states(self, fname):
        self._ensure_kv()
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
            self._optimizer = self._kvstore._updater.optimizer
        else:
            with open(fname, "rb") as f:
                blob = f.read()
            for u in self._updaters:
                u.set_states(blob)
            # the updaters share one Optimizer again after the restore
            self._optimizer = self._updaters[0].optimizer
            for u in self._updaters:
                u.optimizer = self._optimizer
        self._optimizer.param_dict = dict(enumerate(self._params))

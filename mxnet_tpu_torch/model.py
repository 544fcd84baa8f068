"""Checkpoints and the legacy ``FeedForward`` API.

Counterpart of ``mxnet_tpu/model.py`` (ref: python/mxnet/model.py):
``save_checkpoint``/``load_checkpoint`` keep the two-artifact format,
``prefix-symbol.json`` and ``prefix-%04d.params`` with ``arg:``/``aux:``
names, byte for byte the JAX package's, so a checkpoint saved by either
package loads in the other.  ``FeedForward`` is a thin adapter over
``Module``; its default context is the card (``gpu(0)``), where the JAX
package's is ``cpu()``: the port's default device is the card.

``_create_kvstore``, ``_initialize_kvstore``, ``_update_params_on_kvstore``
and ``_update_params`` are the key-value-store steps that ``Module`` and
``gluon.Trainer`` share (ref: model.py:58-166).
"""
from __future__ import annotations

import logging
from collections import namedtuple

from . import kvstore as kvs
from . import ndarray as nd
from .context import cpu, gpu

# ``mx.model.BatchEndParam`` is the JAX package's namedtuple (ref:
# python/mxnet/model.py): it unpacks and indexes.  ``Module.fit``
# hands its callbacks ``module/base_module.py``'s object of the same
# fields, as the JAX package's ``fit`` does
BatchEndParam = namedtuple("BatchEndParams",
                           ["epoch", "nbatch", "eval_metric", "locals"])


def _create_kvstore(kvstore, num_device, arg_params):
    """``(store, update_on_kvstore)`` for a store name, a store or None
    (ref: model.py:58).  One context with a store that is neither
    distributed nor collective needs none; ``'local'`` does not update on
    the store when a parameter has more than 16M elements; a collective
    store (``nccl``, ``tpu``, ``ici``) leaves the update to each context,
    whose replicas apply it to one reduced gradient."""
    update_on_kvstore = True
    if kvstore is None:
        kv = None
    elif isinstance(kvstore, kvs.KVStore):
        kv = kvstore
    elif isinstance(kvstore, str):
        if (num_device == 1 and "dist" not in kvstore
                and "tpu" not in kvstore and "ici" not in kvstore):
            kv = None
        else:
            kv = kvs.create(kvstore)
            if kvstore == "local":
                max_size = max(int(param.size)
                               for param in arg_params.values())
                if max_size > 1024 * 1024 * 16:
                    update_on_kvstore = False
    else:
        raise TypeError("kvstore must be KVStore, str or None")
    if kv is None or any(t in kv.type for t in ("nccl", "tpu", "ici")):
        update_on_kvstore = False
    return (kv, update_on_kvstore)


def _initialize_kvstore(kvstore, param_arrays, arg_params, param_names,
                        update_on_kvstore):
    """Init every key from the masters; a store that updates hands its
    weights to every context (ref: model.py:96)."""
    for idx, param_on_devs in enumerate(param_arrays):
        name = param_names[idx]
        kvstore.init(name, arg_params[name])
        if update_on_kvstore:
            kvstore.pull(name, param_on_devs, priority=-idx)


def _update_params_on_kvstore(param_arrays, grad_arrays, kvstore,
                              param_names):
    """The store updates: push each key's gradients, pull its weights
    (ref: model.py:126)."""
    for index, (arg_list, grad_list) in enumerate(zip(param_arrays,
                                                      grad_arrays)):
        if grad_list[0] is None:
            continue
        name = param_names[index]
        kvstore.push(name, grad_list, priority=-index)
        kvstore.pull(name, arg_list, priority=-index)


def _update_params(param_arrays, grad_arrays, updater, num_device,
                   kvstore=None, param_names=None):
    """Each context updates its weights from the reduced gradients: one
    batched ``push_pull_list`` where the store has it, else a push and a
    pull a key (ref: model.py:145)."""
    live = [(i, a, g) for i, (a, g) in
            enumerate(zip(param_arrays, grad_arrays)) if g[0] is not None]
    if kvstore is not None and hasattr(kvstore, "push_pull_list") and live:
        kvstore.push_pull_list([param_names[i] for i, _, _ in live],
                               [g for _, _, g in live],
                               [g for _, _, g in live])
    elif kvstore is not None:
        for index, _, grad_list in live:
            name = param_names[index]
            kvstore.push(name, grad_list, priority=-index)
            kvstore.pull(name, grad_list, priority=-index)
    for index, arg_list, grad_list in live:
        for k, (p, g) in enumerate(zip(arg_list, grad_list)):
            updater(index * num_device + k, g, p)


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params):
    """Save the symbol and the parameters (ref: model.py:366)."""
    if symbol is not None:
        symbol.save("%s-symbol.json" % prefix)
    save_dict = {("arg:%s" % k): v.as_in_context(cpu())
                 for k, v in arg_params.items()}
    save_dict.update({("aux:%s" % k): v.as_in_context(cpu())
                      for k, v in aux_params.items()})
    param_name = "%s-%04d.params" % (prefix, epoch)
    nd.save(param_name, save_dict)
    logging.info("Saved checkpoint to \"%s\"", param_name)


def load_checkpoint(prefix, epoch):
    """``(symbol, arg_params, aux_params)`` of a checkpoint, the arrays on
    the host (ref: model.py:396)."""
    from . import symbol as sym_mod
    symbol = sym_mod.load("%s-symbol.json" % prefix)
    arg_params, aux_params = {}, {}
    for k, v in nd.load("%s-%04d.params" % (prefix, epoch)).items():
        tp, name = k.split(":", 1)
        if tp == "arg":
            arg_params[name] = v
        if tp == "aux":
            aux_params[name] = v
    return (symbol, arg_params, aux_params)


class FeedForward:
    """The legacy FeedForward API (ref: model.py:~420), over ``Module``."""

    def __init__(self, symbol, ctx=None, num_epoch=None, epoch_size=None,
                 optimizer="sgd", initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        from .initializer import Uniform
        self.symbol = symbol
        self.ctx = ctx if ctx is not None else [gpu(0)]
        if not isinstance(self.ctx, (list, tuple)):
            self.ctx = [self.ctx]
        self.num_epoch = num_epoch
        self.epoch_size = epoch_size
        self.kwargs = kwargs.copy()
        self.optimizer = optimizer
        self.initializer = initializer or Uniform(0.01)
        self.numpy_batch_size = numpy_batch_size
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.allow_extra_params = allow_extra_params
        self.begin_epoch = begin_epoch
        self._module = None

    def _init_module(self, data):
        from .module import Module
        data_names = [x[0] for x in data.provide_data]
        label_names = [x[0] for x in data.provide_label]
        self._module = Module(self.symbol, data_names=data_names,
                              label_names=label_names, context=self.ctx)

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            logger=None, work_load_list=None, monitor=None,
            eval_end_callback=None, eval_batch_end_callback=None):
        data = self._resolve_data(X, y)
        self._init_module(data)
        self._module.fit(data, eval_data=eval_data, eval_metric=eval_metric,
                         epoch_end_callback=epoch_end_callback,
                         batch_end_callback=batch_end_callback,
                         kvstore=kvstore, optimizer=self.optimizer,
                         optimizer_params=dict(self.kwargs),
                         initializer=self.initializer,
                         arg_params=self.arg_params,
                         aux_params=self.aux_params,
                         begin_epoch=self.begin_epoch,
                         num_epoch=self.num_epoch)
        self.arg_params, self.aux_params = self._module.get_params()

    def _resolve_data(self, X, y=None):
        from .io import DataIter, NDArrayIter
        if isinstance(X, DataIter):
            return X
        return NDArrayIter(X, y, batch_size=self.numpy_batch_size)

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        data = self._resolve_data(X)
        if self._module is None:
            self._init_module(data)
            self._module.bind(data_shapes=data.provide_data,
                              label_shapes=data.provide_label,
                              for_training=False)
            self._module.set_params(self.arg_params, self.aux_params or {})
        out = self._module.predict(data, num_batch=num_batch, reset=reset)
        return out.asnumpy() if hasattr(out, "asnumpy") else out

    def score(self, X, eval_metric="acc", num_batch=None,
              batch_end_callback=None, reset=True):
        data = self._resolve_data(X)
        res = self._module.score(data, eval_metric, num_batch=num_batch)
        return res[0][1]

    def save(self, prefix, epoch=None):
        if epoch is None:
            epoch = self.num_epoch
        save_checkpoint(prefix, epoch, self.symbol, self.arg_params,
                        self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch, **kwargs)

    @staticmethod
    def create(symbol, X, y=None, ctx=None, num_epoch=None, epoch_size=None,
               optimizer="sgd", initializer=None, eval_data=None,
               eval_metric="acc", epoch_end_callback=None,
               batch_end_callback=None, kvstore="local", logger=None,
               work_load_list=None, eval_end_callback=None,
               eval_batch_end_callback=None, **kwargs):
        model = FeedForward(symbol, ctx=ctx, num_epoch=num_epoch,
                            epoch_size=epoch_size, optimizer=optimizer,
                            initializer=initializer, **kwargs)
        model.fit(X, y, eval_data=eval_data, eval_metric=eval_metric,
                  epoch_end_callback=epoch_end_callback,
                  batch_end_callback=batch_end_callback, kvstore=kvstore,
                  logger=logger, work_load_list=work_load_list,
                  eval_end_callback=eval_end_callback,
                  eval_batch_end_callback=eval_batch_end_callback)
        return model

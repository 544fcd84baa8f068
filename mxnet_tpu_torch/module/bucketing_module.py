"""BucketingModule: one Module per input shape, all training one set of
parameters.

Counterpart of ``mxnet_tpu/module/bucketing_module.py`` (ref:
python/mxnet/module/bucketing_module.py).  ``sym_gen(bucket_key)`` gives
each bucket's symbol; the default bucket's Module is the anchor, and
every other bucket's Module is spawned at its first batch and bound with
``shared_module=`` the anchor: the same parameter, gradient and aux
NDArrays, the same host masters, the same optimizer and Updater.

Where the JAX package compiles one XLA program per bucket, the port
captures one CUDA graph of the fused train step per bucket.  Unlike the
JAX package, whose buckets other than the anchor train through the
general path with a second optimizer state, every bucket here trains
through a fused step of its own over one shared state (masters,
optimizer states, ``num_update``): ``init_optimizer`` and
``switch_bucket`` give each bucket a step that shares the anchor's.  A
monitor, a shape change or a bare ``update()`` retires the steps of all
buckets at once.
"""
from __future__ import annotations

import copy
import logging
import warnings

from ..initializer import Uniform
from ..symbol.symbol import NameManager
from .base_module import BaseModule, _check_input_names
from .module import Module


class BucketingModule(BaseModule):
    """Dispatch each batch to the Module of its ``bucket_key``."""

    def __init__(self, sym_gen, default_bucket_key=None, logger=logging,
                 context=None, work_load_list=None, fixed_param_names=None,
                 state_names=None):
        super().__init__(logger=logger)
        if default_bucket_key is None:
            raise AssertionError("BucketingModule needs default_bucket_key")
        self._sym_gen = sym_gen
        self._default_bucket_key = default_bucket_key
        self._context = context
        self._work_load_list = work_load_list
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])

        sym, data_names, label_names = sym_gen(default_bucket_key)
        for names, kind, strict in (
                (list(data_names or []), "data", True),
                (list(label_names or []), "label", False),
                (self._state_names, "state", True),
                (self._fixed_param_names, "fixed_param", True)):
            _check_input_names(sym, names, kind, strict)

        self._buckets = {}
        self._active_key = None

    # -- bucket management ---------------------------------------------------
    @property
    def _active(self):
        return self._buckets.get(self._active_key)

    def _spawn(self, bucket_key):
        """The (unbound) Module of one bucket.  ``sym_gen`` runs under a
        counter-reset copy of the ambient NameManager, so that automatic
        names come out the same in every bucket (``fullyconnected0_weight``
        is one parameter, not one per bucket) while a user's
        ``mx.name.Prefix`` stays in effect."""
        scoped = copy.copy(NameManager.current())
        scoped._counter = {}
        with scoped:
            sym, data_names, label_names = self._sym_gen(bucket_key)
        return Module(sym, data_names, label_names, logger=self.logger,
                      context=self._context,
                      fixed_param_names=self._fixed_param_names,
                      state_names=self._state_names)

    def switch_bucket(self, bucket_key, data_shapes, label_shapes=None):
        """Make ``bucket_key`` the active bucket, binding its Module over
        the anchor's parameters (and optimizer) at first sight."""
        if not self.binded:
            raise AssertionError("call bind before switching bucket")
        if bucket_key not in self._buckets:
            anchor = self._buckets[self._default_bucket_key]
            module = self._spawn(bucket_key)
            module.bind(data_shapes, label_shapes,
                        self._active.for_training,
                        self._active.inputs_need_grad,
                        force_rebind=False, shared_module=anchor)
            self._buckets[bucket_key] = module
        self._active_key = bucket_key

    def _reset_bind(self):
        self.binded = False
        self._buckets = {}
        self._active_key = None

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        if self.binded:
            return self._active.data_names
        return self._sym_gen(self._default_bucket_key)[1]

    @property
    def output_names(self):
        if self.binded:
            return self._active.output_names
        return self._sym_gen(self._default_bucket_key)[0].list_outputs()

    # data_shapes/label_shapes/output_shapes/symbol delegate to the active
    # bucket; generated below the class body.

    # -- parameters: one set, held by every bucket ---------------------------
    def get_params(self):
        self._ready()
        return self._active.get_params()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        if not allow_missing:
            self.init_params(initializer=None, arg_params=arg_params,
                             aux_params=aux_params,
                             allow_missing=allow_missing,
                             force_init=force_init)
            return
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. set_params call ignored.",
                          stacklevel=2)
            return
        self._active.set_params(arg_params, aux_params,
                                allow_missing=allow_missing,
                                force_init=force_init,
                                allow_extra=allow_extra)
        self.params_initialized = True

    def init_params(self, initializer=None, arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise AssertionError("call bind before initializing the "
                                 "parameters")
        if initializer is None:
            # a partial load still needs an initializer for the rest
            initializer = Uniform(0.01)
        self._active.init_params(initializer=initializer,
                                 arg_params=arg_params,
                                 aux_params=aux_params,
                                 allow_missing=allow_missing,
                                 force_init=force_init,
                                 allow_extra=allow_extra)
        self.params_initialized = True

    @property
    def _arg_params(self):
        return self._active._arg_params if self._active else None

    @property
    def _aux_params(self):
        return self._active._aux_params if self._active else None

    # -- states --------------------------------------------------------------
    def get_states(self, merge_multi_context=True):
        self._ready()
        return self._active.get_states(merge_multi_context)

    def set_states(self, states=None, value=None):
        self._ready()
        self._active.set_states(states, value)

    # -- binding and the optimizer -------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        held = None
        if force_rebind:
            if self.binded and self.params_initialized:
                held = self.get_params()
            self._reset_bind()
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise AssertionError("shared_module for BucketingModule is not "
                                 "supported")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True

        anchor = self._spawn(self._default_bucket_key)
        anchor.bind(data_shapes, label_shapes, for_training,
                    inputs_need_grad, force_rebind=False,
                    shared_module=None, grad_req=grad_req)
        self._buckets[self._default_bucket_key] = anchor
        self._active_key = self._default_bucket_key
        if self.params_initialized:
            # copied into the bound tensors, never rebound
            arg, aux = held or (self._arg_params, self._aux_params)
            self.set_params(arg, aux)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        self._active.init_optimizer(kvstore, optimizer, optimizer_params,
                                    force_init=force_init)
        for module in self._buckets.values():
            if module is not self._active:
                module.borrow_optimizer(self._active)
        self.optimizer_initialized = True

    # -- computation: the batch's bucket -------------------------------------
    def prepare(self, data_batch):
        """Bind the upcoming batch's bucket now, then stay on the current
        one, so that the step in flight is unaffected."""
        self._ready()
        staying = self._active_key
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self.switch_bucket(staying, None, None)

    def forward(self, data_batch, is_train=None):
        self._ready()
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._active.forward(data_batch, is_train=is_train)

    def forward_backward(self, data_batch):
        """The batch's bucket runs its step: with the fused step, its own
        graph over the shared state."""
        self._ready()
        self.switch_bucket(data_batch.bucket_key, data_batch.provide_data,
                           data_batch.provide_label)
        self._active.forward_backward(data_batch)

    def backward(self, out_grads=None):
        self._ready()
        self._active.backward(out_grads=out_grads)

    def update(self):
        self._ready(optimizer=True)
        self._active.update()

    def get_outputs(self, merge_multi_context=True):
        self._ready()
        return self._active.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._ready(grads=True)
        return self._active.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._ready()
        self._active.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        """Monitor every bucket bound so far (their fused steps retire)."""
        if not self.binded:
            raise AssertionError("install_monitor() needs bind()")
        for module in self._buckets.values():
            module.install_monitor(mon)

    @property
    def _optimizer(self):
        active = self._active
        return getattr(active, "_optimizer", None) \
            if active is not None else None


def _active_delegate(attr):
    def _get(self):
        if not self.binded:
            raise AssertionError("%s needs bind()" % attr)
        return getattr(self._active, attr)
    _get.__name__ = attr
    return property(_get)


for _attr in ("data_shapes", "label_shapes", "output_shapes", "symbol"):
    setattr(BucketingModule, _attr, _active_delegate(_attr))
del _attr

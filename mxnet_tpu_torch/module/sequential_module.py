"""SequentialModule: a chain of modules acting as one.

Counterpart of ``mxnet_tpu/module/sequential_module.py`` (ref:
python/mxnet/module/sequential_module.py): the outputs of stage i feed
stage i+1's data, labels go only to stages added with
``take_labels=True``, and ``auto_wiring`` renames the incoming
descriptors to the next stage's data names.  Interior stages bind with
``inputs_need_grad``, so their gradients flow back through the chain;
such a stage trains through the general path (the fused step refuses
``inputs_need_grad``).
"""
from __future__ import annotations

import logging
from collections import namedtuple

from ..initializer import Uniform
from ..io import DataBatch
from .base_module import BaseModule

_Stage = namedtuple("_Stage", ["module", "takes_labels", "auto_wiring"])


class SequentialModule(BaseModule):
    META_TAKE_LABELS = "take_labels"
    META_AUTO_WIRING = "auto_wiring"

    def __init__(self, logger=logging):
        super().__init__(logger=logger)
        self._stages = []
        self._label_shapes = None

    def add(self, module, **kwargs):
        """Append a stage.  kwargs: take_labels=, auto_wiring=."""
        known = (self.META_TAKE_LABELS, self.META_AUTO_WIRING)
        for key in kwargs:
            if key not in known:
                raise AssertionError(
                    'Unknown meta "%s" (expected one of %s)' % (key, known))
        self._stages.append(_Stage(
            module,
            bool(kwargs.get(self.META_TAKE_LABELS, False)),
            bool(kwargs.get(self.META_AUTO_WIRING, False))))
        # a change of the chain invalidates everything downstream
        self.binded = False
        self.params_initialized = False
        self.optimizer_initialized = False
        return self

    def _mods(self):
        return [s.module for s in self._stages]

    def _need_bound(self):
        if not self.binded:
            raise AssertionError("needs bind()")

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        return self._stages[0].module.data_names if self._stages else []

    @property
    def output_names(self):
        return self._stages[-1].module.output_names if self._stages else []

    @property
    def data_shapes(self):
        self._need_bound()
        return self._stages[0].module.data_shapes

    @property
    def label_shapes(self):
        self._need_bound()
        return self._label_shapes

    @property
    def output_shapes(self):
        self._need_bound()
        return self._stages[-1].module.output_shapes

    # -- parameters ----------------------------------------------------------
    def get_params(self):
        self._ready()
        args, auxs = {}, {}
        for m in self._mods():
            a, x = m.get_params()
            args.update(a)
            auxs.update(x)
        return args, auxs

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        if not self.binded:
            raise AssertionError("call bind before initializing the "
                                 "parameters")
        for m in self._mods():
            m.init_params(initializer=initializer, arg_params=arg_params,
                          aux_params=aux_params,
                          allow_missing=allow_missing,
                          force_init=force_init, allow_extra=allow_extra)
        self._assert_unique_names()
        self.params_initialized = True

    def _assert_unique_names(self):
        """A name owned by two stages would silently alias checkpoints."""
        owner = {}
        for i, m in enumerate(self._mods()):
            a, x = m.get_params()
            for name in list(a) + list(x):
                if name in owner:
                    raise AssertionError(
                        'Duplicated parameter names: name "%s" in layer %d '
                        "(%s) is already used in layer %d (%s)."
                        % (name, i, type(m), owner[name],
                           type(self._mods()[owner[name]])))
                owner[name] = i

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad and not for_training:
            raise AssertionError("inputs_need_grad needs for_training")
        if shared_module is not None:
            raise AssertionError("Shared module is not supported")
        if not self._stages:
            raise AssertionError("Attempting to bind an empty "
                                 "SequentialModule")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.binded = True
        self._label_shapes = label_shapes
        any_labels = False
        flowing = data_shapes
        for i, stage in enumerate(self._stages):
            if stage.auto_wiring:
                names = stage.module.data_names
                if len(names) != len(flowing):
                    raise AssertionError(
                        "stage %d takes %d inputs, the chain gives %d"
                        % (i, len(names), len(flowing)))
                flowing = [(name, shape) for name, (_, shape)
                           in zip(names, flowing)]
            if stage.takes_labels:
                any_labels = True
            stage.module.bind(
                data_shapes=flowing,
                label_shapes=label_shapes if stage.takes_labels else None,
                for_training=for_training,
                # interior stages need input grads to continue the chain
                inputs_need_grad=bool(inputs_need_grad
                                      or (for_training and i > 0)),
                force_rebind=force_rebind, shared_module=None,
                grad_req=grad_req)
            flowing = stage.module.output_shapes
        if not any_labels:
            self._label_shapes = None

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        self._ready()
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring.")
            return
        for m in self._mods():
            m.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                             optimizer_params=optimizer_params,
                             force_init=force_init)
        self.optimizer_initialized = True

    # -- computation ---------------------------------------------------------
    def forward(self, data_batch, is_train=None):
        self._ready()
        # thread a private copy so the caller's batch isn't rewired
        batch = DataBatch(data=data_batch.data, label=data_batch.label,
                          pad=data_batch.pad, index=data_batch.index,
                          provide_data=data_batch.provide_data,
                          provide_label=data_batch.provide_label)
        last = len(self._stages) - 1
        for i, stage in enumerate(self._stages):
            stage.module.forward(batch, is_train=is_train)
            if i == last:
                break
            batch.data = stage.module.get_outputs()
            batch.provide_data = stage.module.output_shapes

    def backward(self, out_grads=None):
        self._ready()
        for i in range(len(self._stages) - 1, -1, -1):
            self._stages[i].module.backward(out_grads=out_grads)
            if i:
                out_grads = self._stages[i].module.get_input_grads()

    def update(self):
        self._ready(optimizer=True)
        for m in self._mods():
            m.update()

    def get_outputs(self, merge_multi_context=True):
        self._ready()
        return self._stages[-1].module.get_outputs(
            merge_multi_context=merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        self._ready(grads=True)
        return self._stages[0].module.get_input_grads(
            merge_multi_context=merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._ready()
        for stage in self._stages:
            if stage.takes_labels:
                stage.module.update_metric(eval_metric, labels)

    def install_monitor(self, mon):
        self._need_bound()
        for m in self._mods():
            m.install_monitor(mon)

"""Module: the symbolic training interface over one device.

Counterpart of ``mxnet_tpu/module/module.py``: ``bind`` (through the
executor group's ``simple_bind``), ``init_params`` with host masters
filled by the initializer's name rules or from given dicts,
``set_params``/``get_params``, ``init_optimizer`` (one context with
``kvstore`` "local" or None updates locally, ``rescale_grad = 1 /
batch_size``), ``forward``, ``backward``, ``forward_backward``,
``update`` and ``update_metric``.

The JAX package's ``FusedTrainStep`` (forward, backward and update in
one XLA program) has no counterpart here: on one device its math is the
general path's, and its own contract makes the ``update()`` after a
fused step a no-op, so ``fit`` gives the same parameters either way.
Key-value stores, checkpoints and optimizer-state files wait for later
slices.
"""
from __future__ import annotations

import logging
import warnings

from ..base import MXNetError
from ..context import cpu, current_context
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..ndarray import zeros as nd_zeros
from .. import optimizer as opt
from .base_module import BaseModule
from .executor_group import DataParallelExecutorGroup


def _descs(shapes):
    return [d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in (shapes or [])]


class Module(BaseModule):
    """BaseModule implementation over a Symbol bound to one context."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 fixed_param_names=None, state_names=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        context = current_context() if context is None else context
        self._context = list(context) if isinstance(context, (list, tuple)) \
            else [context]
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        args = symbol.list_arguments()
        for name in self._data_names:
            if name not in args:
                raise ValueError("data name %r is not an argument of the "
                                 "symbol" % name)
        self._label_names = [n for n in self._label_names if n in args]
        inputs = set(self._data_names + self._label_names
                     + list(state_names or []))
        self._param_names = [a for a in args if a not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = self._aux_params = None
        self._optimizer = self._updater = None
        self._exec_group = None

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if shared_module is not None:
            raise MXNetError("shared_module is not ported yet")
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, _descs(data_shapes),
            _descs(label_shapes) or None, self._param_names, for_training,
            inputs_need_grad, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req)
        self.binded = True
        if self.params_initialized:
            # rebind after set_params: push the masters to the device
            self._exec_group.set_params(self._arg_params, self._aux_params)
        else:
            # host masters shaped like the bound parameters
            self._arg_params = {
                n: nd_zeros(a[0].shape, cpu(), dtype=a[0].tensor.dtype)
                for n, a in zip(self._param_names,
                                self._exec_group.param_arrays)}
            self._aux_params = {
                n: nd_zeros(a[0].shape, cpu(), dtype=a[0].tensor.dtype)
                for n, a in zip(self._aux_names,
                                self._exec_group.aux_arrays)}

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            warnings.warn("Parameters already initialized and "
                          "force_init=False. init_params call ignored.",
                          stacklevel=2)
            return
        if not self.binded:
            raise AssertionError("call bind before initializing the "
                                 "parameters")
        attrs = self._symbol.attr_dict()
        for masters, provided in ((self._arg_params, arg_params),
                                  (self._aux_params, aux_params)):
            for name in sorted(masters):
                arr = masters[name]
                source = None if provided is None else provided.get(name)
                if source is not None:
                    if source is not arr:
                        source.copyto(arr)
                elif provided is not None and not allow_missing:
                    raise RuntimeError("%s is not presented" % name)
                elif initializer is not None:
                    initializer(InitDesc(name, attrs.get(name)), arr)
        self.params_initialized = True
        self._exec_group.set_params(self._arg_params, self._aux_params)

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def get_params(self):
        """(arg_params, aux_params): host copies of the trained state."""
        if not (self.binded and self.params_initialized):
            raise AssertionError("get_params() needs bind() and "
                                 "init_params()")
        self._exec_group.get_params(self._arg_params, self._aux_params)
        return self._arg_params, self._aux_params

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise AssertionError("init_optimizer() needs bind() and "
                                 "init_params()")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        if kvstore not in (None, "local") or len(self._context) != 1:
            raise MXNetError("kvstore %r: the port trains on one context "
                             "with kvstore 'local' or None (key-value "
                             "stores wait for the multi-device slice)"
                             % (kvstore,))
        rescale_grad = 1.0 / self._exec_group.batch_size
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer")
        elif optimizer.rescale_grad != rescale_grad:
            warnings.warn(
                "Optimizer created manually outside Module but "
                "rescale_grad is not normalized to 1.0/batch_size (%s vs. "
                "%s). Is this intended?" % (optimizer.rescale_grad,
                                            rescale_grad), stacklevel=2)
        self._optimizer = optimizer
        self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True

    def forward(self, data_batch, is_train=None):
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._exec_group.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        self._exec_group.forward_backward(data_batch)

    def update(self):
        """One optimizer step of every parameter from its gradient."""
        if not self.optimizer_initialized:
            raise AssertionError("update() needs init_optimizer()")
        group = self._exec_group
        for index, (name, (weight,)) in enumerate(
                zip(self._param_names, group.param_arrays)):
            grad = group.execs[0].grad_dict.get(name)
            if grad is not None:
                self._updater(index, grad, weight)

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

"""Module: the symbolic training interface over one or more contexts.

Counterpart of ``mxnet_tpu/module/module.py``: ``bind`` (one executor a
context through the executor group, each batch split by
``work_load_list``) and ``reshape``, ``init_params`` with host masters
filled by the initializer's name rules or from given dicts,
``set_params``/``get_params``, ``init_optimizer`` with a KVStore (the
JAX package's rules: one context without a ``dist`` store updates
locally, a store that updates holds the optimizer, ``dist_sync``
multiplies the batch size in ``rescale_grad``), ``forward``,
``backward``, ``forward_backward``, ``update`` (through the store or
the per-context Updater) and ``update_metric``; checkpoints
(``save_checkpoint``, the static ``load``) and optimizer-state files in
both of the JAX package's formats: ``fused_v2`` from the fused step, the
``Updater``'s pickle from the general path (the store's when it
updates).

``init_optimizer`` engages the fused train step (``fused_step.py``:
forward, backward and update as one CUDA graph replay a batch on the
card) whenever the JAX package's gating allows, and logs why when it
does not: one context without a store, or several contexts under a
collective store (``'tpu_ici'``) with equal slices, the data-parallel
step with BatchNorm over the global batch.  ``forward_backward`` then
runs the whole step and the matching ``update()`` is a no-op; a loop
that calls ``update()`` without it, a batch of another shape, or a
monitor retires the fused step, its optimizer state handed to the
``Updater``.

``bind(shared_module=)`` (bucketing) binds the sharer's parameter
arrays and adopts its host masters and, once it has one, its optimizer
(``borrow_optimizer``).  When the sharer trains through a fused step,
the new module gets a step of its own (its own executor and, on the
card, its own graph) over the sharer's masters and optimizer states: one
state per parameter, whichever module a batch goes through.  Retiring
the step of one module retires every module that shares it.  The other
settings train through the general path (``FusedTrainStep.refusal``
names why).
"""
from __future__ import annotations

import logging
import pickle
import warnings

from .. import profiler as _profiler
from ..base import MXNetError
from ..context import cpu, current_context
from ..initializer import InitDesc, Uniform
from ..io import DataDesc
from ..ndarray import zeros as nd_zeros
from .. import optimizer as opt
from ..model import (_create_kvstore, _initialize_kvstore, _update_params,
                     _update_params_on_kvstore, load_checkpoint)
from .base_module import BaseModule, _check_input_names
from .executor_group import DataParallelExecutorGroup
from .fused_step import FusedTrainStep


def _descs(shapes):
    return [d if isinstance(d, DataDesc) else DataDesc(*d)
            for d in (shapes or [])]


def _fused_refusal(module):
    """Why the fused step cannot serve ``module`` (None when it can):
    ``FusedTrainStep.refusal``'s reason, or that ``supports`` (which a
    caller may patch, as the JAX package's tests do) declines."""
    why = FusedTrainStep.refusal(module)
    if why is None and not FusedTrainStep.supports(module):
        why = "FusedTrainStep.supports is False"
    return why


class Module(BaseModule):
    """BaseModule implementation over a Symbol bound to one context."""

    def __init__(self, symbol, data_names=("data",),
                 label_names=("softmax_label",), logger=logging, context=None,
                 work_load_list=None, fixed_param_names=None,
                 state_names=None, compression_params=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self._compression_params = compression_params
        context = current_context() if context is None else context
        self._context = list(context) if isinstance(context, (list, tuple)) \
            else [context]
        self._work_load_list = list(work_load_list
                                    or [1] * len(self._context))
        if len(self._work_load_list) != len(self._context):
            raise MXNetError("work_load_list has %d entries for %d "
                             "contexts" % (len(self._work_load_list),
                                           len(self._context)))
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._state_names = list(state_names or [])
        args = symbol.list_arguments()
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._state_names, "state", True)
        self._label_names = [n for n in self._label_names if n in args]
        inputs = set(self._data_names + self._label_names
                     + self._state_names)
        self._param_names = [a for a in args if a not in inputs]
        self._aux_names = symbol.list_auxiliary_states()
        self._output_names = symbol.list_outputs()
        self._arg_params = self._aux_params = None
        self._optimizer = self._updater = None
        self._kvstore = None
        self._update_on_kvstore = None
        self._preload_opt_states = None
        self._fused_step = None
        self._fused_pending = False
        self._exec_group = None
        self._data_shapes = self._label_shapes = None

    # -- checkpoints ---------------------------------------------------------
    @staticmethod
    def load(prefix, epoch, load_optimizer_states=False, **kwargs):
        """A Module over a checkpoint's symbol with its parameters set;
        with ``load_optimizer_states``, ``init_optimizer`` restores
        ``prefix-%04d.states``."""
        sym, args, auxs = load_checkpoint(prefix, epoch)
        mod = Module(symbol=sym, **kwargs)
        mod._arg_params, mod._aux_params = args, auxs
        mod.params_initialized = True
        if load_optimizer_states:
            mod._preload_opt_states = "%s-%04d.states" % (prefix, epoch)
        return mod

    def save_checkpoint(self, prefix, epoch, save_optimizer_states=False):
        self._symbol.save("%s-symbol.json" % prefix)
        param_file = "%s-%04d.params" % (prefix, epoch)
        self.save_params(param_file)
        self.logger.info('Saved checkpoint to "%s"', param_file)
        if save_optimizer_states:
            state_file = "%s-%04d.states" % (prefix, epoch)
            self.save_optimizer_states(state_file)
            self.logger.info('Saved optimizer state to "%s"', state_file)

    @property
    def data_names(self):
        return self._data_names

    @property
    def label_names(self):
        return self._label_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        if not self.binded:
            raise AssertionError("data_shapes needs bind()")
        return self._data_shapes

    @property
    def label_shapes(self):
        if not self.binded:
            raise AssertionError("label_shapes needs bind()")
        return self._label_shapes

    @property
    def output_shapes(self):
        if not self.binded:
            raise AssertionError("output_shapes needs bind()")
        return self._exec_group.get_output_shapes()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if force_rebind:
            self.binded = False
            self._exec_group = None
        if self.binded:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if not for_training and inputs_need_grad:
            raise AssertionError("inputs_need_grad needs for_training")
        shared_group = None
        if shared_module is not None:
            if not (isinstance(shared_module, Module)
                    and shared_module.binded
                    and shared_module.params_initialized):
                raise AssertionError("shared_module must be a bound Module "
                                     "with initialized parameters")
            shared_group = shared_module._exec_group
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes) or None
        self._exec_group = DataParallelExecutorGroup(
            self._symbol, self._context, self._work_load_list,
            self._data_shapes, self._label_shapes, self._param_names,
            for_training, inputs_need_grad, shared_group=shared_group,
            logger=self.logger, fixed_param_names=self._fixed_param_names,
            grad_req=grad_req, state_names=self._state_names)
        self.binded = True
        if shared_module is not None:
            # the sharer's masters, outright (bucketing trains one set)
            self.params_initialized = True
            self._arg_params = shared_module._arg_params
            self._aux_params = shared_module._aux_params
            if shared_module.optimizer_initialized:
                self.borrow_optimizer(shared_module)
        elif self.params_initialized:
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

    def reshape(self, data_shapes, label_shapes=None):
        """Rebind to new input shapes, sharing the parameters."""
        if not self.binded:
            raise AssertionError("reshape() needs bind()")
        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes) or None
        self._exec_group.reshape(self._data_shapes, self._label_shapes)

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

    def get_params(self):
        """(arg_params, aux_params): host copies of the trained state."""
        if not (self.binded and self.params_initialized):
            raise AssertionError("get_params() needs bind() and "
                                 "init_params()")
        self._sync_params_from_devices()
        return self._arg_params, self._aux_params

    def _sync_params_from_devices(self):
        """The host masters from the bound arrays: the fused step's state
        bit for bit once it has run (the contexts' replicas are equal, and
        their mean would round), else the contexts' mean."""
        fs = self._fused_step
        if fs is not None and fs.ran:
            fs.sync_masters(self._arg_params, self._aux_params)
        else:
            self._exec_group.get_params(self._arg_params, self._aux_params)

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        if not (self.binded and self.params_initialized):
            raise AssertionError("init_optimizer() needs bind() and "
                                 "init_params()")
        if self.optimizer_initialized and not force_init:
            self.logger.warning("optimizer already initialized, ignoring...")
            return
        kvstore, update_on_kvstore = _create_kvstore(
            kvstore, len(self._context), self._arg_params)
        # one context and no other process: nothing to synchronize, so the
        # update runs locally on the device (the same math)
        if (kvstore is not None and len(self._context) == 1
                and "dist" not in kvstore.type
                and kvstore.num_workers == 1):
            kvstore, update_on_kvstore = None, False
        batch_size = self._exec_group.batch_size
        if kvstore and "dist" in kvstore.type and "_sync" in kvstore.type:
            batch_size *= kvstore.num_workers
        rescale_grad = 1.0 / batch_size
        if isinstance(optimizer, str):
            # index -> name, for the per-parameter lr/wd multipliers: one
            # index a parameter on the store, one a copy otherwise
            ndev = 1 if update_on_kvstore else len(self._context)
            idx2name = {i * ndev + k: n
                        for i, n in enumerate(self._param_names)
                        for k in range(ndev)}
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad", rescale_grad)
            optimizer = opt.create(optimizer, sym=self._symbol,
                                   param_idx2name=idx2name,
                                   **optimizer_params)
        elif not isinstance(optimizer, opt.Optimizer):
            raise TypeError("optimizer must be a name or an Optimizer")
        elif optimizer.rescale_grad != rescale_grad:
            warnings.warn(
                "Optimizer created manually outside Module but "
                "rescale_grad is not normalized to "
                "1.0/batch_size/num_workers (%s vs. %s). Is this intended?"
                % (optimizer.rescale_grad, rescale_grad), stacklevel=2)
        self._optimizer = optimizer
        self._kvstore = kvstore
        self._update_on_kvstore = update_on_kvstore
        self._updater = None
        if kvstore:
            self._sync_params_from_devices()  # the store starts from them
            if self._compression_params:
                kvstore.set_gradient_compression(self._compression_params)
            _initialize_kvstore(kvstore=kvstore,
                                param_arrays=self._exec_group.param_arrays,
                                arg_params=self._arg_params,
                                param_names=self._param_names,
                                update_on_kvstore=update_on_kvstore)
        if update_on_kvstore:
            kvstore.set_optimizer(self._optimizer)
        else:
            self._updater = opt.get_updater(optimizer)
        self.optimizer_initialized = True
        why = _fused_refusal(self)
        self._fused_step = FusedTrainStep(self) if why is None else None
        self._fused_pending = False
        if why is not None:
            self.logger.info("fused train step unavailable (%s); using the "
                             "general path", why)
        if self._preload_opt_states is not None:
            self.load_optimizer_states(self._preload_opt_states)
            self._preload_opt_states = None

    def borrow_optimizer(self, shared_module):
        """Train with ``shared_module``'s optimizer and Updater; when it
        trains through a fused step, through a step of this module's own
        that shares that step's state."""
        if not shared_module.optimizer_initialized:
            raise AssertionError("borrow_optimizer() needs a sharer with "
                                 "an initialized optimizer")
        self._optimizer = shared_module._optimizer
        self._kvstore = shared_module._kvstore
        self._update_on_kvstore = shared_module._update_on_kvstore
        self._updater = shared_module._updater
        self.optimizer_initialized = True
        self._fused_pending = False
        anchor = shared_module._fused_step
        if anchor is None:
            self._fused_step = None
            return
        why = _fused_refusal(self) or anchor.join_refusal(self)
        if why is None:
            self._fused_step = FusedTrainStep(self, share=anchor)
        else:
            # one optimizer state per parameter: the sharers leave the
            # fused step rather than keep a second state beside it
            shared_module._retire_fused_step(
                "a module sharing the fused step cannot join it (%s)" % why)

    def install_monitor(self, mon):
        """Tap every op output of this module's executor; the fused step,
        which has no tap points, retires with its sharers."""
        if not self.binded:
            raise AssertionError("install_monitor() needs bind()")
        self._exec_group.install_monitor(mon)
        if self._fused_step is not None:
            # _fused_pending stays: a fused forward_backward that applied
            # its update already still turns the next update() into a no-op
            self.logger.warning(
                "monitor installed: leaving the fused train-step path for "
                "the tap-capable general path (expect slower steps while "
                "the monitor is active)")
            self._retire_fused_step("monitor installed")

    def _retire_fused_step(self, why):
        """Leave the fused step for the general path, the optimizer state
        carried over to the Updater, in this module and every module that
        shares its step."""
        self.logger.info("%s; disabling the fused train step", why)
        self._fused_step.retire(self._updater)

    def _rebind_for_batch(self, data_batch):
        """Reshape the bound executor when a batch arrives with new
        shapes."""
        incoming = tuple(tuple(a.shape) for a in data_batch.data)
        if incoming == tuple(tuple(d.shape) for d in self._data_shapes):
            return
        dshapes = data_batch.provide_data or [
            DataDesc(d.name, shape, d.dtype, d.layout)
            for d, shape in zip(self._data_shapes, incoming)]
        lshapes = data_batch.provide_label
        if not lshapes and data_batch.label and self._label_shapes:
            lshapes = [DataDesc(d.name, a.shape, d.dtype, d.layout)
                       for d, a in zip(self._label_shapes, data_batch.label)]
        self.reshape(dshapes, lshapes or None)

    def forward(self, data_batch, is_train=None):
        self._rebind_for_batch(data_batch)
        self._exec_group.forward(data_batch, is_train)

    def backward(self, out_grads=None):
        self._exec_group.backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        """One training step's forward and backward; with the fused step,
        the whole step, whose ``update()`` then does nothing."""
        if self._fused_step is not None:
            shapes = tuple(tuple(a.shape) for a in data_batch.data)
            if self._fused_pending or shapes != tuple(
                    tuple(d.shape) for d in self._data_shapes):
                self._retire_fused_step(
                    "repeated forward_backward or a batch shape change")
            else:
                # a host-side span around the step (its replay is not
                # waited for); a flag check while the profiler is stopped
                with _profiler.record_span("fused_train_step",
                                           category="symbolic"):
                    self._fused_step.run(data_batch)
                self._fused_pending = True
                return
        self._fused_pending = False
        self._rebind_for_batch(data_batch)
        self._exec_group.forward_backward(data_batch)

    def update(self):
        """One optimizer step of every parameter from its gradient."""
        if not self.optimizer_initialized:
            raise AssertionError("update() needs init_optimizer()")
        if self._fused_pending:
            # the fused forward_backward applied this update already
            self._fused_pending = False
            return
        if self._fused_step is not None:
            self._retire_fused_step("update() without a fused "
                                    "forward_backward")
        group = self._exec_group
        if self._update_on_kvstore:
            _update_params_on_kvstore(group.param_arrays, group.grad_arrays,
                                      self._kvstore, self._param_names)
        else:
            _update_params(group.param_arrays, group.grad_arrays,
                           updater=self._updater,
                           num_device=len(self._context),
                           kvstore=self._kvstore,
                           param_names=self._param_names)

    def get_outputs(self, merge_multi_context=True):
        return self._exec_group.get_outputs(merge_multi_context)

    def get_input_grads(self, merge_multi_context=True):
        if not (self.binded and self.params_initialized
                and self.inputs_need_grad):
            raise AssertionError("get_input_grads() needs bind("
                                 "inputs_need_grad=True) and init_params()")
        return self._exec_group.get_input_grads(merge_multi_context)

    def update_metric(self, eval_metric, labels):
        self._exec_group.update_metric(eval_metric, labels)

    # -- optimizer-state files -----------------------------------------------
    def save_optimizer_states(self, fname):
        """``fused_v2`` after the fused step has run, the store's states
        when it updates, else the Updater's pickled states."""
        if not self.optimizer_initialized:
            raise AssertionError("save_optimizer_states() needs "
                                 "init_optimizer()")
        if self._fused_step is not None and self._fused_step.ran:
            blob = pickle.dumps({"format": "fused_v2",
                                 "states": self._fused_step.export_states()})
        elif self._update_on_kvstore:
            self._kvstore.save_optimizer_states(fname)
            return
        else:
            blob = self._updater.get_states()
        with open(fname, "wb") as fout:
            fout.write(blob)

    def load_optimizer_states(self, fname):
        """Either format, written by either package."""
        if not self.optimizer_initialized:
            raise AssertionError("load_optimizer_states() needs "
                                 "init_optimizer()")
        with open(fname, "rb") as f:
            raw = f.read()
        obj = opt.load_states(raw)
        # only the explicit format tag identifies fused states: a bare
        # dict is the Updater's
        if isinstance(obj, dict) and obj.get("format") in ("fused_v1",
                                                           "fused_v2"):
            if self._fused_step is not None:
                self._fused_step.load_states(obj["states"])
            else:
                self.logger.warning(
                    "fused-format optimizer states loaded without a fused "
                    "step; momentum not restored")
            return
        if self._fused_step is not None:
            self.logger.warning(
                "updater-format optimizer states with a fused step active; "
                "disabling the fused step to restore them faithfully")
            self._fused_step.retire(None)
        if self._update_on_kvstore:
            self._kvstore.load_optimizer_states(fname)
        else:
            self._updater.set_states(raw)

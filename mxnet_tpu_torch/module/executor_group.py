"""The executor group of a Module, on one device.

Counterpart of ``mxnet_tpu/module/executor_group.py`` for one context:
binds one executor through ``simple_bind`` with the per-argument
grad_req a Module wants (parameters ``write`` unless fixed, data only
with ``inputs_need_grad``, labels ``null``), loads each batch into the
bound arrays, runs forward/backward, and exposes the parameter, gradient
and aux arrays in the layout the updater walks (one replica per
parameter); ``reshape`` rebinds to new data shapes, sharing the
parameters.  With a ``shared_group`` (bucketing), the executor binds the
sharer's parameter, gradient and aux arrays by name: the very same
NDArrays, so every bucket trains one set of tensors; an array whose
shape differs is allocated anew, zeroed, with a warning.  Splitting a
batch over several devices waits for the multi-device slice.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..context import cpu
from ..io import DataDesc
from ..ndarray import NDArray, array


def _names(descs):
    return [d.name if isinstance(d, DataDesc) else d[0] for d in descs]


def _shapes(descs):
    return {(d.name if isinstance(d, DataDesc) else d[0]):
            tuple(d.shape if isinstance(d, DataDesc) else d[1])
            for d in descs}


def _load(sources, targets):
    for src, dst in zip(sources, targets):
        if not isinstance(src, NDArray):
            src = array(src, ctx=cpu())
        if src.shape != dst.shape:
            raise MXNetError("batch array of shape %s for a bound shape %s"
                             % (src.shape, dst.shape))
        src.copyto(dst)


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write"):
        if len(contexts) != 1:
            raise MXNetError("the port's executor group binds one context; "
                             "got %s (multi-device waits for its slice)"
                             % (contexts,))
        self.symbol = symbol
        self.contexts = contexts
        self.logger = logger
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        fixed = set(fixed_param_names or [])
        data_names = _names(data_shapes)
        if not for_training:
            grad_req = "null"
        if isinstance(grad_req, str):
            self.grad_req = {}
            for k in self.arg_names:
                if k in param_names:
                    self.grad_req[k] = "null" if k in fixed else grad_req
                elif k in data_names and inputs_need_grad:
                    self.grad_req[k] = grad_req
                else:
                    self.grad_req[k] = "null"
        elif isinstance(grad_req, dict):
            self.grad_req = {k: grad_req.get(k, "null")
                             for k in self.arg_names}
        else:
            raise ValueError("invalid grad_req %r" % (grad_req,))
        self.bind_exec(data_shapes, label_shapes, shared_group=shared_group)

    def bind_exec(self, data_shapes, label_shapes, reshape=False,
                  shared_group=None):
        """Bind the executor to these shapes; with ``reshape``, a new
        executor that shares every array whose shape is unchanged (the
        parameters, their gradients and the aux states)."""
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else None
        self.data_names = _names(self.data_shapes)
        self.label_names = _names(self.label_shapes or [])
        shapes = _shapes(self.data_shapes + (self.label_shapes or []))
        self.batch_size = shapes[self.data_names[0]][0]
        types = {d.name: d.dtype for d in self.data_shapes
                 + (self.label_shapes or []) if isinstance(d, DataDesc)}
        if reshape:
            self.execs = [self.execs[0].reshape(allow_up_sizing=True,
                                                **shapes)]
        else:
            shared_args = shared_grads = None
            if shared_group is not None:
                # the sharer's parameters (never its data or labels), their
                # gradients and its aux states
                sharer = shared_group.execs[0]
                shared_args = {n: a for n, a in sharer.arg_dict.items()
                               if n in self.param_names}
                shared_args.update(sharer.aux_dict)
                shared_grads = sharer.grad_dict
            self.execs = [self.symbol.simple_bind(
                ctx=self.contexts[0], grad_req=self.grad_req,
                type_dict=types, shared_args=shared_args,
                shared_grads=shared_grads, logger=self.logger, **shapes)]
        exe = self.execs[0]
        self.data_arrays = [exe.arg_dict[n] for n in self.data_names]
        self.label_arrays = [exe.arg_dict[n] for n in self.label_names
                             if n in exe.arg_dict]
        self.param_arrays = [[exe.arg_dict[n]] for n in self.param_names]
        self.grad_arrays = [[exe.grad_dict[n]] for n in self.param_names
                            if n in exe.grad_dict]
        self.aux_arrays = [[exe.aux_dict[n]] for n in self.aux_names]
        self.input_grad_arrays = [exe.grad_dict[n] for n in self.data_names
                                  if n in exe.grad_dict]

    def reshape(self, data_shapes, label_shapes):
        if data_shapes == self.data_shapes \
                and label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        self.execs[0].copy_params_from(arg_params, aux_params,
                                       allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """Copy the bound parameters and aux states into the given dicts."""
        for names, blocks, table in ((self.param_names, self.param_arrays,
                                      arg_params),
                                     (self.aux_names, self.aux_arrays,
                                      aux_params)):
            for name, (arr,) in zip(names, blocks):
                arr.copyto(table[name])

    def _load_batch(self, data_batch):
        _load(data_batch.data, self.data_arrays)
        if self.label_arrays and data_batch.label:
            _load(data_batch.label, self.label_arrays)

    def forward(self, data_batch, is_train=None):
        self._load_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        self.execs[0].forward(is_train=is_train)

    def backward(self, out_grads=None):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        self.execs[0].backward(out_grads=out_grads)

    def forward_backward(self, data_batch):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        self._load_batch(data_batch)
        self.execs[0].forward_backward(is_train=True)

    def get_output_shapes(self):
        """[(output name, shape)]: the last forward's, or inferred from the
        bound inputs before the first (a SequentialModule binds stage i+1
        off stage i's output shapes)."""
        outputs = self.execs[0].outputs
        if outputs:
            shapes = [out.shape for out in outputs]
        else:
            known = _shapes(self.data_shapes + (self.label_shapes or []))
            _, shapes, _ = self.symbol.infer_shape(**known)
        return [(name, tuple(shape)) for name, shape in
                zip(self.symbol.list_outputs(), shapes)]

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise AssertionError("bind with inputs_need_grad=True")
        grads = list(self.input_grad_arrays)
        return grads if merge_multi_context else [[g] for g in grads]

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)

    def get_outputs(self, merge_multi_context=True):
        outs = self.execs[0].outputs
        return list(outs) if merge_multi_context else [[o] for o in outs]

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self.execs[0].outputs)

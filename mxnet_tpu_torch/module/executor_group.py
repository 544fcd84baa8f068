"""The executor group of a Module: one executor per context.

Counterpart of ``mxnet_tpu/module/executor_group.py`` (ref: python/mxnet/
module/executor_group.py).  Each batch is split along its batch axis by
``work_load_list`` (``decide_slices``), and each context binds an
executor to its slice through ``simple_bind``, with the per-argument
grad_req a Module wants (parameters ``write`` unless fixed, data only
with ``inputs_need_grad``, labels and states ``null``).  Each context
runs its forward and backward; the KVStore and the updater reduce and
apply the gradients (``model._update_params``).  ``param_arrays``,
``grad_arrays`` and ``aux_arrays`` hold one list a name, one array a
context (``None`` for a parameter without a gradient), the layout the
updater walks; outputs and input gradients merge along their batch axis.
``get_params`` averages the contexts' copies; ``set_params`` writes every
context.  ``reshape`` rebinds to new data shapes, sharing the
parameters.  With a ``shared_group`` (bucketing), each context's
executor binds the sharer's parameter, gradient and aux arrays on that
context by name: the very same NDArrays, so every bucket trains one set
of tensors; an array whose shape differs is allocated anew, zeroed, with
a warning.  Two contexts may name one device (``[gpu(0)] * 2``): each
still binds its own arrays.
"""
from __future__ import annotations

import logging

from ..base import MXNetError
from ..context import cpu
from ..io import DataDesc
from ..ndarray import NDArray, array, concatenate


def _names(descs):
    return [d.name if isinstance(d, DataDesc) else d[0] for d in descs]


def _shape_of(desc):
    return tuple(desc.shape if isinstance(desc, DataDesc) else desc[1])


def _split_input_slice(batch_size, work_load_list):
    """The batch slice of each context, in proportion to its work load
    (ref: executor_manager._split_input_slice); the last takes the
    rounding remainder."""
    total_work_load = sum(work_load_list)
    batch_num_list = [round(work_load * batch_size / total_work_load)
                      for work_load in work_load_list]
    batch_num_sum = sum(batch_num_list)
    if batch_num_sum != batch_size:
        batch_num_list[-1] += batch_size - batch_num_sum
    slices = []
    end = 0
    for batch_num in batch_num_list:
        begin = int(min(end, batch_size))
        end = int(min(begin + batch_num, batch_size))
        if begin >= end:
            raise ValueError("Too many slices. Some splits are empty.")
        slices.append(slice(begin, end))
    return slices


def _load(sources, targets):
    """Copy each batch array's slices into the contexts' bound arrays."""
    for src, dsts in zip(sources, targets):
        if not isinstance(src, NDArray):
            src = array(src, ctx=cpu())
        for sl, dst in dsts:
            part = src[sl]
            if part.shape != dst.shape:
                raise MXNetError("batch array of shape %s for a bound "
                                 "shape %s" % (part.shape, dst.shape))
            part.copyto(dst)


def _merge_multi_context(outputs, major_axis):
    """Each output's per-context arrays, joined along its batch axis."""
    rets = []
    for tensors, axis in zip(outputs, major_axis):
        if axis >= 0 and len(tensors) > 1:
            ctx = tensors[0].context
            rets.append(concatenate([t.as_in_context(ctx) for t in tensors],
                                    axis=axis))
        else:
            rets.append(tensors[0])
    return rets


class DataParallelExecutorGroup:
    def __init__(self, symbol, contexts, workload, data_shapes, label_shapes,
                 param_names, for_training, inputs_need_grad,
                 shared_group=None, logger=logging, fixed_param_names=None,
                 grad_req="write", state_names=None):
        self.symbol = symbol
        self.contexts = list(contexts)
        self.workload = list(workload or [1] * len(self.contexts))
        if len(self.workload) != len(self.contexts):
            raise MXNetError("work_load_list has %d entries for %d contexts"
                             % (len(self.workload), len(self.contexts)))
        self.logger = logger
        self.param_names = param_names
        self.arg_names = symbol.list_arguments()
        self.aux_names = symbol.list_auxiliary_states()
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self.fixed_param_names = list(fixed_param_names or [])
        self.state_names = list(state_names or [])
        fixed = set(self.fixed_param_names)
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
        self.output_layouts = [
            DataDesc.get_batch_axis(symbol[i].attr("__layout__"))
            for i in range(len(symbol.list_outputs()))]
        self.execs = []
        self.bind_exec(data_shapes, label_shapes, shared_group=shared_group)

    def decide_slices(self, data_shapes):
        """Each input's batch axis; the first input with one sets the
        batch size and the contexts' slices (ref: executor_group.py:266)."""
        major_axis = [DataDesc.get_batch_axis(
            d.layout if isinstance(d, DataDesc) else "NCHW")
            for d in data_shapes]
        for desc, axis in zip(data_shapes, major_axis):
            if axis == -1:
                continue
            batch_size = _shape_of(desc)[axis]
            if self.batch_size is not None:
                if batch_size != self.batch_size:
                    raise MXNetError(
                        "all data must have the same batch size: batch_size"
                        " = %d, but %s has shape %s" % (
                            self.batch_size, _names([desc])[0],
                            _shape_of(desc)))
            else:
                self.batch_size = batch_size
                self.slices = _split_input_slice(batch_size, self.workload)
        return major_axis

    def _sliced_shapes(self, descs, axes, i):
        """{name: shape} of context i's slice of each input."""
        out = {}
        for desc, axis in zip(descs, axes):
            shape = list(_shape_of(desc))
            if axis >= 0:
                shape[axis] = self.slices[i].stop - self.slices[i].start
            out[_names([desc])[0]] = tuple(shape)
        return out

    def bind_exec(self, data_shapes, label_shapes, reshape=False,
                  shared_group=None):
        """Bind one executor a context to these shapes; with ``reshape``,
        new executors that share every array whose shape is unchanged
        (the parameters, their gradients and the aux states)."""
        self.batch_size = None
        self.data_shapes = list(data_shapes)
        self.label_shapes = list(label_shapes) if label_shapes else None
        self.data_layouts = self.decide_slices(self.data_shapes)
        self.label_layouts = self.decide_slices(self.label_shapes) \
            if self.label_shapes else None
        self.data_names = _names(self.data_shapes)
        self.label_names = _names(self.label_shapes or [])
        types = {d.name: d.dtype for d in self.data_shapes
                 + (self.label_shapes or []) if isinstance(d, DataDesc)}
        execs = []
        for i, ctx in enumerate(self.contexts):
            shapes = self._sliced_shapes(self.data_shapes,
                                         self.data_layouts, i)
            if self.label_shapes:
                shapes.update(self._sliced_shapes(
                    self.label_shapes, self.label_layouts, i))
            if reshape:
                execs.append(self.execs[i].reshape(allow_up_sizing=True,
                                                   **shapes))
                continue
            shared_args = shared_grads = None
            if shared_group is not None:
                # the sharer's parameters (never its data or labels), their
                # gradients and its aux states, on this context
                sharer = shared_group.execs[i]
                shared_args = {n: a for n, a in sharer.arg_dict.items()
                               if n in self.param_names}
                shared_args.update(sharer.aux_dict)
                shared_grads = sharer.grad_dict
            execs.append(self.symbol.simple_bind(
                ctx=ctx, grad_req=self.grad_req, type_dict=types,
                shared_args=shared_args, shared_grads=shared_grads,
                logger=self.logger, **shapes))
        self.execs = execs
        self._collect_arrays()

    def _collect_arrays(self):
        self.data_arrays = [[(sl, e.arg_dict[n])
                             for sl, e in zip(self.slices, self.execs)]
                            for n in self.data_names]
        self.label_arrays = [[(sl, e.arg_dict[n])
                              for sl, e in zip(self.slices, self.execs)]
                             for n in self.label_names
                             if n in self.execs[0].arg_dict]
        self.param_arrays = [[e.arg_dict[n] for e in self.execs]
                             for n in self.param_names]
        self.grad_arrays = [[e.grad_dict.get(n) for e in self.execs]
                            for n in self.param_names] \
            if self.for_training else []
        self.aux_arrays = [[e.aux_dict[n] for e in self.execs]
                           for n in self.aux_names]
        self.input_grad_arrays = [[e.grad_dict[n] for e in self.execs]
                                  for n in self.data_names
                                  if n in self.execs[0].grad_dict]

    def reshape(self, data_shapes, label_shapes):
        if data_shapes == self.data_shapes \
                and label_shapes == self.label_shapes:
            return
        self.bind_exec(data_shapes, label_shapes, reshape=True)

    def set_params(self, arg_params, aux_params, allow_extra=False):
        for exe in self.execs:
            exe.copy_params_from(arg_params, aux_params,
                                 allow_extra_params=allow_extra)

    def get_params(self, arg_params, aux_params):
        """The contexts' mean of each parameter and aux state, into the
        given dicts."""
        for names, blocks, table in ((self.param_names, self.param_arrays,
                                      arg_params),
                                     (self.aux_names, self.aux_arrays,
                                      aux_params)):
            for name, block in zip(names, blocks):
                ctx = block[0].context
                total = block[0].copyto(ctx)
                for w in block[1:]:
                    total += w.as_in_context(ctx)
                (total / len(block)).astype(table[name].dtype) \
                    .copyto(table[name])

    def _load_batch(self, data_batch):
        _load(data_batch.data, self.data_arrays)
        if self.label_arrays and data_batch.label:
            _load(data_batch.label, self.label_arrays)

    def forward(self, data_batch, is_train=None):
        self._load_batch(data_batch)
        if is_train is None:
            is_train = self.for_training
        for exe in self.execs:
            exe.forward(is_train=is_train)

    def backward(self, out_grads=None):
        """Each context's backward, from its slice of ``out_grads`` (head
        gradients over the whole batch)."""
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        if out_grads is None:
            for exe in self.execs:
                exe.backward()
            return
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        for i, exe in enumerate(self.execs):
            sliced = []
            for grad, axis in zip(out_grads, self.output_layouts):
                if axis == 0:
                    grad = grad[self.slices[i].start:self.slices[i].stop]
                sliced.append(grad.as_in_context(self.contexts[i]))
            exe.backward(out_grads=sliced)

    def forward_backward(self, data_batch):
        if not self.for_training:
            raise MXNetError("re-bind with for_training=True to run "
                             "backward")
        self._load_batch(data_batch)
        for exe in self.execs:
            exe.forward_backward(is_train=True)

    def get_output_shapes(self):
        """[(output name, shape)] over the whole batch: the last
        forward's, or inferred from the bound inputs before the first (a
        SequentialModule binds stage i+1 off stage i's output shapes)."""
        outputs = self.execs[0].outputs
        if outputs:
            shapes = [list(out.shape) for out in outputs]
            for shape, axis in zip(shapes, self.output_layouts):
                if axis >= 0 and len(self.execs) > 1:
                    shape[axis] = self.batch_size
        else:
            known = {_names([d])[0]: _shape_of(d) for d in
                     self.data_shapes + (self.label_shapes or [])}
            _, shapes, _ = self.symbol.infer_shape(**known)
        return [(name, tuple(shape)) for name, shape in
                zip(self.symbol.list_outputs(), shapes)]

    def get_outputs(self, merge_multi_context=True):
        outputs = [[exe.outputs[i] for exe in self.execs]
                   for i in range(len(self.execs[0].outputs))]
        if merge_multi_context:
            return _merge_multi_context(outputs, self.output_layouts)
        return outputs

    def get_input_grads(self, merge_multi_context=True):
        if not self.inputs_need_grad:
            raise AssertionError("bind with inputs_need_grad=True")
        if merge_multi_context:
            return _merge_multi_context(self.input_grad_arrays,
                                        self.data_layouts)
        return self.input_grad_arrays

    def install_monitor(self, mon):
        for exe in self.execs:
            mon.install(exe)

    def update_metric(self, eval_metric, labels):
        """Each context's outputs against its slice of the labels."""
        axes = self.label_layouts or [0] * len(labels)
        for exe, islice in zip(self.execs, self.slices):
            sliced = [label[islice.start:islice.stop] if axis == 0
                      else label for label, axis in zip(labels, axes)]
            eval_metric.update(sliced, exe.outputs)

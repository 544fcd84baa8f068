"""PythonModule and PythonLossModule: modules written in Python.

Counterpart of ``mxnet_tpu/module/python_module.py`` (ref: python/mxnet/
module/python_module.py): a BaseModule without parameters whose author
supplies the output shapes and the computation.  ``PythonLossModule``
is a loss head: its forward passes the scores through, and its backward
hands back ``grad_func(scores, labels)`` as the input gradient, on the
scores' device.
"""
from __future__ import annotations

import logging
import operator

from ..ndarray import NDArray, array
from .base_module import BaseModule


class PythonModule(BaseModule):
    """A BaseModule skeleton for a computation in Python, without
    parameters."""

    def __init__(self, data_names, label_names, output_names,
                 logger=logging):
        super().__init__(logger=logger)
        self._data_names = list(data_names or [])
        self._label_names = list(label_names) \
            if label_names is not None else None
        self._output_names = list(output_names or [])
        self._data_shapes = None
        self._label_shapes = None
        self._output_shapes = None

    # the introspection properties (data_names, output_names, *_shapes)
    # read attributes; generated below the class body.

    # -- no parameters, no optimizer, no update ------------------------------
    def get_params(self):
        return {}, {}

    def init_params(self, initializer=None, arg_params=None, aux_params=None,
                    allow_missing=False, force_init=False,
                    allow_extra=False):
        self.params_initialized = True

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        pass  # nothing to optimize

    def update(self):
        pass  # nothing to update

    def update_metric(self, eval_metric, labels):
        if self._label_shapes is not None:
            # a subclass that binds labels must say how to score them
            raise NotImplementedError()

    # -- binding -------------------------------------------------------------
    def _validate_descs(self, data_shapes, label_shapes):
        if [d[0] for d in data_shapes] != self._data_names:
            raise AssertionError("data shapes %s for data names %s"
                                 % (data_shapes, self._data_names))
        if label_shapes is not None and (
                self._label_names is None
                or len(self._label_names) != len(label_shapes)):
            raise AssertionError("label shapes %s for label names %s"
                                 % (label_shapes, self._label_names))

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        self._validate_descs(data_shapes, label_shapes)
        self.for_training = for_training
        self.inputs_need_grad = inputs_need_grad
        self._data_shapes = data_shapes
        self._label_shapes = label_shapes
        self._output_shapes = self._compute_output_shapes()
        self.binded = True

    def _compute_output_shapes(self):
        """Subclasses: output descriptors from the bound input descs."""
        raise NotImplementedError()


for _attr in ("data_names", "output_names", "data_shapes", "label_shapes",
              "output_shapes"):
    setattr(PythonModule, _attr, property(operator.attrgetter("_" + _attr)))
del _attr


class PythonLossModule(PythonModule):
    """A loss head as a PythonModule: forward keeps the scores and labels,
    backward produces the input gradient from ``grad_func``."""

    def __init__(self, name="pyloss", data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 grad_func=None):
        if len(data_names) != 1 or len(label_names) != 1:
            raise AssertionError("a loss head takes one data and one label")
        super().__init__(data_names, label_names, [name + "_output"],
                         logger=logger)
        self._name = name
        if grad_func is not None and not callable(grad_func):
            raise AssertionError("grad_func must be callable")
        self._grad_func = grad_func
        self._scores = None
        self._labels = None
        self._scores_grad = None

    def _compute_output_shapes(self):
        # a loss head passes its scores through unchanged
        return [(self._name + "_output", self._data_shapes[0][1])]

    def forward(self, data_batch, is_train=None):
        self._scores = data_batch.data[0]
        if is_train if is_train is not None else self.for_training:
            self._labels = data_batch.label[0]

    def get_outputs(self, merge_multi_context=True):
        if not merge_multi_context:
            raise AssertionError("one context: outputs are always merged")
        return [self._scores]

    def backward(self, out_grads=None):
        if out_grads is not None:
            raise AssertionError("For a loss module, out_grads should be "
                                 "None")
        if not self.for_training:
            raise AssertionError("bind with for_training=True")
        if self._grad_func is None:
            raise NotImplementedError()
        grad = self._grad_func(self._scores, self._labels)
        self._scores_grad = grad if isinstance(grad, NDArray) \
            else array(grad, ctx=self._scores.context)

    def get_input_grads(self, merge_multi_context=True):
        if not merge_multi_context:
            raise AssertionError("one context: gradients are always merged")
        return [self._scores_grad]

    def install_monitor(self, mon):
        raise NotImplementedError()

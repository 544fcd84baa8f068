"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base with
``rescale_grad``, ``clip_gradient``, learning-rate and weight-decay
multipliers resolved through ``param_idx2name`` (``set_wd_mult`` keeps
weight decay on names ending ``_weight``/``_gamma`` and sets it to 0 on
all others), the registry (``create``), ``Updater``/``get_updater``, and
``SGD`` with momentum over the in-place ops of ``ops/optimizer_ops.py``.
``multi_precision`` (f32 master weights for bf16 parameters) and the
other optimizers have not been ported.
"""
from __future__ import annotations

from .base import MXNetError
from .ndarray import zeros
from .ops import optimizer_ops as _ops


class Optimizer:
    """Base optimizer with lr/wd multipliers and state management."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False):
        if lr_scheduler is not None:
            raise MXNetError("lr_scheduler is not ported yet")
        if multi_precision:
            raise MXNetError("multi_precision is not ported yet")
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = None
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = False
        self.idx2name = dict(param_idx2name or {})
        self.sym_info = (sym.attr_dict(), sym.list_arguments()) \
            if sym is not None else ()
        self.set_lr_mult({})
        self.set_wd_mult({})

    @staticmethod
    def register(klass):
        Optimizer.opt_registry[klass.__name__.lower()] = klass
        return klass

    @staticmethod
    def create_optimizer(name, **kwargs):
        if name.lower() in Optimizer.opt_registry:
            return Optimizer.opt_registry[name.lower()](**kwargs)
        raise ValueError("Cannot find optimizer %s" % name)

    def create_state(self, index, weight):
        return None

    def update(self, index, weight, grad, state):
        raise NotImplementedError

    def set_lr_mult(self, args_lr_mult):
        self.lr_mult = {}
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__lr_mult__" in attr[name]:
                    self.lr_mult[name] = float(attr[name]["__lr_mult__"])
        self.lr_mult.update(args_lr_mult)

    def set_wd_mult(self, args_wd_mult):
        self.wd_mult = {}
        for n in self.idx2name.values():
            if not (n.endswith("_weight") or n.endswith("_gamma")):
                self.wd_mult[n] = 0.0
        if self.sym_info:
            attr, arg_names = self.sym_info
            for name in arg_names:
                if name in attr and "__wd_mult__" in attr[name]:
                    self.wd_mult[name] = float(attr[name]["__wd_mult__"])
        self.wd_mult.update(args_wd_mult)

    def _update_count(self, index):
        if index not in self._index_update_count:
            self._index_update_count[index] = self.begin_num_update
        self._index_update_count[index] += 1
        self.num_update = max(self._index_update_count[index],
                              self.num_update)

    def _get_lr(self, index):
        lr = self.lr
        if index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd


register = Optimizer.register


@register
class SGD(Optimizer):
    """SGD with momentum (ref: optimizer.py:433; sgd_update and
    sgd_mom_update)."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return zeros(weight.shape, weight.context, dtype=weight.tensor.dtype)

    def update(self, index, weight, grad, state):
        self._update_count(index)
        kwargs = dict(lr=self._get_lr(index), wd=self._get_wd(index),
                      rescale_grad=self.rescale_grad,
                      clip_gradient=-1.0 if self.clip_gradient is None
                      else self.clip_gradient)
        if state is not None:
            _ops.sgd_mom_update(weight.tensor, grad.tensor, state.tensor,
                                momentum=self.momentum, **kwargs)
        else:
            _ops.sgd_update(weight.tensor, grad.tensor, **kwargs)


create = Optimizer.create_optimizer


class Updater:
    """Local updater applying an optimizer per key (ref: optimizer.py:1263)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state(index, weight)
        self.optimizer.update(index, weight, grad, self.states[index])


def get_updater(optimizer):
    return Updater(optimizer)

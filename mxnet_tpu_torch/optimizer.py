"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base with
``rescale_grad``, ``clip_gradient``, learning-rate and weight-decay
multipliers resolved through ``param_idx2name`` (``set_wd_mult`` keeps
weight decay on names ending ``_weight``/``_gamma`` and sets it to 0 on
all others) or, for Gluon, through ``param_dict`` (each Parameter's own
``lr_mult``/``wd_mult``), the registry (``create``), ``Updater``/
``get_updater`` with pickled states, ``SGD`` with momentum and ``Adam``
over the in-place ops of ``ops/optimizer_ops.py``.  ``multi_precision``
(f32 master weights for bf16 parameters), learning-rate schedulers and
the other optimizers have not been ported.
"""
from __future__ import annotations

import math
import pickle

from .base import MXNetError
from .ndarray import zeros
from .ops import optimizer_ops as _ops


class Optimizer:
    """Base optimizer with lr/wd multipliers and state management."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
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
        self.param_dict = param_dict or {}
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

    def set_learning_rate(self, lr):
        self.lr = lr

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
        if index in self.param_dict:
            lr *= self.param_dict[index].lr_mult
        elif index in self.lr_mult:
            lr *= self.lr_mult[index]
        elif index in self.idx2name:
            lr *= self.lr_mult.get(self.idx2name[index], 1.0)
        return lr

    def _get_wd(self, index):
        wd = self.wd
        if index in self.param_dict:
            wd *= self.param_dict[index].wd_mult
        elif index in self.wd_mult:
            wd *= self.wd_mult[index]
        elif index in self.idx2name:
            wd *= self.wd_mult.get(self.idx2name[index], 1.0)
        return wd

    def __getstate__(self):
        # a pickled optimizer (Trainer.save_states) carries its settings and
        # counts, not the live Parameters; the Trainer reattaches them
        state = dict(self.__dict__)
        state["param_dict"] = {}
        return state


register = Optimizer.register


def _clip_arg(opt):
    return -1.0 if opt.clip_gradient is None else opt.clip_gradient


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
                      clip_gradient=_clip_arg(self))
        if state is not None:
            _ops.sgd_mom_update(weight.tensor, grad.tensor, state.tensor,
                                momentum=self.momentum, **kwargs)
        else:
            _ops.sgd_update(weight.tensor, grad.tensor, **kwargs)


@register
class Adam(Optimizer):
    """Adam (ref: optimizer.py:433-472; adam_update): the bias correction
    ``sqrt(1 - beta2**t) / (1 - beta1**t)`` is folded into the step's
    learning rate, t counting this parameter's updates."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        dt = weight.tensor.dtype
        return (zeros(weight.shape, weight.context, dtype=dt),
                zeros(weight.shape, weight.context, dtype=dt))

    def update(self, index, weight, grad, state):
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        t = self._index_update_count[index]
        lr *= math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t)
        mean, var = state
        _ops.adam_update(weight.tensor, grad.tensor, mean.tensor, var.tensor,
                         lr=lr, beta1=self.beta1, beta2=self.beta2,
                         epsilon=self.epsilon, wd=wd,
                         rescale_grad=self.rescale_grad,
                         clip_gradient=_clip_arg(self))


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

    def set_states(self, states):
        states = pickle.loads(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
        else:
            self.states = states

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


def get_updater(optimizer):
    return Updater(optimizer)

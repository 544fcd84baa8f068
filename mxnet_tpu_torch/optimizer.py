"""Optimizers.

Counterpart of ``mxnet_tpu/optimizer.py``: the ``Optimizer`` base with
``rescale_grad``, ``clip_gradient``, a learning-rate scheduler
(``lr_scheduler.py``) and learning-rate and weight-decay multipliers
resolved through ``param_idx2name`` (``set_wd_mult`` keeps weight decay
on names ending ``_weight``/``_gamma`` and sets it to 0 on all others)
or, for Gluon, through ``param_dict`` (each Parameter's own
``lr_mult``/``wd_mult``); ``multi_precision`` (an f32 master copy of a
float16/bfloat16 weight, ``create_state_multi_precision`` /
``update_multi_precision``); the registry (``create``); ``Updater`` /
``get_updater`` with pickled states; and the thirteen optimizers of the
reference with ``Test``: SGD, Signum, NAG, SGLD, DCASGD, Adam, AdaGrad,
RMSProp (plain or centered), AdaDelta, Ftrl, FTML, Adamax and Nadam.

Each optimizer writes its update once, as ``fused_update(w, g, state,
lr, wd, ex, key)`` over torch tensors: the fused train step
(``module/fused_step.py``) calls it with ``lr``, ``wd`` and the
per-step extras ``ex`` (``fused_scalars``: bias corrections) as 0-d
device tensors, so that a CUDA graph of the step reads them as data, and
the general path's ``update`` calls it with Python floats.  An update
that returns the tensors it was given has changed them in place; one
that returns new tensors leaves the write-back to its caller
(``apply_update``).
"""
from __future__ import annotations

import importlib
import io
import math
import pickle

import torch

from .base import MXNetError, dtype_name
from . import random as _random
from .ndarray import NDArray, _invoke, zeros
from .ops import optimizer_ops as _ops


def _is_low_precision(dtype):
    """True for storage dtypes that get an f32 master copy under
    ``multi_precision`` (the reference checks float16; bfloat16 gets the
    same treatment)."""
    return dtype_name(dtype) in ("float16", "bfloat16")


def state_tensors(state):
    """A create_state-shaped tree (None, an NDArray or tensor, tuples of
    those) with every NDArray replaced by its tensor."""
    if isinstance(state, tuple):
        return tuple(state_tensors(s) for s in state)
    return state.tensor if isinstance(state, NDArray) else state


def state_leaves(state):
    """The tensors of a state tree, in order, without the Nones."""
    if isinstance(state, tuple):
        return [t for s in state for t in state_leaves(s)]
    return [] if state is None else [state]


@torch.no_grad()
def apply_update(opt, w, g, state, lr, wd, ex, key=None):
    """``opt.fused_update`` with its results written back into ``w`` and
    the leaves of ``state``, which the caller keeps: the states first,
    since a new state may be computed from the old weight."""
    new_w, new_state = opt.fused_update(w, g, state, lr, wd, ex, key=key)
    old, new = state_leaves(state), state_leaves(new_state)
    if len(old) != len(new):
        raise ValueError("%s.fused_update changed the state's structure"
                         % type(opt).__name__)
    for dst, src in zip(old, new):
        if src is not dst:
            dst.copy_(src)
    if new_w is not w:
        w.copy_(new_w)


class Optimizer:
    """Base optimizer with lr/wd multipliers and state management."""

    opt_registry = {}

    def __init__(self, rescale_grad=1.0, param_idx2name=None, wd=0.0,
                 clip_gradient=None, learning_rate=0.01, lr_scheduler=None,
                 sym=None, begin_num_update=0, multi_precision=False,
                 param_dict=None):
        self.rescale_grad = rescale_grad
        self.lr = learning_rate
        self.lr_scheduler = lr_scheduler
        if lr_scheduler is not None:
            self.lr_scheduler.base_lr = learning_rate
        self.wd = wd
        self.lr_mult = {}
        self.wd_mult = {}
        self.begin_num_update = begin_num_update
        self.num_update = begin_num_update
        self._index_update_count = {}
        self.clip_gradient = clip_gradient
        self.multi_precision = multi_precision
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

    def create_state_multi_precision(self, index, weight):
        """``(w32, state)`` for a half-width weight under
        multi_precision, else ``create_state``."""
        if self.multi_precision and _is_low_precision(weight.dtype):
            w32 = weight.astype("float32")
            return (w32, self.create_state(index, w32))
        return self.create_state(index, weight)

    def update(self, index, weight, grad, state):
        """One update of NDArray ``weight`` from ``grad``: the optimizer's
        ``fused_update`` with this step's scalars as Python floats.  A
        sparse gradient is densified (the storage fallback)."""
        grad = _dense(grad)
        self._update_count(index)
        lr, wd = self._get_lr(index), self._get_wd(index)
        apply_update(self, weight.tensor, grad.tensor, state_tensors(state),
                     lr, wd, self.fused_scalars(index),
                     key=_random.generator(weight.tensor.device)
                     if self.fused_needs_rng else None)

    def update_multi_precision(self, index, weight, grad, state):
        if self.multi_precision and _is_low_precision(weight.dtype):
            grad = _dense(grad)
            w32 = state[0]
            self.update(index, w32, NDArray(grad.tensor.float()), state[1])
            w32.copyto(weight)
        else:
            self.update(index, weight, grad, state)

    # -- the fused interface -------------------------------------------------
    fused_needs_rng = False  # True when fused_update draws random numbers
    fused_n_scalars = 0      # width of the fused_scalars tuple

    def _fused_ok(self):
        # fused_update must come from a class at or below the one that
        # defines update() in the MRO: a subclass overriding only update()
        # (custom math over an existing optimizer) must not train with its
        # parent's fused math
        for klass in type(self).__mro__:
            if "fused_update" in vars(klass):
                return klass.fused_update is not Optimizer.fused_update
            if "update" in vars(klass):
                return False
        return False

    def fused_scalars(self, index):
        """The per-step scalars beyond lr and wd (bias corrections), once
        per parameter per step after ``_update_count``: a stateful
        schedule (Nadam's ``m_schedule``) advances here."""
        return ()

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        """``(new_w, new_state)`` from weight ``w`` (the f32 master under
        multi_precision), gradient ``g`` (in ``w``'s dtype) and the
        create_state-shaped ``state`` of tensors; ``lr``, ``wd`` and the
        ``ex`` of ``fused_scalars`` are floats or 0-d tensors; ``key`` is
        the device's ``torch.Generator`` when ``fused_needs_rng``."""
        raise NotImplementedError

    def fused_wrap_mp_state(self, state_nd, master_nd):
        """The Updater's state of a half-width weight under
        multi_precision (``(w32, state)``; SGD's is ``(mom, w32)``)."""
        return (master_nd, state_nd)

    def health_update_scale(self, index=0):
        """Host-side magnitude of this optimizer's step per unit raw
        gradient: ``lr * |rescale_grad|``.  The health sentinel's general
        path carries grad and param norms but not the applied update, so
        its update/param ratio is estimated as
        ``scale * grad_norm / param_norm`` (the fused train step computes
        the exact ratio in the step).  Momentum and adaptive terms are
        ignored: an order-of-magnitude signal for a divergence detector."""
        return float(abs(self._get_lr(index)) * abs(self.rescale_grad))

    def _clip(self, g):
        g = g * self.rescale_grad
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        return g

    def set_learning_rate(self, lr):
        if self.lr_scheduler is not None:
            raise MXNetError("LRScheduler of the optimizer has already "
                              "been defined.")
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
        if self.lr_scheduler is not None:
            lr = self.lr_scheduler(self.num_update)
        else:
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

    def __setstate__(self, state):
        self.__dict__.update(state)


register = Optimizer.register


def _clip_arg(opt):
    return -1.0 if opt.clip_gradient is None else opt.clip_gradient


def _dense(grad):
    """A sparse gradient densified (the storage fallback); a dense one as
    it is."""
    return grad.todense() if grad.stype != "default" else grad


def _zeros_like(weight, dtype=None):
    return zeros(weight.shape, weight.context,
                 dtype=weight.tensor.dtype if dtype is None else dtype)


@register
class SGD(Optimizer):
    """SGD with momentum (ref: optimizer.py:217): ``sgd_update``,
    ``sgd_mom_update`` and, under multi_precision, their ``mp_`` forms
    with the state ``(mom, w32)``."""

    def __init__(self, momentum=0.0, lazy_update=True, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        if self.momentum == 0.0:
            return None
        return _zeros_like(weight)

    def create_state_multi_precision(self, index, weight):
        if self.multi_precision and _is_low_precision(weight.dtype):
            mom = _zeros_like(weight, "float32") if self.momentum != 0.0 \
                else None
            return (mom, weight.astype("float32"))
        return self.create_state(index, weight)

    def _kwargs(self, lr, wd):
        return dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                    clip_gradient=_clip_arg(self))

    def update(self, index, weight, grad, state):
        if isinstance(state, tuple):  # multi-precision: no lazy path
            grad = _dense(grad)
        self._update_count(index)
        kw = self._kwargs(self._get_lr(index), self._get_wd(index))
        if grad.stype == "row_sparse":  # the registered op's lazy path
            if state is None:
                _invoke("sgd_update", [weight, grad], kw, out=weight)
            else:
                _invoke("sgd_mom_update", [weight, grad, state],
                        dict(kw, momentum=self.momentum), out=weight)
            return
        w, g = weight.tensor, _dense(grad).tensor
        if isinstance(state, tuple):  # multi-precision: (mom, w32)
            mom, w32 = state
            if mom is not None:
                _ops.mp_sgd_mom_update(w, g, mom.tensor, w32.tensor,
                                       momentum=self.momentum, **kw)
            else:
                _ops.mp_sgd_update(w, g, w32.tensor, **kw)
        elif state is not None:
            _ops.sgd_mom_update(w, g, state.tensor, momentum=self.momentum,
                                **kw)
        else:
            _ops.sgd_update(w, g, **kw)

    update_multi_precision = update

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        if state is None:
            _ops.sgd_update(w, g, **self._kwargs(lr, wd))
        else:
            _ops.sgd_mom_update(w, g, state, momentum=self.momentum,
                                **self._kwargs(lr, wd))
        return w, state

    def fused_wrap_mp_state(self, state_nd, master_nd):
        return (state_nd, master_nd)


@register
class Signum(Optimizer):
    """Signum, or signSGD without momentum (ref: optimizer.py:281)."""

    def __init__(self, learning_rate=0.01, momentum=0.9, wd_lh=0.0,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.momentum = momentum
        self.wd_lh = wd_lh

    def create_state(self, index, weight):
        return _zeros_like(weight) if self.momentum != 0.0 else None

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        kw = dict(lr=lr, wd=wd, rescale_grad=self.rescale_grad,
                  clip_gradient=_clip_arg(self))
        if state is None:
            _ops.signsgd_update(w, g, **kw)
        else:
            _ops.signum_update(w, g, state, momentum=self.momentum,
                               wd_lh=self.wd_lh, **kw)
        return w, state


@register
class NAG(Optimizer):
    """Nesterov's accelerated gradient (ref: optimizer.py:319)."""

    def __init__(self, momentum=0.0, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum

    def create_state(self, index, weight):
        return None if self.momentum == 0.0 else _zeros_like(weight)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        g = self._clip(g)
        if state is None:
            return w - lr * (g + wd * w), None
        g = g + wd * w
        mom = self.momentum * state + g
        return w - lr * (g + self.momentum * mom), mom


@register
class SGLD(Optimizer):
    """Stochastic gradient Langevin dynamics (ref: optimizer.py:358): the
    noise comes from the device's generator (``mx.random.seed``)."""

    fused_needs_rng = True

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        g = self._clip(g)
        std = torch.sqrt(lr) if isinstance(lr, torch.Tensor) \
            else math.sqrt(lr)
        noise = torch.randn(w.shape, generator=key, device=w.device,
                            dtype=torch.float32) * std
        return w - lr / 2 * (g + wd * w) + noise, state


@register
class DCASGD(Optimizer):
    """Delay-compensated asynchronous SGD (ref: optimizer.py:387)."""

    def __init__(self, momentum=0.0, lamda=0.04, **kwargs):
        super().__init__(**kwargs)
        self.momentum = momentum
        self.weight_previous = {}
        self.lamda = lamda

    def create_state(self, index, weight):
        prev = weight.copyto(weight.context)
        if self.momentum == 0.0:
            return (None, prev)
        return (_zeros_like(weight), prev)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        g = self._clip(g)
        mom, prev = state
        delta = -lr * (g + wd * w + self.lamda * g * g * (w - prev))
        mom = delta if mom is None else self.momentum * mom + delta
        return w + mom, (None if self.momentum == 0.0 else mom, w)


@register
class Adam(Optimizer):
    """Adam (ref: optimizer.py:433; adam_update): the bias correction
    ``sqrt(1 - beta2**t) / (1 - beta1**t)`` is the step's one extra
    scalar, folded into its learning rate, t counting this parameter's
    updates."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, lazy_update=True, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.lazy_update = lazy_update

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def update(self, index, weight, grad, state):
        if grad.stype != "row_sparse":
            return super().update(index, weight, grad, state)
        # the registered op's lazy path
        self._update_count(index)
        _invoke("adam_update", [weight, grad, state[0], state[1]],
                dict(lr=self._get_lr(index) * self.fused_scalars(index)[0],
                     beta1=self.beta1, beta2=self.beta2,
                     epsilon=self.epsilon, wd=self._get_wd(index),
                     rescale_grad=self.rescale_grad,
                     clip_gradient=_clip_arg(self)), out=weight)

    fused_n_scalars = 1

    def fused_scalars(self, index):
        t = self._index_update_count[index]
        return (math.sqrt(1.0 - self.beta2 ** t) / (1.0 - self.beta1 ** t),)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        _ops.adam_update(w, g, state[0], state[1], lr=lr * ex[0],
                         beta1=self.beta1, beta2=self.beta2,
                         epsilon=self.epsilon, wd=wd,
                         rescale_grad=self.rescale_grad,
                         clip_gradient=_clip_arg(self))
        return w, state


@register
class AdaGrad(Optimizer):
    """AdaGrad (ref: optimizer.py:475)."""

    def __init__(self, eps=1e-7, **kwargs):
        super().__init__(**kwargs)
        self.float_stable_eps = eps

    def create_state(self, index, weight):
        return _zeros_like(weight)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        g = self._clip(g)
        hist = state + g * g
        return w - lr * (g / torch.sqrt(hist + self.float_stable_eps)
                         + w * wd), hist


@register
class RMSProp(Optimizer):
    """RMSProp, plain or Graves' centered form (ref: optimizer.py:505;
    rmsprop_update, rmspropalex_update)."""

    def __init__(self, learning_rate=0.001, gamma1=0.9, gamma2=0.9,
                 epsilon=1e-8, centered=False, clip_weights=None, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.gamma1 = gamma1
        self.gamma2 = gamma2
        self.centered = centered
        self.epsilon = epsilon
        self.clip_weights = clip_weights

    def create_state(self, index, weight):
        if self.centered:
            return (_zeros_like(weight), _zeros_like(weight),
                    _zeros_like(weight))
        return (_zeros_like(weight),)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        kw = dict(lr=lr, gamma1=self.gamma1, epsilon=self.epsilon, wd=wd,
                  rescale_grad=self.rescale_grad,
                  clip_gradient=_clip_arg(self),
                  clip_weights=self.clip_weights or -1.0)
        if self.centered:
            _ops.rmspropalex_update(w, g, *state, gamma2=self.gamma2, **kw)
        else:
            _ops.rmsprop_update(w, g, state[0], **kw)
        return w, state


@register
class AdaDelta(Optimizer):
    """AdaDelta (ref: optimizer.py:557)."""

    def __init__(self, rho=0.90, epsilon=1e-5, **kwargs):
        super().__init__(**kwargs)
        self.rho = rho
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        g = self._clip(g)
        acc_g, acc_delta = state
        acc_g = self.rho * acc_g + (1.0 - self.rho) * g * g
        delta = (torch.sqrt(acc_delta + self.epsilon)
                 / torch.sqrt(acc_g + self.epsilon)) * g
        acc_delta = self.rho * acc_delta + (1.0 - self.rho) * delta * delta
        return w - delta - wd * w, (acc_g, acc_delta)


@register
class Ftrl(Optimizer):
    """FTRL-proximal (ref: optimizer.py:596; ftrl_update)."""

    def __init__(self, lamda1=0.01, learning_rate=0.1, beta=1, **kwargs):
        super().__init__(**kwargs)
        self.lamda1 = lamda1
        self.beta = beta
        self.lr = learning_rate

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        _ops.ftrl_update(w, g, state[0], state[1], lr=lr,
                         lamda1=self.lamda1, beta=self.beta, wd=wd,
                         rescale_grad=self.rescale_grad,
                         clip_gradient=_clip_arg(self))
        return w, state


@register
class FTML(Optimizer):
    """Follow the moving leader (ref: optimizer.py:627); extras
    ``(1 - beta1**t, 1 - beta2**t)``."""

    def __init__(self, beta1=0.6, beta2=0.999, epsilon=1e-8, **kwargs):
        super().__init__(**kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight),
                _zeros_like(weight))

    fused_n_scalars = 2

    def fused_scalars(self, index):
        t = self._index_update_count[index]
        return (1.0 - self.beta1 ** t, 1.0 - self.beta2 ** t)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        coef1, coef2 = ex[0], ex[1]
        g = g * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        d, v, z = state
        v = self.beta2 * v + (1 - self.beta2) * g * g
        d_t = coef1 / lr * (torch.sqrt(v / coef2) + self.epsilon)
        sigma_t = d_t - self.beta1 * d
        z = self.beta1 * z + (1 - self.beta1) * g - sigma_t * w
        return -z / d_t, (d_t, v, z)


@register
class Adamax(Optimizer):
    """Adamax (ref: optimizer.py:676); extra ``1 / (1 - beta1**t)``."""

    def __init__(self, learning_rate=0.002, beta1=0.9, beta2=0.999,
                 **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    fused_n_scalars = 1

    def fused_scalars(self, index):
        t = self._index_update_count[index]
        return (1.0 / (1.0 - self.beta1 ** t),)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        g = g * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m_t, u_t = state
        m_t = self.beta1 * m_t + (1.0 - self.beta1) * g
        u_t = torch.maximum(self.beta2 * u_t, torch.abs(g))
        return w - (lr * ex[0]) * m_t / u_t, (m_t, u_t)


@register
class Nadam(Optimizer):
    """Nesterov Adam (ref: optimizer.py:717); five extras, the momentum
    schedule advancing once per parameter per step in
    ``fused_scalars``."""

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, schedule_decay=0.004, **kwargs):
        super().__init__(learning_rate=learning_rate, **kwargs)
        self.beta1 = beta1
        self.beta2 = beta2
        self.epsilon = epsilon
        self.schedule_decay = schedule_decay
        self.m_schedule = 1.0

    def create_state(self, index, weight):
        return (_zeros_like(weight), _zeros_like(weight))

    fused_n_scalars = 5

    def fused_scalars(self, index):
        t = self._index_update_count[index]
        momentum_t = self.beta1 * (1.0 - 0.5 * 0.96
                                   ** (t * self.schedule_decay))
        momentum_t_1 = self.beta1 * (1.0 - 0.5 * 0.96
                                     ** ((t + 1) * self.schedule_decay))
        self.m_schedule = self.m_schedule * momentum_t
        m_schedule_next = self.m_schedule * momentum_t_1
        return (momentum_t, momentum_t_1, self.m_schedule, m_schedule_next,
                1.0 - self.beta2 ** t)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        momentum_t, momentum_t_1, m_schedule, m_schedule_next, coef2 = ex
        g = g * self.rescale_grad + wd * w
        if self.clip_gradient is not None:
            g = torch.clamp(g, -self.clip_gradient, self.clip_gradient)
        m_t, v_t = state
        m_t = self.beta1 * m_t + (1.0 - self.beta1) * g
        v_t = self.beta2 * v_t + (1.0 - self.beta2) * g * g
        grad_prime = g / (1.0 - m_schedule)
        m_t_prime = m_t / (1.0 - m_schedule_next)
        v_t_prime = v_t / coef2
        m_t_bar = (1.0 - momentum_t) * grad_prime + momentum_t_1 * m_t_prime
        return w - lr * m_t_bar / (torch.sqrt(v_t_prime) + self.epsilon), \
            (m_t, v_t)


@register
class Test(Optimizer):
    """The reference's test optimizer: ``weight += grad * rescale_grad``
    and the state holds the new weight."""

    def create_state(self, index, weight):
        return zeros(weight.shape, weight.context)

    def update(self, index, weight, grad, state):
        with torch.no_grad():
            weight.tensor.add_(grad.tensor * self.rescale_grad)
            state.tensor.copy_(weight.tensor)

    def fused_update(self, w, g, state, lr, wd, ex, key=None):
        new_w = w + g * self.rescale_grad
        return new_w, new_w


create = Optimizer.create_optimizer


class _Dropped:
    """What a pickled object of the JAX package that the port has no use
    for (a Gluon Parameter in an optimizer's ``param_dict``, a Context)
    loads as."""

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, state):
        pass


class _StatesUnpickler(pickle.Unpickler):
    """Reads optimizer states that either package wrote: the JAX
    package's NDArrays load as the port's (``NDArray.__setstate__``
    takes both layouts), its optimizers and schedulers as the port's
    classes of the same names, and its other objects as ``_Dropped``.
    Nothing of the JAX package (or of JAX) is imported."""

    _MAPPED = {"mxnet_tpu.optimizer": "mxnet_tpu_torch.optimizer",
               "mxnet_tpu.lr_scheduler": "mxnet_tpu_torch.lr_scheduler"}

    def find_class(self, module, name):
        root = module.split(".")[0]
        if root == "mxnet_tpu":
            if name == "NDArray":
                return NDArray
            target = self._MAPPED.get(module)
            if target is not None:
                return getattr(importlib.import_module(target), name)
            return _Dropped
        if root in ("jax", "jaxlib"):
            return _Dropped
        return super().find_class(module, name)


def load_states(blob):
    """Unpickle an optimizer-state blob written by either package."""
    return _StatesUnpickler(io.BytesIO(blob)).load()


class Updater:
    """Local updater applying an optimizer per key (ref: optimizer.py:804)."""

    def __init__(self, optimizer):
        self.optimizer = optimizer
        self.states = {}
        self.states_synced = {}

    def __call__(self, index, grad, weight):
        if index not in self.states:
            self.states[index] = self.optimizer.create_state_multi_precision(
                index, weight)
            self.states_synced[index] = True
        elif not self.states_synced.get(index, True):
            # loaded states go where the weight is (ref:
            # Updater.sync_state_context)
            self.states[index] = _on_context(self.states[index],
                                             weight.context)
            self.states_synced[index] = True
        self.optimizer.update_multi_precision(index, weight, grad,
                                              self.states[index])

    def set_states(self, states):
        states = load_states(states)
        if isinstance(states, tuple) and len(states) == 2:
            self.states, self.optimizer = states
            self.optimizer.param_dict = {}
        else:
            self.states = states
        self.states_synced = dict.fromkeys(self.states.keys(), False)

    def get_states(self, dump_optimizer=False):
        return pickle.dumps((self.states, self.optimizer) if dump_optimizer
                            else self.states)


def _on_context(state, ctx):
    """An optimizer state (an NDArray, or tuples and lists of them) on
    ``ctx``."""
    if isinstance(state, NDArray):
        return state.as_in_context(ctx)
    if isinstance(state, (tuple, list)):
        return type(state)(_on_context(s, ctx) for s in state)
    return state


def get_updater(optimizer):
    return Updater(optimizer)

"""Autograd: imperative automatic differentiation on torch autograd.

Counterpart of ``mxnet_tpu/autograd.py``, with the same observable API:
the ``record``/``pause``/``train_mode``/``predict_mode`` scopes,
``mark_variables``, ``backward`` and ``grad``.  The JAX package keeps a
tape of its own and differentiates it node by node with ``jax.vjp``;
here the recording is torch's own graph: imperative ops run with torch
grad mode on exactly inside ``record()`` (``ndarray._invoke``), a marked
variable's tensor is a leaf that requires grad, and ``backward`` asks
``torch.autograd.grad`` for the leaves' gradients and writes them into
their buffers as ``grad_req`` says — ``'write'`` overwrites, ``'add'``
accumulates (torch's own ``.grad`` accumulation is never used, so
``'write'`` cannot leak an earlier step's gradient).
"""
from __future__ import annotations

import threading
import weakref

import torch

from .base import MXNetError

_state = threading.local()
# every NDArray given a gradient buffer, by id: the candidates backward
# asks torch for (weak, so a dropped array leaves the table)
_MARKED = weakref.WeakValueDictionary()


def _st():
    if not hasattr(_state, "recording"):
        _state.recording = False
        _state.training = False
    return _state


def is_recording():
    return _st().recording


def is_training():
    return _st().training


def set_recording(is_record):
    prev = _st().recording
    _state.recording = bool(is_record)
    return prev


def set_training(train_mode):
    prev = _st().training
    _state.training = bool(train_mode)
    return prev


class _RecordingStateScope:
    def __init__(self, is_record, train_mode):
        self._enter_is_record = is_record
        self._enter_train_mode = train_mode
        self._prev_is_record = None
        self._prev_train_mode = None

    def __enter__(self):
        if self._enter_is_record is not None:
            self._prev_is_record = set_recording(self._enter_is_record)
        if self._enter_train_mode is not None:
            self._prev_train_mode = set_training(self._enter_train_mode)

    def __exit__(self, ptype, value, trace):
        if self._enter_is_record is not None:
            set_recording(self._prev_is_record)
        if self._enter_train_mode is not None:
            set_training(self._prev_train_mode)


def record(train_mode=True):
    """Autograd recording scope (ref: python/mxnet/autograd.py:122)."""
    return _RecordingStateScope(True, train_mode)


def pause(train_mode=False):
    return _RecordingStateScope(False, train_mode)


def train_mode():
    return _RecordingStateScope(None, True)


def predict_mode():
    return _RecordingStateScope(None, False)


def mark_variables(variables, gradients, grad_reqs="write"):
    """Attach gradient buffers to variables (ref: MXAutogradMarkVariables):
    each variable's tensor becomes a torch leaf that requires grad (same
    storage), and ``backward`` fills its buffer per ``grad_req``."""
    if isinstance(grad_reqs, str):
        grad_reqs = [grad_reqs] * len(variables)
    for var, grad, req in zip(variables, gradients, grad_reqs):
        if req not in ("write", "add", "null"):
            raise MXNetError("grad_req %r: one of write, add, null" % req)
        t = var.tensor.detach()
        if t.is_inference():  # made under inference_mode: take a copy
            t = t.clone()
        var._h.tensor = t.requires_grad_(req != "null")
        var._grad = grad if req != "null" else None
        var._grad_req = req
        _MARKED[id(var)] = var


def _heads_and_grads(heads, head_grads):
    from .ndarray import NDArray
    if isinstance(heads, NDArray):
        heads = [heads]
    if head_grads is None:
        head_grads = [None] * len(heads)
    elif isinstance(head_grads, NDArray):
        head_grads = [head_grads]
    ys, gs = [], []
    for h, hg in zip(heads, head_grads):
        if not h.tensor.requires_grad:
            raise MXNetError("cannot differentiate: output is not on the "
                             "tape (was it computed inside "
                             "autograd.record()?)")
        ys.append(h.tensor)
        gs.append(torch.ones_like(h.tensor) if hg is None
                  else hg.tensor.to(device=h.tensor.device,
                                    dtype=h.tensor.dtype))
    return ys, gs


def backward(heads, head_grads=None, retain_graph=False, train_mode=True):
    """Run backward from head NDArrays, filling every marked variable's
    gradient buffer that the heads depend on (ref: Imperative::Backward,
    imperative.cc:357); a variable they do not reach keeps its buffer."""
    ys, gs = _heads_and_grads(heads, head_grads)
    marked = [v for v in list(_MARKED.values())
              if v._grad is not None and v.tensor.requires_grad]
    if not marked:
        return
    grads = torch.autograd.grad(ys, [v.tensor for v in marked], gs,
                                retain_graph=retain_graph, allow_unused=True)
    with torch.no_grad():
        for var, g in zip(marked, grads):
            if g is None:
                continue
            buf = var._grad.tensor
            if var._grad_req == "add":
                buf.add_(g)
            else:
                buf.copy_(g)


def grad(heads, variables, head_grads=None, retain_graph=None,
         create_graph=False, train_mode=True):
    """Gradients of ``heads`` with respect to ``variables`` (NDArrays
    whose tensors require grad), returned as new NDArrays; the variables'
    own buffers are left alone (ref: autograd.py:270)."""
    from .ndarray import NDArray
    single = isinstance(variables, NDArray)
    if single:
        variables = [variables]
    ys, gs = _heads_and_grads(heads, head_grads)
    if any(not v.tensor.requires_grad for v in variables):
        raise MXNetError("grad: every variable needs attach_grad() first")
    keep = create_graph if retain_graph is None else retain_graph
    grads = torch.autograd.grad(ys, [v.tensor for v in variables], gs,
                                retain_graph=keep, create_graph=create_graph,
                                allow_unused=True)
    out = [NDArray(torch.zeros_like(v.tensor.detach()) if g is None else g)
           for v, g in zip(variables, grads)]
    return out[0] if single else out


def get_symbol(x):
    """Not supported, as in the JAX package: the recording is torch's
    graph, not a Symbol."""
    raise MXNetError("autograd.get_symbol is not supported in "
                     "mxnet_tpu_torch")


class Function:
    """Custom differentiable function (ref: autograd.py:381): subclass it
    and write ``forward`` and ``backward`` in NDArray ops.  Recording is
    paused inside both; ``backward`` receives the outputs' gradients and
    returns the inputs'.  ``save_for_backward``/``saved_tensors`` carry
    NDArrays from one to the other.  Under ``record()`` a call is one
    node of torch's graph (a ``torch.autograd.Function`` whose backward
    calls this one's), so a loss after it differentiates through it."""

    def __init__(self):
        self._saved = None

    def save_for_backward(self, *args):
        self._saved = args

    @property
    def saved_tensors(self):
        return self._saved

    def __call__(self, *inputs):
        from .ndarray import NDArray
        if not is_recording():
            with pause():
                return self.forward(*inputs)
        func, fmt = self, {}

        class _Node(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                with pause():
                    outs = func.forward(*[NDArray(t) for t in tensors])
                fmt["single"] = not isinstance(outs, (list, tuple))
                outs = [outs] if fmt["single"] else list(outs)
                return tuple(o.tensor for o in outs)

            @staticmethod
            def backward(ctx, *grads):
                with pause():
                    in_grads = func.backward(*[NDArray(g) for g in grads])
                if not isinstance(in_grads, (list, tuple)):
                    in_grads = [in_grads]
                return tuple(None if g is None else g.tensor
                             for g in in_grads)

        with torch.enable_grad():
            outs = _Node.apply(*[i.tensor for i in inputs])
        outs = [NDArray(t) for t in outs]
        return outs[0] if fmt["single"] else outs

    def forward(self, *inputs):
        raise NotImplementedError

    def backward(self, *output_grads):
        raise NotImplementedError

"""Executor: binds a Symbol to a device and runs its forward.

Counterpart of ``mxnet_tpu/executor.py`` (forward only: the backward and
the fused forward-backward come with the training slice).  Where the JAX
package jits the whole graph into one XLA program, the port builds a plan
once per bind signature (``_Program``, cached by ``executor_cache``) and
runs it eagerly op by op under ``torch.inference_mode``; the ops launch
their own kernels (cuBLAS products, the hand-written flash attention).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError, torch_dtype
from .ndarray import NDArray, zeros as nd_zeros
from .ndarray.ndarray import _to_tensor
from .ops.registry import get_op
from . import executor_cache


class _Program:
    """A symbol graph lowered to a list of op calls over value slots.

    Every (node, output) entry of the graph gets a slot number, in topo
    order; nodes are identified by position, never by name (an exported
    graph repeats op names).  ``steps`` holds, per op node, the op, its
    normalized attrs, its input slots, its first output slot and the
    slots whose last reader it is (freed right after it runs)."""

    def __init__(self, symbol):
        order = symbol._topo()
        symbol._mark_aux(order)
        self.arg_names = [n.name for n in order if n.is_var and not n._is_aux]
        self.aux_names = [n.name for n in order if n.is_var and n._is_aux]
        slot = {}
        self.var_slots = []  # (name, slot) for every variable
        raw = []
        for node in order:
            if node.is_var:
                slot[(id(node), 0)] = len(slot)
                self.var_slots.append((node.name, slot[(id(node), 0)]))
                continue
            op = get_op(node.op_name)
            attrs = op.normalize_attrs(node.attrs)
            ins = [slot[(id(src), idx)] for src, idx in node.inputs]
            first = len(slot)
            n_out = op.str_outputs(attrs)
            for i in range(n_out):
                slot[(id(node), i)] = first + i
            raw.append((op, attrs, ins, first, n_out))
        self.n_slots = len(slot)
        self.out_slots = [slot[(id(n), i)] for n, i in symbol._entries]
        keep = set(self.out_slots)
        last_use = {}
        for step, (_, _, ins, _, _) in enumerate(raw):
            for s in ins:
                last_use[s] = step
        self.steps = []
        for step, (op, attrs, ins, first, n_out) in enumerate(raw):
            free = tuple(sorted({s for s in ins if last_use[s] == step
                                 and s not in keep}))
            self.steps.append((op, attrs, tuple(ins), first, n_out, free))

    def evaluate(self, values):
        """Run the plan; ``values`` maps variable name -> tensor."""
        env = [None] * self.n_slots
        for name, s in self.var_slots:
            if name not in values:
                raise MXNetError("unbound variable %r" % name)
            env[s] = values[name]
        for op, attrs, ins, first, n_out, free in self.steps:
            out = op.impl(*[env[s] for s in ins], **attrs)
            if not isinstance(out, tuple):
                out = (out,)
            env[first:first + n_out] = out[:n_out]
            for s in free:
                env[s] = None
        return [env[s] for s in self.out_slots]


class Executor:
    def __init__(self, symbol, ctx, arg_dict, aux_dict):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device()
        self.arg_dict = arg_dict
        self.aux_dict = aux_dict
        self.outputs = []
        self._prog = executor_cache.get_program(symbol, arg_dict, aux_dict,
                                                self._device)

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` (NDArrays or array-likes) are copied
        into the bound arguments first.  The ops of this slice behave the
        same in train and predict mode; gradients wait for the training
        slice."""
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %r" % k)
            dst = self.arg_dict[k]
            src = v.tensor if isinstance(v, NDArray) \
                else _to_tensor(np.asarray(v), dst.context, None)
            with torch.inference_mode():
                dst.tensor.copy_(src)
        values = {n: a.tensor for n, a in self.arg_dict.items()}
        values.update((n, a.tensor) for n, a in self.aux_dict.items())
        with torch.inference_mode():
            outs = self._prog.evaluate(values)
        self.outputs = [NDArray(o) for o in outs]
        return self.outputs

    def copy_params_from(self, arg_params, aux_params=None,
                         allow_extra_params=False):
        for table, params, what in ((self.arg_dict, arg_params, "param"),
                                    (self.aux_dict, aux_params or {}, "aux")):
            for k, v in params.items():
                if k in table:
                    if v is not table[k]:
                        v.copyto(table[k])
                elif not allow_extra_params:
                    raise MXNetError("invalid %s %r" % (what, k))

    def reshape(self, partial_shaping=False, allow_up_sizing=False, **kwargs):
        """A new executor bound to other input shapes, sharing every
        array whose shape is unchanged.  As in the reference, an argument
        not named in kwargs that changes shape needs
        ``partial_shaping=True``, and an array that grows needs
        ``allow_up_sizing=True``."""
        arg_shapes, _, aux_shapes = self._symbol.infer_shape(**kwargs)
        new = {}
        for names, shapes, table, kind in (
                (self._prog.arg_names, arg_shapes, self.arg_dict, "argument"),
                (self._prog.aux_names, aux_shapes, self.aux_dict,
                 "auxiliary state")):
            for name, shape in zip(names, shapes):
                cur = table[name]
                shape = tuple(int(d) for d in shape)
                if cur.shape == shape:
                    new[name] = cur
                    continue
                if not partial_shaping and name not in kwargs:
                    raise MXNetError(
                        "reshape changed the shape of unspecified %s %r "
                        "(%s -> %s); if intended, pass partial_shaping=True"
                        % (kind, name, cur.shape, shape))
                if math.prod(shape) > math.prod(cur.shape) \
                        and not allow_up_sizing:
                    raise MXNetError(
                        "new shape of %s %r (%s) is larger than the bound "
                        "shape %s; pass allow_up_sizing=True to allow "
                        "allocating new arrays" % (kind, name, shape,
                                                   cur.shape))
                new[name] = nd_zeros(shape, cur.context,
                                     dtype=cur.tensor.dtype)
        return Executor(self._symbol, self._ctx,
                        {n: new[n] for n in self._prog.arg_names},
                        {n: new[n] for n in self._prog.aux_names})

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs,
                     shared_args=None):
        if grad_req not in ("null", None) and not (
                isinstance(grad_req, dict)
                and all(r == "null" for r in grad_req.values())):
            raise MXNetError("gradients are not ported yet: bind with "
                             "grad_req='null'")
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        type_dict = dict(type_dict or {})
        arg_types, _, aux_types = symbol.infer_type(**type_dict)
        shared = shared_args or {}

        def alloc(names, shapes, types):
            out = {}
            for name, shape, dt in zip(names, shapes, types):
                dt = torch_dtype(type_dict.get(name, dt or "float32"))
                have = shared.get(name)
                if have is not None and have.shape == tuple(shape) \
                        and have.tensor.dtype == dt \
                        and have.context == ctx:
                    out[name] = have
                else:
                    out[name] = nd_zeros(shape, ctx, dtype=dt)
            return out

        return Executor(
            symbol, ctx,
            alloc(symbol.list_arguments(), arg_shapes, arg_types),
            alloc(symbol.list_auxiliary_states(), aux_shapes, aux_types))

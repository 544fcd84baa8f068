"""Executor: binds a Symbol to a device and runs its forward and backward.

Counterpart of ``mxnet_tpu/executor.py``.  Where the JAX package jits the
whole graph into one XLA program and takes gradients as its ``jax.vjp``,
the port builds a plan once per bind signature (``_Program``, cached by
``executor_cache``) and runs it eagerly op by op; the ops launch their
own kernels (cuDNN convolutions, cuBLAS products, the hand-written
flash-attention, BatchNorm-sums and pooling-backward kernels).

Under ``group2ctx`` (manual model parallelism) an argument or aux state
may live on another context than the executor's: the plan computes on
the executor's device, its inputs copied there (the reference's
``_CrossDeviceCopy``), and each gradient is stored on its argument's
context.

A forward with ``is_train=False`` runs under ``torch.inference_mode``.
A training forward of an executor with gradients records torch autograd
over detached leaf views of the arguments that take a gradient, and
``backward`` differentiates that recording: the aux values the forward
consumed are the ones differentiated, even though the forward has
already written the advanced BatchNorm moving statistics back into
``aux_dict``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .base import MXNetError, dtype_name, torch_dtype
from .ndarray import NDArray, zeros as nd_zeros
from .ndarray.ndarray import _to_tensor
from .ops.registry import call_op, get_op
from . import executor_cache
from . import profiler as _profiler
from .observability import tracing as _tracing


class _Program:
    """A symbol graph lowered to a list of op calls over value slots.

    Every (node, output) entry of the graph gets a slot number, in topo
    order; nodes are identified by position, never by name (an exported
    graph repeats op names).  ``steps`` holds, per op node, the op, its
    normalized attrs, its input slots, its first output slot and the
    slots whose last reader it is (freed right after it runs).  ``kinds``
    holds the run kinds seen (``'fwd'``, ``'fwd_bwd'``): the first run of
    each counts as one build (``note_kind``), as the JAX package traces
    each program of a signature at its first use."""

    def __init__(self, symbol, known_shapes=None):
        self.kinds = set()
        order = symbol._topo()
        symbol._mark_aux(order)
        resolved = _resolve_init_shapes(symbol, order, known_shapes or {})
        self.arg_names = [n.name for n in order if n.is_var and not n._is_aux]
        self.aux_names = [n.name for n in order if n.is_var and n._is_aux]
        slot = {}
        self.var_slots = []  # (name, slot) for every variable
        # per step: the node's name and its inputs' monitor names
        self.taps = []
        raw = []
        for node in order:
            if node.is_var:
                slot[(id(node), 0)] = len(slot)
                self.var_slots.append((node.name, slot[(id(node), 0)]))
                continue
            op = get_op(node.op_name)
            attrs = op.normalize_attrs(node.attrs, len(node.inputs))
            if node in resolved:
                attrs["shape"] = resolved[node]
            ins = [slot[(id(src), idx)] for src, idx in node.inputs]
            first = len(slot)
            n_out = op.str_outputs(attrs)
            for i in range(n_out):
                slot[(id(node), i)] = first + i
            # state outputs past the visible ones rebind these aux
            # variables (BatchNorm's moving statistics); as in the JAX
            # package, an argument in a state slot (an update op's
            # optimizer state) is left as bound
            mutates = tuple((k, node.inputs[i][0].name)
                            for k, i in enumerate(op.mutate_map)
                            if node.inputs[i][0].is_var
                            and node.inputs[i][0]._is_aux)
            raw.append((op, attrs, ins, first, n_out, mutates))
            self.taps.append((node.name, tuple(
                "%s_%s" % (node.name, op.input_names[i]
                           if op.input_names and i < len(op.input_names)
                           else "input%d" % i)
                for i in range(len(ins)))))
        self.n_slots = len(slot)
        self.out_slots = [slot[(id(n), i)] for n, i in symbol._entries]
        keep = set(self.out_slots)
        last_use = {}
        for step, (_, _, ins, _, _, _) in enumerate(raw):
            for s in ins:
                last_use[s] = step
        self.steps = []
        for step, (op, attrs, ins, first, n_out, mutates) in enumerate(raw):
            free = tuple(sorted({s for s in ins if last_use[s] == step
                                 and s not in keep}))
            self.steps.append((op, attrs, tuple(ins), first, n_out, free,
                               mutates))

    def note_kind(self, kind):
        """Count this plan's first run of ``kind`` as a build."""
        if kind not in self.kinds:
            self.kinds.add(kind)
            executor_cache.note_trace(kind)

    def evaluate(self, values, train=False, tap=None, tap_inputs=False,
                 device=None):
        """Run the plan on ``device`` (by default the variables' device);
        ``values`` maps variable name -> tensor.  Returns
        (outputs, {aux name: new value}) — the state outputs of the ops
        with a ``mutate_map``.  ``tap(name, tensor)`` sees every op's
        visible outputs (``<node>_output``, then ``<node>_output<i>``
        for i >= 1, the JAX package's names), and
        with ``tap_inputs`` its inputs (``<node>_<input name>``) first."""
        env = [None] * self.n_slots
        for name, s in self.var_slots:
            if name not in values:
                raise MXNetError("unbound variable %r" % name)
            env[s] = values[name]
        new_aux = {}
        if device is None:
            device = next((v.device for v in values.values()), None)
        for k, (op, attrs, ins, first, n_out, free, mutates) in enumerate(
                self.steps):
            if tap is not None and tap_inputs:
                for in_name, s in zip(self.taps[k][1], ins):
                    tap(in_name, env[s])
            if op.takes_train_flag:
                attrs = dict(attrs, _train=train)
            if op.takes_device:
                attrs = dict(attrs, _device=device)
            out = call_op(op, [env[s] for s in ins], attrs)
            if not isinstance(out, tuple):
                out = (out,)
            env[first:first + n_out] = out[:n_out]
            if tap is not None:
                node_name = self.taps[k][0]
                for i in range(n_out):
                    tap(node_name + ("_output" if i == 0
                                     else "_output%d" % i), out[i])
            for j, name in mutates:
                new_aux[name] = out[n_out + j]
            for s in free:
                env[s] = None
        return [env[s] for s in self.out_slots], new_aux


def _resolve_init_shapes(symbol, order, known_shapes):
    """{node: shape} for the init ops (``_zeros``, ...) whose ``shape``
    attr has unknown (0) dims, such as an RNN's begin state of batch 0:
    their shape comes from inference over the bound argument shapes, as
    the JAX package's ``finalize_shapes`` does."""
    needs = []
    for node in order:
        if node.is_var or not node.attrs.get("shape"):
            continue
        op = get_op(node.op_name)
        if "shape" in op.params and any(
                int(d) == 0 for d in
                op.normalize_attrs(node.attrs).get("shape") or ()):
            needs.append(node)
    if not needs:
        return {}
    shapes, _ = symbol._infer(dict(known_shapes), {})
    out = {}
    for node in needs:
        s = shapes.get((node, 0))
        if s is None or any(int(d) == 0 for d in s):
            raise MXNetError(
                "cannot resolve unknown dims of init op %r (shape %s) from "
                "bound argument shapes %s; pass full shapes to bind/"
                "simple_bind" % (node.op_name, node.attrs.get("shape"),
                                 dict(known_shapes)))
        out[node] = tuple(int(d) for d in s)
    return out


def _req_table(arg_names, grad_req):
    """grad_req as a {name: 'write'|'add'|'null'} table from a string, a
    list in argument order or a dict (missing names are 'null')."""
    if grad_req is None:
        grad_req = "null"
    if isinstance(grad_req, str):
        table = {n: grad_req for n in arg_names}
    elif isinstance(grad_req, (list, tuple)):
        table = dict(zip(arg_names, grad_req))
    else:
        table = {n: grad_req.get(n, "null") for n in arg_names}
    for n, r in table.items():
        if r not in ("write", "add", "null"):
            raise MXNetError("grad_req %r of %r: one of write, add, null"
                             % (r, n))
    return table


class Executor:
    def __init__(self, symbol, ctx, arg_dict, aux_dict, grad_dict=None,
                 grad_req=None):
        self._symbol = symbol
        self._ctx = ctx
        self._device = ctx.torch_device()
        self.arg_dict = arg_dict
        self.aux_dict = aux_dict
        self.grad_dict = dict(grad_dict or {})
        self._grad_req = _req_table(list(arg_dict), grad_req)
        self._grad_names = [n for n in arg_dict
                            if self._grad_req[n] != "null"
                            and self.grad_dict.get(n) is not None]
        self.outputs = []
        self._monitor_callback = None
        self._monitor_all = False
        # the last training forward's autograd recording: (outputs, {name:
        # leaf}); dropped at the next forward
        self._recorded = None
        self._prog = executor_cache.get_program(
            symbol, arg_dict, aux_dict, self._device,
            tuple(self._grad_names))

    @property
    def arg_arrays(self):
        return [self.arg_dict[n] for n in self._prog.arg_names]

    @property
    def grad_arrays(self):
        return [self.grad_dict.get(n) for n in self._prog.arg_names]

    @property
    def aux_arrays(self):
        return [self.aux_dict[n] for n in self._prog.aux_names]

    @property
    def output_dict(self):
        return dict(zip(self._symbol.list_outputs(), self.outputs))

    def set_monitor_callback(self, callback, monitor_all=False):
        """Call ``callback(name, NDArray)`` on every op output of each
        forward (and on every op input too under ``monitor_all``)."""
        self._monitor_callback = callback
        self._monitor_all = monitor_all

    def _tap(self):
        callback = self._monitor_callback
        if callback is None:
            return {}

        def tap(name, value):
            callback(name, NDArray(value.detach()))
        return {"tap": tap, "tap_inputs": self._monitor_all}

    def forward(self, is_train=False, **kwargs):
        """Run the graph; ``kwargs`` (NDArrays or array-likes) are copied
        into the bound arguments first.  Under ``is_train`` the ops run in
        training mode, the BatchNorm moving statistics are written back
        into ``aux_dict``, and, when the executor takes gradients, the
        run is recorded for ``backward``.  While the profiler records,
        one ``executor_forward`` span (ref: kOnlySymbolic,
        profiler.h:94-121)."""
        if _tracing._recording:
            with _profiler.synced_span("executor_forward", self._device,
                                       dev=str(self._ctx)):
                return self._forward(is_train, kwargs)
        return self._forward(is_train, kwargs)

    def _forward(self, is_train, kwargs):
        self._recorded = None
        for k, v in kwargs.items():
            if k not in self.arg_dict:
                raise MXNetError("unknown argument %r" % k)
            dst = self.arg_dict[k]
            src = v.tensor if isinstance(v, NDArray) \
                else _to_tensor(np.asarray(v), dst.context, None)
            with torch.inference_mode():
                dst.tensor.copy_(src)
        train = bool(is_train)
        self._prog.note_kind("fwd_bwd" if train and self._grad_names
                             else "fwd")
        if train and self._grad_names:
            outs, new_aux, leaves = self._record(**self._tap())
            self._recorded = (outs, leaves)
        else:
            values = self._values()
            with torch.inference_mode():
                outs, new_aux = self._prog.evaluate(
                    values, train=train, device=self._device, **self._tap())
        if train:
            with torch.no_grad():
                for name, value in new_aux.items():
                    dst = self.aux_dict[name].tensor
                    if value is not dst:
                        dst.copy_(value)
        self.outputs = [NDArray(o.detach()) for o in outs]
        return self.outputs

    def _values(self, leaves=None):
        """{name: tensor} of the bound arrays (``leaves`` in place of
        some) on the executor's device: an array placed on another
        context is copied here, differentiably."""
        values = {n: a.tensor for n, a in self.arg_dict.items()}
        values.update((n, a.tensor) for n, a in self.aux_dict.items())
        values.update(leaves or {})
        dev = self._device
        return {n: t if t.device == dev else t.to(dev)
                for n, t in values.items()}

    def _record(self, **tap):
        """A training-mode run of the graph over the bound arrays under
        torch autograd: (outputs, new aux values, {name: leaf}) for the
        arguments that take a gradient, each leaf on its argument's
        context."""
        # leaves share storage with the bound arrays: no copy
        leaves = {n: self.arg_dict[n].tensor.detach().requires_grad_(True)
                  for n in self._grad_names}
        with torch.enable_grad():
            values = self._values(leaves)
            outs, new_aux = self._prog.evaluate(values, train=True,
                                                device=self._device, **tap)
        return outs, new_aux, leaves

    def backward(self, out_grads=None, is_train=True):
        """Gradients of the last forward into ``grad_dict`` (honoring
        grad_req write/add).  ``out_grads``: head gradients, one per
        output (an NDArray, a list, None entries meaning ones); by default
        ones.  An argument the outputs do not depend on (a fixed BatchNorm
        gamma) gets a zero gradient.  After a forward that did not train,
        the forward is run again in training mode from the bound arrays
        (outputs and aux states left as they are), as the reference
        does."""
        if _tracing._recording:
            with _profiler.synced_span("executor_backward", self._device,
                                       dev=str(self._ctx)):
                return self._backward(out_grads)
        return self._backward(out_grads)

    def _backward(self, out_grads):
        if not self.outputs:
            raise MXNetError("backward() called before forward()")
        if not self._grad_names:
            return
        if self._recorded is not None:
            outs, leaves = self._recorded
        else:
            self._prog.note_kind("fwd_bwd")
            outs, _, leaves = self._record()
        if isinstance(out_grads, NDArray):
            out_grads = [out_grads]
        heads = [None] * len(outs) if out_grads is None else list(out_grads)
        if len(heads) != len(outs):
            raise MXNetError("backward: %d head gradients for %d outputs"
                             % (len(heads), len(outs)))
        ys, gs = [], []
        for o, h in zip(outs, heads):
            if not o.requires_grad:
                continue
            ys.append(o)
            gs.append(torch.ones_like(o) if h is None
                      else h.tensor.to(device=o.device, dtype=o.dtype))
        names = list(leaves)
        grads = torch.autograd.grad(ys, [leaves[n] for n in names], gs,
                                    retain_graph=True, allow_unused=True) \
            if ys else [None] * len(names)
        with torch.no_grad():
            for n, g in zip(names, grads):
                dst = self.grad_dict[n].tensor
                if g is None:
                    if self._grad_req[n] == "write":
                        dst.zero_()
                elif self._grad_req[n] == "add":
                    dst.add_(g)
                else:
                    dst.copy_(g)

    def forward_backward(self, is_train=True, out_grads=None):
        """forward(is_train) then, when training, backward(out_grads)."""
        if _tracing._recording:
            with _profiler.synced_span("executor_fwd_bwd", self._device,
                                       dev=str(self._ctx)):
                return self._forward_backward(is_train, out_grads)
        return self._forward_backward(is_train, out_grads)

    def _forward_backward(self, is_train, out_grads):
        self.forward(is_train=is_train)
        if is_train:
            self.backward(out_grads=out_grads)
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
        new, grads = {}, {}
        for names, shapes, table, kind in (
                (self._prog.arg_names, arg_shapes, self.arg_dict, "argument"),
                (self._prog.aux_names, aux_shapes, self.aux_dict,
                 "auxiliary state")):
            for name, shape in zip(names, shapes):
                cur = table[name]
                shape = tuple(int(d) for d in shape)
                grad = self.grad_dict.get(name)
                if cur.shape == shape:
                    new[name] = cur
                    if grad is not None:
                        grads[name] = grad
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
                if grad is not None:
                    grads[name] = nd_zeros(shape, cur.context,
                                           dtype=cur.tensor.dtype)
        return Executor(self._symbol, self._ctx,
                        {n: new[n] for n in self._prog.arg_names},
                        {n: new[n] for n in self._prog.aux_names},
                        grads, self._grad_req)

    @staticmethod
    def _simple_bind(symbol, ctx, grad_req, type_dict, shape_kwargs,
                     shared_args=None, shared_grads=None, logger=None,
                     buffer=None, placed=None):
        """``shared_args`` (arguments and aux states by name) are bound as
        given wherever their shape, dtype and context fit, and with them
        the ``shared_grads`` of the same names; then arguments of ``buffer``
        ({name: NDArray}) that fit; the rest is allocated zeroed (and
        added to ``buffer``), with a warning to ``logger`` for a shared
        name that no longer fits (its values cannot carry over).  An
        array's context is ``placed[name]`` (``group2ctx``), else
        ``ctx``."""
        placed = placed or {}
        arg_names = symbol.list_arguments()
        req = _req_table(arg_names, grad_req)
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape_kwargs)
        type_dict = dict(type_dict or {})
        arg_types, _, aux_types = symbol.infer_type(**type_dict)
        shared = shared_args or {}
        shared_grads = shared_grads or {}

        def fits(have, shape, dt, where):
            return have is not None and have.shape == shape \
                and have.tensor.dtype == dt and have.context == where

        def alloc(names, shapes, types, kind, pool=None):
            out = {}
            for name, shape, dt in zip(names, shapes, types):
                shape = tuple(int(d) for d in shape)
                dt = torch_dtype(type_dict.get(name, dt or "float32"))
                where = placed.get(name, ctx)
                have = shared.get(name)
                if fits(have, shape, dt, where):
                    out[name] = have
                    continue
                if have is not None and logger is not None:
                    # loud: it usually means a mis-specified bucket
                    logger.warning(
                        "%s %r changed from %s %s to %s %s across the "
                        "shared bind; reallocating it ZEROED (its values "
                        "cannot carry over)", kind, name, have.shape,
                        dtype_name(have.tensor.dtype), shape,
                        dtype_name(dt))
                if pool is not None and have is None \
                        and fits(pool.get(name), shape, dt, where):
                    out[name] = pool[name]
                    continue
                out[name] = nd_zeros(shape, where, dtype=dt)
                if pool is not None and have is None:
                    pool[name] = out[name]
            return out

        args = alloc(arg_names, arg_shapes, arg_types, "parameter", buffer)
        grads = {}
        for name, arr in args.items():
            if req[name] == "null":
                continue
            have = shared_grads.get(name)
            grads[name] = have if have is not None \
                and shared.get(name) is arr else \
                nd_zeros(arr.shape, arr.context, dtype=arr.tensor.dtype)
        return Executor(
            symbol, ctx, args,
            alloc(symbol.list_auxiliary_states(), aux_shapes, aux_types,
                  "auxiliary state"),
            grads, req)

    @staticmethod
    def _bind(symbol, ctx, args, args_grad, grad_req, aux_states,
              others=()):
        """An executor over the caller's own arrays (lists in argument
        order or dicts by name), on ``ctx``; an array may also lie on
        one of ``others`` (the ``group2ctx`` contexts)."""
        def table(names, given, what):
            if given is None:
                return {}
            pairs = zip(names, given) if isinstance(given, (list, tuple)) \
                else dict(given).items()
            out = {n: a for n, a in pairs if a is not None}
            for name, arr in out.items():
                if arr.context != ctx and arr.context not in others:
                    raise MXNetError("bind: %s %r is on %s, not on %s"
                                     % (what, name, arr.context,
                                        " or ".join(map(str, {ctx}
                                                        | set(others)))))
            return out

        arg_names = symbol.list_arguments()
        arg_dict = table(arg_names, args, "argument")
        missing = [n for n in arg_names if n not in arg_dict]
        if missing:
            raise MXNetError("bind: no array for arguments %s" % missing)
        return Executor(
            symbol, ctx, {n: arg_dict[n] for n in arg_names},
            table(symbol.list_auxiliary_states(), aux_states, "aux state"),
            table(arg_names, args_grad, "gradient"), grad_req)

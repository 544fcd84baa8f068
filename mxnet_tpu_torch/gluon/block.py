"""Gluon Block and HybridBlock (ref: python/mxnet/gluon/block.py).

Counterpart of ``mxnet_tpu/gluon/block.py``.  Names come out exactly as
the JAX package's: the same ``_BlockScope`` prefix counters and one
symbol ``NameManager`` per scope, so one ``{name: array}`` dict keys the
parameters of both packages' nets and an exported graph is the same JSON.

A Block runs eagerly through the imperative ops (``mx.nd``), recorded by
torch autograd inside ``autograd.record()``.  ``hybridize()`` makes a
HybridBlock trace its ``hybrid_forward`` once into a Symbol and run that
graph's plan (``executor._Program``, cached by ``executor_cache``) — the
CachedOp.  A :class:`SymbolBlock` runs a given Symbol (an exported graph)
through the same plan, its arguments and auxiliary states registered as
Parameters.  The plan runs on the Parameters' own tensors, which are the
torch leaves ``autograd`` differentiates, with grad mode on while
recording; so a hybridized forward sits in the same torch graph as the
loss after it, and its gradients are the imperative run's.
"""
from __future__ import annotations

import copy
import re
import threading

import torch

from ..ndarray import NDArray
from .. import ndarray as nd_mod
from .. import symbol as sym_mod
from .. import autograd
from .. import executor_cache
from ..symbol import Symbol
from .parameter import (DeferredInitializationError, Parameter,
                        ParameterDict, forward_position, run_at_position)
from .utils import _indent


class _BlockScope:
    """Name scoping for Blocks (ref: block.py:35)."""

    _current = threading.local()

    def __init__(self, block):
        self._block = block
        self._counter = {}
        self._old_scope = None
        self._name_scope = None

    @staticmethod
    def create(prefix, params, hint):
        current = getattr(_BlockScope._current, "value", None)
        if current is None:
            if prefix is None:
                prefix = sym_mod.NameManager.current().get(None, hint) + "_"
            if params is None:
                params = ParameterDict(prefix)
            else:
                params = ParameterDict(params.prefix, params)
            return prefix, params
        if prefix is None:
            count = current._counter.get(hint, 0)
            prefix = "%s%d_" % (hint, count)
            current._counter[hint] = count + 1
        if params is None:
            parent = current._block.params
            params = ParameterDict(parent.prefix + prefix, parent._shared)
        else:
            params = ParameterDict(params.prefix, params)
        return current._block.prefix + prefix, params

    def __enter__(self):
        if self._block._empty_prefix:
            return self
        self._old_scope = getattr(_BlockScope._current, "value", None)
        _BlockScope._current.value = self
        self._name_scope = sym_mod.NameManager()
        self._name_scope.__enter__()
        return self

    def __exit__(self, ptype, value, trace):
        if self._block._empty_prefix:
            return
        self._name_scope.__exit__(ptype, value, trace)
        self._name_scope = None
        _BlockScope._current.value = self._old_scope


def _flatten(args):
    if isinstance(args, (NDArray, Symbol)):
        return [args], 0
    if args is None:
        return [None], None
    if not isinstance(args, (list, tuple)):
        raise TypeError("HybridBlock input must be (nested) list of Symbol "
                        "or NDArray, but got %s of type %s"
                        % (args, type(args)))
    flat, fmts = [], []
    for i in args:
        arg, fmt = _flatten(i)
        flat.extend(arg)
        fmts.append(fmt)
    return flat, fmts


def _regroup(args, fmt):
    if isinstance(fmt, int):
        if fmt == 0:
            return args[0], args[1:]
        return args[:fmt], args[fmt:]
    if fmt is None:
        return None, args[1:]
    ret = []
    for i in fmt:
        res, args = _regroup(args, i)
        ret.append(res)
    return ret, args


class Block:
    """Base class for all neural network layers and models (ref:
    block.py:122)."""

    def __init__(self, prefix=None, params=None):
        self._empty_prefix = prefix == ""
        self._prefix, self._params = _BlockScope.create(
            prefix, params, self._alias())
        self._name = self._prefix[:-1] if self._prefix.endswith("_") \
            else self._prefix
        self._scope = _BlockScope(self)
        self._children = []
        self._reg_params = {}

    def __repr__(self):
        modstr = "\n".join(
            "  ({key}): {block}".format(key=key, block=_indent(str(block), 2))
            for key, block in self.__dict__.items()
            if isinstance(block, Block))
        return "{name}(\n{modstr}\n)".format(name=type(self).__name__,
                                             modstr=modstr)

    def __setattr__(self, name, value):
        if hasattr(self, name):
            existing = getattr(self, name)
            if isinstance(existing, (Parameter, Block)) and \
                    not isinstance(value, type(existing)):
                raise TypeError(
                    "Changing attribute type for {name} from {type1} to "
                    "{type2} is not allowed.".format(
                        name=name, type1=type(existing), type2=type(value)))
            if isinstance(existing, Block):
                for i, c in enumerate(self._children):
                    if c is existing:
                        self._children[i] = value
            elif isinstance(value, Block):
                self.register_child(value)
        elif isinstance(value, Block):
            self.register_child(value)
        if isinstance(value, Parameter):
            if self._reg_params.get(name, value) is not value:
                raise AssertionError("Overriding Parameter attribute %s is "
                                     "not allowed." % name)
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def _alias(self):
        return type(self).__name__.lower()

    @property
    def prefix(self):
        return self._prefix

    @property
    def name(self):
        return self._name

    def name_scope(self):
        return self._scope

    @property
    def params(self):
        return self._params

    def collect_params(self, select=None):
        ret = ParameterDict(self._params.prefix)
        if not select:
            ret.update(self.params)
        else:
            pattern = re.compile(select)
            ret.update({name: value for name, value in self.params.items()
                        if pattern.match(name)})
        for cld in self._children:
            ret.update(cld.collect_params(select=select))
        return ret

    def save_params(self, filename):
        self.collect_params().save(filename, strip_prefix=self.prefix)

    def load_params(self, filename, ctx=None, allow_missing=False,
                    ignore_extra=False):
        self.collect_params().load(filename, ctx, allow_missing, ignore_extra,
                                   self.prefix)

    save_parameters = save_params
    load_parameters = load_params

    def register_child(self, block):
        self._children.append(block)

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        self.collect_params().initialize(init, ctx, verbose, force_reinit)

    def hybridize(self, active=True, **kwargs):
        for cld in self._children:
            cld.hybridize(active, **kwargs)

    def cast(self, dtype):
        """Cast this block's and its children's Parameters to ``dtype``."""
        for child in self._children:
            child.cast(dtype)
        for _, param in self.params.items():
            param.cast(dtype)

    def __call__(self, *args):
        position = forward_position(args)
        if position is None:
            return self.forward(*args)
        return run_at_position(position, self.forward, *args)

    def forward(self, *args):
        raise NotImplementedError


class HybridBlock(Block):
    """A Block that can be traced into one Symbol graph (ref:
    block.py:375)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._active = False
        self._cached_graph = ()
        self._cached_plans = {}

    def __setattr__(self, name, value):
        super().__setattr__(name, value)
        if isinstance(value, HybridBlock):
            self._clear_cached_op()

    def register_child(self, block):
        if not isinstance(block, HybridBlock):
            raise ValueError(
                "Children of HybridBlock must also be HybridBlock, but %s has "
                "type %s." % (block, type(block)))
        super().register_child(block)
        self._clear_cached_op()

    def hybridize(self, active=True, **kwargs):
        self._active = active
        self._clear_cached_op()
        super().hybridize(active, **kwargs)

    def cast(self, dtype):
        self._clear_cached_op()
        super().cast(dtype)

    def _clear_cached_op(self):
        self._cached_graph = ()
        self._cached_plans = {}

    def _get_graph(self, *args):
        if not self._cached_graph:
            flat_args, self._in_format = _flatten(args)
            inputs = [sym_mod.var("data%d" % i) if len(flat_args) > 1
                      else sym_mod.var("data") for i in range(len(flat_args))]
            grouped_inputs, _ = _regroup(inputs, self._in_format)
            if not isinstance(grouped_inputs, (list, tuple)):
                grouped_inputs = [grouped_inputs]
            params = {i: j.var() for i, j in self._reg_params.items()}
            with self.name_scope():
                out = self.hybrid_forward(sym_mod, *grouped_inputs, **params)
            out, self._out_format = _flatten(out)
            self._cached_graph = inputs, sym_mod.Group(out)
        return self._cached_graph

    def infer_shape(self, *args):
        """Infer (and set) parameter shapes from input shapes."""
        inputs, out = self._get_graph(*args)
        flat_args, _ = _flatten(args)
        shape_kwargs = {i.name: j.shape for i, j in zip(inputs, flat_args)}
        arg_shapes, _, aux_shapes = out.infer_shape_partial(**shape_kwargs)
        sdict = dict(zip(out.list_arguments(), arg_shapes))
        sdict.update(zip(out.list_auxiliary_states(), aux_shapes))
        for name, param in self.collect_params().items():
            if sdict.get(name) is not None:
                param.shape = sdict[name]

    def _deferred_infer_shape(self, *args):
        try:
            self.infer_shape(*args)
        except Exception as e:
            raise ValueError("Deferred initialization failed because shape "
                             "cannot be inferred: " + str(e))

    def _finish_deferred(self, *args):
        self._deferred_infer_shape(*args)
        for _, param in self.collect_params().items():
            param._finish_deferred_init()

    def _call_cached_op(self, *args):
        """Run the traced graph's plan on the Parameters' own tensors (the
        CachedOp).  While recording, torch records the plan's ops, so the
        Parameters' leaves get gradients from whatever loss follows."""
        inputs, out = self._get_graph(*args)
        flat_args, _ = _flatten(args)
        ctx = flat_args[0].context
        key = (ctx,) + tuple((a.shape, str(a.tensor.dtype))
                             for a in flat_args)
        plan = self._cached_plans.get(key)
        if plan is None:
            params = dict(self.collect_params().items())
            input_names = [i.name for i in inputs]
            arg_names = out.list_arguments()
            aux_names = out.list_auxiliary_states()
            bound = [(n, params[n]) for n in arg_names + aux_names
                     if n in params]
            arg_dict = dict(zip(input_names, flat_args))
            arg_dict.update((n, p.data(ctx)) for n, p in bound
                            if n in arg_names)
            aux_dict = {n: p.data(ctx) for n, p in bound if n in aux_names}
            grads = tuple(n for n, p in bound if p.grad_req != "null")
            prog = executor_cache.get_program(out, arg_dict, aux_dict,
                                              ctx.torch_device(), grads,
                                              health=False)
            plan = (prog, input_names, bound, set(aux_names))
            self._cached_plans[key] = plan
        prog, input_names, bound, aux_names = plan
        values = {n: a.tensor for n, a in zip(input_names, flat_args)}
        # read each Parameter's current tensor: set_data, load_params and
        # mark_variables rebind or refill them between calls
        values.update((n, p.data(ctx).tensor) for n, p in bound)
        train = autograd.is_training()
        with torch.set_grad_enabled(autograd.is_recording()):
            outs, new_aux = prog.evaluate(values, train=train)
        if train and new_aux:
            with torch.no_grad():
                for name, value in new_aux.items():
                    if name in aux_names and value is not values[name]:
                        values[name].copy_(value)
        ret, _ = _regroup([NDArray(o) for o in outs], self._out_format)
        return ret

    def forward(self, x, *args):
        """Dispatch ``hybrid_forward`` on NDArrays (imperatively, or
        through the cached graph once hybridized) or on Symbols."""
        if isinstance(x, NDArray):
            if self._active:
                try:
                    return self._call_cached_op(x, *args)
                except DeferredInitializationError:
                    self._finish_deferred(x, *args)
                    return self._call_cached_op(x, *args)
            try:
                params = {i: j.data(x.context)
                          for i, j in self._reg_params.items()}
            except DeferredInitializationError:
                self._finish_deferred(x, *args)
                params = {i: j.data(x.context)
                          for i, j in self._reg_params.items()}
            return self.hybrid_forward(nd_mod, x, *args, **params)
        if not isinstance(x, Symbol):
            raise TypeError("HybridBlock requires the first argument to "
                            "forward be either Symbol or NDArray, but got %s"
                            % type(x))
        params = {i: j.var() for i, j in self._reg_params.items()}
        with self.name_scope():
            return self.hybrid_forward(sym_mod, x, *args, **params)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError

    def export(self, path, epoch=0):
        """Write ``path-symbol.json`` and ``path-%04d.params`` (the deploy
        format the Predictor and Module read, in either package)."""
        if not self._cached_graph:
            raise RuntimeError(
                "Please first call block.hybridize() and then run forward "
                "with this block at least once before calling export.")
        sym = self._cached_graph[1]
        sym.save("%s-symbol.json" % path)
        arg_names = set(sym.list_arguments())
        aux_names = set(sym.list_auxiliary_states())
        arg_dict = {}
        for name, param in self.collect_params().items():
            if name in arg_names:
                arg_dict["arg:%s" % name] = param._reduce()
            elif name in aux_names:
                arg_dict["aux:%s" % name] = param._reduce()
        nd_mod.save("%s-%04d.params" % (path, epoch), arg_dict)


class SymbolBlock(HybridBlock):
    """A Block over a given Symbol (ref: block.py:598), such as a graph
    that ``export`` wrote: every argument that is not an input becomes a
    Parameter, every auxiliary state one with ``grad_req='null'``, all
    named as in the graph, and a call runs the graph's plan (the
    CachedOp of a hybridized block)."""

    def __init__(self, outputs, inputs, params=None):
        super().__init__(prefix=None, params=params)
        self._prefix = ""
        self._params = ParameterDict("", params)
        if isinstance(inputs, Symbol) and len(inputs.list_outputs()) == 1:
            inputs = [inputs]
        if isinstance(outputs, (list, tuple)) and len(outputs) == 1:
            outputs = outputs[0]
        if isinstance(outputs, (list, tuple)):
            outputs = sym_mod.Group(outputs)
        syms, self._in_format = _flatten(inputs)
        _, self._out_format = _flatten(outputs)
        input_names = {i.name for i in syms}
        for i in outputs.list_arguments():
            if i not in input_names:
                self.params.get(i, allow_deferred_init=True)
        for i in outputs.list_auxiliary_states():
            if i not in input_names:
                self.params.get(i, grad_req="null", allow_deferred_init=True)
        self._cached_graph = syms, outputs
        prefix = _common_prefix(list(self._params.keys()))
        self._reg_params = {k[len(prefix):]: v
                            for k, v in self._params.items()}
        self._prefix = prefix

    def forward(self, x, *args):
        if isinstance(x, NDArray):
            try:
                return self._call_cached_op(x, *args)
            except DeferredInitializationError:
                self._finish_deferred(x, *args)
                return self._call_cached_op(x, *args)
        if not isinstance(x, Symbol):
            raise TypeError("SymbolBlock takes NDArray or Symbol inputs, "
                            "got %s" % type(x))
        return copy.copy(self._cached_graph[1])

    def _clear_cached_op(self):
        # the graph is the block itself: only the plans are dropped
        self._cached_plans = {}

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _common_prefix(names):
    """The longest string every name starts with."""
    if not names:
        return ""
    prefix = names[0]
    for name in names:
        i = 0
        while i < len(prefix) and i < len(name) and prefix[i] == name[i]:
            i += 1
        prefix = prefix[:i]
    return prefix

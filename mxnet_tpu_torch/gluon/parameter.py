"""Gluon Parameter, Constant and ParameterDict.

Counterpart of ``mxnet_tpu/gluon/parameter.py``, with its design: each
Parameter owns a list of per-context slots ``[context, data, grad]``, and
deferred initialization is one pending record consumed either by the
first forward (shape now known) or by loading saved values.  Data and
gradient are NDArrays over torch tensors; the data tensor is a torch leaf
that requires grad unless ``grad_req`` is ``'null'`` (``autograd.
mark_variables``), so a recorded forward reaches it.
"""
from __future__ import annotations

import threading
import warnings
import weakref
from collections import OrderedDict, namedtuple

import numpy as np

from ..base import MXNetError, np_dtype
from ..context import Context, cpu, current_context
from ..ndarray import NDArray, array as nd_array, zeros as nd_zeros
from .. import autograd
from .. import initializer as init_mod
from ..initializer import InitDesc


class DeferredInitializationError(MXNetError):
    """Raised when a deferred Parameter is touched before its first forward."""


# A deferred-init record: which initializer to run, on which contexts,
# which fallback to use when ``init`` is None, and an optional concrete
# payload (set when values were loaded before the shape was known).
_Pending = namedtuple("_Pending", ["init", "contexts", "fallback", "payload"])

_GRAD_REQS = ("write", "add", "null")

# -- the replica a forward pass runs for -----------------------------------
# Contexts of one list may share a device: ``[gpu(0)] * 2`` on one card, or
# host contexts, which are all the one host device.  ``split_and_load``
# records each slice's position in its context list; a top-level Block
# called with such a slice runs with that position, and a Parameter takes
# the slot at it when that slot's device is the one asked for.
_SLICES = {}                  # id(slice) -> (weak reference, position)
_FORWARD = threading.local()  # .position while such a forward runs


def mark_slice(array, position):
    """Record ``array`` as the slice of context ``position``."""
    key = id(array)
    _SLICES[key] = (weakref.ref(array, lambda _: _SLICES.pop(key, None)),
                    position)


def forward_position(args):
    """The position of the slice a top-level forward is called with (its
    first argument), or None: inside a forward, or for another array."""
    if getattr(_FORWARD, "position", None) is not None or not args:
        return None
    entry = _SLICES.get(id(args[0]))
    return entry[1] if entry is not None and entry[0]() is args[0] else None


def run_at_position(position, fn, *args):
    """``fn(*args)`` with Parameters reading the slots at ``position``."""
    _FORWARD.position = position
    try:
        return fn(*args)
    finally:
        _FORWARD.position = None


def _same_device(a, b):
    return (a.device_typeid == 2) == (b.device_typeid == 2) and (
        a.device_typeid != 2 or a.device_id == b.device_id)


def _as_context_list(ctx):
    if ctx is None:
        return None
    if isinstance(ctx, Context):
        return [ctx]
    return list(ctx)


def _shapes_compatible(want, have):
    """Merge two shapes where 0 is a wildcard; None if they conflict."""
    if want is None:
        return tuple(have)
    if len(want) != len(have):
        return None
    merged = []
    for w, h in zip(want, have):
        if w and h and w != h:
            return None
        merged.append(w or h)
    return tuple(merged)


class Parameter:
    """One logical tensor, replicated across one or more contexts.

    ``grad_req`` chooses gradient bookkeeping: 'write' (fresh each
    backward), 'add' (accumulate; caller zero_grads), 'null' (no grad).
    """

    def __init__(self, name, grad_req="write", shape=None, dtype=np.float32,
                 lr_mult=1.0, wd_mult=1.0, init=None,
                 allow_deferred_init=False, differentiable=True,
                 stype="default", grad_stype="default"):
        self.name = name
        self._slots = None          # list of [ctx, data, grad] after init
        self._pending = None        # _Pending while deferred
        self._var = None
        self._allow_deferred_init = allow_deferred_init
        self._differentiable = differentiable
        self._grad_req = None
        self.shape = (shape,) if isinstance(shape, int) else shape
        self.dtype = dtype
        self.lr_mult = lr_mult
        self.wd_mult = wd_mult
        self.grad_req = grad_req
        if isinstance(init, str):
            init = init_mod.create(init)
        self.init = init

    def __repr__(self):
        return "Parameter {} (shape={}, dtype={})".format(
            self.name, self.shape, self.dtype)

    # -- grad_req --------------------------------------------------------
    @property
    def grad_req(self):
        return self._grad_req

    @grad_req.setter
    def grad_req(self, req):
        if req not in _GRAD_REQS:
            raise AssertionError(
                "grad_req must be one of %s, but got %s" % (_GRAD_REQS, req))
        if not self._differentiable:
            req = "null"
        if req == self._grad_req:
            return
        self._grad_req = req
        if self._slots is None:
            return
        if req == "null":
            for slot in self._slots:
                slot[2] = None
                autograd.mark_variables([slot[1]], [None], "null")
        else:
            self._attach_grads()

    def _finish_deferred_init(self):
        self._materialize()

    # -- initialization --------------------------------------------------
    def initialize(self, init=None, ctx=None, default_init=None,
                   force_reinit=False):
        if default_init is None:
            default_init = init_mod.Uniform()
        if self._slots is not None and not force_reinit:
            warnings.warn(
                "Parameter %s is already initialized, ignoring. "
                "Set force_reinit=True to re-initialize." % self.name,
                stacklevel=2)
            return
        if not self._shape_known() and not self._allow_deferred_init:
            raise ValueError(
                "Parameter %s has unknown shape %s and deferred init is "
                "not allowed; pass the shape or run a forward first"
                % (self.name, (self.shape,)))
        self._slots = None
        contexts = _as_context_list(ctx) or [current_context()]
        # an explicit choice (call-level or param-level) applies as the
        # weight rule; the fallback goes through name-suffix dispatch so
        # gamma/beta/running stats land on their canonical constants
        explicit = init if init is not None else self.init
        self._pending = _Pending(explicit, contexts, default_init, None)
        if self._shape_known():
            self._materialize()

    def _shape_known(self):
        return self.shape is not None and int(np.prod(self.shape)) > 0

    def _materialize(self):
        """Consume the pending record: build data and grads on every ctx."""
        if self._pending is None:
            return
        pending, self._pending = self._pending, None
        if not self._shape_known():
            raise AssertionError(
                "Parameter %s still has unknown shape %s at materialize "
                "time" % (self.name, (self.shape,)))
        with autograd.pause():
            payload = pending.payload
            if payload is None:
                payload = nd_zeros(self.shape, ctx=cpu(), dtype=self.dtype)
                explicit = pending.init
                desc = InitDesc(self.name, {"__init__": ""})
                if explicit is None:
                    pending.fallback(desc, payload)
                elif isinstance(explicit, init_mod.Initializer):
                    explicit._init_weight(desc, payload)
                else:  # a callable routing by name
                    explicit(self.name, payload)
            self._place(payload, pending.contexts)

    def _place(self, value, contexts):
        """Copy ``value`` onto ``contexts`` and attach gradients."""
        if not isinstance(value, NDArray):
            value = nd_array(value, dtype=self.dtype)
        self.shape = tuple(value.shape)
        self._slots = [[ctx, value.copyto(ctx), None] for ctx in contexts]
        self._attach_grads()

    def _attach_grads(self):
        if self.grad_req == "null":
            return
        for slot in self._slots:
            grad = nd_zeros(self.shape, ctx=slot[0],
                            dtype=slot[1].tensor.dtype)
            slot[2] = grad
            autograd.mark_variables([slot[1]], [grad], self.grad_req)

    def _load_init(self, data, ctx):
        """Fill from a loaded array, validating shape/ctx agreement."""
        if self.shape and _shapes_compatible(self.shape, data.shape) is None:
            raise AssertionError(
                "loaded value for Parameter %s has shape %s but %s is "
                "required" % (self.name, data.shape, (self.shape,)))
        if self.dtype is not None and \
                np_dtype(data.dtype) != np_dtype(self.dtype):
            data = data.astype(self.dtype)
        contexts = _as_context_list(ctx)
        if self._slots is not None:
            if contexts is not None and \
                    set(contexts) != set(self.list_ctx()):
                raise AssertionError(
                    "cannot load Parameter %s on %s: it already lives on %s"
                    % (self.name, contexts, self.list_ctx()))
            self.set_data(data)
        else:
            if self._pending:
                if contexts is not None and \
                        set(contexts) != set(self._pending.contexts):
                    raise AssertionError(
                        "cannot load Parameter %s on %s: it already lives "
                        "on %s" % (self.name, contexts, self.list_ctx()))
                contexts = self._pending.contexts
            self._place(data, contexts or [current_context()])
        self._pending = None

    # -- accessors -------------------------------------------------------
    def _slot_for(self, ctx):
        if self._slots is None:
            if self._pending is not None:
                raise DeferredInitializationError(
                    "Parameter %s awaits deferred initialization; it gets "
                    "a shape (and values) on the first forward pass"
                    % self.name)
            raise RuntimeError(
                "Parameter %s has not been initialized. Initialize via "
                "Block.collect_params().initialize(...) — note that "
                "Block.params alone omits the children's parameters"
                % self.name)
        if ctx is None:
            if len(self._slots) == 1:
                return self._slots[0]
            ctx = current_context()
        position = getattr(_FORWARD, "position", None)
        if position is not None and position < len(self._slots) \
                and _same_device(self._slots[position][0], ctx):
            return self._slots[position]
        for slot in self._slots:
            if slot[0] == ctx:
                return slot
        raise RuntimeError(
            "Parameter %s was not initialized on context %s. "
            "It was only initialized on %s."
            % (self.name, ctx, self.list_ctx()))

    def _require_grad(self):
        if self._slots is not None and self.grad_req == "null":
            raise RuntimeError(
                "Parameter %s carries no gradient because grad_req='null'"
                % self.name)

    def data(self, ctx=None):
        return self._slot_for(ctx)[1]

    def grad(self, ctx=None):
        self._require_grad()
        return self._slot_for(ctx)[2]

    def list_data(self):
        if self._slots is None:
            self._slot_for(None)  # raises the initialization error
        return [slot[1] for slot in self._slots]

    def list_grad(self):
        self._require_grad()
        if self._slots is None:
            self._slot_for(None)  # raises the initialization error
        return [slot[2] for slot in self._slots]

    def list_ctx(self):
        if self._slots is None:
            if self._pending is not None:
                return self._pending.contexts
            raise RuntimeError(
                "Parameter %s has not been initialized" % self.name)
        return [slot[0] for slot in self._slots]

    # -- mutation --------------------------------------------------------
    def set_data(self, data):
        """Write ``data`` into every replica, in place."""
        if self._slots is None:
            raise AssertionError(
                "Parameter %s has not been initialized" % self.name)
        for slot in self._slots:
            if isinstance(data, NDArray):
                data.copyto(slot[1])
            else:
                slot[1][:] = data

    def zero_grad(self):
        if self._slots is None:
            return
        for slot in self._slots:
            if slot[2] is not None:
                slot[2][:] = 0

    def reset_ctx(self, ctx):
        """Move the Parameter (its replicas' mean) to ``ctx``, or change
        the contexts a deferred initialization will use."""
        contexts = _as_context_list(ctx) or [current_context()]
        if self._slots is not None:
            merged = self._reduce()
            with autograd.pause():
                self._place(merged, contexts)
        elif self._pending is not None:
            self._pending = self._pending._replace(contexts=contexts)
        else:
            raise ValueError(
                "Parameter %s cannot move to a new context before it is "
                "initialized" % self.name)

    def cast(self, dtype):
        """Convert the data (and so the gradient) to ``dtype``."""
        self.dtype = dtype
        self._var = None
        if self._slots is None:
            return
        with autograd.pause():
            for slot in self._slots:
                slot[1] = slot[1].astype(dtype)
                slot[2] = None
            self._attach_grads()

    def _reduce(self):
        """Mean of all replicas, on cpu (the checkpoint representation)."""
        replicas = self.list_data()
        total = replicas[0].copyto(cpu())
        for other in replicas[1:]:
            total += other.copyto(cpu())
        return total / len(replicas) if len(replicas) > 1 else total

    def var(self):
        if self._var is None:
            from .. import symbol
            self._var = symbol.var(
                self.name, shape=self.shape, dtype=self.dtype,
                lr_mult=self.lr_mult, wd_mult=self.wd_mult, init=self.init)
        return self._var


class Constant(Parameter):
    """A non-trainable Parameter pinned to a fixed value."""

    def __init__(self, name, value):
        if not isinstance(value, NDArray):
            value = nd_array(value, ctx=cpu())
        self.value = value

        class _Pinned(init_mod.Initializer):
            def _init_weight(self, _, arr):
                value.copyto(arr)

        super().__init__(name, grad_req="null", shape=value.shape,
                         dtype=value.dtype, init=_Pinned())


class ParameterDict:
    """Ordered name -> Parameter mapping with prefix and sharing semantics."""

    def __init__(self, prefix="", shared=None):
        self._prefix = prefix
        self._params = OrderedDict()
        self._shared = shared

    # -- mapping protocol ------------------------------------------------
    def __getitem__(self, key):
        return self._params[key]

    def __iter__(self):
        return iter(self._params)

    def __repr__(self):
        head = self._prefix + " " if self._prefix else ""
        body = "\n".join(repr(p).replace("\n", "\n  ")
                         for p in self.values())
        return "{}(\n{}\n)".format(head, body)

    def items(self):
        return self._params.items()

    def keys(self):
        return self._params.keys()

    def values(self):
        return self._params.values()

    @property
    def prefix(self):
        return self._prefix

    # -- retrieval / creation --------------------------------------------
    def _lookup(self, name):
        """Find locally, then adopt from the shared dict."""
        found = self._params.get(name)
        if found is None and self._shared is not None:
            found = self._shared._params.get(name)
            if found is not None:
                self._params[name] = found
        return found

    def get(self, name, **kwargs):
        """Get-or-create, reconciling attributes with any existing entry."""
        name = self._prefix + name
        param = self._lookup(name)
        if param is None:
            param = Parameter(name, **kwargs)
            self._params[name] = param
            return param
        for attr, want in kwargs.items():
            have = getattr(param, attr, None)
            if have is None:
                setattr(param, attr, want)
                continue
            if attr == "shape" and want is not None:
                merged = _shapes_compatible(tuple(want), have)
                if merged is not None:
                    param.shape = merged
                    continue
            if want is not None and want != have:
                raise AssertionError(
                    "Parameter %s already exists with %s=%s; cannot "
                    "re-get it with %s=%s"
                    % (name, attr, have, attr, want))
        return param

    def get_constant(self, name, value=None):
        name = self._prefix + name
        param = self._lookup(name)
        if param is None:
            if value is None:
                raise KeyError("No constant named %s." % name)
            param = Constant(name, value)
            self._params[name] = param
        return param

    def update(self, other):
        for name, param in other.items():
            mine = self._params.get(name)
            if mine is not None and mine is not param:
                raise AssertionError(
                    "cannot merge ParameterDicts: both hold a distinct "
                    "Parameter named %s" % name)
            self._params[name] = param

    # -- bulk operations -------------------------------------------------
    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False):
        if init is None:
            init = init_mod.Uniform()
        if verbose:
            init.set_verbosity(verbose=verbose)
        for param in self.values():
            param.initialize(None, ctx, init, force_reinit=force_reinit)

    def zero_grad(self):
        for param in self.values():
            param.zero_grad()

    def reset_ctx(self, ctx):
        for param in self.values():
            param.reset_ctx(ctx)

    def setattr(self, name, value):
        """Set attribute ``name`` (``grad_req``, ``lr_mult``, ...) of every
        Parameter."""
        for param in self.values():
            setattr(param, name, value)

    # -- persistence -----------------------------------------------------
    def save(self, filename, strip_prefix=""):
        from ..ndarray import save as nd_save
        out = {}
        for param in self.values():
            if not param.name.startswith(strip_prefix):
                raise ValueError(
                    "cannot strip prefix %r: Parameter %s does not carry it"
                    % (strip_prefix, param.name))
            out[param.name[len(strip_prefix):]] = param._reduce()
        nd_save(filename, out)

    def load(self, filename, ctx=None, allow_missing=False,
             ignore_extra=False, restore_prefix=""):
        from ..ndarray import load as nd_load
        if restore_prefix:
            for name in self.keys():
                if not name.startswith(restore_prefix):
                    raise AssertionError(
                        "restore_prefix is %r but Parameter %s does not "
                        "start with it" % (restore_prefix, name))
        # an export's names carry "arg:"/"aux:" (MXNet's loader strips them)
        loaded = {restore_prefix + (k[4:] if k.startswith(("arg:", "aux:"))
                                    else k): v
                  for k, v in nd_load(filename).items()}
        if not allow_missing:
            absent = [n for n in self.keys() if n not in loaded]
            if absent:
                raise AssertionError(
                    "file %s is missing parameters %s (pass "
                    "allow_missing=True to skip them)" % (filename, absent))
        for name, value in loaded.items():
            if name not in self._params:
                if not ignore_extra:
                    raise AssertionError(
                        "file %s contains %s which this ParameterDict does "
                        "not hold (pass ignore_extra=True to drop it)"
                        % (filename, name))
                continue
            self._params[name]._load_init(value, ctx)

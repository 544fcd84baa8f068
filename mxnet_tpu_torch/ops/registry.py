"""Operator registry.

Counterpart of ``mxnet_tpu/ops/registry.py``.  Every op is a plain
function on ``torch.Tensor``s plus its typed attr table and, where the op
declares one, a shape and a type rule.  Where an op has no shape rule,
:func:`eval_shape_op` runs it on ``device="meta"`` tensors, which carry a
shape and a dtype but no storage — the role ``jax.eval_shape`` plays in
the JAX package.
"""
from __future__ import annotations

import torch

from ..base import MXNetError, dtype_name, shape_attr, str_to_attr, torch_dtype

# ---------------------------------------------------------------------------
# Attr type converters (dmlc::Parameter reflection)
# ---------------------------------------------------------------------------


def pShape(v):
    return shape_attr(v)


def pShapeN(v):
    """A shape whose elements may be None (``slice``'s begin/end/step:
    None means from the start, to the end, step 1)."""
    v = str_to_attr(v)
    if v is None:
        return None
    if isinstance(v, int):
        return (v,)
    return tuple(None if e is None else int(e) for e in v)


def pInt(v):
    return int(str_to_attr(v))


def pFloat(v):
    return float(str_to_attr(v))


def pBool(v):
    return bool(str_to_attr(v))


def pStr(v):
    return str(v)


def pAny(v):
    return str_to_attr(v)


def pDtype(v):
    return dtype_name(v) if v is not None else None


class Op:
    """A registered operator.

    impl: (*tensors, **attrs) -> tensor | tuple of tensors.
    params: {attr_name: (converter, default)}; attrs not listed are rejected.
    num_inputs: an int, or a function of the normalized attrs.
    infer_shape: optional fn(in_shapes, attrs[, out_shapes]) ->
        (filled in_shapes, out_shapes), able to fill unknown (None) input
        shapes from known ones — how MXNet infers weight shapes from data.
    bidirectional_infer: infer_shape also takes the current output shapes.
    infer_type: optional fn(in_dtypes, attrs) -> (filled, out_dtypes).
    num_outputs: an int, or a function of the normalized attrs — the
        visible outputs (symbol entries).
    mutate_map: input indices rebound by the impl's trailing outputs
        beyond the visible ones — in-place state updates such as
        BatchNorm's moving statistics (ref: FMutateInputs); the executor
        writes them back into the aux arrays under ``is_train``.
    takes_train_flag: the impl takes a ``_train`` kwarg distinguishing
        train and predict mode.
    takes_device: the impl has no tensor input and takes the device to
        create its output on as a ``_device`` kwarg (the init ops and the
        zero-input samplers).
    needs_rng: the impl draws from its device's generator
        (``random.generator``); the fused step refuses a graph with such
        an op where torch cannot register that generator with a CUDA
        graph (a replay would repeat its draws).
    key_var_num_args: the attr that counts a variadic op's inputs
        (``num_args`` of ``Concat``, ``stack``, ``add_n``); when a node or
        call leaves it unset, it is filled from the number of inputs.
    sparse_impl: optional fn(input NDArrays, normalized attrs) -> outputs
        (tensors or NDArrays, sparse ones included), run when any input
        is sparse and the inputs' storage types match ``sparse_pattern``
        (ref: FComputeEx); it may return ``NotImplemented`` to decline
        (``lazy_update=False``), and ops without one densify read-only
        sparse inputs (the storage fallback).
    sparse_pattern: the input storage types ``sparse_impl`` takes, e.g.
        ``("default", "row_sparse")``; None when it checks them itself.
    aliases: further names the op is registered under.
    """

    def __init__(self, name, impl, params=None, num_inputs=None, num_outputs=1,
                 infer_shape=None, infer_type=None, input_names=None,
                 aux_names=(), bidirectional_infer=False, mutate_map=(),
                 takes_train_flag=False, takes_device=False,
                 needs_rng=False, key_var_num_args=None, sparse_impl=None,
                 sparse_pattern=None, aliases=(), doc=""):
        self.name = name
        self.impl = impl
        self.params = params or {}
        if num_inputs is None and input_names is not None:
            num_inputs = len(input_names) + len(aux_names)
        self.num_inputs = num_inputs
        self.num_outputs = num_outputs
        self.infer_shape = infer_shape
        self.infer_type = infer_type
        self.bidirectional_infer = bidirectional_infer
        self.input_names = input_names
        self.aux_names = tuple(aux_names)
        self.mutate_map = tuple(mutate_map)
        self.takes_train_flag = takes_train_flag
        self.takes_device = takes_device
        self.needs_rng = needs_rng
        self.key_var_num_args = key_var_num_args
        self.sparse_impl = sparse_impl
        self.sparse_pattern = sparse_pattern
        self.aliases = tuple(aliases)
        self.doc = doc

    def normalize_attrs(self, attrs, num_inputs=None):
        """Convert raw (possibly string) attrs into typed python values;
        ``num_inputs`` fills an unset ``key_var_num_args`` attr."""
        out = {}
        for k, v in attrs.items():
            if k in ("name", "ctx_group") \
                    or (k.startswith("__") and k.endswith("__")):
                continue
            if k not in self.params:
                raise MXNetError("%s: unknown attr %r" % (self.name, k))
            conv, _ = self.params[k]
            out[k] = conv(v) if v is not None else None
        for k, (_, default) in self.params.items():
            out.setdefault(k, default)
        key = self.key_var_num_args
        if key and num_inputs is not None and not out.get(key):
            out[key] = num_inputs
        return out

    def str_outputs(self, attrs):
        n = self.num_outputs
        return n(attrs) if callable(n) else n

    def __repr__(self):
        return "Op(%s)" % self.name


_REGISTRY = {}


def register(name, impl=None, **kwargs):
    """Register an op.  Usable as a decorator or a direct call."""

    def _do(impl_fn):
        op = Op(name, impl_fn, **kwargs)
        for key in (name,) + op.aliases:
            _REGISTRY[key] = op
        return impl_fn

    if impl is not None:
        return _do(impl)
    return _do


def get_op(name):
    op = _REGISTRY.get(name)
    if op is None:
        raise MXNetError("operator %r is not registered" % name)
    return op


def op_registry():
    return _REGISTRY


def apply_op(op, inputs, attrs):
    """Run an op's impl on tensors with normalized attrs; returns a tuple."""
    out = op.impl(*inputs, **attrs)
    return out if isinstance(out, tuple) else (out,)


def _freeze(v):
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    if isinstance(v, dict):
        return tuple(sorted((k, _freeze(x)) for k, x in v.items()))
    return v


# shape-inference memo: a pure function of (op, input shapes, input
# dtypes, attrs), run for every shape-rule-less node at every bind
_SHAPE_MEMO = {}
_SHAPE_MEMO_MAX = 8192


def eval_shape_op(op, in_shapes, in_dtypes, attrs):
    """Forward shape/dtype inference (all input shapes known) by running
    the op on meta tensors.  Returns ([out shapes], [out dtype names])."""
    key = (op, tuple(tuple(s) for s in in_shapes),
           tuple(dtype_name(d) for d in in_dtypes), _freeze(attrs))
    hit = _SHAPE_MEMO.get(key)
    if hit is None:
        metas = [torch.empty(tuple(int(d) for d in s), dtype=torch_dtype(d),
                             device="meta")
                 for s, d in zip(in_shapes, in_dtypes)]
        out = apply_op(op, metas, dict(attrs, _device=torch.device("meta"))
                       if op.takes_device else attrs)
        hit = ([tuple(o.shape) for o in out],
               [dtype_name(o.dtype) for o in out])
        if len(_SHAPE_MEMO) >= _SHAPE_MEMO_MAX:
            for stale in list(_SHAPE_MEMO)[:_SHAPE_MEMO_MAX // 2]:
                _SHAPE_MEMO.pop(stale, None)
        _SHAPE_MEMO[key] = hit
    return list(hit[0]), list(hit[1])

"""Core tensor operators.

Counterpart of part of ``mxnet_tpu/ops/tensor.py``: the elementwise
(equal-shape) and broadcast add/sub/mul/div, their scalar variants (what
NDArray and Symbol arithmetic with a number lowers to), ``abs``,
``square`` and ``negative``, ``Cast``, ``sum`` and ``mean`` with the
reference's ``axis``/``keepdims``/``exclude`` semantics, ``norm``,
``Reshape`` with MXNet's special codes, ``reshape_like``,
``expand_dims``, ``Flatten`` and ``pick``.  Op names and attrs follow the reference registry so a graph's
JSON stays the same in both packages.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError, torch_dtype
from .registry import pAny, pBool, pDtype, pFloat, pInt, pShape, register

# ---------------------------------------------------------------------------
# Elementwise binary (same-shape) and broadcast variants
# ---------------------------------------------------------------------------

_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div}


def _mk_binary(fn, elemwise=False):
    def impl(lhs, rhs):
        if elemwise and lhs.shape != rhs.shape:
            # the reference's elemwise_* ops REQUIRE equal shapes
            # (elemwise_binary_op.h); broadcasting is broadcast_*'s job
            raise MXNetError(
                "elemwise op needs equal shapes, got %s and %s — use the "
                "broadcast_* variant" % (tuple(lhs.shape), tuple(rhs.shape)))
        return fn(lhs, rhs)
    return impl


for _n, _f in _BINARY.items():
    register("elemwise_%s" % _n, _mk_binary(_f, elemwise=True), num_inputs=2,
             aliases=("_%s" % _n, "_Plus" if _n == "add" else "_%s_" % _n))
    register("broadcast_%s" % _n, _mk_binary(_f), num_inputs=2,
             aliases=("broadcast_plus" if _n == "add" else
                      "broadcast_minus" if _n == "sub" else
                      "_broadcast_%s" % _n,))

# scalar variants (ref: elemwise_binary_scalar_op*.cc); the result keeps
# the tensor's dtype, as the reference casts the scalar to it
_SCALAR_OPS = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
}


def _mk_scalar(fn):
    def impl(x, scalar=0.0):
        return fn(x, scalar).to(x.dtype)
    return impl


for _n, _f in _SCALAR_OPS.items():
    register(_n, _mk_scalar(_f), num_inputs=1,
             params={"scalar": (pFloat, 0.0)},
             aliases=("_PlusScalar",) if _n == "_plus_scalar" else ())

for _n, _f in (("abs", torch.abs), ("square", torch.square),
               ("negative", torch.neg)):
    register(_n, (lambda f: lambda x: f(x))(_f), num_inputs=1,
             aliases=("_np_" + _n,))

register("Cast", lambda x, dtype="float32": x.to(torch_dtype(dtype)),
         num_inputs=1, params={"dtype": (pDtype, "float32")},
         aliases=("cast",),
         # the output dtype is the attr, whatever the input's
         infer_type=lambda in_dts, attrs: (in_dts, [attrs["dtype"]]))

# ---------------------------------------------------------------------------
# Reductions (ref: broadcast_reduce_op*.cc; axis/keepdims/exclude)
# ---------------------------------------------------------------------------


def _norm_axis(axis, ndim, exclude=False):
    if axis is None or axis == ():
        return () if exclude else tuple(range(ndim))
    if isinstance(axis, int):
        axis = (axis,)
    ax = tuple(a % ndim for a in axis)
    if exclude:
        ax = tuple(i for i in range(ndim) if i not in ax)
    return ax


def _mk_reduce(fn):
    def impl(x, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis, x.ndim, exclude)
        if not ax:  # nothing to reduce (exclude of every axis)
            return x
        return fn(x, dim=ax, keepdim=bool(keepdims))
    return impl


_REDUCE_PARAMS = {"axis": (pShape, None), "keepdims": (pBool, False),
                  "exclude": (pBool, False)}

register("sum", _mk_reduce(torch.sum), num_inputs=1, params=_REDUCE_PARAMS,
         aliases=("sum_axis",))
register("mean", _mk_reduce(torch.mean), num_inputs=1, params=_REDUCE_PARAMS)


def _norm(x, ord=2, axis=None, keepdims=False):
    """L1/L2 norm; over the whole array the result has shape (1,), as in
    the reference."""
    ord = int(ord)
    if ord not in (1, 2):
        raise MXNetError("norm only supports ord=1 or ord=2, got %d" % ord)
    whole = axis is None or axis == ()
    ax = tuple(range(x.ndim)) if whole else _norm_axis(axis, x.ndim)
    if ord == 1:
        out = torch.sum(torch.abs(x), dim=ax, keepdim=bool(keepdims))
    else:
        out = torch.sqrt(torch.sum(torch.square(x), dim=ax,
                                   keepdim=bool(keepdims)))
    if whole and not keepdims:
        out = out.reshape((1,))
    return out


register("norm", _norm, num_inputs=1,
         params={"ord": (pInt, 2), "axis": (pShape, None),
                 "keepdims": (pBool, False)})

# ---------------------------------------------------------------------------
# Shape manipulation (ref: matrix_op-inl.h)
# ---------------------------------------------------------------------------


def _reshape_shape(data_shape, target):
    """MXNet reshape with special codes 0 (copy), -1 (infer), -2 (copy
    rest), -3 (merge two), -4 (split; followed by two dims, -1 allowed
    once)."""
    out = []
    src = list(data_shape)
    i = j = 0  # cursors into src and target
    target = list(target)
    while j < len(target):
        t = target[j]
        if t == 0:
            out.append(src[i])
            i += 1
        elif t == -1:
            # every code consumes one source dim, so a later 0 copies the
            # dim at the advanced cursor (ref: InferReshapeShape)
            out.append(-1)
            i += 1
        elif t == -2:
            out.extend(src[i:])
            i = len(src)
        elif t == -3:
            out.append(src[i] * src[i + 1])
            i += 2
        elif t == -4:
            d1, d2 = target[j + 1], target[j + 2]
            cur = src[i]
            i += 1
            if d1 == -1:
                d1 = cur // d2
            if d2 == -1:
                d2 = cur // d1
            out.extend([d1, d2])
            j += 3
            continue
        else:
            out.append(int(t))
            i += 1
        j += 1
    if -1 in out:
        known = math.prod(d for d in out if d != -1) or 1
        total = math.prod(data_shape) if data_shape else 1
        out[out.index(-1)] = total // known
    return tuple(out)


def _reshape(x, shape=None, reverse=False, target_shape=None,
             keep_highest=False):
    if shape is None and target_shape is not None:  # legacy attr
        shape = target_shape
    return torch.reshape(x, _reshape_shape(tuple(x.shape), shape))


register("Reshape", _reshape, num_inputs=1, aliases=("reshape",),
         params={"shape": (pShape, None), "reverse": (pBool, False),
                 "target_shape": (pShape, None),
                 "keep_highest": (pBool, False)})


def _reshape_like_infer_shape(in_shapes, attrs):
    lhs, rhs = in_shapes
    if lhs is not None and rhs is not None \
            and math.prod(lhs) != math.prod(rhs):
        raise MXNetError("reshape_like: lhs %s and rhs %s carry different "
                         "element counts" % (tuple(lhs), tuple(rhs)))
    return in_shapes, [tuple(rhs) if rhs is not None else None]


# rhs contributes its shape only (no gradient)
register("reshape_like", lambda lhs, rhs: torch.reshape(lhs, rhs.shape),
         num_inputs=2, infer_shape=_reshape_like_infer_shape)


register("expand_dims", lambda x, axis=0: torch.unsqueeze(x, int(axis)),
         num_inputs=1, params={"axis": (pInt, 0)})
register("Flatten", lambda x: x.reshape(x.shape[0], -1), num_inputs=1,
         aliases=("flatten",))

# ---------------------------------------------------------------------------
# Indexing
# ---------------------------------------------------------------------------


def _pick(data, index, axis=-1, keepdims=False):
    """``data`` along ``axis`` at ``index`` (the label of each position),
    as ``take_along_axis`` (ref: pick, ops/tensor.py:416)."""
    ax = int(axis) % data.ndim
    idx = torch.unsqueeze(index.to(torch.int64), ax)
    out = torch.take_along_dim(data, idx, dim=ax)
    return out if keepdims else torch.squeeze(out, ax)


register("pick", _pick, num_inputs=2,
         params={"axis": (pAny, -1), "keepdims": (pBool, False)})

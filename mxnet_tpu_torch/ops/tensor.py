"""Core tensor operators.

Counterpart of ``mxnet_tpu/ops/tensor.py``: elementwise, broadcast
and scalar arithmetic and comparisons, ``add_n``, the unary math family,
``BlockGrad``/``make_loss``/``clip``/``Cast``, the reductions (``sum`` to
``nanprod``, ``max``/``min``, ``argmax``/``argmin``, ``norm``), ``dot`` and
``batch_dot``, shape manipulation (``Reshape`` with MXNet's special codes,
``transpose``, ``slice``, ``Concat``/``stack``/``split``, ``Pad``, ...),
indexing (``take``, ``pick``, ``one_hot``, ``where``, ``gather_nd``,
``scatter_nd``), ordering (``sort``, ``argsort``, ``topk``), the init
ops and the sparse-storage ops (``cast_storage``, ``sparse_retain``,
``_square_sum``: dense in a symbol graph, sparse through ``_invoke``'s
dispatch on a sparse input).  Op names, aliases and attrs follow the reference registry so a
graph's JSON stays the same in both packages; each impl is the same
function in torch ops, differentiable by torch autograd where the JAX
op is by ``jax.vjp``.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..base import MXNetError, torch_dtype
from .registry import (pAny, pBool, pDtype, pFloat, pInt, pShape, pShapeN,
                       pStr, register)


def _scalar_like(x, value):
    """``value`` as a 0-d tensor of ``x``'s dtype on its device (the
    reference casts a scalar operand to the tensor's dtype)."""
    return torch.tensor(value, dtype=x.dtype, device=x.device)


# ---------------------------------------------------------------------------
# Elementwise binary (same-shape) and broadcast variants
# ---------------------------------------------------------------------------

_BINARY = {"add": torch.add, "sub": torch.sub, "mul": torch.mul,
           "div": torch.div, "mod": torch.remainder, "power": torch.pow,
           "maximum": torch.maximum, "minimum": torch.minimum,
           "hypot": torch.hypot}
_LOGIC = {"equal": torch.eq, "not_equal": torch.ne, "greater": torch.gt,
          "greater_equal": torch.ge, "lesser": torch.lt,
          "lesser_equal": torch.le}


def _mk_binary(fn, logic=False, elemwise=False):
    def impl(lhs, rhs):
        if elemwise and lhs.shape != rhs.shape:
            # the reference's elemwise_* ops REQUIRE equal shapes
            # (elemwise_binary_op.h); broadcasting is broadcast_*'s job
            raise MXNetError(
                "elemwise op needs equal shapes, got %s and %s — use the "
                "broadcast_* variant" % (tuple(lhs.shape), tuple(rhs.shape)))
        out = fn(lhs, rhs)
        return out.to(lhs.dtype) if logic else out
    return impl


for _n, _f in _BINARY.items():
    register("elemwise_%s" % _n, _mk_binary(_f, elemwise=True), num_inputs=2,
             aliases=("_%s" % _n, "_Plus" if _n == "add" else "_%s_" % _n))
    register("broadcast_%s" % _n, _mk_binary(_f), num_inputs=2,
             aliases=("broadcast_plus" if _n == "add" else
                      "broadcast_minus" if _n == "sub" else
                      "_broadcast_%s" % _n,))
for _n, _f in _LOGIC.items():
    register("_%s" % _n, _mk_binary(_f, logic=True), num_inputs=2)
    register("broadcast_%s" % _n, _mk_binary(_f, logic=True), num_inputs=2)

register("_grad_add", lambda a, b: a + b, num_inputs=2)


def _add_n(*args, num_args=0):
    out = args[0]
    for a in args[1:]:
        out = out + a
    return out


register("add_n", _add_n, num_inputs=None, key_var_num_args="num_args",
         aliases=("ElementWiseSum", "_sum", "elemwise_sum"),
         params={"num_args": (pInt, 0)})

# scalar variants (ref: elemwise_binary_scalar_op*.cc): the scalar is cast
# to the tensor's dtype first, and the result keeps that dtype
_SCALAR_OPS = {
    "_plus_scalar": lambda x, s: x + s,
    "_minus_scalar": lambda x, s: x - s,
    "_rminus_scalar": lambda x, s: s - x,
    "_mul_scalar": lambda x, s: x * s,
    "_div_scalar": lambda x, s: x / s,
    "_rdiv_scalar": lambda x, s: s / x,
    "_mod_scalar": lambda x, s: torch.remainder(x, s),
    "_rmod_scalar": lambda x, s: torch.remainder(_scalar_like(x, s), x),
    "_power_scalar": lambda x, s: torch.pow(x, s),
    "_rpower_scalar": lambda x, s: torch.pow(s, x),
    # a 0-d operand, so that a tie splits the gradient as jnp.maximum does
    "_maximum_scalar": lambda x, s: torch.maximum(x, _scalar_like(x, s)),
    "_minimum_scalar": lambda x, s: torch.minimum(x, _scalar_like(x, s)),
    "_hypot_scalar": lambda x, s: torch.hypot(x, _scalar_like(x, s)),
}
_SCALAR_LOGIC = {"_equal_scalar": torch.eq, "_not_equal_scalar": torch.ne,
                 "_greater_scalar": torch.gt,
                 "_greater_equal_scalar": torch.ge,
                 "_lesser_scalar": torch.lt, "_lesser_equal_scalar": torch.le}


def _mk_scalar(fn, logic=False):
    def impl(x, scalar=0.0):
        if logic:
            return fn(x, scalar).to(x.dtype)
        s = scalar if x.is_floating_point() else int(scalar)
        return fn(x, s).to(x.dtype)
    return impl


for _n, _f in _SCALAR_OPS.items():
    register(_n, _mk_scalar(_f), num_inputs=1,
             params={"scalar": (pFloat, 0.0)},
             aliases=("_PlusScalar",) if _n == "_plus_scalar" else ())
for _n, _f in _SCALAR_LOGIC.items():
    register(_n, _mk_scalar(_f, logic=True), num_inputs=1,
             params={"scalar": (pFloat, 0.0)})

# ---------------------------------------------------------------------------
# Elementwise unary
# ---------------------------------------------------------------------------


def _cbrt(x):
    return torch.sign(x) * torch.abs(x).pow(1.0 / 3.0)


def _relu(x):
    # jnp.maximum(x, 0), whose gradient at x == 0 is 0.5; torch.maximum
    # splits a tie the same way (torch.relu would give 0 there)
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _round_half_away(x):
    # mshadow round = C round(): half away from zero (torch.round would be
    # banker's rounding, round(2.5) -> 2)
    return torch.where(x >= 0, torch.floor(x + 0.5), torch.ceil(x - 0.5))


_UNARY = {
    "abs": torch.abs, "sign": torch.sign, "rint": torch.round,
    "ceil": torch.ceil, "floor": torch.floor, "trunc": torch.trunc,
    "fix": torch.trunc, "square": torch.square, "sqrt": torch.sqrt,
    "rsqrt": torch.rsqrt, "cbrt": _cbrt,
    "rcbrt": lambda x: 1.0 / _cbrt(x),
    "exp": torch.exp, "log": torch.log, "log10": torch.log10,
    "log2": torch.log2, "log1p": torch.log1p, "expm1": torch.expm1,
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "arcsin": torch.asin, "arccos": torch.acos, "arctan": torch.atan,
    "degrees": torch.rad2deg, "radians": torch.deg2rad,
    "sinh": torch.sinh, "cosh": torch.cosh, "tanh": torch.tanh,
    "arcsinh": torch.asinh, "arccosh": torch.acosh, "arctanh": torch.atanh,
    "gamma": lambda x: torch.exp(torch.lgamma(x)), "gammaln": torch.lgamma,
    "negative": torch.neg, "reciprocal": torch.reciprocal,
    "relu": _relu, "sigmoid": torch.sigmoid,
    "softsign": lambda x: x / (1 + torch.abs(x)), "erf": torch.erf,
    "logical_not": lambda x: (x == 0).to(x.dtype),
    "round": _round_half_away,
}

for _n, _f in _UNARY.items():
    register(_n, (lambda f: lambda x: f(x))(_f), num_inputs=1,
             aliases=("_np_" + _n,))

register("_copy", torch.clone, num_inputs=1, aliases=("identity",))
register("BlockGrad", torch.Tensor.detach, num_inputs=1,
         aliases=("stop_gradient",))
register("make_loss", lambda x: x, num_inputs=1)
register("Cast", lambda x, dtype="float32": x.to(torch_dtype(dtype)),
         num_inputs=1, params={"dtype": (pDtype, "float32")},
         aliases=("cast",),
         # the output dtype is the attr, whatever the input's
         infer_type=lambda in_dts, attrs: (in_dts, [attrs["dtype"]]))
register("clip", lambda x, a_min=0.0, a_max=1.0: torch.clamp(x, a_min, a_max),
         num_inputs=1, params={"a_min": (pFloat, 0.0), "a_max": (pFloat, 1.0)})

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


def _nanprod(x, dim, keepdim):
    return torch.prod(torch.where(torch.isnan(x), torch.ones_like(x), x),
                      dim=dim, keepdim=keepdim)


def _mk_reduce(fn, one_dim_at_a_time=False):
    def impl(x, axis=None, keepdims=False, exclude=False):
        ax = _norm_axis(axis, x.ndim, exclude)
        if not ax:  # nothing to reduce (exclude of every axis)
            return x
        if not one_dim_at_a_time:
            return fn(x, dim=ax, keepdim=bool(keepdims))
        for a in sorted(ax, reverse=True):  # torch.prod takes one dim
            x = fn(x, dim=a, keepdim=bool(keepdims))
        return x
    return impl


_REDUCE_PARAMS = {"axis": (pShape, None), "keepdims": (pBool, False),
                  "exclude": (pBool, False)}

register("sum", _mk_reduce(torch.sum), num_inputs=1, params=_REDUCE_PARAMS,
         aliases=("sum_axis",))
register("mean", _mk_reduce(torch.mean), num_inputs=1, params=_REDUCE_PARAMS)
register("prod", _mk_reduce(torch.prod, True), num_inputs=1,
         params=_REDUCE_PARAMS)
register("nansum", _mk_reduce(torch.nansum), num_inputs=1,
         params=_REDUCE_PARAMS)
register("nanprod", _mk_reduce(_nanprod, True), num_inputs=1,
         params=_REDUCE_PARAMS)
register("max", _mk_reduce(torch.amax), num_inputs=1, params=_REDUCE_PARAMS,
         aliases=("max_axis",))
register("min", _mk_reduce(torch.amin), num_inputs=1, params=_REDUCE_PARAMS,
         aliases=("min_axis",))


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


def _argminmax(fn):
    """Index of the first extreme along ``axis`` (the whole array when
    None), as the input's dtype."""
    def impl(x, axis=None, keepdims=False):
        if axis is None:
            out = fn(x.reshape(-1)).to(x.dtype)
            return out.reshape((1,) * x.ndim if keepdims else ())
        return fn(x, dim=int(axis), keepdim=bool(keepdims)).to(x.dtype)
    return impl


register("argmax", _argminmax(torch.argmax), num_inputs=1,
         params={"axis": (pAny, None), "keepdims": (pBool, False)})
register("argmin", _argminmax(torch.argmin), num_inputs=1,
         params={"axis": (pAny, None), "keepdims": (pBool, False)})
register("argmax_channel", lambda x: torch.argmax(x, dim=1).to(x.dtype),
         num_inputs=1)

# ---------------------------------------------------------------------------
# dot / batch_dot (cuBLAS; the JAX package leaves them to XLA)
# ---------------------------------------------------------------------------


def _reverse_axes(x):
    return x.permute(*reversed(range(x.ndim)))


def _dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = _reverse_axes(lhs) if transpose_a else lhs
    b = _reverse_axes(rhs) if transpose_b else rhs
    if a.ndim == 1 and b.ndim == 1:
        return torch.dot(a, b).reshape((1,))
    return torch.matmul(a, b)


register("dot", _dot, num_inputs=2,
         params={"transpose_a": (pBool, False), "transpose_b": (pBool, False)})


def _batch_dot(lhs, rhs, transpose_a=False, transpose_b=False):
    a = torch.swapaxes(lhs, -1, -2) if transpose_a else lhs
    b = torch.swapaxes(rhs, -1, -2) if transpose_b else rhs
    return torch.matmul(a, b).to(lhs.dtype)


register("batch_dot", _batch_dot, num_inputs=2,
         params={"transpose_a": (pBool, False), "transpose_b": (pBool, False)})

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


def _transpose(x, axes=None):
    if not axes:
        return _reverse_axes(x)
    return x.permute(*axes)


register("transpose", _transpose, num_inputs=1,
         params={"axes": (pShape, None)})
register("expand_dims", lambda x, axis=0: torch.unsqueeze(x, int(axis)),
         num_inputs=1, params={"axis": (pInt, 0)})
register("Flatten", lambda x: x.reshape(x.shape[0], -1), num_inputs=1,
         aliases=("flatten",))


def _slice_dim(x, dim, start, stop, step):
    """``x`` along ``dim`` as python's ``[start:stop:step]``; a negative
    step (which torch slicing refuses) gathers the indices."""
    if step is None or step > 0:
        idx = [slice(None)] * x.ndim
        idx[dim] = slice(start, stop, step)
        return x[tuple(idx)]
    rows = range(*slice(start, stop, step).indices(x.shape[dim]))
    return torch.index_select(x, dim, torch.tensor(list(rows),
                                                   dtype=torch.int64,
                                                   device=x.device))


def _slice(x, begin=None, end=None, step=None):
    begin, end, step = begin or (), end or (), step or ()
    for i in range(x.ndim):
        b = begin[i] if i < len(begin) else None
        e = end[i] if i < len(end) else None
        s = step[i] if i < len(step) and step[i] not in (None, 0) else None
        if b is not None or e is not None or s is not None:
            x = _slice_dim(x, i, b, e, s)
    return x


register("slice", _slice, num_inputs=1, aliases=("crop",),
         params={"begin": (pShapeN, None), "end": (pShapeN, None),
                 "step": (pShapeN, None)})


def _slice_axis(x, axis=0, begin=0, end=None):
    axis = axis % x.ndim
    e = x.shape[axis] if end is None else int(end)
    return _slice_dim(x, axis, int(begin), e, None)


register("slice_axis", _slice_axis, num_inputs=1,
         params={"axis": (pInt, 0), "begin": (pInt, 0), "end": (pAny, None)})


def _slice_like(x, shape_like, axes=None):
    for a in (axes if axes else range(x.ndim)):
        a %= x.ndim
        x = _slice_dim(x, a, 0, shape_like.shape[a], None)
    return x


register("slice_like", _slice_like, num_inputs=2,
         params={"axes": (pShape, None)})


def _take(a, indices, axis=0, mode="clip"):
    """``a`` at ``indices`` along ``axis``; out-of-range indices clip
    (``wrap``: wrap around), as ``jnp.take`` in the reference."""
    axis = int(axis) % a.ndim
    n = a.shape[axis]
    idx = indices.to(torch.int64)
    idx = torch.remainder(idx, n) if mode == "wrap" else idx.clamp(0, n - 1)
    out = torch.index_select(a, axis, idx.reshape(-1))
    return out.reshape(a.shape[:axis] + idx.shape + a.shape[axis + 1:])


register("take", _take, num_inputs=2,
         params={"axis": (pInt, 0), "mode": (pStr, "clip")})


def _batch_take(a, indices):
    idx = indices.to(torch.int64)
    return torch.gather(a, 1, idx[:, None])[:, 0]


register("batch_take", _batch_take, num_inputs=2)


def _pick(data, index, axis=-1, keepdims=False):
    """``data`` along ``axis`` at ``index`` (the label of each position),
    as ``take_along_axis`` (ref: pick, ops/tensor.py:416)."""
    ax = int(axis) % data.ndim
    idx = torch.unsqueeze(index.to(torch.int64), ax)
    out = torch.take_along_dim(data, idx, dim=ax)
    return out if keepdims else torch.squeeze(out, ax)


register("pick", _pick, num_inputs=2,
         params={"axis": (pAny, -1), "keepdims": (pBool, False)})


def _one_hot(indices, depth=1, on_value=1.0, off_value=0.0,
             dtype="float32"):
    """Indices outside [0, depth) give an all-off row (``jax.nn.one_hot``)."""
    ind = indices.to(torch.int64)
    eye = (ind.unsqueeze(-1) == torch.arange(int(depth), device=ind.device)
           ).to(torch_dtype(dtype))
    return eye * on_value + (1 - eye) * off_value


register("one_hot", _one_hot, num_inputs=1,
         params={"depth": (pInt, 1), "on_value": (pFloat, 1.0),
                 "off_value": (pFloat, 0.0), "dtype": (pDtype, "float32")})


def _where(cond, x, y):
    """Same-shape elementwise select, OR a 1-D condition choosing whole
    rows along axis 0 (ref: control_flow_op.h WhereOpForward — any other
    1-D length is an error, never a silent broadcast)."""
    if cond.ndim == 1 and x.ndim > 1:
        if cond.shape[0] != x.shape[0]:
            raise MXNetError("where: 1-D condition of length %d must match "
                             "x.shape[0]=%d" % (cond.shape[0], x.shape[0]))
        cond = cond.reshape((-1,) + (1,) * (x.ndim - 1))
    elif cond.shape != x.shape:
        raise MXNetError("where: condition shape %s must equal x shape %s "
                         "(or be a length-%d vector)"
                         % (tuple(cond.shape), tuple(x.shape), x.shape[0]))
    return torch.where(cond.to(torch.bool), x, y)


register("where", _where, num_inputs=3)
register("tile", lambda x, reps=(1,): torch.tile(x, tuple(reps)),
         num_inputs=1, params={"reps": (pShape, (1,))})


def _repeat(x, repeats=1, axis=None):
    if axis is None:
        return torch.repeat_interleave(x.reshape(-1), int(repeats))
    return torch.repeat_interleave(x, int(repeats), dim=int(axis))


register("repeat", _repeat, num_inputs=1,
         params={"repeats": (pInt, 1), "axis": (pAny, None)})


def _reverse(x, axis=()):
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.flip(x, ax)


register("reverse", _reverse, num_inputs=1, params={"axis": (pAny, ())},
         aliases=("flip",))
register("SwapAxis", lambda x, dim1=0, dim2=0:
         torch.swapaxes(x, int(dim1), int(dim2)),
         num_inputs=1, params={"dim1": (pInt, 0), "dim2": (pInt, 0)},
         aliases=("swapaxes",))


def _squeeze(x, axis=None):
    if axis is None:
        return torch.squeeze(x)
    ax = (axis,) if isinstance(axis, int) else tuple(axis)
    return torch.squeeze(x, tuple(a % x.ndim for a in ax))


register("squeeze", _squeeze, num_inputs=1, params={"axis": (pAny, None)})
register("Concat", lambda *args, dim=1, num_args=0: torch.cat(args, int(dim)),
         num_inputs=None, key_var_num_args="num_args", aliases=("concat",),
         params={"dim": (pInt, 1), "num_args": (pInt, 0)})
register("stack", lambda *args, axis=0, num_args=0:
         torch.stack(args, int(axis)),
         num_inputs=None, key_var_num_args="num_args",
         params={"axis": (pInt, 0), "num_args": (pInt, 0)})


def _split(x, num_outputs=1, axis=1, squeeze_axis=False):
    n, axis = int(num_outputs), int(axis)
    if x.shape[axis] % n:
        raise MXNetError("split: axis %d of size %d does not divide into %d"
                         % (axis, x.shape[axis], n))
    parts = torch.chunk(x, n, dim=axis)
    if squeeze_axis:
        parts = tuple(torch.squeeze(p, axis) for p in parts)
    return tuple(parts) if len(parts) > 1 else parts[0]


register("SliceChannel", _split, num_inputs=1, aliases=("split",),
         num_outputs=lambda attrs: int(attrs.get("num_outputs", 1)),
         params={"num_outputs": (pInt, 1), "axis": (pInt, 1),
                 "squeeze_axis": (pBool, False)})


def _broadcast_to(x, shape=None):
    tgt = tuple(int(t) if int(t) != 0 else s for t, s in zip(shape, x.shape))
    return torch.broadcast_to(x, tgt)


register("broadcast_to", _broadcast_to, num_inputs=1,
         params={"shape": (pShape, None)})


def _broadcast_axis(x, axis=(), size=()):
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    sizes = (size,) if isinstance(size, int) else tuple(size)
    tgt = list(x.shape)
    for a, s in zip(axes, sizes):
        tgt[a] = s
    return torch.broadcast_to(x, tuple(tgt))


register("broadcast_axis", _broadcast_axis, num_inputs=1,
         params={"axis": (pAny, ()), "size": (pAny, ())},
         aliases=("broadcast_axes",))


def _gather_nd(data, indices):
    return data[tuple(indices.to(torch.int64))]


register("gather_nd", _gather_nd, num_inputs=2)


def _scatter_nd(data, indices, shape=None):
    out = torch.zeros(tuple(shape), dtype=data.dtype, device=data.device)
    return out.index_put(tuple(indices.to(torch.int64)), data,
                         accumulate=True)


register("scatter_nd", _scatter_nd, num_inputs=2,
         params={"shape": (pShape, None)})


def _pad(x, mode="constant", pad_width=None, constant_value=0.0):
    pw = [(int(pad_width[2 * i]), int(pad_width[2 * i + 1]))
          for i in range(x.ndim)]
    if mode == "constant":
        flat = [p for lo_hi in reversed(pw) for p in lo_hi]  # F.pad order
        return torch.nn.functional.pad(x, flat, value=constant_value)
    # edge / reflect along each padded axis: numpy's own index map, so
    # the padding (and its gradient, summed back) is np.pad's
    np_mode = "edge" if mode == "edge" else "reflect"
    for ax, (lo, hi) in enumerate(pw):
        if lo or hi:
            idx = np.pad(np.arange(x.shape[ax]), (lo, hi), mode=np_mode)
            x = torch.index_select(x, ax, torch.from_numpy(idx).to(x.device))
    return x


register("Pad", _pad, num_inputs=1, aliases=("pad",),
         params={"mode": (pStr, "constant"), "pad_width": (pShape, None),
                 "constant_value": (pFloat, 0.0)})

# ---------------------------------------------------------------------------
# Ordering (ref: ordering_op-inl.h).  Stable sorts: ties keep index order,
# as jnp.argsort and lax.top_k do.
# ---------------------------------------------------------------------------


def _flat_or(x, axis):
    """(x, axis) with ``axis=None`` meaning the flattened array."""
    if axis is None:
        return x.reshape(-1), 0
    return x, int(axis) % x.ndim


def _sort(x, axis=-1, is_ascend=True):
    x, ax = _flat_or(x, axis)
    out = torch.sort(x, dim=ax, stable=True).values
    return out if is_ascend else torch.flip(out, (ax,))


register("sort", _sort, num_inputs=1,
         params={"axis": (pAny, -1), "is_ascend": (pBool, True)})


def _argsort(x, axis=-1, is_ascend=True, dtype="float32"):
    x, ax = _flat_or(x, axis)
    out = torch.argsort(x, dim=ax, stable=True)
    if not is_ascend:
        out = torch.flip(out, (ax,))
    return out.to(torch_dtype(dtype))


register("argsort", _argsort, num_inputs=1,
         params={"axis": (pAny, -1), "is_ascend": (pBool, True),
                 "dtype": (pDtype, "float32")})


def _topk(x, axis=-1, k=1, ret_typ="indices", is_ascend=False,
          dtype="float32"):
    x, ax = _flat_or(x, axis)
    # the k first of a stable sort: equal values keep index order
    idx = torch.argsort(x if is_ascend else -x, dim=ax, stable=True)
    idx = torch.narrow(idx, ax, 0, int(k))
    if ret_typ == "mask":
        # 1 at each selected position, input shape (ref: kMask)
        return torch.zeros_like(x).scatter(ax, idx, 1.0)
    vals = torch.gather(x, ax, idx)
    if ret_typ == "value":
        return vals
    if ret_typ == "both":
        return vals, idx.to(torch_dtype(dtype))
    return idx.to(torch_dtype(dtype))


register("topk", _topk, num_inputs=1,
         num_outputs=lambda attrs: 2 if attrs.get("ret_typ") == "both" else 1,
         params={"axis": (pAny, -1), "k": (pInt, 1),
                 "ret_typ": (pStr, "indices"), "is_ascend": (pBool, False),
                 "dtype": (pDtype, "float32")})

# ---------------------------------------------------------------------------
# Init ops (ref: init_op.h): no inputs; the caller's device comes as
# ``_device`` (the imperative call's ctx, the executor's device)
# ---------------------------------------------------------------------------


def _zeros(shape=None, ctx=None, dtype="float32", _device=None):
    return torch.zeros(shape or (1,), dtype=torch_dtype(dtype),
                       device=_device)


def _ones(shape=None, ctx=None, dtype="float32", _device=None):
    return torch.ones(shape or (1,), dtype=torch_dtype(dtype), device=_device)


def _full(shape=None, ctx=None, dtype="float32", value=0.0, _device=None):
    return torch.full(shape or (1,), value, dtype=torch_dtype(dtype),
                      device=_device)


def _arange(start=0.0, stop=None, step=1.0, repeat=1, ctx=None,
            dtype="float32", infer_range=False, _device=None):
    if stop is None:  # arange(n) counts from 0 to n
        start, stop = 0.0, start
    # computed as numpy computes it, then placed
    arr = torch.from_numpy(np.arange(start, float(stop), step,
                                     dtype=np.dtype(str(dtype))))
    if int(repeat) > 1:
        arr = torch.repeat_interleave(arr, int(repeat))
    return arr.to(_device)


def _eye(N=1, M=0, k=0, ctx=None, dtype="float32", _device=None):
    m = int(M) if int(M) > 0 else int(N)
    return torch.from_numpy(np.eye(int(N), m, int(k),
                                   dtype=np.dtype(str(dtype)))).to(_device)


_INIT_PARAMS = {"shape": (pShape, None), "ctx": (pStr, None),
                "dtype": (pDtype, "float32")}
register("_zeros", _zeros, num_inputs=0, params=_INIT_PARAMS,
         takes_device=True)
register("_ones", _ones, num_inputs=0, params=_INIT_PARAMS,
         takes_device=True)
register("_full", _full, num_inputs=0, takes_device=True,
         params=dict(_INIT_PARAMS, value=(pFloat, 0.0)))
register("_arange", _arange, num_inputs=0, takes_device=True,
         params={"start": (pFloat, 0.0), "stop": (pAny, None),
                 "step": (pFloat, 1.0), "repeat": (pInt, 1),
                 "ctx": (pStr, None), "dtype": (pDtype, "float32"),
                 "infer_range": (pBool, False)})
register("_eye", _eye, num_inputs=0, takes_device=True,
         params={"N": (pInt, 1), "M": (pInt, 0), "k": (pInt, 0),
                 "ctx": (pStr, None), "dtype": (pDtype, "float32")})

register("zeros_like", torch.zeros_like, num_inputs=1)
register("ones_like", torch.ones_like, num_inputs=1)
register("shape_array", lambda x: torch.tensor(x.shape, dtype=torch.int64,
                                               device=x.device),
         num_inputs=1)
register("size_array", lambda x: torch.tensor([x.numel()], dtype=torch.int64,
                                              device=x.device),
         num_inputs=1)


# ---------------------------------------------------------------------------
# Sparse-storage ops (ref: cast_storage-inl.h, sparse_retain-inl.h,
# square_sum-inl.h).  The dense impls serve symbol graphs, whose every
# array is dense; a sparse input reaches the sparse_impl.
# ---------------------------------------------------------------------------

def _cast_storage_dense(data, stype="default"):
    # storage is an NDArray-level property: in a graph the node is the
    # identity
    return data


def _cast_storage_sparse(inputs, attrs):
    arr = inputs[0]
    stype = attrs.get("stype", "default")
    return (arr.todense() if stype == "default" else arr.tostype(stype),)


register("cast_storage", _cast_storage_dense, num_inputs=1,
         sparse_impl=_cast_storage_sparse,
         params={"stype": (pStr, "default")})


def _sparse_retain_dense(data, indices):
    mask = torch.zeros(data.shape[0], dtype=torch.bool, device=data.device)
    mask[indices.long()] = True
    return torch.where(mask.reshape((-1,) + (1,) * (data.ndim - 1)), data,
                       torch.zeros((), dtype=data.dtype, device=data.device))


def _sparse_retain_sparse(inputs, attrs):
    return (inputs[0].retain(inputs[1]),)


register("sparse_retain", _sparse_retain_dense, num_inputs=2,
         input_names=["data", "indices"],
         sparse_impl=_sparse_retain_sparse,
         sparse_pattern=("row_sparse", "default"))


def _square_sum_dense(data, axis=None, keepdims=False, exclude=False):
    ax = _norm_axis(axis, data.ndim, exclude)
    sq = data * data
    return torch.sum(sq, dim=ax, keepdim=bool(keepdims)) if ax else sq


def _square_sum_sparse(inputs, attrs):
    """The row_sparse path: the stored rows only (ref: square_sum-inl.h, a
    2-D input, axis 0 or 1; axis 1 with keepdims gives row_sparse).
    Anything else declines to the dense fallback."""
    from ..ndarray.ndarray import NDArray
    from ..ndarray.sparse import RowSparseNDArray
    rsp = inputs[0]
    if attrs.get("exclude") or len(rsp.shape) != 2:
        return NotImplemented
    axis = attrs.get("axis")
    if isinstance(axis, tuple):
        axis = axis[0] if len(axis) == 1 else None
    data = rsp.data.tensor
    sq = data * data
    if axis in (1, -1):
        row_vals = sq.sum(dim=tuple(range(1, data.ndim)))
        if attrs.get("keepdims"):
            return (RowSparseNDArray(NDArray(row_vals[:, None]),
                                     rsp.indices, (rsp.shape[0], 1)),)
        out = torch.zeros(rsp.shape[0], dtype=data.dtype, device=data.device)
        out[rsp.indices.tensor.long()] = row_vals
        return (out,)
    if axis == 0:
        out = sq.sum(dim=0)
        return (out[None] if attrs.get("keepdims") else out,)
    return (sq.sum(),)


register("_square_sum", _square_sum_dense, num_inputs=1,
         aliases=("square_sum",), sparse_impl=_square_sum_sparse,
         sparse_pattern=("row_sparse",), params=_REDUCE_PARAMS)

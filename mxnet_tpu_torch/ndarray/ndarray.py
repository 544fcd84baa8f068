"""NDArray: the imperative tensor, a handle over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  The JAX package holds an
immutable ``jax.Array`` in a one-slot ``_Handle`` and rebinds it on
mutation; here the handle holds a ``torch.Tensor`` and writes into it in
place (``copyto``, ``x[:] = v``, ``x += v`` outside recording), so every
holder of the NDArray and of its tensor sees the write.

Imperative ops (``mx.nd.<op>``, the operators) dispatch through
:func:`_invoke`: the registered op's torch function runs with torch
autograd on exactly while ``autograd.record()`` is active, so the
recording is torch's own graph.  ``attach_grad`` makes the tensor a
leaf that requires grad and ``backward`` fills the gradient buffer (see
``autograd.py``).

``save``/``load``/``loads`` use the JAX package's ``.params`` container
byte for byte (``MXTPU001`` magic, then per array: name, dtype name,
shape and raw little-endian data; bfloat16 travels as float32 data under
the name ``bfloat16``), so a file saved by either package loads in the
other.
"""
from __future__ import annotations

import io
import os
import struct

import numpy as np
import torch
import torch.utils.dlpack

from ..base import MXNetError, dtype_name, np_dtype, torch_dtype
from ..context import Context, context_of, cpu, current_context
from ..ops.registry import get_op
from .. import autograd as ag


class _Handle:
    """Mutable slot holding the current tensor (the Chunk analog)."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor


class NDArray:
    __slots__ = ("_h", "_grad", "_grad_req", "_host_ctx", "__weakref__")

    def __init__(self, tensor):
        self._h = tensor if isinstance(tensor, _Handle) else _Handle(tensor)
        self._grad = None
        self._grad_req = "null"
        # a host context other than cpu(0) that made this array: every
        # host context shares the host tensor device, but an array
        # reports its own (group2ctx places arrays on cpu(1), cpu(2))
        self._host_ctx = None

    @property
    def tensor(self):
        """The underlying ``torch.Tensor``."""
        return self._h.tensor

    @property
    def shape(self):
        return tuple(self._h.tensor.shape)

    @property
    def ndim(self):
        return self._h.tensor.ndim

    @property
    def size(self):
        return self._h.tensor.numel()

    @property
    def dtype(self):
        return np_dtype(self._h.tensor.dtype)

    @property
    def context(self):
        if self._host_ctx is not None and not self._h.tensor.is_cuda:
            return self._host_ctx
        return context_of(self._h.tensor.device)

    ctx = context

    @property
    def grad(self):
        return self._grad

    @property
    def T(self):
        return _invoke("transpose", [self], {})

    def wait_to_read(self):
        """Block until the array's pending device work has finished."""
        if self._h.tensor.is_cuda:
            torch.cuda.synchronize(self._h.tensor.device)

    # -- host transfer and copies --------------------------------------------
    def asnumpy(self):
        """A numpy copy: later writes to this array (an optimizer's
        in-place update, ``clip_global_norm``) leave it as it was."""
        t = self._h.tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        if t.device.type == "cpu":
            return t.numpy().copy()  # a host tensor's numpy() is a view
        return t.cpu().numpy()

    def asscalar(self):
        if self.size != 1:
            raise MXNetError("The current array is not a scalar")
        return self.asnumpy().reshape(-1)[0]

    def astype(self, dtype, copy=True):
        return _invoke("Cast", [self], {"dtype": dtype_name(dtype)})

    def copy(self):
        return _invoke("_copy", [self], {})

    def copyto(self, other):
        """Copy into ``other``: an NDArray (its storage, dtype and device
        kept) or a Context (a new array there)."""
        if isinstance(other, NDArray):
            if other is self:
                raise MXNetError("cannot copy an array onto itself")
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            with torch.no_grad():
                other._h.tensor.copy_(self._h.tensor)
            return other
        if isinstance(other, Context):
            return _on(NDArray(self._h.tensor.detach().to(
                other.torch_device(), copy=True)), other)
        raise TypeError("copyto does not support type " + str(type(other)))

    def as_in_context(self, context):
        if self.context == context:
            return self
        return self.copyto(context)

    # -- autograd --------------------------------------------------------------
    def detach(self):
        """The same values, cut from the recorded graph (a carried RNN
        state between truncated-BPTT batches)."""
        return NDArray(self._h.tensor.detach())

    def attach_grad(self, grad_req="write", stype=None):
        """Give this array a gradient buffer (``.grad``), filled by
        ``backward`` according to ``grad_req``.  The buffer is dense
        whatever ``stype`` asks, as in the JAX package."""
        grad = NDArray(torch.zeros_like(self._h.tensor.detach()))
        ag.mark_variables([self], [grad], grad_req)

    def backward(self, out_grad=None, retain_graph=False, train_mode=True):
        ag.backward([self], [out_grad] if out_grad is not None else None,
                    retain_graph, train_mode)

    # -- shape and reductions --------------------------------------------------
    def reshape(self, *shape, **kwargs):
        if len(shape) == 1 and isinstance(shape[0], (list, tuple)):
            shape = tuple(shape[0])
        if kwargs.get("shape"):
            shape = tuple(kwargs["shape"])
        return _invoke("Reshape", [self], {"shape": shape})

    def sum(self, axis=None, keepdims=False):
        return _invoke("sum", [self], {"axis": axis, "keepdims": keepdims})

    def mean(self, axis=None, keepdims=False):
        return _invoke("mean", [self], {"axis": axis, "keepdims": keepdims})

    def norm(self):
        return _invoke("norm", [self], {})

    def max(self, axis=None, keepdims=False):
        return _invoke("max", [self], {"axis": axis, "keepdims": keepdims})

    def min(self, axis=None, keepdims=False):
        return _invoke("min", [self], {"axis": axis, "keepdims": keepdims})

    def argmax(self, axis=None, keepdims=False):
        return _invoke("argmax", [self], {"axis": axis, "keepdims": keepdims})

    def argmin(self, axis=None, keepdims=False):
        return _invoke("argmin", [self], {"axis": axis, "keepdims": keepdims})

    # -- fluent methods: each one op of the registry, as the reference's ------
    def expand_dims(self, axis):
        return _invoke("expand_dims", [self], {"axis": axis})

    def flatten(self):
        return _invoke("Flatten", [self], {})

    def transpose(self, axes=None):
        return _invoke("transpose", [self], {"axes": axes})

    def swapaxes(self, dim1, dim2):
        return _invoke("SwapAxis", [self], {"dim1": dim1, "dim2": dim2})

    def flip(self, axis):
        return _invoke("reverse", [self], {"axis": axis})

    def split(self, *args, **kwargs):
        from . import split as _split
        return _split(self, *args, **kwargs)

    def slice(self, begin, end):
        return _invoke("slice", [self], {"begin": begin, "end": end})

    def slice_axis(self, axis, begin, end):
        return _invoke("slice_axis", [self],
                       {"axis": axis, "begin": begin, "end": end})

    def broadcast_to(self, shape):
        return _invoke("broadcast_to", [self], {"shape": shape})

    def tile(self, reps):
        return _invoke("tile", [self], {"reps": reps})

    def abs(self):
        return _invoke("abs", [self], {})

    def square(self):
        return _invoke("square", [self], {})

    def sqrt(self):
        return _invoke("sqrt", [self], {})

    def clip(self, a_min, a_max):
        return _invoke("clip", [self], {"a_min": a_min, "a_max": a_max})

    def round(self):
        return _invoke("rint", [self], {})

    def sign(self):
        return _invoke("sign", [self], {})

    def log(self):
        return _invoke("log", [self], {})

    def exp(self):
        return _invoke("exp", [self], {})

    def sigmoid(self):
        return _invoke("sigmoid", [self], {})

    def tanh(self):
        return _invoke("tanh", [self], {})

    def relu(self):
        return _invoke("relu", [self], {})

    def softmax(self, axis=-1):
        return _invoke("softmax", [self], {"axis": axis})

    def one_hot(self, depth, **kwargs):
        return _invoke("one_hot", [self], dict(kwargs, depth=depth))

    def take(self, indices, axis=0, mode="clip"):
        return _invoke("take", [self, indices], {"axis": axis, "mode": mode})

    def dot(self, other, transpose_a=False, transpose_b=False):
        return _invoke("dot", [self, other], {"transpose_a": transpose_a,
                                              "transpose_b": transpose_b})

    @property
    def stype(self):
        return "default"

    def tostype(self, stype):
        """This array for ``"default"``, else its ``row_sparse`` or ``csr``
        form (``sparse.cast_storage``)."""
        if stype == "default":
            return self
        from .sparse import cast_storage
        return cast_storage(self, stype)

    # -- python protocol -------------------------------------------------------
    def __len__(self):
        return self.shape[0]

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(d) for d in self.shape),
            self.context)

    def __bool__(self):
        if self.size == 1:
            return bool(self.asscalar())
        raise ValueError("The truth value of an NDArray with multiple "
                         "elements is ambiguous.")

    def __float__(self):
        return float(self.asscalar())

    def __int__(self):
        return int(self.asscalar())

    # arithmetic: broadcasting like the reference's broadcast_* family
    def _binary(self, other, op_nd, op_sc, reverse=False):
        if isinstance(other, NDArray):
            lhs, rhs = (other, self) if reverse else (self, other)
            return _invoke(op_nd, [lhs, rhs], {})
        return _invoke(op_sc, [self], {"scalar": float(other)})

    def __add__(self, o):
        return self._binary(o, "broadcast_add", "_plus_scalar")

    __radd__ = __add__

    def __sub__(self, o):
        return self._binary(o, "broadcast_sub", "_minus_scalar")

    def __rsub__(self, o):
        return self._binary(o, "broadcast_sub", "_rminus_scalar",
                            reverse=True)

    def __mul__(self, o):
        return self._binary(o, "broadcast_mul", "_mul_scalar")

    __rmul__ = __mul__

    def __truediv__(self, o):
        return self._binary(o, "broadcast_div", "_div_scalar")

    def __rtruediv__(self, o):
        return self._binary(o, "broadcast_div", "_rdiv_scalar", reverse=True)

    def __mod__(self, o):
        return self._binary(o, "broadcast_mod", "_mod_scalar")

    def __rmod__(self, o):
        return self._binary(o, "broadcast_mod", "_rmod_scalar", reverse=True)

    def __pow__(self, o):
        return self._binary(o, "broadcast_power", "_power_scalar")

    def __rpow__(self, o):
        return self._binary(o, "broadcast_power", "_rpower_scalar",
                            reverse=True)

    def __neg__(self):
        return _invoke("negative", [self], {})

    def __abs__(self):
        return _invoke("abs", [self], {})

    # comparisons give 0/1 arrays of the operand's dtype, ``==`` and ``!=``
    # too (so ``x in list_of_arrays`` compares elementwise, as in the
    # reference); the hash stays the identity's
    def __eq__(self, o):
        if o is None:
            return False
        return self._binary(o, "broadcast_equal", "_equal_scalar")

    def __ne__(self, o):
        if o is None:
            return True
        return self._binary(o, "broadcast_not_equal", "_not_equal_scalar")

    def __hash__(self):
        return id(self)

    def __gt__(self, o):
        return self._binary(o, "broadcast_greater", "_greater_scalar")

    def __ge__(self, o):
        return self._binary(o, "broadcast_greater_equal",
                            "_greater_equal_scalar")

    def __lt__(self, o):
        return self._binary(o, "broadcast_lesser", "_lesser_scalar")

    def __le__(self, o):
        return self._binary(o, "broadcast_lesser_equal",
                            "_lesser_equal_scalar")

    def _inplace(self, result):
        """``x op= y``: while recording, rebind the handle to the recorded
        result (the JAX package's semantics); otherwise write the result
        into this array's storage, which every holder shares."""
        if ag.is_recording():
            self._h.tensor = result.tensor
        else:
            with torch.no_grad():
                self._h.tensor.copy_(result.tensor)
        return self

    def __iadd__(self, o):
        return self._inplace(self.__add__(o))

    def __isub__(self, o):
        return self._inplace(self.__sub__(o))

    def __imul__(self, o):
        return self._inplace(self.__mul__(o))

    def __itruediv__(self, o):
        return self._inplace(self.__truediv__(o))

    def __getstate__(self):
        return {"data": self.asnumpy(), "dtype": dtype_name(self.tensor.dtype),
                "ctx": (self.context.device_typeid, self.context.device_id)}

    def __setstate__(self, state):
        if "ctx" in state:
            ctx, dtype = Context(*state["ctx"]), state["dtype"]
        else:  # the JAX package's layout: data, ctx_type, ctx_id
            dtype = None
            ctx = Context(state["ctx_type"], state["ctx_id"]) \
                if state["ctx_type"] in Context.devtype2str else cpu()
        self._h = _Handle(_to_tensor(state["data"], ctx, dtype))
        self._grad = None
        self._host_ctx = None
        _on(self, ctx)
        self._grad_req = "null"

    # -- indexing --------------------------------------------------------------
    # torch slicing refuses a negative step: such a slice is read as a
    # positive-step slice of the array flipped along its dimension
    def __getitem__(self, key):
        if isinstance(key, NDArray):
            key = key.tensor.to(torch.int64)
        t = self._h.tensor
        with torch.set_grad_enabled(ag.is_recording()):
            flips, key = _flipped_key(key, t.shape)
            if flips:
                t = t.flip(flips)
            return NDArray(t[key])

    def __setitem__(self, key, value):
        dst = self._h.tensor
        if isinstance(value, NDArray):
            value = value.tensor
        elif not isinstance(value, (int, float, bool)):
            value = torch.as_tensor(np.asarray(value))
        if isinstance(value, torch.Tensor):
            value = value.to(device=dst.device, dtype=dst.dtype)
        if isinstance(key, NDArray):
            key = key.tensor.to(torch.int64)
        flips, flipped = _flipped_key(key, dst.shape)
        with torch.no_grad():
            if not flips:
                dst[key] = value
                return
            # the flat positions the read would gather, written in place
            pos = torch.arange(dst.numel(), device=dst.device).reshape(
                dst.shape).flip(flips)[flipped]
            value = torch.as_tensor(value, device=dst.device,
                                    dtype=dst.dtype).expand(pos.shape)
            dst[torch.unravel_index(pos.reshape(-1), dst.shape)] = \
                value.reshape(-1)


def _flipped_key(key, shape):
    """(dims to flip, key over the flipped array) for an index ``key`` of
    an array of ``shape``: each slice with a negative step becomes a
    positive-step slice along its dimension flipped.  No flips for a key
    without such a slice."""
    parts = key if isinstance(key, tuple) else (key,)
    if not any(isinstance(k, slice) and k.step is not None and k.step < 0
               for k in parts):
        return [], key
    used = sum(1 for k in parts if k is not None and k is not Ellipsis)
    flips, out, dim = [], [], 0
    for k in parts:
        if k is None:
            out.append(k)
            continue
        if k is Ellipsis:
            dim += len(shape) - used
            out.append(k)
            continue
        if isinstance(k, slice) and k.step is not None and k.step < 0:
            n = shape[dim]
            idx = range(*k.indices(n))
            flips.append(dim)
            if len(idx):  # original index i is n - 1 - i in the flip
                first = n - 1 - idx[0]
                k = slice(first, first + (len(idx) - 1) * -k.step + 1,
                          -k.step)
            else:
                k = slice(0, 0)
        out.append(k)
        dim += 1
    return flips, tuple(out)


def _to_tensor(source, ctx, dtype):
    if isinstance(source, NDArray):
        t = source.tensor.detach()
        if dtype is not None:
            t = t.to(torch_dtype(dtype))
        return t.to(ctx.torch_device(), copy=True)
    if dtype is None:
        # MXNet semantics: keep a numpy dtype; python lists become float32
        dtype = source.dtype if isinstance(source, np.ndarray) \
            else np.float32
    name = dtype_name(dtype)
    npa = np.asarray(source)
    if name == "bfloat16":
        t = torch.from_numpy(np.array(npa, dtype=np.float32))
    else:
        t = torch.from_numpy(np.array(npa, dtype=np.dtype(name)))
    return t.to(device=ctx.torch_device(), dtype=torch_dtype(name))


# ---------------------------------------------------------------------------
# Imperative dispatch (ref: MXImperativeInvokeEx -> Imperative::Invoke)
# ---------------------------------------------------------------------------

def _parse_ctx(text):
    """A Context from its string form (``"gpu(0)"``, ``"cpu"``)."""
    name, _, rest = text.partition("(")
    return Context(Context.devstr2type[name.strip()],
                   int(rest.rstrip(")") or 0))


def _invoke(op_name, inputs, attrs, out=None):
    """Run a registered op on NDArrays: normalize attrs, run its torch
    function (recorded by torch autograd while ``autograd.record()`` is
    active), write state outputs back into the inputs they update
    (BatchNorm's moving statistics), and honour ``out=``."""
    op = get_op(op_name)
    stypes = [i.stype for i in inputs]
    if any(s != "default" for s in stypes):
        return _invoke_sparse(op, inputs, stypes, attrs, out)
    if op.takes_device:  # the output's device: the ctx attr, else current
        ctx = attrs.pop("ctx", None) or current_context()
        if isinstance(ctx, str):
            ctx = _parse_ctx(ctx)
    nattrs = op.normalize_attrs(attrs, len(inputs))
    if op.takes_device:
        nattrs["_device"] = ctx.torch_device()
    if op.takes_train_flag:
        nattrs["_train"] = ag.is_training()
    recording = ag.is_recording()
    with torch.set_grad_enabled(recording):
        outs = op.impl(*[i.tensor for i in inputs], **nattrs)
    if not isinstance(outs, tuple):
        outs = (outs,)
    n_vis = op.str_outputs(nattrs)
    with torch.no_grad():
        for value, idx in zip(outs[n_vis:], op.mutate_map):
            if idx < len(inputs) and value is not inputs[idx].tensor:
                inputs[idx].tensor.copy_(value)
    out_nds = [NDArray(v) for v in outs[:n_vis]]
    if out is not None:
        given = [out] if isinstance(out, NDArray) else list(out)
        for dst, src in zip(given, out_nds):
            if recording or dst.shape != src.shape:
                dst._h.tensor = src.tensor
            else:
                with torch.no_grad():
                    dst.tensor.copy_(src.tensor)
        return out
    return out_nds[0] if len(out_nds) == 1 else out_nds


_STORAGE_FALLBACK_WARNED = set()


def _invoke_sparse(op, inputs, stypes, attrs, out):
    """``_invoke`` with a sparse input (ref: imperative_utils.h dispatch
    mode selection, exec_utils.h storage fallback): the op's sparse
    implementation when the storage types match its pattern and it does
    not decline; else, unless a sparse input would be mutated (its update
    would be lost), the op on the densified inputs.  The sparse path is
    not recorded for autograd (the optimizer updates)."""
    nattrs = op.normalize_attrs(attrs, len(inputs))
    outs = NotImplemented
    if op.sparse_impl is not None and (
            op.sparse_pattern is None
            or tuple(stypes) == tuple(op.sparse_pattern[:len(stypes)])):
        outs = op.sparse_impl(inputs, nattrs)
    if outs is NotImplemented:
        for idx in op.mutate_map:
            if idx < len(inputs) and stypes[idx] != "default":
                raise MXNetError(
                    "%s: input %d is %s storage and would be mutated; no "
                    "sparse implementation applies"
                    % (op.name, idx, stypes[idx]))
        if op.name not in _STORAGE_FALLBACK_WARNED:
            _STORAGE_FALLBACK_WARNED.add(op.name)
            from ..base import _logger
            _logger.info("op %s has no sparse implementation; falling back "
                         "to dense storage (ref: storage fallback)", op.name)
        dense = [i.todense() if s != "default" else i
                 for i, s in zip(inputs, stypes)]
        return _invoke(op.name, dense, attrs, out=out)
    if not isinstance(outs, tuple):
        outs = (outs,)
    n_vis = op.str_outputs(nattrs)
    with torch.no_grad():
        for value, idx in zip(outs[n_vis:], op.mutate_map):
            if idx < len(inputs) and value is not inputs[idx].tensor:
                inputs[idx].tensor.copy_(value)
    out_nds = [v if isinstance(v, NDArray) else NDArray(v)
               for v in outs[:n_vis]]
    if out is not None:
        given = [out] if isinstance(out, NDArray) else list(out)
        for dst, src in zip(given, out_nds):
            if dst is not src:
                src.copyto(dst)
        return out
    return out_nds[0] if len(out_nds) == 1 else out_nds


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------

def _on(nd, ctx):
    """``nd``, made on ``ctx``: a host context other than cpu(0) is
    recorded, since the tensor's device does not tell it."""
    if ctx.device_typeid == 1 and ctx.device_id:
        nd._host_ctx = ctx
    return nd


def array(source_array, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return _on(NDArray(_to_tensor(source_array, ctx, dtype)), ctx)


def _shape_tuple(shape):
    if isinstance(shape, int):
        shape = (shape,)
    return tuple(int(d) for d in shape)


def full(shape, val, ctx=None, dtype="float32", out=None):
    ctx = ctx or current_context()
    nd = _on(NDArray(torch.full(_shape_tuple(shape), val,
                                dtype=torch_dtype(dtype),
                                device=ctx.torch_device())), ctx)
    if out is not None:
        nd.copyto(out)
        return out
    return nd


def zeros(shape, ctx=None, dtype="float32", **kwargs):
    return full(shape, 0, ctx, dtype)


def ones(shape, ctx=None, dtype="float32", **kwargs):
    return full(shape, 1, ctx, dtype)


def empty(shape, ctx=None, dtype="float32"):
    ctx = ctx or current_context()
    return _on(NDArray(torch.empty(_shape_tuple(shape),
                                   dtype=torch_dtype(dtype),
                                   device=ctx.torch_device())), ctx)


def concatenate(arrays, axis=0, always_copy=True):
    """The arrays joined along ``axis``; a single array is returned as it
    is unless ``always_copy`` (ref: mx.nd.concatenate)."""
    arrays = list(arrays)
    if len(arrays) == 1 and not always_copy:
        return arrays[0]
    return _invoke("Concat", arrays, {"dim": axis})


def invoke(op_name, inputs, attrs=None, out=None):
    """Run the registered op ``op_name`` on ``inputs`` (ref:
    MXImperativeInvoke)."""
    return _invoke(op_name, list(inputs), dict(attrs or {}), out=out)


def arange(start, stop=None, step=1.0, repeat=1, ctx=None, dtype="float32"):
    """Evenly spaced values in [start, stop), each ``repeat`` times."""
    return _invoke("_arange", [], {"start": start, "stop": stop,
                                   "step": step, "repeat": repeat,
                                   "ctx": ctx, "dtype": dtype})


def moveaxis(tensor, source, destination):
    """A new array with axis ``source`` moved to ``destination``."""
    with torch.set_grad_enabled(ag.is_recording()):
        return NDArray(torch.movedim(tensor.tensor, source, destination)
                       .clone(memory_format=torch.contiguous_format))


def from_numpy(npa, zero_copy=False):
    """An array of ``npa``'s values on the current context."""
    return array(npa)


def from_dlpack(capsule):
    """An array over the memory a DLPack capsule (or an object with
    ``__dlpack__``) describes, without a copy."""
    return NDArray(torch.from_dlpack(capsule))


def to_dlpack_for_read(data):
    """A DLPack capsule over the array's memory, without a copy."""
    return torch.utils.dlpack.to_dlpack(data.tensor.detach())


to_dlpack_for_write = to_dlpack_for_read


def waitall():
    """Block until every queued device operation has finished (ref:
    MXNDArrayWaitAll)."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# Serialization: the JAX package's .params container, byte for byte
# ---------------------------------------------------------------------------

_NDAR_MAGIC = b"MXTPU001"


def save(fname, data):
    """Save an NDArray, a list of them or a {name: NDArray} dict to a
    local path (atomically: written to a temporary file, then renamed) or
    to a registered scheme's URI (``filesystem.register_scheme``)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = [""] * len(data)
        arrays = list(data)
    from ..filesystem import is_remote, open_uri
    if is_remote(fname):
        # a registered scheme's backend owns atomicity (object stores
        # publish on close): no temporary file and rename there
        with open_uri(fname, "wb") as f:
            _save_stream(f, names, arrays)
        return
    tmp = fname + ".tmp"
    with open(tmp, "wb") as f:
        _save_stream(f, names, arrays)
    os.replace(tmp, fname)


def _save_stream(f, names, arrays):
    f.write(_NDAR_MAGIC)
    f.write(struct.pack("<q", len(arrays)))
    for name, nd in zip(names, arrays):
        nb = name.encode()
        f.write(struct.pack("<q", len(nb)))
        f.write(nb)
        if isinstance(nd, NDArray):
            dt = dtype_name(nd.tensor.dtype)
            npa = nd.asnumpy()
        else:
            npa = np.asarray(nd)
            dt = dtype_name(npa.dtype)
        if dt == "bfloat16":
            npa = npa.astype(np.float32)
        f.write(struct.pack("<q", len(dt)))
        f.write(dt.encode())
        f.write(struct.pack("<q", npa.ndim))
        f.write(struct.pack("<%dq" % npa.ndim, *npa.shape))
        buf = np.ascontiguousarray(npa).tobytes()
        f.write(struct.pack("<q", len(buf)))
        f.write(buf)


def load(fname, ctx=None):
    """Load a ``save`` file.  Arrays land on ``ctx``, by default the host
    (``cpu()``): a file is host data until a bind copies it."""
    from ..filesystem import open_uri
    with open_uri(fname, "rb") as f:
        return _load_stream(f, fname, ctx or cpu())


def loads(data, ctx=None):
    """Parse a ``save``-format blob from bytes."""
    return _load_stream(io.BytesIO(data), "<bytes>", ctx or cpu())


def _load_stream(f, fname, ctx):
    if f.read(8) != _NDAR_MAGIC:
        raise MXNetError("invalid NDArray file %s" % fname)
    n = struct.unpack("<q", f.read(8))[0]
    names, arrays = [], []
    for _ in range(n):
        ln = struct.unpack("<q", f.read(8))[0]
        names.append(f.read(ln).decode())
        ld = struct.unpack("<q", f.read(8))[0]
        dt = f.read(ld).decode()
        ndim = struct.unpack("<q", f.read(8))[0]
        shape = struct.unpack("<%dq" % ndim, f.read(8 * ndim)) if ndim else ()
        lb = struct.unpack("<q", f.read(8))[0]
        raw_dt = np.float32 if dt == "bfloat16" else np.dtype(dt)
        npa = np.frombuffer(f.read(lb), raw_dt).reshape(shape)
        arrays.append(array(npa, ctx=ctx, dtype=dt))
    if any(names):
        return dict(zip(names, arrays))
    return arrays

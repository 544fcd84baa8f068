"""NDArray: the imperative tensor, a handle over a ``torch.Tensor``.

Counterpart of ``mxnet_tpu/ndarray/ndarray.py``.  The JAX package holds an
immutable ``jax.Array`` in a one-slot ``_Handle`` and rebinds it on
mutation; here the handle holds a ``torch.Tensor`` and writes into it in
place (``copyto`` copies into the destination's storage).

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

from ..base import MXNetError, dtype_name, np_dtype, torch_dtype
from ..context import Context, context_of, cpu, current_context


class _Handle:
    """Mutable slot holding the current tensor (the Chunk analog)."""

    __slots__ = ("tensor",)

    def __init__(self, tensor):
        self.tensor = tensor


class NDArray:
    __slots__ = ("_h", "__weakref__")

    def __init__(self, tensor):
        self._h = tensor if isinstance(tensor, _Handle) else _Handle(tensor)

    @property
    def tensor(self):
        """The underlying ``torch.Tensor``."""
        return self._h.tensor

    @property
    def shape(self):
        return tuple(self._h.tensor.shape)

    @property
    def dtype(self):
        return np_dtype(self._h.tensor.dtype)

    @property
    def context(self):
        return context_of(self._h.tensor.device)

    ctx = context

    def asnumpy(self):
        t = self._h.tensor.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()

    def copyto(self, other):
        """Copy into ``other``: an NDArray (its storage, dtype and device
        kept) or a Context (a new array there)."""
        if isinstance(other, NDArray):
            if other is self:
                raise MXNetError("cannot copy an array onto itself")
            if other.shape != self.shape:
                raise MXNetError("copyto: shape %s into %s"
                                 % (self.shape, other.shape))
            with torch.inference_mode():
                other._h.tensor.copy_(self._h.tensor)
            return other
        if isinstance(other, Context):
            return NDArray(self._h.tensor.to(other.torch_device(), copy=True))
        raise TypeError("copyto does not support type " + str(type(other)))

    def __repr__(self):
        return "\n%s\n<NDArray %s @%s>" % (
            self.asnumpy(), "x".join(str(d) for d in self.shape),
            self.context)


def _to_tensor(source, ctx, dtype):
    if isinstance(source, NDArray):
        t = source.tensor
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


def array(source_array, ctx=None, dtype=None):
    ctx = ctx or current_context()
    return NDArray(_to_tensor(source_array, ctx, dtype))


def zeros(shape, ctx=None, dtype="float32"):
    ctx = ctx or current_context()
    if isinstance(shape, int):
        shape = (shape,)
    return NDArray(torch.zeros(tuple(int(d) for d in shape),
                               dtype=torch_dtype(dtype),
                               device=ctx.torch_device()))


# ---------------------------------------------------------------------------
# Serialization: the JAX package's .params container, byte for byte
# ---------------------------------------------------------------------------

_NDAR_MAGIC = b"MXTPU001"


def save(fname, data):
    """Save an NDArray, a list of them or a {name: NDArray} dict
    (atomically: written to a temporary file, then renamed)."""
    if isinstance(data, NDArray):
        data = [data]
    if isinstance(data, dict):
        names = list(data.keys())
        arrays = [data[k] for k in names]
    else:
        names = [""] * len(data)
        arrays = list(data)
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
    with open(fname, "rb") as f:
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

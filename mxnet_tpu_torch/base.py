"""Base utilities: the error type, attr-string reflection and dtype names.

Counterpart of ``mxnet_tpu/base.py``.  Symbols carry their attrs as strings
(the nnvm JSON convention), ops declare typed params, and the helpers here
convert both ways with MXNet's spelling: tuples print as ``"(1, 2)"``,
bools as ``"True"``/``"False"``.  Dtypes are named by strings everywhere a
graph sees them; :func:`torch_dtype` maps a name onto the tensor type.
"""
from __future__ import annotations

import numpy as np
import torch

__version__ = "1.0.1"  # capability parity target: MXNet 1.0.1


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch (ref: MXGetLastError)."""


def attr_to_str(value):
    """Serialize a python attr value the way MXNet's frontends do."""
    if isinstance(value, (list, tuple)):
        return "(" + ", ".join(str(v) for v in value) + ")"
    return str(value)


def _parse_scalar(s):
    s = s.strip()
    if s in ("True", "true"):
        return True
    if s in ("False", "false"):
        return False
    if s in ("None", ""):
        return None
    for conv in (int, float):
        try:
            return conv(s)
        except ValueError:
            pass
    return s


def str_to_attr(s):
    """Parse an MXNet attr string back into a python value."""
    if not isinstance(s, str):
        return s
    t = s.strip()
    if t[:1] + t[-1:] in ("()", "[]"):
        inner = t[1:-1].strip()
        if not inner:
            return ()
        return tuple(_parse_scalar(p) for p in inner.split(",") if p.strip())
    return _parse_scalar(t)


def shape_attr(value):
    """Coerce an attr to a shape tuple of ints (accepts int, str, tuple)."""
    if value is None:
        return None
    if isinstance(value, str):
        value = str_to_attr(value)
    if isinstance(value, int):
        return (value,)
    return tuple(int(v) for v in value)


_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "uint8": torch.uint8, "int8": torch.int8, "int32": torch.int32,
    "int64": torch.int64, "bool": torch.bool,
}
_NAME_OF_TORCH = {v: k for k, v in _TORCH_DTYPES.items()}


def dtype_name(dtype):
    """Canonical name of a dtype given as a name, numpy type or torch
    dtype (``None`` means float32, MXNet's default)."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        return _NAME_OF_TORCH[dtype]
    if isinstance(dtype, str):
        if dtype == "bfloat16":
            return dtype
        dtype = "bool" if dtype == "bool_" else dtype
    name = np.dtype(dtype).name
    if name not in _TORCH_DTYPES:
        raise MXNetError("unsupported dtype %r" % (dtype,))
    return name


def np_dtype(dtype):
    """The numpy type of a dtype; bfloat16, which numpy lacks, stays the
    torch dtype (the JAX package returns ``jnp.bfloat16`` there)."""
    name = dtype_name(dtype)
    return torch.bfloat16 if name == "bfloat16" else np.dtype(name)


def torch_dtype(dtype):
    """The torch dtype of a dtype given in any accepted spelling."""
    return _TORCH_DTYPES[dtype_name(dtype)]

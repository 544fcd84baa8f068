"""Base utilities: the error type, attr-string reflection and dtype names.

Counterpart of ``mxnet_tpu/base.py``.  Symbols carry their attrs as strings
(the nnvm JSON convention), ops declare typed params, and the helpers here
convert both ways with MXNet's spelling: tuples print as ``"(1, 2)"``,
bools as ``"True"``/``"False"``.  Dtypes are named by strings everywhere a
graph sees them; :func:`torch_dtype` maps a name onto the tensor type.
"""
from __future__ import annotations

import datetime
import logging
import os
import time

import numpy as np
import torch

__version__ = "1.0.1"  # capability parity target: MXNet 1.0.1

_logger = logging.getLogger("mxnet_tpu_torch")


class MXNetError(Exception):
    """Error raised by mxnet_tpu_torch (ref: MXGetLastError)."""


# the TCP store this process rendezvoused on (set by the launcher bridge)
_DIST_STORE = []


def maybe_initialize_distributed_from_env():
    """Bridge the launcher's environment (``tools/launch.py`` sets
    ``JAX_COORDINATOR_ADDRESS``, ``JAX_NUM_PROCESSES`` and
    ``JAX_PROCESS_ID``; only the names are shared with the JAX package) to
    ``torch.distributed``: a TCP store at that address, rank 0 hosting
    it, and the default process group over gloo.  A no-op when the
    variables are absent or name one process, or when a process group
    exists.  The dist store calls it when it is first created."""
    addr = os.environ.get("JAX_COORDINATOR_ADDRESS")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    if not (addr and nproc and pid) or int(nproc) <= 1:
        return
    if torch.distributed.is_initialized():
        return
    initialize_distributed_with_retry(addr, int(nproc), int(pid))


def initialize_distributed_with_retry(addr, nproc, pid, attempts=3,
                                      timeout_s=300):
    """``torch.distributed.init_process_group`` over a TCP store at
    ``addr`` (``host:port``), with the JAX package's bounded retry and
    backoff: rank 0 may bind its port seconds after its peers start, so a
    failed connection is tried again before it raises."""
    dist = torch.distributed
    host, port = addr.rsplit(":", 1)
    timeout = datetime.timedelta(seconds=timeout_s)
    last = None
    for attempt in range(attempts):
        try:
            store = dist.TCPStore(host, int(port), nproc, pid == 0,
                                  timeout=timeout)
            dist.init_process_group("gloo", store=store, rank=pid,
                                    world_size=nproc, timeout=timeout)
            _DIST_STORE[:] = [store]
            return
        except RuntimeError as e:  # DistNetworkError among them: retried
            last = e
            _logger.warning("torch.distributed rendezvous attempt %d/%d "
                            "failed: %s", attempt + 1, attempts, e)
            time.sleep(2.0 * (attempt + 1))
    raise last


def dist_store():
    """The process group's key-value store: the bridge's, else the one
    ``init_process_group`` made."""
    if _DIST_STORE:
        return _DIST_STORE[0]
    from torch.distributed import distributed_c10d
    return distributed_c10d._get_default_store()


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

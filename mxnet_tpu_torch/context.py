"""Device context.

Counterpart of ``mxnet_tpu/context.py``.  Device types keep the reference's
numbering (kCPU=1, kGPU=2, kCPUPinned=3, kCPUShared=5).  A Context maps
onto a ``torch.device``: ``cpu(i)`` is the host and ``gpu(i)`` is
``cuda:i``.  The default context is ``gpu(0)``: an entry point that is not
given ``cpu()`` runs on the card, and raises ``MXNetError`` where there is
no card, instead of quietly running on the host.
"""
from __future__ import annotations

import threading

import torch

from .base import MXNetError


class Context:
    """Device context holding device type and id."""

    devtype2str = {1: "cpu", 2: "gpu", 3: "cpu_pinned", 5: "cpu_shared"}
    devstr2type = {"cpu": 1, "gpu": 2, "cpu_pinned": 3, "cpu_shared": 5}
    _default_ctx = threading.local()

    def __init__(self, device_type, device_id=0):
        if isinstance(device_type, Context):
            self.device_typeid = device_type.device_typeid
            self.device_id = device_type.device_id
        else:
            if isinstance(device_type, str):
                device_type = self.devstr2type[device_type]
            self.device_typeid = device_type
            self.device_id = device_id
        self._old_ctx = None

    @property
    def device_type(self):
        return self.devtype2str[self.device_typeid]

    def __hash__(self):
        return hash((self.device_typeid, self.device_id))

    def __eq__(self, other):
        return (isinstance(other, Context)
                and self.device_typeid == other.device_typeid
                and self.device_id == other.device_id)

    def __str__(self):
        return "%s(%d)" % (self.device_type, self.device_id)

    __repr__ = __str__

    def torch_device(self):
        """The ``torch.device`` this context names.  A gpu context with no
        visible card raises: the port never substitutes the host."""
        if self.device_typeid != 2:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise MXNetError(
                "context %s needs a CUDA device and none is available; "
                "pass mx.cpu() to run on the host" % self)
        if self.device_id >= torch.cuda.device_count():
            raise MXNetError("context %s out of range: %d device(s) visible"
                             % (self, torch.cuda.device_count()))
        return torch.device("cuda", self.device_id)

    def __enter__(self):
        self._old_ctx = Context.default_ctx()
        Context._default_ctx.value = self
        return self

    def __exit__(self, ptype, value, trace):
        Context._default_ctx.value = self._old_ctx

    @classmethod
    def default_ctx(cls):
        if not hasattr(cls._default_ctx, "value"):
            cls._default_ctx.value = Context(2, 0)
        return cls._default_ctx.value


def cpu(device_id=0):
    return Context(1, device_id)


def gpu(device_id=0):
    return Context(2, device_id)


def current_context():
    return Context.default_ctx()


def context_of(device):
    """The Context naming a ``torch.device``."""
    if device.type == "cuda":
        return gpu(device.index or 0)
    return cpu(0)


def num_gpus():
    return torch.cuda.device_count()

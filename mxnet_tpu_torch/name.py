"""Automatic naming: ``mx.name.NameManager`` and ``Prefix``.

Counterpart of ``mxnet_tpu/name.py`` (ref: python/mxnet/name.py).  The
manager lives with Symbol; this module keeps the import path and adds
``Prefix``.
"""
from __future__ import annotations

from .symbol.symbol import NameManager  # noqa: F401


class Prefix(NameManager):
    """A NameManager that puts a prefix before every automatic name."""

    def __init__(self, prefix):
        super().__init__()
        self._prefix = prefix

    def get(self, name, hint):
        return self._prefix + super().get(name, hint)

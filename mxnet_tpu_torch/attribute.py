"""Attribute scoping: ``mx.attribute.AttrScope``.

Counterpart of ``mxnet_tpu/attribute.py`` (ref: python/mxnet/
attribute.py).  The scope lives with Symbol (``symbol/symbol.py``),
because attributes are a graph concept; this module keeps the import
path.
"""
from __future__ import annotations

from .symbol.symbol import AttrScope  # noqa: F401

current = AttrScope

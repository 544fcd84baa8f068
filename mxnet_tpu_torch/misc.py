"""Deprecated pre-lr_scheduler API (parity: python/mxnet/misc.py).

The reference kept this module as the legacy spelling of what became
``mx.lr_scheduler``; code written against it gets working shims here
that delegate to the real schedulers.
"""
from __future__ import annotations

import warnings

from .lr_scheduler import LRScheduler, FactorScheduler as _Factor


class LearningRateScheduler(LRScheduler):
    """Deprecated: use mx.lr_scheduler.LRScheduler."""

    def __init__(self):
        warnings.warn("mx.misc is deprecated; use mx.lr_scheduler",
                      DeprecationWarning, stacklevel=2)
        super().__init__(base_lr=0.01)


class FactorScheduler(_Factor):
    """Deprecated: use mx.lr_scheduler.FactorScheduler.  A real
    subclass so legacy isinstance checks and subclassing keep
    working."""

    def __init__(self, step, factor=0.1):
        warnings.warn("mx.misc is deprecated; use mx.lr_scheduler",
                      DeprecationWarning, stacklevel=2)
        super().__init__(step=step, factor=factor)

"""Engine frontend (ref: python/mxnet/engine.py — bulk context manager).

The reference's threaded dependency engine scheduled every op push.  In
the port each op runs as it is called, its kernels queued in order on
torch's current CUDA stream, so ``bulk`` is kept for API parity and does
nothing.
"""
from __future__ import annotations

import contextlib


@contextlib.contextmanager
def bulk(size):
    """Bulk execution scope (ref: MXEngineSetBulkSize)."""
    yield


def set_bulk_size(size):
    return 0

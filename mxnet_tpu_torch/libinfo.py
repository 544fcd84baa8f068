"""Library information (ref: python/mxnet/libinfo.py).

The reference locates libmxnet.so for its ctypes bridge.  The port's
native libraries are its hand-written CUDA kernels, which ``ops/_build``
compiles with ``nvcc`` at first use, so ``find_lib_path`` returns the ones
built so far (possibly none) and ``features`` reports what this process
can run.
"""
from __future__ import annotations

import glob
import os

import torch

from .base import __version__  # noqa: F401  (single source of truth)
from .ops import _build


def find_lib_path():
    """Paths of the kernel libraries built so far (none before the first
    launch on a card)."""
    return sorted(glob.glob(os.path.join(_build.BUILD_DIR, "*.so")))


def features():
    """Capability flags, the analog of the reference's USE_* build flags."""
    return {
        "CUDA": torch.cuda.is_available(),
        "CUDNN": torch.backends.cudnn.is_available(),
        "HAND_KERNELS": bool(find_lib_path()),
        "DIST_KVSTORE": True,
        "PROFILER": True,
    }

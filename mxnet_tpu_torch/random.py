"""Global random state.

Counterpart of ``mxnet_tpu/random.py``.  The JAX package keeps one root
PRNG key and splits it per random op; the port keeps one explicit
``torch.Generator`` per device, all seeded by :func:`seed`
(``mx.random.seed``), which also seeds numpy's global generator as the
JAX package's does: the data iterators and samplers shuffle from numpy,
so a seeded run shuffles the same in both packages.  The two packages
draw different numbers from the same seed: a test that needs both to see
the same values makes them with numpy and hands them to each.

``mx.random.uniform``, ``normal``, ... are ``mx.nd.random``'s samplers
(the reference's ``from .ndarray.random import *``).
"""
from __future__ import annotations

import threading

import numpy as _np
import torch

_DEFAULT_SEED = 0
_lock = threading.Lock()
_seed = _DEFAULT_SEED
_generators = {}  # str(torch.device) -> torch.Generator


def seed(seed_state):
    """Seed every device's generator and numpy's global one (ref:
    mx.random.seed)."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for gen in _generators.values():
            gen.manual_seed(_seed)
    _np.random.seed(_seed & 0x7FFFFFFF)


def generator(device="cpu"):
    """The generator of ``device``, made and seeded on first use."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = str(device)
    with _lock:
        gen = _generators.get(key)
        if gen is None:
            gen = torch.Generator(device=device)
            gen.manual_seed(_seed)
            _generators[key] = gen
        return gen


def __getattr__(name):
    # resolved lazily: ndarray imports this module at package init
    if not name.startswith("_"):
        from .ndarray import random as _nd_random
        if name in _nd_random.__all__:
            fn = getattr(_nd_random, name)
            globals()[name] = fn
            return fn
    raise AttributeError("module 'mxnet_tpu_torch.random' has no attribute "
                         "%r" % name)

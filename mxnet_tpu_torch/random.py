"""Global random state.

Counterpart of ``mxnet_tpu/random.py``.  The JAX package keeps one root
PRNG key and splits it per random op; the port keeps one explicit
``torch.Generator`` per device, all seeded by :func:`seed`
(``mx.random.seed``).  The two packages draw different numbers from the
same seed: a test that needs both to see the same values makes them with
numpy and hands them to each.
"""
from __future__ import annotations

import threading

import torch

_DEFAULT_SEED = 0
_lock = threading.Lock()
_seed = _DEFAULT_SEED
_generators = {}  # str(torch.device) -> torch.Generator


def seed(seed_state):
    """Seed every device's generator (ref: mx.random.seed)."""
    global _seed
    with _lock:
        _seed = int(seed_state)
        for gen in _generators.values():
            gen.manual_seed(_seed)


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

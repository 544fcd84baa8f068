"""Process-wide plan cache for Executors.

Counterpart of ``mxnet_tpu/executor_cache.py``.  The JAX package caches
the traced, jitted XLA program of a bind signature; PyTorch runs eagerly,
so what the port builds once per signature is the execution *plan*: the
graph's topological order lowered to a list of op calls over numbered
value slots, with each slot's last use computed so intermediates are
freed as soon as nothing reads them (``executor._Program``).

Entries are keyed by

    (structural graph hash, arg shapes+dtypes, aux shapes+dtypes,
     gradient names, device, kernel_signature(device))

and one plan build counts as one "trace" (``note_trace``), so the
serving layer's zero-rebuild warmup check (``watch_traces``) measures the
same event it does in the JAX package: a bind signature seen for the
first time.
"""
from __future__ import annotations

from collections import OrderedDict

from . import threads as _threads
from .ops import kernels as _kernels

MAX_ENTRIES = 128

_lock = _threads.package_lock("executor_cache._lock")
_entries = OrderedDict()  # key -> _Program, LRU order
_stats = {"traces_fwd": 0}


def note_trace(kind):
    """Record one plan build of kind ``'fwd'``."""
    with _lock:
        _stats["traces_" + kind] += 1


def _signature(symbol, arg_dict, aux_dict, device, grad_names):
    def sig(d):
        return tuple(sorted((n, tuple(a.shape), str(a.tensor.dtype))
                            for n, a in d.items()))
    return (symbol.structural_hash(), sig(arg_dict), sig(aux_dict),
            tuple(grad_names), str(device),
            _kernels.kernel_signature(device))


def get_program(symbol, arg_dict, aux_dict, device, grad_names=()):
    """The shared plan for this bind signature, built on first sight."""
    from .executor import _Program
    key = _signature(symbol, arg_dict, aux_dict, device, grad_names)
    with _lock:
        prog = _entries.get(key)
        if prog is not None:
            _entries.move_to_end(key)
            return prog
    prog = _Program(symbol, {n: a.shape for n, a in arg_dict.items()})
    note_trace("fwd")
    with _lock:
        # a concurrent bind may have built the same signature; the first
        # insertion wins so every caller shares one plan
        existing = _entries.setdefault(key, prog)
        while len(_entries) > MAX_ENTRIES:
            _entries.popitem(last=False)
    return existing


def trace_counts():
    """Snapshot of the plan-build counters ({'traces_fwd': n})."""
    with _lock:
        return dict(_stats)


def reset_stats():
    """Zero the plan-build counters (cached plans stay)."""
    with _lock:
        for k in _stats:
            _stats[k] = 0


class watch_traces:
    """Context manager over ``trace_counts``: ``delta()``/``total()``
    report the builds since ``__enter__`` (frozen at ``__exit__``)::

        with executor_cache.watch_traces() as w:
            serve_requests()
        assert w.total() == 0, w.delta()
    """

    def __enter__(self):
        self._t0 = trace_counts()
        self._t1 = None
        return self

    def __exit__(self, *exc):
        self._t1 = trace_counts()
        return False

    def delta(self):
        end = self._t1 if self._t1 is not None else trace_counts()
        return {k: end[k] - self._t0.get(k, 0) for k in end}

    def total(self):
        return sum(self.delta().values())


def clear():
    """Drop every cached plan (live Executors keep theirs)."""
    with _lock:
        _entries.clear()

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

and a plan's first run of each kind counts as one "trace"
(``note_trace``), so the serving layer's zero-rebuild warmup check
(``watch_traces``) measures the same event it does in the JAX package:
a bind signature run for the first time.

``MXNET_TPU_EXEC_CACHE=0`` turns sharing off (every bind builds its own
plan, counted as a miss) and ``MXNET_TPU_EXEC_CACHE_SIZE`` bounds the
entries (default 128, least recently used first out), both read at each
bind as in the JAX package.  ``stats()`` returns every key of the JAX
package's; ``programs``, ``compile_ms`` and ``disk`` (the memory
profiler's program records and the persistent program cache, later
runtime-services slices) hold their empty values.  Hits, misses,
evictions and builds are mirrored into the telemetry registry
(``exec_cache.*``) and, while the profiler records, onto its timeline
(counters, and ``recompile:<kind>`` / ``exec_cache_eviction``
instants).
"""
from __future__ import annotations

import os
from collections import OrderedDict

from . import profiler as _profiler
from . import threads as _threads
from .observability import telemetry as _telemetry
from .ops import kernels as _kernels

_lock = _threads.package_lock("executor_cache._lock")
_entries = OrderedDict()  # key -> _Program, LRU order
_stats = {"hits": 0, "misses": 0, "evictions": 0,
          "traces_fwd": 0, "traces_fwd_bwd": 0, "traces_fused_step": 0}
# the persistent program cache's counters (a later slice): all zero
_DISK_KEYS = ("hits", "misses", "evictions", "writes", "bytes_written",
              "bytes_read", "pruned", "pruned_bytes")


def _enabled():
    return os.environ.get("MXNET_TPU_EXEC_CACHE", "1") != "0"


def _maxsize():
    return int(os.environ.get("MXNET_TPU_EXEC_CACHE_SIZE", "128"))


def note_trace(kind):
    """Record one build of kind ``'fwd'`` (a plan's first predict-mode
    run), ``'fwd_bwd'`` (its first training run, forward and backward:
    the JAX package's fused forward-backward program) or
    ``'fused_step'`` (a fused train step's first step): the counter, the
    registry's ``exec_cache.traces_<kind>`` and, while the profiler
    records, a counter sample and a ``recompile:<kind>`` instant."""
    with _lock:
        _stats["traces_" + kind] += 1
        value = _stats["traces_" + kind]
    _telemetry.counter("exec_cache.traces_" + kind,
                       help="plan builds of the %s program" % kind).inc()
    _profiler.record_counter("exec_cache_traces_" + kind, value)
    _profiler.record_instant("recompile:" + kind, category="exec_cache",
                             args={"total": value})


def _note(event):
    with _lock:
        _stats[event] += 1
        value = _stats[event]
    _telemetry.counter("exec_cache." + event).inc()
    _profiler.record_counter("exec_cache_" + event, value)


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
    if not _enabled():
        _note("misses")
        return _Program(symbol, {n: a.shape for n, a in arg_dict.items()})
    key = _signature(symbol, arg_dict, aux_dict, device, grad_names)
    with _lock:
        prog = _entries.get(key)
        if prog is not None:
            _entries.move_to_end(key)
            _stats["hits"] += 1
            hits = _stats["hits"]
    if prog is not None:
        _telemetry.counter("exec_cache.hits").inc()
        _profiler.record_counter("exec_cache_hits", hits)
        return prog
    _note("misses")
    prog = _Program(symbol, {n: a.shape for n, a in arg_dict.items()})
    with _lock:
        # a concurrent bind may have built the same signature; the first
        # insertion wins so every caller shares one plan
        existing = _entries.setdefault(key, prog)
        evicted = 0
        while len(_entries) > _maxsize():
            _entries.popitem(last=False)
            _stats["evictions"] += 1
            evicted += 1
    if evicted:
        _telemetry.counter("exec_cache.evictions").inc(evicted)
        _profiler.record_instant("exec_cache_eviction",
                                 category="exec_cache",
                                 args={"evicted": evicted})
    return existing


def trace_counts():
    """Snapshot of the plan-build counters only ({'traces_fwd': n,
    'traces_fwd_bwd': n, 'traces_fused_step': n})."""
    with _lock:
        return {k: v for k, v in _stats.items() if k.startswith("traces_")}


def stats():
    """Counter snapshot with the JAX package's keys: hits, misses,
    evictions, the per-kind build counts, the live entry count, whether
    sharing is enabled, ``recompile_causes`` (the retrace explainer's
    tallies), ``programs``, ``compile_ms`` and ``disk`` (the last four
    empty until the slices that fill them)."""
    with _lock:
        out = dict(_stats)
        out["entries"] = len(_entries)
    out["recompile_causes"] = {}
    out["enabled"] = _enabled()
    out["programs"] = []
    out["compile_ms"] = {"count": 0, "total_ms": 0.0, "max_ms": 0.0,
                         "mean_ms": 0.0}
    out["disk"] = dict.fromkeys(_DISK_KEYS, 0)
    out["disk"].update(enabled=False, dir=None, read_only=False)
    return out


def reset_stats():
    """Zero the counters (cached plans stay)."""
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

"""Process-wide plan cache for Executors.

Counterpart of ``mxnet_tpu/executor_cache.py``.  The JAX package caches
the traced, jitted XLA program of a bind signature; PyTorch runs eagerly,
so what the port builds once per signature is the execution *plan*: the
graph's topological order lowered to a list of op calls over numbered
value slots, with each slot's last use computed so intermediates are
freed as soon as nothing reads them (``executor._Program``).

Entries are keyed by the JAX package's key layout,

    (structural graph hash, arg shapes+dtypes, aux shapes+dtypes,
     gradient names, device, health flag, kernel_signature(device))

and a plan's first run of each kind counts as one "trace"
(``note_trace``), so the serving layer's zero-rebuild warmup check
(``watch_traces``) measures the same event it does in the JAX package:
a bind signature run for the first time.  The health flag
(``MXNET_TPU_HEALTH``, observability/health.py) keys only signatures
that take a gradient: turning the sentinel on costs one new plan, and
turning it off reuses the old one.

A miss whose symbol already has a cached sibling is explained:
``diff_signatures`` names the components that differ, the miss tallies
its primary cause in ``stats()["recompile_causes"]`` and the
``exec_cache.recompile_cause.<cause>`` counter, drops a
``recompile_cause:<cause>`` instant while the profiler records, and logs
one line.  Each plan build opens a memprof program record
(``stats()["programs"]``, ``stats()["compile_ms"]`` over the CUDA-graph
captures); ``disk``, the persistent program cache's counters, stays
empty until that slice.

``MXNET_TPU_EXEC_CACHE=0`` turns sharing off (every bind builds its own
plan, counted as a miss) and ``MXNET_TPU_EXEC_CACHE_SIZE`` bounds the
entries (default 128, least recently used first out), both read at each
bind as in the JAX package.  Hits, misses, evictions and builds are
mirrored into the telemetry registry (``exec_cache.*``) and, while the
profiler records, onto its timeline (counters, and ``recompile:<kind>``
/ ``exec_cache_eviction`` instants).
"""
from __future__ import annotations

import os
import time
from collections import OrderedDict

from . import profiler as _profiler
from . import threads as _threads
from .log import module_logger as _module_logger
from .observability import health as _health
from .observability import memprof as _memprof
from .observability import telemetry as _telemetry
from .ops import kernels as _kernels

_lock = _threads.package_lock("executor_cache._lock")
_entries = OrderedDict()  # key -> _Program, LRU order
_stats = {"hits": 0, "misses": 0, "evictions": 0,
          "traces_fwd": 0, "traces_fwd_bwd": 0, "traces_fused_step": 0}
_recompile_causes = {}  # cause slug -> count (the retrace explainer)
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


def _signature(symbol, arg_dict, aux_dict, device, grad_names, health):
    def sig(d):
        return tuple(sorted((n, tuple(a.shape), str(a.tensor.dtype))
                            for n, a in d.items()))
    return (symbol.structural_hash(), sig(arg_dict), sig(aux_dict),
            tuple(grad_names), str(device), bool(health),
            _kernels.kernel_signature(device))


# -- retrace explainer --------------------------------------------------------
#
# a miss whose symbol already has a cached sibling: the graph did not
# change, so something in the bind signature did, and the rebuild comes
# with a name

# primary-cause priority: the most common and most actionable first
_CAUSE_PRIORITY = ("shapes", "dtypes", "arg_names", "aux_names",
                   "grad_names", "platform", "health", "kernel_flags",
                   "comm_flags")


def _diff_shape_sig(prefix, old_sig, new_sig, causes, details):
    """Diff two sorted (name, shape, dtype) tuples; appends causes
    '<prefix>_names' / 'shapes' / 'dtypes' with one-line details."""
    old_d = {n: (s, d) for n, s, d in old_sig}
    new_d = {n: (s, d) for n, s, d in new_sig}
    if set(old_d) != set(new_d):
        causes.append(prefix + "_names")
        added = sorted(set(new_d) - set(old_d))
        removed = sorted(set(old_d) - set(new_d))
        details.append("%s added=%s removed=%s"
                       % (prefix, added or "[]", removed or "[]"))
    common = sorted(set(old_d) & set(new_d))
    for k, cause in ((0, "shapes"), (1, "dtypes")):
        diffs = [(n, old_d[n][k], new_d[n][k]) for n in common
                 if old_d[n][k] != new_d[n][k]]
        if diffs:
            causes.append(cause)
            n, a, b = diffs[0]
            more = "" if len(diffs) == 1 \
                else " (+%d more)" % (len(diffs) - 1)
            details.append("%s %r: %s -> %s%s" % (prefix, n, a, b, more))


def diff_signatures(old_key, new_key):
    """Explain how two same-symbol cache keys differ.

    Returns ``(primary_cause, all_causes, detail)`` where causes are
    slugs from ``shapes / dtypes / arg_names / aux_names / grad_names /
    platform / health / kernel_flags / comm_flags`` (primary = the
    highest-priority one) and ``detail`` is a one-liner naming the first
    difference per component.  ``(None, [], "")`` when the keys are
    identical.  The key layout is the JAX package's (the device stands in
    its platform slot); a key without the comm component reads as
    overlap off."""
    causes, details = [], []
    _diff_shape_sig("arg", old_key[1], new_key[1], causes, details)
    _diff_shape_sig("aux", old_key[2], new_key[2], causes, details)
    for k, cause, what in ((3, "grad_names", "grad names"),
                           (4, "platform", "platform"),
                           (5, "health", "health sentinel"),
                           (6, "kernel_flags", "kernel flags")):
        if old_key[k] != new_key[k]:
            causes.append(cause)
            a, b = old_key[k], new_key[k]
            if k == 3:
                a, b = list(a), list(b)
            details.append("%s %s -> %s" % (what, a, b))
    old_comm = old_key[7] if len(old_key) > 7 else ()
    new_comm = new_key[7] if len(new_key) > 7 else ()
    if old_comm != new_comm:
        causes.append("comm_flags")
        details.append("comm flags %s -> %s" % (old_comm, new_comm))
    if not causes:
        return None, [], ""
    primary = next(c for c in _CAUSE_PRIORITY if c in causes)
    return primary, causes, "; ".join(details)


def _explain_miss(sibling_key, new_key):
    """A miss with a cached same-symbol sibling: name what changed."""
    primary, causes, detail = diff_signatures(sibling_key, new_key)
    if primary is None:
        return
    with _lock:
        _recompile_causes[primary] = _recompile_causes.get(primary, 0) + 1
    _telemetry.counter(
        "exec_cache.recompile_cause." + primary,
        help="same-symbol cache misses explained by this component").inc()
    _profiler.record_instant(
        "recompile_cause:" + primary, category="exec_cache",
        args={"causes": list(causes), "detail": detail})
    _module_logger(__name__).info(
        "executor cache miss on an already-cached symbol: %s changed "
        "(%s) — this bind builds a new plan", primary, detail)


def _build(symbol, arg_dict, grad_names, health):
    """Build one plan and open its memprof program record."""
    from .executor import _Program
    t0 = time.perf_counter()
    prog = _Program(symbol, {n: a.shape for n, a in arg_dict.items()},
                    health=health, grad_names=grad_names)
    ms = (time.perf_counter() - t0) * 1e3
    label = "%s@%s" % (getattr(symbol, "name", None) or "sym",
                       symbol.structural_hash()[:10])
    prog.memprof_record = _memprof.note_build(
        "fwd_bwd" if grad_names else "fwd", label, trace_ms=ms)
    return prog


def get_program(symbol, arg_dict, aux_dict, device, grad_names=(),
                health=None):
    """The shared plan for this bind signature, built on first sight.
    ``health`` (default: the ``MXNET_TPU_HEALTH`` env) makes the plan's
    training runs pack the health vector and keys the entry; signatures
    that take no gradient never split on it."""
    if health is None:
        health = _health.enabled()
    health = bool(health) and bool(grad_names)
    if not _enabled():
        _note("misses")
        return _build(symbol, arg_dict, grad_names, health)
    key = _signature(symbol, arg_dict, aux_dict, device, grad_names, health)
    sibling_key = None
    with _lock:
        prog = _entries.get(key)
        if prog is not None:
            _entries.move_to_end(key)
            _stats["hits"] += 1
            hits = _stats["hits"]
        else:
            # the most recently used cached signature of the same symbol:
            # the retrace explainer's baseline
            for k in reversed(_entries):
                if k[0] == key[0]:
                    sibling_key = k
                    break
    if prog is not None:
        _telemetry.counter("exec_cache.hits").inc()
        _profiler.record_counter("exec_cache_hits", hits)
        return prog
    if sibling_key is not None:
        _explain_miss(sibling_key, key)
    _note("misses")
    prog = _build(symbol, arg_dict, grad_names, health)
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
    tallies), ``programs`` (memprof's program records: one per plan
    build and per CUDA-graph capture), ``compile_ms`` (the captures'
    summary) and ``disk`` (empty until the persistent program cache)."""
    with _lock:
        out = dict(_stats)
        out["entries"] = len(_entries)
        out["recompile_causes"] = dict(_recompile_causes)
    out["enabled"] = _enabled()
    out["programs"] = _memprof.program_records()
    out["compile_ms"] = _memprof.compile_summary()
    out["disk"] = dict.fromkeys(_DISK_KEYS, 0)
    out["disk"].update(enabled=False, dir=None, read_only=False)
    return out


def reset_stats():
    """Zero the counters (cached plans stay; the program records belong
    to observability.memprof and are reset there)."""
    with _lock:
        for k in _stats:
            _stats[k] = 0
        _recompile_causes.clear()


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

"""Serving counters, gauges and samples, kept in plain dicts.

Counterpart of the ``record_*`` functions of
``mxnet_tpu/serving/metrics.py``.  The JAX package writes them to its
telemetry registry; the port keeps them here until the observability
slice ports that registry.  Names follow the JAX package's instruments:

- ``serving.requests_total``           admitted requests
- ``serving.rejected_total.<reason>``  typed rejections
- ``serving.batches``                  dispatched batches
- ``serving.padded_rows_total``        padding rows dispatched
- ``serving.request_latency_ms``       submit -> completion, per request
  (and ``.<model>``, the SLO attainment input)
- ``serving.queue_ms``                 submit -> dispatch, per request
- ``serving.dispatch_ms``              executor wall time, per batch
- ``serving.batch_size``               real rows, per batch

Fleet tier (``router.py``):

- ``serving.replica.<i>.dispatches`` / ``.rows`` / ``.dispatch_ms``
- ``serving.replica_quarantined``      replicas quarantined
- ``serving.slo_ms.<model>``           gauge, declared p99 target

Decode tiers (``continuous.py``, ``kv_cache.py``, ``decode.py``):

- ``serving.decode.iterations``, ``.joins``, ``.leaves`` counters and
  ``serving.decode.active_slots`` samples
- ``serving.decode.kv_pages_in_use`` / ``kv_pages_total`` /
  ``kv_pages_high_water`` gauges, ``kv_pages_per_stream`` samples
- ``serving.decode.prefix_lookups`` / ``prefix_hits`` /
  ``kv_evictions`` / ``kv_cow_clones`` counters

Counters are ints, gauges floats; the sample series keep their latest
``MAX_SAMPLES`` observations.  :func:`to_prometheus` renders a snapshot
in the Prometheus text format for the HTTP front end's ``/metrics``.
"""
from __future__ import annotations

import time
from collections import deque

import numpy as np

from .. import threads as _threads

MAX_SAMPLES = 65536

_lock = _threads.package_lock("serving.metrics._lock")
_counters = {}
_gauges = {}
_samples = {}


def _inc(name, n=1):
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


def _set(name, value):
    with _lock:
        _gauges[name] = float(value)


def _observe(name, value):
    with _lock:
        _samples.setdefault(name, deque(maxlen=MAX_SAMPLES)).append(value)


def record_rejection(reason, model=None):
    _inc("serving.rejected_total." + reason)


def record_admitted(n_rows=None, model=None):
    _inc("serving.requests_total")


def record_queue_wait(ms):
    """Accrued queue wait of a request rejected while queued."""
    _observe("serving.queue_ms", ms)


def record_batch(model, bucket, rows):
    _observe("serving.batch_size", rows)
    _inc("serving.padded_rows_total", bucket - rows)
    _inc("serving.batches")


def record_dispatch_ms(ms):
    _observe("serving.dispatch_ms", ms)


def record_request_done(request, t_done=None):
    t_done = time.monotonic() if t_done is None else t_done
    total_ms = (t_done - request.t_submit) * 1e3
    _observe("serving.request_latency_ms", total_ms)
    _observe("serving.request_latency_ms." + request.model, total_ms)
    _observe("serving.queue_ms",
             ((request.t_dispatch or t_done) - request.t_submit) * 1e3)


def record_replica_dispatch(replica, model, rows, ms):
    """Which replica ran a batch, its real rows and its wall time."""
    prefix = "serving.replica.%d." % int(replica)
    _inc(prefix + "dispatches")
    _inc(prefix + "rows", rows)
    _observe(prefix + "dispatch_ms", ms)


def record_replica_quarantined(replica, reason):
    _inc("serving.replica_quarantined")


def record_slo(model, slo_ms):
    """Declared per-model latency SLO (p99 target, ms)."""
    _set("serving.slo_ms." + model, slo_ms)


def record_decode_step(active_slots, joins, leaves):
    """One decode iteration: slot occupancy and membership churn."""
    _inc("serving.decode.iterations")
    _observe("serving.decode.active_slots", active_slots)
    if joins:
        _inc("serving.decode.joins", joins)
    if leaves:
        _inc("serving.decode.leaves", leaves)


def record_kv_pool(used_pages, total_pages, high_water=None):
    """Block-pool occupancy after an alloc/release/evict transition."""
    _set("serving.decode.kv_pages_in_use", used_pages)
    _set("serving.decode.kv_pages_total", total_pages)
    if high_water is not None:
        _set("serving.decode.kv_pages_high_water", high_water)


def record_kv_stream_finished(pages_held):
    """A paged stream finished: its context footprint in pages."""
    _observe("serving.decode.kv_pages_per_stream", int(pages_held))


def record_kv_prefix(lookups=0, hit_pages=0):
    """Prefix-cache outcome at submit: probes made, pages reused."""
    if lookups:
        _inc("serving.decode.prefix_lookups", lookups)
    if hit_pages:
        _inc("serving.decode.prefix_hits", hit_pages)


def record_kv_eviction(n=1):
    _inc("serving.decode.kv_evictions", n)


def record_kv_cow(n=1):
    _inc("serving.decode.kv_cow_clones", n)


def snapshot():
    """{"counters": {name: int}, "gauges": {name: float},
    "samples": {name: [float, ...]}}."""
    with _lock:
        return {"counters": dict(_counters), "gauges": dict(_gauges),
                "samples": {k: list(v) for k, v in _samples.items()}}


def reset():
    with _lock:
        _counters.clear()
        _gauges.clear()
        _samples.clear()


def _prom_name(name):
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def to_prometheus(snap=None):
    """The Prometheus text exposition of a snapshot: counters and gauges
    as themselves, each sample series as a summary (count, sum and the
    0.5/0.9/0.99 quantiles of the kept observations)."""
    snap = snapshot() if snap is None else snap
    lines = []
    for name, value in sorted(snap["counters"].items()):
        n = _prom_name(name)
        lines += ["# TYPE %s counter" % n, "%s %d" % (n, value)]
    for name, value in sorted(snap["gauges"].items()):
        n = _prom_name(name)
        lines += ["# TYPE %s gauge" % n, "%s %r" % (n, value)]
    for name, values in sorted(snap["samples"].items()):
        n = _prom_name(name)
        lines.append("# TYPE %s summary" % n)
        if values:
            for q in (0.5, 0.9, 0.99):
                lines.append('%s{quantile="%s"} %r'
                             % (n, q, float(np.quantile(values, q))))
        lines += ["%s_sum %r" % (n, float(sum(values))),
                  "%s_count %d" % (n, len(values))]
    return "\n".join(lines) + "\n"

"""Serving counters, kept in a plain dict.

Counterpart of the ``record_*`` functions of
``mxnet_tpu/serving/metrics.py`` that this slice's server calls.  The
JAX package writes them to its telemetry registry; the port keeps them
here until the observability slice ports that registry.  Names follow
the JAX package's instruments:

- ``serving.requests_total``           admitted requests
- ``serving.rejected_total.<reason>``  typed rejections
- ``serving.batches``                  dispatched batches
- ``serving.padded_rows_total``        padding rows dispatched
- ``serving.request_latency_ms``       submit -> completion, per request
- ``serving.queue_ms``                 submit -> dispatch, per request
- ``serving.dispatch_ms``              executor wall time, per batch
- ``serving.batch_size``               real rows, per batch

Counters are ints; the ``*_ms`` and ``batch_size`` series keep their
latest ``MAX_SAMPLES`` observations.
"""
from __future__ import annotations

import time
from collections import deque

from .. import threads as _threads

MAX_SAMPLES = 65536

_lock = _threads.package_lock("serving.metrics._lock")
_counters = {}
_samples = {}


def _inc(name, n=1):
    with _lock:
        _counters[name] = _counters.get(name, 0) + n


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
    _observe("serving.request_latency_ms",
             (t_done - request.t_submit) * 1e3)
    _observe("serving.queue_ms",
             ((request.t_dispatch or t_done) - request.t_submit) * 1e3)


def snapshot():
    """{"counters": {name: int}, "samples": {name: [float, ...]}}."""
    with _lock:
        return {"counters": dict(_counters),
                "samples": {k: list(v) for k, v in _samples.items()}}


def reset():
    with _lock:
        _counters.clear()
        _samples.clear()

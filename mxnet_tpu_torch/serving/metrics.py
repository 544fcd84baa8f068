"""Serving telemetry: one place that names every serving instrument.

Counterpart of ``mxnet_tpu/serving/metrics.py``, on the port's metrics
registry (``observability.telemetry``) with the JAX package's names, so
``GET /metrics`` (``telemetry.to_prometheus()``) reads the same in both
packages.  All instrumentation runs on the host, outside any captured
CUDA graph.  Instruments resolve through the registry factories at the
call site — they return the shared no-op handle when
``MXNET_TPU_TELEMETRY=0``, and re-resolve automatically across
``telemetry.reset()`` because nothing is cached here.

Naming contract:

- ``serving.request_latency_ms``  histogram, submit -> completion
- ``serving.queue_ms``            histogram, submit -> batch dispatch
  (REJECTED-while-queued requests feed it too, with their accrued
  wait — a queue that is shedding must not look healthy because only
  survivors report)
- ``serving.dispatch_ms``         histogram, executor run per batch
- ``serving.batch_size``          histogram, real (unpadded) rows
- ``serving.request_rows``        histogram, rows per ADMITTED request
  (admission-time, pre-batching — the traffic shape; ``batch_size``
  only exists post-dispatch and mixes co-batched requests)
- ``serving.request_rows.<model>``  the same, per model (a shared
  server mixes traffic shapes)
- ``serving.padded_rows_total``   counter, padding rows added
- ``serving.batches``             counter, dispatched batches
- ``serving.requests_total``      counter, admitted requests
- ``serving.rejected_total.<reason>``  counter per typed rejection
- ``serving.queue_depth``         gauge (live callback)

Fleet tier:

- ``serving.replica.<i>.dispatches``   counter, batches run by replica i
- ``serving.replica.<i>.rows``         counter, real rows served by i
- ``serving.replica.<i>.dispatch_ms``  histogram, executor wall per batch
- ``serving.replica_quarantined``      counter, replicas quarantined
- ``serving.replicas``                 gauge (live callback), fleet size
- ``serving.request_latency_ms.<model>``  histogram, per-model latency
  (the SLO attainment input — the process-wide histogram mixes models)
- ``serving.slo_ms.<model>``           gauge, declared p99 target
- ``serving.decode.iterations``        counter, continuous-batcher steps
- ``serving.decode.active_slots``      histogram, occupancy per step
- ``serving.decode.joins`` / ``serving.decode.leaves``  counters

Paged-KV tier (``serving/kv_cache.py`` + ``serving/decode.py``):

- ``serving.decode.kv_pages_in_use``     gauge, pages held
  (active + prefix-cached idle)
- ``serving.decode.kv_pages_total``      gauge, pool capacity in pages
- ``serving.decode.kv_pages_high_water`` gauge, most pages ever held
- ``serving.decode.kv_pages_per_stream`` histogram, pages a stream
  held at finish (its context footprint in page units)
- ``serving.decode.prefix_lookups``      counter, submit-time prefix
  probes
- ``serving.decode.prefix_hits``         counter, pages reused from
  the prefix cache (prompt tokens NOT recomputed)
- ``serving.decode.kv_evictions``        counter, cached pages evicted
  to satisfy an allocation
- ``serving.decode.kv_cow_clones``       counter, shared pages cloned
  copy-on-write before a divergent append

Trace events (category ``serving``): per-request ``serving:request``
spans with a nested ``serving:queue`` phase, per-batch ``serving:batch``
spans with a nested ``serving:dispatch`` phase, and
``serving_reject:<reason>`` instants.
"""
from __future__ import annotations

import time
import weakref

from .. import threads as _threads
from ..observability import telemetry, tracing


def record_rejection(reason, model=None):
    """Count one typed rejection and drop a trace instant — the single
    choke point every rejection path (submit-time raise, queued-deadline
    expiry, HTTP mapping) goes through."""
    telemetry.counter("serving.rejected_total." + reason,
                      help="requests rejected with %s" % reason).inc()
    if tracing.is_recording():
        args = {"model": model} if model else None
        tracing.emit_instant("serving_reject:" + reason,
                             category="serving", args=args)


def record_admitted(n_rows=None, model=None):
    telemetry.counter("serving.requests_total",
                      help="requests admitted to the queue").inc()
    if n_rows is not None:
        # per-request row count at admission: the observed traffic
        # shape, process-wide and per model (different models see
        # different traffic; one series per registered model, the
        # rejected_total.<reason> pattern)
        telemetry.histogram(
            "serving.request_rows",
            help="rows per admitted request (pre-batching)"
        ).observe(n_rows)
        if model:
            telemetry.histogram(
                "serving.request_rows." + model,
                help="rows per admitted request for one model"
            ).observe(n_rows)
    # re-arm the function gauge: set_function state does NOT survive
    # telemetry.reset() the way the counter/histogram factories above do
    # (they re-create per call site; the gauge callback was installed
    # once at Server construction).  Every admission is a cheap, natural
    # point to restore it for all live servers.
    _ensure_queue_gauge()


def record_queue_wait(ms):
    """Accrued queue wait of a request REJECTED at the queued stage
    (deadline sweep, drain shed).  Served requests record theirs in
    :func:`record_request_done`; without this, the queue histogram
    sees only survivors and looks healthiest exactly when the server
    is shedding its slowest waiters."""
    telemetry.histogram("serving.queue_ms",
                        help="submit->dispatch queue wait").observe(ms)


def record_batch(model, bucket, rows):
    """Per-dispatched-batch facts: real rows (the batch-size
    distribution) and padding overhead."""
    telemetry.histogram("serving.batch_size",
                        help="real rows per dispatched batch").observe(rows)
    telemetry.counter("serving.padded_rows_total",
                      help="padding rows dispatched").inc(bucket - rows)
    telemetry.counter("serving.batches",
                      help="batches dispatched").inc()


def record_dispatch_ms(ms):
    telemetry.histogram("serving.dispatch_ms",
                        help="executor wall time per batch").observe(ms)


def record_replica_dispatch(replica, model, rows, ms):
    """Per-replica routing facts (fleet tier): which replica ran the
    batch, how many real rows it served, and its executor wall time.
    Cardinality is one series set per replica — replica counts are
    single digits, the rejected_total.<reason> pattern."""
    prefix = "serving.replica.%d." % int(replica)
    telemetry.counter(prefix + "dispatches",
                      help="batches dispatched to this replica").inc()
    telemetry.counter(prefix + "rows",
                      help="real rows served by this replica").inc(rows)
    telemetry.histogram(prefix + "dispatch_ms",
                        help="executor wall time per batch on this "
                             "replica").observe(ms)


def record_replica_quarantined(replica, reason):
    """A replica threw and was quarantined (drained, not the server)."""
    telemetry.counter("serving.replica_quarantined",
                      help="replicas quarantined after a dispatch "
                           "failure").inc()
    if tracing.is_recording():
        tracing.emit_instant("serving_replica_quarantined",
                             category="serving",
                             args={"replica": int(replica),
                                   "reason": reason})


def record_slo(model, slo_ms):
    """Declared per-model latency SLO (p99 target, ms) — a gauge, so a
    reader can compare observed quantiles against the declared target
    from a telemetry snapshot alone."""
    telemetry.gauge("serving.slo_ms." + model,
                    help="declared p99 latency target (ms)").set(
        float(slo_ms))


def record_decode_step(active_slots, joins, leaves):
    """One continuous-batcher iteration: slot occupancy + membership
    churn (serving/continuous.py)."""
    telemetry.counter("serving.decode.iterations",
                      help="continuous-batcher iterations").inc()
    telemetry.histogram("serving.decode.active_slots",
                        help="occupied slots per iteration").observe(
        active_slots)
    if joins:
        telemetry.counter("serving.decode.joins",
                          help="streams joined a slot").inc(joins)
    if leaves:
        telemetry.counter("serving.decode.leaves",
                          help="streams left at EOS").inc(leaves)


def record_kv_pool(used_pages, total_pages, high_water=None):
    """Block-pool occupancy after an alloc/release/evict transition
    (gauges: the current truth, not a rate)."""
    telemetry.gauge("serving.decode.kv_pages_in_use",
                    help="KV pool pages held (active + prefix-cached)"
                    ).set(int(used_pages))
    telemetry.gauge("serving.decode.kv_pages_total",
                    help="KV pool capacity in pages").set(int(total_pages))
    if high_water is not None:
        telemetry.gauge("serving.decode.kv_pages_high_water",
                        help="most KV pool pages ever held").set(
            int(high_water))


def record_kv_stream_finished(pages_held):
    """A paged stream finished: its context footprint in page units."""
    telemetry.histogram("serving.decode.kv_pages_per_stream",
                        help="pages a stream held at finish").observe(
        int(pages_held))


def record_kv_prefix(lookups=0, hit_pages=0):
    """Prefix-cache outcome at submit: probes made and pages reused
    (every reused page is page_size prompt tokens NOT recomputed)."""
    if lookups:
        telemetry.counter("serving.decode.prefix_lookups",
                          help="prefix-cache probes at submit").inc(lookups)
    if hit_pages:
        telemetry.counter("serving.decode.prefix_hits",
                          help="pages reused from the prefix cache").inc(
            hit_pages)


def record_kv_eviction(n=1):
    """Refcount-0 cached pages evicted (LRU) to satisfy an alloc."""
    telemetry.counter("serving.decode.kv_evictions",
                      help="prefix-cached pages evicted for space").inc(n)


def record_kv_cow(n=1):
    """Shared pages cloned copy-on-write before a divergent append."""
    telemetry.counter("serving.decode.kv_cow_clones",
                      help="shared KV pages cloned copy-on-write").inc(n)


def record_nonfinite_response(model, n_outputs):
    """Served-output health (``MXNET_TPU_HEALTH=1``): a dispatched batch
    produced non-finite values in ``n_outputs`` of its outputs.  The
    responses still ship (a caller may legitimately serve inf logits),
    but the counter and the instant make a poisoned model visible."""
    telemetry.counter("serving.nonfinite_responses",
                      help="batches with non-finite output values").inc()
    if tracing.is_recording():
        tracing.emit_instant("serving_nonfinite", category="serving",
                             args={"model": model,
                                   "outputs": n_outputs})


def record_request_done(request, t_done=None):
    """Request completed (at ``t_done``, by default now): latency histograms + the request/queue spans.
    Spans are emitted from the dispatch thread with explicit timestamps
    (the queue phase crosses threads, so context-manager nesting cannot
    express it); ids link queue under request the way StepTracker links
    components under a step."""
    t_done = time.monotonic() if t_done is None else t_done
    queue_s = (request.t_dispatch or t_done) - request.t_submit
    total_s = t_done - request.t_submit
    telemetry.histogram("serving.request_latency_ms",
                        help="submit->completion wall time"
                        ).observe(total_s * 1e3)
    # per-model latency: the SLO attainment input (a declared target is
    # per model; the process-wide histogram mixes models behind one
    # shared server)
    telemetry.histogram("serving.request_latency_ms." + request.model,
                        help="submit->completion wall time for one model"
                        ).observe(total_s * 1e3)
    telemetry.histogram("serving.queue_ms",
                        help="submit->dispatch queue wait"
                        ).observe(queue_s * 1e3)
    if tracing.is_recording():
        now_us = tracing.now_us()
        t0_us = now_us - total_s * 1e6
        span_id = next(tracing._span_ids)
        tracing.emit_complete(
            "serving:request", t0_us, total_s * 1e6, category="serving",
            pid="serving", args={"span_id": span_id,
                                 "model": request.model,
                                 "rows": request.n_rows})
        tracing.emit_complete(
            "serving:queue", t0_us, queue_s * 1e6, category="serving",
            pid="serving", args={"parent_id": span_id})


# weakrefs: the gauge must not keep a closed Server's admission
# controller (and its queue) alive, and a second Server must add to the
# reading, not silently replace the first's.  The lock keeps a snapshot
# taken on one thread from discarding a registration racing in on
# another (the rebuild in _total_queued would lose the append).
_queue_sources = []
_queue_sources_lock = _threads.package_lock("_queue_sources_lock")


def _total_queued():
    total = 0
    with _queue_sources_lock:
        live = []
        for ref in _queue_sources:
            admission = ref()
            if admission is not None:
                live.append(ref)
        _queue_sources[:] = live
    for ref in live:
        admission = ref()
        if admission is not None:
            total += admission.pending()
    return total


def _ensure_queue_gauge():
    """(Re-)install the queue-depth callback on whatever gauge instance
    the registry currently holds — idempotent, and the recovery path
    after ``telemetry.reset()`` discards the instance that was armed at
    registration time."""
    telemetry.gauge("serving.queue_depth",
                    help="requests waiting for a batch slot, all servers"
                    ).set_function(_total_queued)


def register_queue_gauge(admission):
    """Live queue-depth gauge (function gauge: sampled at snapshot
    time, free otherwise).  Process-wide: reports the TOTAL requests
    queued across every live Server's admission controller."""
    with _queue_sources_lock:
        _queue_sources.append(weakref.ref(admission))
    _ensure_queue_gauge()


def register_replica_gauge(group):
    """Live fleet-size gauge (``serving.replicas``): shed rate and queue
    depth read against the replica count that produced them.  Weakly
    referenced, same lifetime contract as the queue gauge."""
    ref = weakref.ref(group)
    telemetry.gauge("serving.replicas",
                    help="replicas behind the fleet admission queue"
                    ).set_function(
        lambda: len(ref()) if ref() is not None else 0)

"""Hot-path instrumentation used by the framework itself.

Counterpart of ``mxnet_tpu/observability/instrument.py``.  Everything
here runs on the host, outside a captured CUDA graph: adding or removing
instrumentation adds no launch and no synchronize to a step, and never
changes a plan (the executor cache's build counters hold that line).

- ``StepTracker``: the per-step breakdown behind ``BaseModule.fit``.
  Each training step decomposes into the five components a production
  stack asks about first — ``data_wait`` (input starvation),
  ``fwd_bwd_dispatch``, ``update``, ``metric``, ``sync`` — each emitted
  as a child span of an enclosing ``step`` span and observed into
  fixed-bucket histograms.  The step span's extent is [first component
  start, last component end], so the components cover it up to pure
  python glue.
- ``note_io_wait``: every ``DataIter.__next__`` reports how long the
  consumer waited for the batch (the numerator of the input-starvation
  ratio).
- ``record_kv``: kvstore push/pull bytes + latency.
- ``sample_device_memory``: the live-bytes + peak-bytes gauges, sampled
  every ``MXNET_TPU_MEM_SAMPLE_STEPS`` steps (default 10) by the
  tracker (and on demand); the latest sample is kept host-side
  (``last_memory_sample``) for post-mortem step records.
"""
from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np

from . import telemetry
from . import tracing

# device-memory gauge sampling cadence, in training steps (the
# MXNET_TPU_MEM_SAMPLE_STEPS default; MEM_SAMPLE_INTERVAL is the
# historical name, kept as an alias)
DEFAULT_MEM_SAMPLE_STEPS = 10
MEM_SAMPLE_INTERVAL = DEFAULT_MEM_SAMPLE_STEPS
_MEM_STEPS_ENV = "MXNET_TPU_MEM_SAMPLE_STEPS"
_mem_env_warned = False


def mem_sample_steps():
    """The device-memory sampling cadence in training steps: the
    ``MXNET_TPU_MEM_SAMPLE_STEPS`` env (clamped to >= 1), default 10.
    A malformed value warns once and falls back to the default — the
    same never-take-the-run-down posture as ``MXNET_TPU_FLIGHT_STEPS``.
    Re-read per ``StepTracker`` (i.e. per epoch), so tests and tools
    can flip it without a process restart."""
    global _mem_env_warned
    raw = os.environ.get(_MEM_STEPS_ENV, "")
    if not raw:
        return DEFAULT_MEM_SAMPLE_STEPS
    try:
        return max(1, int(raw))
    except ValueError:
        if not _mem_env_warned:
            _mem_env_warned = True
            logging.getLogger("mxnet_tpu_torch").warning(
                "ignoring malformed %s=%r (want an integer); using %d",
                _MEM_STEPS_ENV, raw, DEFAULT_MEM_SAMPLE_STEPS)
        return DEFAULT_MEM_SAMPLE_STEPS

STEP_COMPONENTS = ("data_wait", "fwd_bwd_dispatch", "update", "metric",
                   "sync")


class _NoopComponent:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_CM = _NoopComponent()


class _Component:
    """Times one component occurrence; accumulates into the tracker and
    emits a ``step:<name>`` child span when the profiler is recording."""

    __slots__ = ("_tracker", "_name", "_t0")

    def __init__(self, tracker, name):
        self._tracker = tracker
        self._name = name

    def __enter__(self):
        self._t0 = tracing.now_us()
        if self._tracker._step_t0 is None:
            self._tracker._step_t0 = self._t0
        return self

    def __exit__(self, *exc):
        t1 = tracing.now_us()
        tracker = self._tracker
        tracker._parts[self._name] += t1 - self._t0
        tracker._last_end = t1
        if tracing.is_recording():
            tracing.emit_complete(
                "step:" + self._name, self._t0, t1 - self._t0,
                category="step", pid=tracker.pid,
                args={"parent_id": tracker._step_span_id})
        return False


class StepTracker:
    """Per-step breakdown over one epoch of a training loop.

    Usage (the shape ``BaseModule._run_epoch`` drives)::

        tracker = StepTracker(epoch=epoch)
        with tracker.component("data_wait"):
            batch = next(it)
        with tracker.component("fwd_bwd_dispatch"):
            module.forward_backward(batch)
        ...
        tracker.step_end(nbatch)

    ``component`` calls may repeat within a step ("sync" does); the
    durations accumulate.  ``step_end`` emits the enclosing ``step``
    span (complete event spanning first-component-start to
    last-component-end, with per-component millisecond args), feeds the
    histograms, and samples the device-memory gauges every
    ``MXNET_TPU_MEM_SAMPLE_STEPS`` steps (default 10).
    """

    def __init__(self, epoch=0, pid="train"):
        self.epoch = epoch
        self.pid = pid
        self._mem_every = mem_sample_steps()
        self._resolve_handles()
        self._reset_step()

    def _resolve_handles(self):
        """(Re)fetch the registry instruments.  Keyed on the registry
        epoch so a telemetry.reset() mid-epoch (snapshot-then-reset
        scrape loops) re-registers instead of observing into orphaned
        instruments — same contract as the io/kv handle caches."""
        self._handle_key = (telemetry.registry_epoch(),
                            telemetry.enabled())
        # disabled telemetry hands back no-op instruments; component()
        # then short-circuits entirely unless the profiler is recording
        self._hists = {c: telemetry.histogram(
            "module.step.%s_ms" % c,
            help="per-step %s time" % c) for c in STEP_COMPONENTS}
        self._hist_total = telemetry.histogram(
            "module.step.total_ms", help="measured step wall time")
        self._steps = telemetry.counter(
            "module.steps", help="training steps observed")
        self._mem_gauge = telemetry.gauge(
            "device.live_bytes", help="live device memory (sampled)")
        self._peak_gauge = telemetry.gauge(
            "device.peak_bytes",
            help="allocator peak bytes in use (sampled; backends with "
                 "memory_stats only)")
        self._telemetry_on = self._hist_total is not telemetry.NOOP

    def _reset_step(self):
        self._parts = {c: 0.0 for c in STEP_COMPONENTS}
        self._step_t0 = None
        self._last_end = None
        self._step_span_id = None

    def component(self, name):
        if not (self._telemetry_on or tracing.is_recording()):
            # both sinks off: the whole step costs one flag check per
            # component (the module's zero-cost-when-disabled contract)
            return _NOOP_CM
        if self._step_span_id is None:
            # allocate the step's span id lazily at first component so
            # children can link to a parent that is emitted after them
            self._step_span_id = next(tracing._span_ids)
        return _Component(self, name)

    def step_end(self, nbatch):
        """Close out the step.  Returns the per-component millisecond
        breakdown (plus ``total``) so callers can keep the last-N of them, or None when no component ran."""
        if self._step_t0 is None:
            return None
        if self._handle_key != (telemetry.registry_epoch(),
                                telemetry.enabled()):
            self._resolve_handles()
        dur = self._last_end - self._step_t0
        args = {"span_id": self._step_span_id, "step": nbatch,
                "epoch": self.epoch}
        timings = {}
        for c in STEP_COMPONENTS:
            ms = self._parts[c] / 1e3
            args[c + "_ms"] = timings[c] = round(ms, 4)
            self._hists[c].observe(ms)
        timings["total"] = round(dur / 1e3, 4)
        self._hist_total.observe(dur / 1e3)
        self._steps.inc()
        if tracing.is_recording():
            tracing.emit_complete("step", self._step_t0, dur,
                                  category="step", pid=self.pid,
                                  args=args)
        if nbatch % self._mem_every == 0 \
                and (self._telemetry_on or tracing.is_recording()):
            # the allocator query is a host call per device — never pay
            # it when nobody is listening
            sample_device_memory(self._mem_gauge, self._peak_gauge)
        self._reset_step()
        return timings


# the most recent device-memory sample, host-side: step records carry
# it so post-mortem dumps show the memory trend leading into an anomaly
_last_mem_sample = None


def sample_device_memory(gauge=None, peak_gauge=None):
    """Total live device bytes: the CUDA caching allocator's
    ``allocated_bytes.all.current`` summed over the visible cards
    (``torch.cuda.memory_stats``; the JAX package reads its backend's
    ``memory_stats`` or sums ``jax.live_arrays``).  Sets the
    ``device.live_bytes`` gauge and the ``device.peak_bytes`` gauge (the
    allocator's ``allocated_bytes.all.peak``), drops counter samples onto
    the trace timeline, stashes the sample for ``last_memory_sample``,
    and returns the live byte count.  A host without a card reports 0
    live bytes and no peak."""
    global _last_mem_sample
    total = 0
    peak = None
    try:
        import torch
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            for i in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(i)
                total += int(stats.get("allocated_bytes.all.current", 0))
                peak = (peak or 0) + int(
                    stats.get("allocated_bytes.all.peak", 0))
    except Exception:
        return 0
    if gauge is None:
        gauge = telemetry.gauge("device.live_bytes",
                                help="live device memory (sampled)")
    gauge.set(total)
    tracing.emit_counter("device_live_bytes", total, category="memory")
    if peak is not None:
        if peak_gauge is None:
            peak_gauge = telemetry.gauge(
                "device.peak_bytes",
                help="allocator peak bytes in use (sampled; backends "
                     "with memory_stats only)")
        peak_gauge.set(peak)
        tracing.emit_counter("device_peak_bytes", peak, category="memory")
    _last_mem_sample = {"live_bytes": total, "peak_bytes": peak,
                        "t": time.time()}
    return total


def last_memory_sample():
    """The most recent ``sample_device_memory`` result as
    ``{live_bytes, peak_bytes, t}`` (None before the first sample).
    ``peak_bytes`` is None on backends without allocator stats."""
    return dict(_last_mem_sample) if _last_mem_sample else None


# per-batch handles, memoized against the registry epoch + enabled flag
# so the io hot path skips the registry lock (and telemetry.reset() in
# tests still invalidates the cache)
_io_cache = (None, None)


def note_io_wait(seconds):
    """One next-batch wait observed by a DataIter consumer (pooled
    across iterators — the starvation question is per-process)."""
    global _io_cache
    key = (telemetry.registry_epoch(), telemetry.enabled())
    cached_key, handles = _io_cache
    if cached_key != key:
        handles = (
            telemetry.histogram("io.next_batch_wait_ms",
                                help="time blocked waiting for a batch"),
            telemetry.counter("io.batches",
                              help="batches produced by DataIters"),
            telemetry.counter("io.next_batch_wait_total_ms",
                              help="cumulative next-batch wait"))
        _io_cache = (key, handles)
    hist, n_batches, total = handles
    ms = seconds * 1e3
    hist.observe(ms)
    n_batches.inc()
    total.inc(ms)


# io_pipeline handles, memoized like the io cache above: the pipeline's
# consumer wait is the per-stage starvation signal (queue_wait), decode
# and h2d histograms attribute where batch time goes, and h2d_ahead
# counts uploads issued under the previous step's compute (the overlap
# contract)
_pipe_cache = (None, None)


def _pipeline_handles():
    global _pipe_cache
    key = (telemetry.registry_epoch(), telemetry.enabled())
    cached_key, handles = _pipe_cache
    if cached_key != key:
        handles = {
            "queue_wait": telemetry.histogram(
                "io_pipeline.queue_wait_ms",
                help="consumer time blocked waiting on pipeline "
                     "output (the starvation numerator)"),
            "decode": telemetry.histogram(
                "io_pipeline.decode_ms",
                help="per-batch read+decode+assemble time (worker-side)"),
            "h2d": telemetry.histogram(
                "io_pipeline.h2d_ms",
                help="host time issuing the device_put (transfer is "
                     "async)"),
            "batches": telemetry.counter(
                "io_pipeline.batches", help="batches produced"),
            "records": telemetry.counter(
                "io_pipeline.records", help="records decoded"),
            "h2d_ahead": telemetry.counter(
                "io_pipeline.h2d_ahead_total",
                help="uploads issued ahead of consumption (overlapped "
                     "with compute)"),
        }
        _pipe_cache = (key, handles)
    return handles


# waits taken while ARMING an epoch (adapter priming at reset) happen
# outside the fit loop's steps by design — counting them would inflate
# the starvation ratio on healthy runs, so the adapter suppresses them
# for its (consumer) thread while it primes
_pipe_tls = threading.local()


class suppress_pipeline_wait:
    """Context manager: waits on this thread are not starvation."""

    def __enter__(self):
        self._prev = getattr(_pipe_tls, "suppress", False)
        _pipe_tls.suppress = True
        return self

    def __exit__(self, *exc):
        _pipe_tls.suppress = self._prev
        return False


def note_pipeline_wait(seconds):
    """One consumer wait on the pipeline's reorder buffer (the
    numerator of the pipeline starvation ratio).  Returns False when
    suppressed (arm-time priming) so callers skip the matching span."""
    if getattr(_pipe_tls, "suppress", False):
        return False
    h = _pipeline_handles()
    h["queue_wait"].observe(seconds * 1e3)
    h["batches"].inc()
    return True


def note_pipeline_decode(seconds, records):
    h = _pipeline_handles()
    h["decode"].observe(seconds * 1e3)
    h["records"].inc(records)


def note_pipeline_h2d(seconds):
    _pipeline_handles()["h2d"].observe(seconds * 1e3)


def note_pipeline_h2d_ahead():
    _pipeline_handles()["h2d_ahead"].inc()


# generation counter for the pipeline gauges: the gauges are
# process-wide (like every io_pipeline series), so when several runs
# are live the LAST-ARMED one owns them; a run tearing down must only
# zero them if it is still the owner (disarm_pipeline_gauges), or an
# ending eval run would stomp the live train run's gauges
_pipe_gauge_token = 0


def arm_pipeline_gauges(task_depth_fn, reorder_fill_fn):
    """Wire the live per-stage queue-depth gauges to the current epoch
    run.  Re-armed at every run start so the gauges survive a
    telemetry.reset() between epochs; returns a token for
    `disarm_pipeline_gauges`."""
    global _pipe_gauge_token
    _pipe_gauge_token += 1
    telemetry.gauge(
        "io_pipeline.task_queue_depth",
        help="tasks parked for workers").set_function(task_depth_fn)
    telemetry.gauge(
        "io_pipeline.reorder_fill",
        help="completed batches held for in-order release"
    ).set_function(reorder_fill_fn)
    return _pipe_gauge_token


def disarm_pipeline_gauges(token):
    """Zero the gauges (dropping their closures' references to the
    run's queues) — only if ``token`` still owns them."""
    if token == _pipe_gauge_token:
        arm_pipeline_gauges(lambda: 0, lambda: 0)


# -- gradient-collective (comm) accounting -----------------------------------
#
# Two kinds of gradient communication exist after the overlap work
# (parallel/comm.py):
#
# - EXPOSED: host-driven kvstore collectives (dist push/pull, tpu_ici
#   push_pull) — the step waits on them, so their wall time is real
#   exposed comm; recorded with bytes + latency + a ``comm:<op>`` span.
# - OVERLAPPED: in-program bucketed collectives inside the fused train
#   step — no host-observable latency (they ride under the backward),
#   so only their per-step wire bytes are recorded, from the static
#   CommPlan.
#
# ``comm.bytes_total`` sums both; ``comm.exposed_ms`` only ever grows
# from the exposed path — a training setup whose exposed_ms is ~0 while
# overlapped_bytes grows is the overlap win.
_comm_cache = (None, None)


def _comm_handles():
    global _comm_cache
    key = (telemetry.registry_epoch(), telemetry.enabled())
    cached_key, handles = _comm_cache
    if cached_key != key:
        handles = {
            "bytes_total": telemetry.counter(
                "comm.bytes_total",
                help="gradient-collective payload bytes contributed by "
                     "this worker (exposed + overlapped)"),
            "exposed_bytes": telemetry.counter(
                "comm.exposed_bytes",
                help="bytes moved by host-driven (exposed) collectives"),
            "exposed_ms": telemetry.histogram(
                "comm.exposed_ms",
                help="wall time the step spent blocked on exposed "
                     "collectives"),
            "overlapped_bytes": telemetry.counter(
                "comm.overlapped_bytes",
                help="bytes moved by in-program bucketed collectives "
                     "(overlapped with backward)"),
            "compressed_saved_bytes": telemetry.counter(
                "comm.compressed_saved_bytes",
                help="f32-equivalent bytes NOT moved thanks to 2-bit "
                     "compression"),
            "steps": telemetry.counter(
                "comm.steps", help="training steps with in-program "
                                   "bucketed collectives"),
        }
        _comm_cache = (key, handles)
    return handles


def note_comm_overlapped(plan):
    """One fused-step dispatch with in-program bucketed collectives:
    account the plan's wire bytes (host-side; zero traced-program
    effect).  ``plan`` is a ``parallel.comm.CommPlan``.  The trace
    counter carries the PER-STEP bytes (samples sum to the window's
    total), so a trace window never inherits a prior session's
    cumulative value."""
    if not (telemetry.enabled() or tracing.is_recording()):
        return
    h = _comm_handles()
    h["bytes_total"].inc(plan.wire_bytes)
    h["overlapped_bytes"].inc(plan.wire_bytes)
    h["steps"].inc()
    if plan.compress:
        h["compressed_saved_bytes"].inc(plan.grad_f32_bytes
                                        - plan.wire_bytes)
    if tracing.is_recording():
        tracing.emit_counter("comm_overlapped_bytes", plan.wire_bytes,
                             category="comm")


def record_comm_exposed(op, nbytes, seconds, store_type):
    """One host-driven (exposed) collective: bytes + blocked wall time
    + a ``comm:<op>`` span on the trace timeline."""
    if not (telemetry.enabled() or tracing.is_recording()):
        return
    h = _comm_handles()
    h["bytes_total"].inc(nbytes)
    h["exposed_bytes"].inc(nbytes)
    h["exposed_ms"].observe(seconds * 1e3)
    if tracing.is_recording():
        t1 = tracing.now_us()
        tracing.emit_complete("comm:" + op, t1 - seconds * 1e6,
                              seconds * 1e6, category="comm",
                              args={"bytes": nbytes, "store": store_type})


# push/pull handles, memoized per op against the registry epoch +
# enabled flag (kvstore traffic is per key-batch per step — same
# registry-lock-avoidance as the io cache above)
_kv_cache = (None, {})


def _kv_handles(op):
    global _kv_cache
    key = (telemetry.registry_epoch(), telemetry.enabled())
    cached_key, by_op = _kv_cache
    if cached_key != key:
        by_op = {}
        _kv_cache = (key, by_op)
    handles = by_op.get(op)
    if handles is None:
        handles = (
            telemetry.counter("kvstore.%s_bytes" % op,
                              help="payload bytes moved by %s" % op),
            telemetry.histogram("kvstore.%s_ms" % op,
                                help="%s wall latency" % op))
        by_op[op] = handles
    return handles


def record_kv(op, payload, seconds, store_type):
    """One kvstore push/pull: payload bytes + wall latency.  Takes the
    raw payload (NDArray / nested lists) and only walks its shapes when
    a sink is actually listening."""
    if not (telemetry.enabled() or tracing.is_recording()):
        return
    nbytes = payload_nbytes(payload)
    ms = seconds * 1e3
    bytes_counter, latency_hist = _kv_handles(op)
    bytes_counter.inc(nbytes)
    latency_hist.observe(ms)
    if tracing.is_recording():
        t1 = tracing.now_us()
        tracing.emit_complete("kvstore_" + op, t1 - seconds * 1e6,
                              seconds * 1e6, category="kvstore",
                              args={"bytes": nbytes,
                                    "store": store_type})


def payload_nbytes(value):
    """Total bytes of an NDArray / nested list-of-NDArrays payload
    (host-side metadata walk; no device sync)."""
    total = 0
    stack = [value]
    while stack:
        v = stack.pop()
        if isinstance(v, (list, tuple)):
            stack.extend(v)
            continue
        shape = getattr(v, "shape", None)
        if shape is None:
            continue
        n = 1
        for d in shape:
            n *= int(d)
        dtype = getattr(v, "dtype", None)
        try:
            itemsize = getattr(dtype, "itemsize", None) \
                or (np.dtype(dtype).itemsize if dtype is not None else 4)
        except TypeError:
            itemsize = 4
        total += n * itemsize
    return total

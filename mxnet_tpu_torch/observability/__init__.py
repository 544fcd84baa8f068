"""Runtime telemetry (ref: src/engine/profiler.{h,cc} and the metrics and
logging surface of MXNet 1.0), the counterpart of
``mxnet_tpu/observability/``.

Three layers, lowest first:

- ``tracing``: the structured trace-event sink: nested spans with
  parent/child links over a thread-local span stack, Chrome "X"
  complete-events with real thread ids, instant events (plan builds,
  evictions), counter samples.  ``mxnet_tpu_torch.profiler`` is the
  reference-compatible facade over this buffer.
- ``telemetry``: the process-wide metrics registry: named Counter /
  Gauge / Histogram (fixed log2 buckets, no numpy in the hot path) with
  ``snapshot()`` plus Prometheus-text and JSON-lines exporters.
  ``MXNET_TPU_TELEMETRY=0`` hands out shared no-op instruments instead.
- ``instrument``: the hot-path helpers the framework itself uses: the
  per-step breakdown tracker driving ``BaseModule.fit`` (data_wait /
  fwd_bwd_dispatch / update / metric / sync), the input-starvation
  accounting behind ``io.DataIter``, kvstore push/pull bytes and
  latency, and the device-memory gauges over ``torch.cuda``.

Every call site stays outside a captured CUDA graph: instrumentation adds
no launch and no synchronize to a step.
"""
from __future__ import annotations

from . import tracing
from . import telemetry
from . import instrument
from .tracing import span, emit_instant
from .telemetry import counter, gauge, histogram, snapshot

__all__ = ["tracing", "telemetry", "instrument", "span", "emit_instant",
           "counter", "gauge", "histogram", "snapshot"]

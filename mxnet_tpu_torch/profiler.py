"""Profiler (ref: src/engine/profiler.{h,cc} + python/mxnet/profiler.py).

Counterpart of ``mxnet_tpu/profiler.py``: a reference-compatible facade
over ``mxnet_tpu_torch.observability.tracing``:

- op-span layer: framework events (imperative invokes, executor
  dispatches, engine pipeline stages, per-step breakdown) recorded as
  nested Chrome "X" complete-events with real thread ids and
  parent/child span links, dumped as Chrome trace-event JSON
  (chrome://tracing / Perfetto), format-compatible with the reference's
  DumpProfile (profiler.cc:147).  The old B/E pair encoding collided on
  nested or concurrent same-name spans (one ``open_ts`` slot per name —
  re-entry silently overwrote it); complete events carry their own
  ``dur`` so ``aggregate_stats`` cannot be corrupted.
- device layer: ``torch.profiler`` traces with CUDA activities for
  kernel-level detail.  The names stay ``start_jax_trace`` /
  ``stop_jax_trace`` so the same user code runs in both packages; the
  port writes a Chrome trace JSON under ``logdir`` where the JAX package
  writes an XPlane trace.

``MXNET_TPU_PROFILER_AUTOSTART=1`` starts recording at import and dumps
at interpreter exit (parity: MXNET_PROFILER_AUTOSTART, profiler.cc's
autostart), so a run can be traced without touching its code.
"""
from __future__ import annotations

import atexit
import json
import os
import threading

from .observability import tracing as _tracing

_state = {"mode": "symbolic", "filename": "profile.json"}


def profiler_set_config(mode="symbolic", filename="profile.json"):
    _state["mode"] = mode
    _state["filename"] = filename


def profiler_set_state(state="stop"):
    if state == "run":
        _tracing.set_recording(True)
    else:
        _tracing.set_recording(False)
        dump_profile()


def is_running():
    return _tracing.is_recording()


def op_spans_enabled():
    """Per-op spans record only in 'all' mode (ref: kAllOperator vs
    kOnlySymbolic, profiler.h:94-121) — they synchronize the op's stream
    after each op for accurate timing, so symbolic mode leaves the
    asynchronous launches intact."""
    return _state["mode"] in ("all", "all_operator")


def record_event(name, start_us, end_us, category="operator", dev="cpu/0",
                 tid=None):
    """One completed span with known endpoints — a Chrome "X" event.
    ``tid`` defaults to the REAL calling thread id (the old hardcoded 0
    merged every thread onto one track and collided concurrent
    same-name spans in ``aggregate_stats``)."""
    if tid in (None, 0):
        tid = threading.get_ident()
    _tracing.emit_complete(name, start_us, end_us - start_us,
                           category=category, pid=dev, tid=tid)


def record_counter(name, value, category="exec_cache", dev="cpu/0"):
    """Chrome trace-event counter sample ("ph": "C") — used by the
    executor program cache to surface hit/miss/trace counts on the same
    timeline as the execution spans (chrome://tracing renders counters
    as a stacked track)."""
    _tracing.emit_counter(name, value, category=category, pid=dev)


def record_instant(name, category="runtime", dev="cpu/0", args=None):
    """A point-in-time marker ("ph": "i") — recompiles, cache evictions,
    and other events with no duration."""
    _tracing.emit_instant(name, category=category, pid=dev, args=args)


class record_span(_tracing.span):
    """Nested-span context manager (legacy signature).  Spans started on
    the same thread nest via the thread-local span stack and link to
    their parent; the emitted event is a complete ("X") event."""

    def __init__(self, name, category="operator", dev="cpu/0", args=None):
        super().__init__(name, category=category, pid=dev, args=args)


class synced_span(record_span):
    """A ``record_span`` whose end stamp waits for the work queued on
    ``device``'s current stream (the JAX package blocks on the jitted
    program's outputs), except while that stream is capturing a CUDA
    graph, where waiting would break the capture.  Category
    ``symbolic``: the executor's spans."""

    def __init__(self, name, device, category="symbolic", dev="cpu/0",
                 args=None):
        super().__init__(name, category=category, dev=dev, args=args)
        self.device = device

    def __exit__(self, *exc):
        if self._live and self.device.type == "cuda":
            import torch
            if not torch.cuda.is_current_stream_capturing():
                torch.cuda.current_stream(self.device).synchronize()
        return super().__exit__(*exc)


def dump_profile():
    """Write Chrome trace-event JSON (ref: DumpProfile profiler.cc:147)."""
    payload = {"traceEvents": _tracing.snapshot_events(),
               "displayTimeUnit": "ms"}
    dropped = _tracing.dropped_events()
    if dropped:
        # the buffer cap fired: say so in the artifact itself
        payload["otherData"] = {"dropped_events": dropped}
    with open(_state["filename"], "w") as f:
        json.dump(payload, f)


def aggregate_stats(_events_snapshot=None):
    """Per-name aggregate statistics over the recorded spans:
    name -> dict(count, total_ms, min_ms, max_ms, avg_ms), per category
    (ref: AggregateStats — MXAggregateProfileStatsPrint's table).

    Understands both encodings: "X" complete-events (the native form)
    and legacy "B"/"E" pairs, which pair LIFO per (cat, name, tid, pid)
    so nested same-name spans aggregate correctly instead of
    overwriting each other's open timestamp."""
    events = _events_snapshot if _events_snapshot is not None \
        else _tracing.snapshot_events()
    open_ts = {}  # key -> [ts, ...] stack (legacy B/E pairing)
    stats = {}

    def add(cat, name, dur_ms):
        s = stats.setdefault((cat, name), {
            "count": 0, "total_ms": 0.0, "min_ms": float("inf"),
            "max_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += dur_ms
        s["min_ms"] = min(s["min_ms"], dur_ms)
        s["max_ms"] = max(s["max_ms"], dur_ms)

    for e in events:
        ph = e.get("ph")
        if ph == "X":
            add(e["cat"], e["name"], e.get("dur", 0.0) / 1e3)
            continue
        key = (e["cat"], e["name"], e.get("tid"), e.get("pid"))
        if ph == "B":
            open_ts.setdefault(key, []).append(e["ts"])
        elif ph == "E" and open_ts.get(key):
            add(e["cat"], e["name"], (e["ts"] - open_ts[key].pop()) / 1e3)
    out = {}
    for (cat, name), s in stats.items():
        out.setdefault(cat, {})[name] = dict(
            s, avg_ms=s["total_ms"] / s["count"])
    return out


def dumps(reset=False, sort_by="total_ms"):
    """Aggregate-statistics table as text (ref: profiler.dumps /
    MXAggregateProfileStatsPrint).  reset=True atomically swaps the
    event buffer out, so spans recorded concurrently land in the NEXT
    window instead of being silently dropped."""
    if reset:
        agg = aggregate_stats(_tracing.swap_events())
    else:
        agg = aggregate_stats()
    lines = []
    for cat in sorted(agg):
        lines.append("%s" % cat)
        lines.append("%-40s %8s %12s %12s %12s %12s"
                     % ("Name", "Calls", "Total(ms)", "Min(ms)",
                        "Max(ms)", "Avg(ms)"))
        rows = sorted(agg[cat].items(),
                      key=lambda kv: -kv[1].get(sort_by, 0.0))
        for name, s in rows:
            lines.append("%-40s %8d %12.3f %12.3f %12.3f %12.3f"
                         % (name[:40], s["count"], s["total_ms"],
                            s["min_ms"], s["max_ms"], s["avg_ms"]))
        lines.append("")
    return "\n".join(lines)


_trace = {}


def start_jax_trace(logdir=None):
    """Start a ``torch.profiler`` trace of host and (where a card is
    present) CUDA activity; ``stop_jax_trace`` writes it under
    ``logdir`` (by default ``mxnet_tpu_trace`` in the temporary
    directory, ``$TMPDIR`` where set).  Returns ``logdir``."""
    import tempfile
    import torch
    if logdir is None:
        logdir = os.path.join(tempfile.gettempdir(), "mxnet_tpu_trace")
    if _trace:
        raise RuntimeError("a device trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _trace.update(prof=prof, logdir=logdir)
    return logdir


def stop_jax_trace():
    """Stop the trace ``start_jax_trace`` began and write it as Chrome
    trace JSON, ``<logdir>/mxnet_tpu_torch.<pid>.<ms>.pt.trace.json``;
    returns that path."""
    import time
    if not _trace:
        raise RuntimeError("no device trace is running")
    prof, logdir = _trace.pop("prof"), _trace.pop("logdir")
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "mxnet_tpu_torch.%d.%d.pt.trace.json"
                        % (os.getpid(), int(time.time() * 1e3)))
    prof.export_chrome_trace(path)
    return path


def _autostart_dump():
    """atexit hook: a run autostarted by env gets its dump even if it
    never calls profiler_set_state('stop') itself."""
    if is_running():
        profiler_set_state("stop")


if os.environ.get("MXNET_TPU_PROFILER_AUTOSTART") == "1":
    # parity: MXNET_PROFILER_AUTOSTART starts the profiler before any
    # user code runs and dumps at process exit (profiler.cc autostart)
    profiler_set_state("run")
    atexit.register(_autostart_dump)

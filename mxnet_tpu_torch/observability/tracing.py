"""Structured trace-event sink (the buffer under ``mxnet_tpu_torch.profiler``).

Counterpart of ``mxnet_tpu/observability/tracing.py``, event for event.
The reference profiler kept per-op begin/end pairs (OprExecStat,
profiler.h) and dumped them as Chrome trace JSON.  This module is that
buffer grown up:

- spans are **nested**: a thread-local span stack links each span to its
  parent (``args.span_id`` / ``args.parent_id``), so a trace viewer and
  ``aggregate_stats`` both see structure, not a flat soup;
- spans are **complete events** (``"ph": "X"`` with ``dur``), emitted
  once at exit — the B/E same-name nesting collision that corrupted the
  old ``aggregate_stats`` cannot exist in this encoding;
- thread ids are **real** (``threading.get_ident()``), so engine worker
  threads, prefetchers and the training loop land on separate tracks;
- **instant events** mark points in time (recompiles, cache evictions)
  and **counter events** sample monotonic series onto the timeline.

Recording is off until ``set_recording(True)`` (the profiler facade's
``profiler_set_state("run")``); every emit checks that flag first, so a
non-profiled process pays one attribute read per callsite.
"""
from __future__ import annotations

import itertools
import logging
import os
import threading

from .. import threads as _threads
import time

_lock = _threads.package_lock("tracing._lock")
_events = []
_recording = False
_span_ids = itertools.count(1)
_tls = threading.local()

# Autostart + per-step instrumentation means a forgotten 'run' state on
# a long training job would otherwise grow the buffer without bound
# (~10-15 events/step) and OOM at the atexit json.dump.  Past the cap,
# new events are counted-and-dropped with one warning; dumps report the
# drop count.  MXNET_TPU_PROFILER_MAX_EVENTS overrides (0 = unbounded).
_MAX_EVENTS = int(os.environ.get("MXNET_TPU_PROFILER_MAX_EVENTS",
                                 "1000000"))
_dropped = 0


def _append(event):
    """Buffer append under the lock, honoring the event cap."""
    global _dropped
    with _lock:
        if _MAX_EVENTS and len(_events) >= _MAX_EVENTS:
            _dropped += 1
            just_hit = _dropped == 1
        else:
            _events.append(event)
            just_hit = False
    if just_hit:
        logging.warning(
            "profiler event buffer reached MXNET_TPU_PROFILER_MAX_EVENTS"
            "=%d; further events are dropped (dump/swap the profile, or "
            "raise/zero the cap)", _MAX_EVENTS)


def dropped_events():
    """Events discarded since the last buffer swap/clear."""
    return _dropped


def now_us():
    """Trace timestamps are wall-clock microseconds (same clock as every
    pre-existing event in this buffer, so mixed dumps stay ordered)."""
    return time.time() * 1e6


def is_recording():
    return _recording


def set_recording(flag):
    global _recording
    _recording = bool(flag)


def emit(event):
    """Append one raw trace event dict (callers use the typed helpers)."""
    if not _recording:
        return
    _append(event)


def emit_complete(name, ts_us, dur_us, category="runtime", pid="cpu/0",
                  tid=None, args=None):
    """One Chrome complete-event ("X"): a span known only at its end."""
    if not _recording:
        return
    event = {"name": name, "cat": category, "ph": "X", "ts": ts_us,
             "dur": max(dur_us, 0.0), "pid": pid,
             "tid": threading.get_ident() if tid is None else tid}
    if args:
        event["args"] = args
    _append(event)


def emit_instant(name, category="runtime", pid="cpu/0", args=None):
    """A point-in-time marker (recompile, eviction, ...)."""
    if not _recording:
        return
    event = {"name": name, "cat": category, "ph": "i", "ts": now_us(),
             "pid": pid, "tid": threading.get_ident(), "s": "t"}
    if args:
        event["args"] = args
    _append(event)


def emit_counter(name, value, category="counter", pid="cpu/0"):
    """A counter sample ("C") — renders as a stacked track."""
    if not _recording:
        return
    _append({"name": name, "cat": category, "ph": "C",
             "ts": now_us(), "pid": pid, "tid": 0,
             "args": {"value": value}})


def _stack():
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class span:
    """Context manager recording one nested span on this thread's stack.

    Enter pushes; exit pops and emits a complete event carrying
    ``span_id`` and (when nested) ``parent_id``.  When recording is off
    both directions are a single flag check."""

    __slots__ = ("name", "category", "pid", "args", "_t0", "_id",
                 "_parent", "_live")

    def __init__(self, name, category="runtime", pid="cpu/0", args=None):
        self.name = name
        self.category = category
        self.pid = pid
        self.args = args

    def __enter__(self):
        self._live = _recording
        if not self._live:
            return self
        stack = _stack()
        self._parent = stack[-1]._id if stack else 0
        self._id = next(_span_ids)
        stack.append(self)
        self._t0 = now_us()
        return self

    def __exit__(self, *exc):
        if not self._live:
            return False
        t1 = now_us()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        args = dict(self.args) if self.args else {}
        args["span_id"] = self._id
        if self._parent:
            args["parent_id"] = self._parent
        emit_complete(self.name, self._t0, t1 - self._t0, self.category,
                      self.pid, args=args)
        return False


def current_span():
    """The innermost open span on this thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def snapshot_events():
    """A copy of the recorded events."""
    with _lock:
        return list(_events)


def swap_events():
    """Atomically take the buffer and start a fresh one (events recorded
    concurrently land in the next window instead of being dropped)."""
    global _dropped
    with _lock:
        taken = list(_events)
        _events.clear()
        _dropped = 0
    return taken


def clear_events():
    global _dropped
    with _lock:
        _events.clear()
        _dropped = 0

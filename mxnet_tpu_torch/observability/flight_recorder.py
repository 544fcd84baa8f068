"""Flight recorder: a bounded black box for long unattended runs.

Counterpart of ``mxnet_tpu/observability/flight_recorder.py``.  A
training job that dies at step 12,400 of an overnight run must leave
evidence behind.  The recorder keeps rings of recent state: the last
``MXNET_TPU_FLIGHT_STEPS`` (default 512) per-step records (health
summary, step-breakdown timings, plan-build counters, the latest device
memory sample), the last 200 ``mxnet_tpu_torch.*`` log records (a
handler on the package root logger), recent discrete events (anomalies,
serving failures, exceptions), plus an env/config fingerprint, and dumps
them all as ONE strict-JSON file:

- on anomaly (``HealthMonitor`` actions ``dump``/``raise``),
- on an unhandled exception in ``fit`` or the serving dispatch thread
  (hooks; gated on ``MXNET_TPU_HEALTH=1``),
- on demand (``flight_recorder.dump()``).

The dump has the JAX package's ``kind`` (``mxnet_tpu_flight``), keys and
sections, so ``tools/traceview.py --flight <dump.json>`` renders a dump
of either package and exits 1 when it holds a fired anomaly.  The
sections that later runtime-services slices fill (``tuning``,
``elastic``, ``alerts``, ``requests``, ``requests_sampled``) are present
and empty, as in a JAX dump with nothing recorded there.  The
fingerprint names the torch and CUDA versions and the card where the
JAX package names jax and its backend.

Everything here is host-side bookkeeping over a few scalars a step: no
launch, no synchronize, nothing inside a captured CUDA graph.
"""
from __future__ import annotations

import json
import logging
import math
import os
import sys
import tempfile
import time
import traceback
from collections import deque

from .. import threads as _threads
from ..log import PACKAGE_LOGGER
from . import telemetry as _telemetry

_STEPS_ENV = "MXNET_TPU_FLIGHT_STEPS"
_PATH_ENV = "MXNET_TPU_FLIGHT_PATH"
DEFAULT_STEPS = 512
LOG_CAPACITY = 200
EVENT_CAPACITY = 64
DECISION_CAPACITY = 128
ELASTIC_CAPACITY = 128
ALERT_CAPACITY = 128

# env fingerprint: every knob that could explain a divergence later
_FINGERPRINT_PREFIXES = ("MXNET_TPU_", "CUDA_", "PYTORCH_", "TORCH_",
                         "DMLC_")


def _json_safe(obj):
    """Recursively convert to strict-JSON values: non-finite floats
    become the telemetry exporters' string tokens, numpy and torch
    scalars become python numbers, unknown objects become their repr."""
    if isinstance(obj, dict):
        return {str(k): _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    if isinstance(obj, bool) or obj is None or isinstance(obj, str):
        return obj
    if isinstance(obj, int):
        return obj
    if isinstance(obj, float):
        if math.isfinite(obj):
            return obj
        return "NaN" if math.isnan(obj) else (
            "Infinity" if obj > 0 else "-Infinity")
    item = getattr(obj, "item", None)
    if callable(item):
        try:
            return _json_safe(item())
        except Exception:
            pass
    return repr(obj)


class _RingHandler(logging.Handler):
    """Captures formatted log records into a bounded deque, under the
    recorder's lock so ``dump()`` snapshots the ring without racing a
    concurrent emit."""

    def __init__(self, ring, lock):
        super().__init__(level=logging.NOTSET)
        self._ring = ring
        self._ring_lock = lock

    def emit(self, record):
        try:
            entry = {"t": record.created, "level": record.levelname,
                     "logger": record.name, "message": record.getMessage()}
            with self._ring_lock:
                self._ring.append(entry)
        except Exception:  # a log hook must never take the caller down
            pass


class FlightRecorder:
    """The process black box.  Thread-safe; all rings are bounded."""

    def __init__(self, capacity=None):
        if capacity is None:
            raw = os.environ.get(_STEPS_ENV, "")
            try:
                capacity = int(raw) if raw else DEFAULT_STEPS
            except ValueError:
                # the black box must not take a healthy run down
                logging.getLogger(PACKAGE_LOGGER).warning(
                    "ignoring malformed %s=%r (want an integer); using "
                    "%d", _STEPS_ENV, raw, DEFAULT_STEPS)
                capacity = DEFAULT_STEPS
        self.capacity = max(1, capacity)
        self._lock = _threads.package_lock("FlightRecorder._lock")
        self._steps = deque(maxlen=self.capacity)
        self._events = deque(maxlen=EVENT_CAPACITY)
        self._logs = deque(maxlen=LOG_CAPACITY)
        self._decisions = deque(maxlen=DECISION_CAPACITY)
        self._elastic = deque(maxlen=ELASTIC_CAPACITY)
        self._alerts = deque(maxlen=ALERT_CAPACITY)
        self._anomalies = []
        self._handler = None
        self._dumped_reasons = set()
        self._dump_seq = 0
        self.last_dump_path = None

    # -- capture -------------------------------------------------------------

    def install_log_capture(self):
        """Attach the ring handler to the package root logger
        (``mxnet_tpu_torch``), once per recorder."""
        if self._handler is not None:
            return
        self._handler = _RingHandler(self._logs, self._lock)
        logging.getLogger(PACKAGE_LOGGER).addHandler(self._handler)

    def remove_log_capture(self):
        if self._handler is not None:
            logging.getLogger(PACKAGE_LOGGER).removeHandler(self._handler)
            self._handler = None

    def record_step(self, step, epoch=0, batch=None, health=None,
                    timings=None, mem=None, extra=None):
        """One per-step record: the unpacked health summary, the
        StepTracker component timings (ms), the plan-build counters at
        this step (a dump shows when a rebuild landed), and the latest
        device-memory sample (``mem``: {live_bytes, peak_bytes, t})."""
        from .. import executor_cache  # lazy: avoids an import cycle
        entry = {"step": int(step), "epoch": int(epoch), "t": time.time(),
                 "exec_cache": executor_cache.trace_counts()}
        if batch is not None:
            entry["batch"] = int(batch)
        if health is not None:
            entry["health"] = dict(health)
        if timings is not None:
            entry["timings"] = dict(timings)
        if mem is not None:
            entry["mem"] = dict(mem)
        if extra is not None:
            entry["extra"] = dict(extra)
        with self._lock:
            self._steps.append(entry)

    def note(self, kind, payload=None):
        """One discrete event (serving failure, checkpoint, ...)."""
        event = {"kind": str(kind), "t": time.time()}
        if payload is not None:
            event["payload"] = payload
        with self._lock:
            self._events.append(event)

    def note_decision(self, record):
        """One autotune decision record (its own bounded ring)."""
        with self._lock:
            self._decisions.append(dict(record))

    def decisions_recorded(self):
        with self._lock:
            return len(self._decisions)

    def note_elastic(self, record):
        """One elastic lifecycle record (its own bounded ring)."""
        entry = dict(record)
        entry.setdefault("t", time.time())
        with self._lock:
            self._elastic.append(entry)

    def elastic_recorded(self):
        with self._lock:
            return len(self._elastic)

    def last_checkpoint_step(self):
        """Step of the newest committed-checkpoint record, or None."""
        with self._lock:
            for entry in reversed(self._elastic):
                if entry.get("kind") == "checkpoint":
                    return entry.get("step")
        return None

    def note_alert(self, record):
        """One alert-engine transition (its own bounded ring)."""
        entry = dict(record)
        entry.setdefault("t", time.time())
        with self._lock:
            self._alerts.append(entry)

    def alerts_recorded(self):
        with self._lock:
            return len(self._alerts)

    def note_anomaly(self, record):
        """A fired health anomaly (called by ``HealthMonitor``)."""
        with self._lock:
            self._anomalies.append(dict(record))
        self.note("anomaly", {"rule": record.get("rule"),
                              "step": record.get("step")})

    def note_exception(self, exc):
        """An unhandled exception on its way out (fit/serving hooks)."""
        tb = traceback.format_exception(type(exc), exc, exc.__traceback__)
        self.note("exception", {"type": type(exc).__name__,
                                "message": str(exc),
                                "traceback": "".join(tb)[-4000:]})

    # -- introspection -------------------------------------------------------

    @property
    def first_anomaly_step(self):
        with self._lock:
            return self._anomalies[0]["step"] if self._anomalies else None

    def steps_recorded(self):
        with self._lock:
            return len(self._steps)

    def last_step(self):
        """Step number of the newest per-step record (None when no step
        was recorded): the OOM black box stamps its anomaly with it."""
        with self._lock:
            return self._steps[-1]["step"] if self._steps else None

    def anomaly_count(self, rule=None):
        """Recorded anomalies, optionally for one rule.  The anomaly list
        is unbounded by design: its first entry is the diagnosis."""
        with self._lock:
            if rule is None:
                return len(self._anomalies)
            return sum(1 for a in self._anomalies
                       if a.get("rule") == rule)

    def fingerprint(self):
        """Env/config snapshot: relevant env vars, interpreter, torch,
        CUDA and the card."""
        env = {k: v for k, v in sorted(os.environ.items())
               if k.startswith(_FINGERPRINT_PREFIXES)}
        fp = {"pid": os.getpid(),
              "argv0": sys.argv[0] if sys.argv else "",
              "python": sys.version.split()[0],
              "env": env}
        try:
            import torch
            fp["torch"] = torch.__version__
            fp["cuda"] = torch.version.cuda
            on_card = torch.cuda.is_available()
            fp["backend"] = "cuda" if on_card else "cpu"
            if on_card:
                fp["device"] = torch.cuda.get_device_name(0)
                fp["device_count"] = torch.cuda.device_count()
        except Exception:
            pass
        return fp

    # -- the dump ------------------------------------------------------------

    def _default_path(self, reason):
        explicit = os.environ.get(_PATH_ENV)
        if explicit:
            return explicit
        self._dump_seq += 1
        return os.path.join(
            tempfile.gettempdir(),
            "mxnet_tpu_flight_%d_%02d_%s.json"
            % (os.getpid(), self._dump_seq, reason))

    def dump(self, path=None, reason="on_demand", sections=None):
        """Write the black box as one strict-JSON file and return its
        path.  ``sections`` merges extra top-level documents into the dump
        (the OOM black box attaches ``{"memory": report}``); core keys
        cannot be overridden.  Never raises into the caller: a failing
        dump on the way out of a dying run must not mask its error."""
        # built outside the lock: both may log, and the ring handler
        # takes the same lock
        fingerprint = self.fingerprint()
        try:
            telemetry_snap = _telemetry.snapshot()
        except Exception:
            telemetry_snap = {}
        with self._lock:
            doc = {
                "kind": "mxnet_tpu_flight",
                "version": 1,
                "reason": reason,
                "created": time.time(),
                "created_iso": time.strftime("%Y-%m-%dT%H:%M:%S"),
                "capacity": self.capacity,
                "fingerprint": fingerprint,
                "steps": list(self._steps),
                "events": list(self._events),
                "anomalies": list(self._anomalies),
                "first_anomaly_step": (self._anomalies[0]["step"]
                                       if self._anomalies else None),
                "logs": list(self._logs),
                "tuning": list(self._decisions),
                "elastic": list(self._elastic),
                "alerts": list(self._alerts),
            }
        doc["telemetry"] = telemetry_snap
        # the request-trace rings arrive with the fleet health plane
        doc["requests"] = []
        doc["requests_sampled"] = []
        if sections:
            for k, v in sections.items():
                doc.setdefault(str(k), v)
        if path is None:
            path = self._default_path(reason)
        try:
            with open(path, "w") as f:
                json.dump(_json_safe(doc), f, allow_nan=False)
        except Exception:
            logging.getLogger(PACKAGE_LOGGER).exception(
                "flight recorder dump to %r failed", path)
            return None
        self.last_dump_path = path
        with self._lock:
            self._dumped_reasons.add(reason)
        return path

    def has_dumped(self, reason):
        """Has this reason already produced a dump this process?"""
        with self._lock:
            return reason in self._dumped_reasons

    def dump_once(self, reason, path=None, sections=None):
        """Dump unless this reason already produced one this process:
        the hook form for failure paths that can repeat."""
        if self.has_dumped(reason):
            return None
        return self.dump(path=path, reason=reason, sections=sections)


# -- process-wide singleton ----------------------------------------------------

_recorder = None
_singleton_lock = _threads.package_lock("flight_recorder._singleton_lock")


def get_recorder():
    """The process recorder (created on first use, log capture armed)."""
    global _recorder
    with _singleton_lock:
        if _recorder is None:
            _recorder = FlightRecorder()
            _recorder.install_log_capture()
        return _recorder


def record_step(step, **kwargs):
    get_recorder().record_step(step, **kwargs)


def note(kind, payload=None):
    get_recorder().note(kind, payload)


def note_exception(exc):
    get_recorder().note_exception(exc)


def note_elastic(record):
    get_recorder().note_elastic(record)


def note_alert(record):
    get_recorder().note_alert(record)


def dump(path=None, reason="on_demand", sections=None):
    return get_recorder().dump(path=path, reason=reason, sections=sections)


def dump_once(reason, path=None, sections=None):
    return get_recorder().dump_once(reason, path=path, sections=sections)


def reset():
    """Drop the recorder (tests; re-reads ``MXNET_TPU_FLIGHT_STEPS`` on
    next use)."""
    global _recorder
    with _singleton_lock:
        if _recorder is not None:
            _recorder.remove_log_capture()
        _recorder = None

"""The serving front end: a futures API over the dynamic batcher.

Counterpart of ``mxnet_tpu/serving/server.py``::

    server = serving.Server(max_batch_size=4)        # models on gpu(0)
    server.add_model("lm", symbol, arg_params, input_shapes={"data": (1024,)})
    server.warmup()                     # run every bucket once, then verify
    out = server.submit("lm", {"data": x})           # blocking
    fut = server.submit_async("lm", {"data": x})     # concurrent.futures
    server.close()                      # graceful drain

- ``warmup()`` runs every registered model through every batch bucket,
  then sweeps again and raises unless the second pass built ZERO plans:
  steady-state traffic after a clean warmup never builds.
- ``submit*`` raises typed rejections synchronously (``ModelNotFound``,
  ``RequestTooLarge``, ``Overloaded``, ``ServerClosed``, ``BadRequest``)
  and delivers queued-stage rejections (``DeadlineExceeded``) through the
  future.
- ``close(drain=True)`` stops admission, lets the dispatch thread finish
  every queued request, and joins it.

The HTTP endpoint, ``prewarm``, signal handlers and the autotune cadence
wait for later slices.
"""
from __future__ import annotations

from concurrent.futures import Future

import numpy as np

from .. import threads as _threads
from ..base import MXNetError
from . import metrics
from .admission import AdmissionController, Request
from .batcher import DynamicBatcher
from .errors import BadRequest, RequestTooLarge, ServerClosed, ServingError
from .registry import ModelRegistry


class Server:
    """In-process dynamic-batching inference service."""

    def __init__(self, registry=None, max_batch_size=8, batch_window_ms=2.0,
                 queue_depth=None, auto_start=True):
        self.registry = registry if registry is not None else ModelRegistry()
        self.max_batch_size = int(max_batch_size)
        self.batch_window_ms = float(batch_window_ms)
        self.admission = AdmissionController(queue_depth)
        self.batcher = DynamicBatcher(self.registry, self.admission,
                                      max_batch_size=self.max_batch_size,
                                      batch_window_ms=self.batch_window_ms)
        self._closed = False
        self._close_lock = _threads.package_lock("Server._close_lock")
        if auto_start:
            self.start()

    def add_model(self, name, symbol, arg_params, aux_params=None,
                  input_shapes=None, ctx=None):
        """Register a symbol and its params, bucketed to this server's
        ``max_batch_size``, on ``ctx`` (default: the current context,
        ``gpu(0)``).  ``input_shapes`` maps input name -> per-row feature
        shape (no batch dim): ``{"data": (1024,)}``.  The graph must be
        row-wise, or padding and co-batching would change results."""
        if not input_shapes:
            raise BadRequest("input_shapes is required: {input_name: "
                             "per-row feature shape}, e.g. {'data': (8,)}")
        return self.registry.register(
            name, symbol, arg_params, aux_params, input_shapes,
            max_batch_size=self.max_batch_size, ctx=ctx)

    def start(self):
        self.batcher.start()

    def warmup(self, verify=True):
        """Run every bucket of every registered model.  With ``verify``
        a second sweep must build zero plans, or MXNetError.  Returns
        {model: {"buckets", "traces_first_pass"[, "traces_verify_pass"]}}."""
        report = {}
        names = self.registry.names()
        # warm EVERY model before verifying any: the counters are
        # process-global
        for name in names:
            model = self.registry.get(name)
            report[name] = {"buckets": list(model.buckets),
                            "traces_first_pass": sum(model.warmup().values())}
        if verify:
            for name in names:
                second = self.registry.get(name).warmup()
                report[name]["traces_verify_pass"] = sum(second.values())
                if report[name]["traces_verify_pass"]:
                    raise MXNetError(
                        "serving warmup verification failed for model %r: "
                        "%d plan builds on the second sweep (per bucket: "
                        "%s) — steady-state serving would rebuild"
                        % (name, report[name]["traces_verify_pass"], second))
        return report

    def close(self, drain=True, timeout=None):
        """Refuse new admissions (``ServerClosed``) and, with ``drain``,
        wait for the dispatch thread to complete every queued request.
        Requests still queued when ``timeout`` expires are rejected with
        ``ServerClosed``."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        self.admission.close()
        if self.batcher.started and drain:
            self.batcher.join(timeout)
            if self.batcher.alive:
                for request in self.admission.drain_remaining():
                    self.batcher.reject(request, ServerClosed(
                        "server drain deadline (%.1fs) expired before this "
                        "queued request for model %r was dispatched"
                        % (timeout or 0.0, request.model)))

    @property
    def closed(self):
        return self._closed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def submit_async(self, model, inputs, deadline_ms=None):
        """Queue one request; returns a ``concurrent.futures.Future``
        resolving to the per-output list of host arrays (this request's
        rows).  Raises typed rejections synchronously."""
        try:
            if self._closed:
                raise ServerClosed("server is closed")
            served = self.registry.get(model)
            arrays, n_rows = self._validate(served, inputs,
                                            self.max_batch_size)
            request = Request(model, arrays, n_rows, Future(),
                              deadline_ms=deadline_ms)
            self.admission.offer(request)
        except ServingError as exc:
            metrics.record_rejection(exc.reason, model=model)
            raise
        metrics.record_admitted(request.n_rows, model=model)
        request.future.request = request
        return request.future

    def submit(self, model, inputs, deadline_ms=None, timeout=None):
        """Blocking ``submit_async``."""
        return self.submit_async(model, inputs,
                                 deadline_ms=deadline_ms).result(timeout)

    @staticmethod
    def _validate(served, inputs, server_max):
        """Coerce ``inputs`` to {name: f32 array of (rows,)+feature};
        returns (arrays, rows).  A bare array serves a single-input
        model; a per-row array gains a rows=1 leading dim."""
        names = sorted(served.input_shapes)
        if not isinstance(inputs, dict):
            if len(names) != 1:
                raise BadRequest("model %r has inputs %s; pass a {name: "
                                 "array} dict" % (served.name, names))
            inputs = {names[0]: inputs}
        unknown = sorted(set(inputs) - set(names))
        missing = sorted(set(names) - set(inputs))
        if unknown or missing:
            raise BadRequest("model %r inputs mismatch: missing %s, unknown "
                             "%s" % (served.name, missing or "none",
                                     unknown or "none"))
        arrays, rows = {}, None
        for name in names:
            feature = served.input_shapes[name]
            try:
                arr = np.asarray(inputs[name], dtype=np.float32)
            except (TypeError, ValueError) as exc:
                raise BadRequest("input %r is not numeric: %s"
                                 % (name, exc)) from exc
            if arr.shape == feature:
                arr = arr[None]
            if arr.shape[1:] != feature or arr.shape[0] == 0:
                raise BadRequest("input %r expects shape (rows,)+%s, got %s"
                                 % (name, feature, arr.shape))
            if rows is None:
                rows = arr.shape[0]
            elif arr.shape[0] != rows:
                raise BadRequest("inputs disagree on rows: %r has %d, %r has "
                                 "%d" % (names[0], rows, name, arr.shape[0]))
            arrays[name] = arr
        limit = min(served.max_batch_size, server_max)
        if rows > limit:
            raise RequestTooLarge(
                "request of %d rows exceeds max_batch_size %d for model %r; "
                "split it client-side" % (rows, limit, served.name))
        return arrays, rows

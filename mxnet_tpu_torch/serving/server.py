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
- ``close(drain=True, timeout=None)`` stops admission, lets the dispatch
  thread finish every queued request, and joins it; requests still
  queued past ``timeout`` are rejected with ``ServerClosed``.
  ``install_signal_handlers`` wires SIGTERM/SIGINT to that bounded drain.

The HTTP front end (stdlib ``http.server``, JSON in and out,
``serve_http=True``): ``POST /v1/models/<name>:predict`` or
``/predict/<name>``, ``GET /healthz`` and ``GET /metrics`` (the metrics
registry in the Prometheus text format, ``telemetry.to_prometheus()``,
with the JAX package's names).  ``prewarm`` and the autotune cadence
wait for a later runtime-services slice.
"""
from __future__ import annotations

import json
import logging
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from .. import threads as _threads
from ..base import MXNetError
from ..log import module_logger as _module_logger
from ..observability import memprof as _memprof
from ..observability import telemetry as _telemetry
from . import metrics
from .admission import AdmissionController, Request
from .batcher import DynamicBatcher
from .errors import BadRequest, RequestTooLarge, ServerClosed, ServingError
from .registry import ModelRegistry

_log = logging.getLogger(__name__)


class Server:
    """In-process dynamic-batching inference service."""

    def __init__(self, registry=None, max_batch_size=8, batch_window_ms=2.0,
                 queue_depth=None, serve_http=False, http_host="127.0.0.1",
                 http_port=0, auto_start=True):
        self.registry = registry if registry is not None else ModelRegistry()
        self.max_batch_size = int(max_batch_size)
        self.batch_window_ms = float(batch_window_ms)
        self.admission = AdmissionController(queue_depth)
        self.batcher = self._make_batcher()
        metrics.register_queue_gauge(self.admission)
        self._closed = False
        self._close_lock = _threads.package_lock("Server._close_lock")
        self._httpd = None
        self._http_thread = None
        self._prev_signal_handlers = {}
        if auto_start:
            self.start()
        if serve_http:
            self._start_http(http_host, http_port)

    def _make_batcher(self):
        """The dispatch engine behind the admission queue (``FleetServer``
        puts its replica router here)."""
        return DynamicBatcher(self.registry, self.admission,
                              max_batch_size=self.max_batch_size,
                              batch_window_ms=self.batch_window_ms)

    def add_model(self, name, symbol, arg_params, aux_params=None,
                  input_shapes=None, ctx=None, quantize=None,
                  calibration=None, slo_ms=None):
        """Register a symbol and its params, bucketed to this server's
        ``max_batch_size``, on ``ctx`` (default: the current context,
        ``gpu(0)``).  ``input_shapes`` maps input name -> per-row feature
        shape (no batch dim): ``{"data": (1024,)}``.  The graph must be
        row-wise, or padding and co-batching would change results.
        ``quantize="int8"`` serves the graph's int8 rewrite
        (``calibration`` pins activation ranges); ``slo_ms`` declares the
        model's p99 latency target (env default
        ``MXNET_TPU_SERVING_SLO_MS``)."""
        if not input_shapes:
            raise BadRequest("input_shapes is required: {input_name: "
                             "per-row feature shape}, e.g. {'data': (8,)}")
        return self.registry.register(
            name, symbol, arg_params, aux_params, input_shapes,
            max_batch_size=self.max_batch_size, ctx=ctx, quantize=quantize,
            calibration=calibration, slo_ms=slo_ms)

    def load_model(self, name, prefix, epoch, input_shapes, ctx=None,
                   quantize=None, calibration=None, slo_ms=None):
        """Register from checkpoint artifacts (``save_checkpoint``'s
        prefix-symbol.json + prefix-%04d.params, from either package)."""
        from ..model import load_checkpoint
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return self.add_model(name, symbol, arg_params, aux_params,
                              input_shapes, ctx=ctx, quantize=quantize,
                              calibration=calibration, slo_ms=slo_ms)

    def start(self):
        self.batcher.start()

    # a summed warmup footprint within this fraction of device capacity
    # is "thin": one more replica, bucket or model likely runs out
    THIN_MEMORY_MARGIN = 0.10

    def warmup(self, verify=True):
        """Run every bucket of every registered model.  With ``verify``
        a second sweep must build zero plans, or MXNetError.  Returns
        {model: {"buckets", "traces_first_pass"[, "traces_verify_pass"]}}.

        Under ``MXNET_TPU_MEMPROF=1`` the report gains a ``memory``
        section: each model's per-bucket footprints (the memprof records
        of the bucket plans), the summed serving footprint (per-bucket
        temp and output bytes, plus each model's widest argument block
        once: bucket predictors share their weights) and, on the card,
        the headroom against its total memory, warning under
        ``THIN_MEMORY_MARGIN``."""
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
        memory = self._warmup_memory_report(names)
        if memory is not None:
            if "memory" in report:
                # a model named "memory" keeps its entry
                _module_logger(__name__).warning(
                    'a served model is named "memory": the warmup '
                    "report's footprint section is omitted (rename the "
                    "model to get it)")
            else:
                report["memory"] = memory
        return report

    def _warmup_memory_report(self, names):
        """The summed-footprint-against-capacity section of the warmup
        report (None when no bucket plan was measured)."""
        per_model = {}
        footprint = 0
        for name in names:
            bm = self.registry.get(name).bucket_memory
            if not bm:
                continue
            per_model[name] = {str(b): dict(v) for b, v in bm.items()}
            footprint += max(v.get("argument_bytes", 0)
                             for v in bm.values())
            footprint += sum(v.get("temp_bytes", 0)
                             + v.get("output_bytes", 0)
                             for v in bm.values())
        if not per_model:
            return None
        limits = [d["bytes_limit"] for d in _memprof.device_memory()
                  if d.get("bytes_limit")]
        memory = {"per_model": per_model,
                  "footprint_bytes": int(footprint),
                  "device_limit_bytes": int(limits[0]) if limits else None,
                  "headroom_frac": None}
        _telemetry.gauge(
            "serving.warmup_footprint_bytes",
            help="summed per-bucket plan footprint measured at "
                 "warmup").set(footprint)
        if limits:
            headroom = (limits[0] - footprint) / float(limits[0])
            memory["headroom_frac"] = round(headroom, 4)
            if headroom < self.THIN_MEMORY_MARGIN:
                _module_logger(__name__).warning(
                    "serving warmup footprint %d bytes leaves only "
                    "%.1f%% of device capacity (%d bytes) — thin margin "
                    "(< %.0f%%): one more bucket, model, or replica "
                    "likely runs out of memory",
                    footprint, headroom * 100.0, limits[0],
                    self.THIN_MEMORY_MARGIN * 100.0)
                _telemetry.counter(
                    "serving.warmup_thin_memory_margin",
                    help="warmups whose footprint left under the thin-"
                         "margin threshold of device capacity").inc()
        return memory

    def close(self, drain=True, timeout=None):
        """Refuse new admissions (``ServerClosed``) and, with ``drain``,
        wait for the dispatch thread to complete every queued request.
        Requests still queued when ``timeout`` expires are rejected with
        ``ServerClosed``."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if self._httpd is not None:
            self._httpd.shutdown()
            self._http_thread.join(timeout=5)
            self._httpd.server_close()
        self.admission.close()
        if self.batcher.started and drain:
            self.batcher.join(timeout)
            if self.batcher.alive:
                shed = self.admission.drain_remaining()
                for request in shed:
                    self.batcher.reject(request, ServerClosed(
                        "server drain deadline (%.1fs) expired before this "
                        "queued request for model %r was dispatched"
                        % (timeout or 0.0, request.model)))
                if shed:
                    _log.warning("drain deadline expired: rejected %d "
                                 "queued request(s) with ServerClosed",
                                 len(shed))

    def install_signal_handlers(self, drain_deadline_s=30.0, signals=None):
        """Wire SIGTERM/SIGINT to a bounded graceful drain
        (``close(drain=True, timeout=drain_deadline_s)``): in-flight
        requests finish, anything queued past the deadline is rejected
        with ``ServerClosed``.  A callable previous handler runs after
        the drain.  Returns the signals hooked (none off the main
        thread, where Python forbids handlers).

        The handler only starts a drain thread: it runs on the
        interrupted main thread, which may hold a logging lock, and
        draining in signal context could deadlock on it."""
        import signal as _signal
        if signals is None:
            signals = (_signal.SIGTERM, _signal.SIGINT)

        def _drain(signum):
            _log.warning("signal %d: draining serving (deadline %.1fs)",
                         signum, drain_deadline_s)
            self.close(drain=True, timeout=drain_deadline_s)
            prev = self._prev_signal_handlers.get(signum)
            if callable(prev):
                prev(signum, None)

        def _handler(signum, frame):
            _threads.spawn(_drain, "serving", "drain", args=(signum,))

        installed = []
        for sig in signals:
            try:
                self._prev_signal_handlers[sig] = _signal.signal(
                    sig, _handler)
                installed.append(sig)
            except ValueError:
                _log.warning("cannot install the serving drain handler for "
                             "signal %s off the main thread", sig)
        return installed

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

    # -- HTTP front end ------------------------------------------------------

    def _start_http(self, host, port):
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd.daemon_threads = True
        self._httpd.owner = self
        self._http_thread = _threads.spawn(
            self._httpd.serve_forever, "serving", "http")

    @property
    def http_address(self):
        """(host, port) of the live HTTP listener, or None."""
        if self._httpd is None:
            return None
        return self._httpd.server_address[:2]


class _Handler(BaseHTTPRequestHandler):
    """JSON-over-HTTP mapping of the futures API.

    POST /v1/models/<name>:predict   {"inputs": {...}, "deadline_ms": n}
    POST /predict/<name>             the same body
    GET  /healthz                    liveness + registered models
    GET  /metrics                    Prometheus text exposition
    """

    server_version = "mxnet-tpu-torch-serving"
    protocol_version = "HTTP/1.1"

    def log_message(self, format, *args):
        """Silence per-request stderr lines (the metrics are the log)."""

    def _send(self, status, body, content_type="application/json"):
        data = body.encode() if isinstance(body, str) \
            else json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):
        if self.path == "/healthz":
            self._send(200, {"status": "ok",
                             "models": self.server.owner.registry.names()})
        elif self.path == "/metrics":
            self._send(200, _telemetry.to_prometheus(),
                       content_type="text/plain; version=0.0.4")
        else:
            self._send(404, {"error": "not_found", "path": self.path})

    def do_POST(self):
        name = self._model_name()
        if name is None:
            self._send(404, {"error": "not_found", "path": self.path})
            return
        try:
            length = int(self.headers.get("Content-Length", "0"))
            try:
                payload = json.loads(self.rfile.read(length) or b"{}")
            except ValueError as exc:
                raise BadRequest("unparsable JSON body: %s" % exc) from exc
            if not isinstance(payload, dict):
                raise BadRequest("body must be a JSON object")
            inputs = payload.get("inputs", payload.get("data"))
            if inputs is None:
                raise BadRequest('body needs "inputs" (dict or array)')
            outs = self.server.owner.submit(
                name, inputs, deadline_ms=payload.get("deadline_ms"))
            self._send(200, {"model": name,
                             "outputs": [o.tolist() for o in outs]})
        except ServingError as exc:
            self._send(exc.http_status,
                       {"error": type(exc).__name__, "reason": exc.reason,
                        "message": str(exc)})
        except Exception as exc:  # the handler thread must answer
            self._send(500, {"error": type(exc).__name__,
                             "message": str(exc)})

    def _model_name(self):
        """The model of ``/v1/models/<name>:predict`` (TF-serving
        spelling) or ``/predict/<name>``."""
        path = self.path.split("?", 1)[0]
        if path.startswith("/v1/models/") and path.endswith(":predict"):
            return path[len("/v1/models/"):-len(":predict")] or None
        if path.startswith("/predict/"):
            return path[len("/predict/"):] or None
        return None

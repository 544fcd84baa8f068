"""Dynamic batcher: single requests in, bucket-padded batches out.

Counterpart of ``mxnet_tpu/serving/batcher.py``.  The batcher queues
single requests, concatenates them up to ``max_batch_size`` rows, pads
the concat to the smallest bucket, runs ONE forward for the whole batch,
and splits the outputs back per request.  A fixed set of batch shapes
means a fixed set of cached plans, so after ``Server.warmup`` steady
state builds nothing.

The dispatch thread must never die: every per-batch failure is caught
and delivered to that batch's futures, then the loop continues.  Padding
rows are zeros; the graph evaluates row-wise, so padding never changes a
real row's result.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import InvalidStateError

import numpy as np

from .. import threads as _threads
from . import metrics
from .registry import bucket_for

_log = logging.getLogger(__name__)


def _fail_future(future, exc):
    """Deliver ``exc`` if the future is still pending (a client may
    cancel it at any instant); True when THIS call resolved it."""
    try:
        future.set_exception(exc)
        return True
    except InvalidStateError:
        return False


def _resolve_future(future, result):
    try:
        future.set_result(result)
        return True
    except InvalidStateError:
        return False


def assemble_padded(model, batch, bucket):
    """Concat the requests' input arrays and zero-pad to ``bucket`` rows."""
    padded = {}
    for input_name, feature in model.input_shapes.items():
        buf = np.zeros((bucket,) + feature, dtype=np.float32)
        off = 0
        for r in batch:
            buf[off:off + r.n_rows] = r.inputs[input_name]
            off += r.n_rows
        padded[input_name] = buf
    return padded


def split_results(batch, outs, bucket):
    """Slice each request's rows out of the batched outputs and resolve
    its future (a list of per-output host arrays)."""
    off = 0
    for r in batch:
        # copy, not view: a retained response must not pin the whole
        # bucket-sized output
        result = [o[off:off + r.n_rows].copy() for o in outs]
        off += r.n_rows
        r.dispatch_bucket = bucket
        _resolve_future(r.future, result)
        metrics.record_request_done(r)


def run_group(model, batch, rows, replica=None):
    """Run one same-model group: bucket, pad, dispatch, record, split.
    Raises on failure; the caller owns the failure policy (the batcher
    fails the futures, a fleet ``Replica`` also quarantines itself).
    ``replica`` tags the per-replica counters."""
    bucket = bucket_for(rows, model.buckets)
    padded = assemble_padded(model, batch, bucket)
    t0 = time.monotonic()
    outs = model.run_batch(bucket, padded)
    ms = (time.monotonic() - t0) * 1e3
    metrics.record_dispatch_ms(ms)
    if replica is not None:
        metrics.record_replica_dispatch(replica, model.name, rows, ms)
    metrics.record_batch(model.name, bucket, rows)
    split_results(batch, outs, bucket)
    return bucket


def fail_batch(batch, exc, model_name):
    """Deliver ``exc`` to every request of a failed batch, counting one
    rejection per request actually failed."""
    reason = getattr(exc, "reason", "dispatch_error")
    for r in batch:
        if _fail_future(r.future, exc):
            metrics.record_rejection(reason, model=model_name)


class DynamicBatcher:
    """Consumes an AdmissionController, dispatches through a
    ModelRegistry, on one package thread."""

    def __init__(self, registry, admission, max_batch_size=8,
                 batch_window_ms=2.0):
        self.registry = registry
        self.admission = admission
        self.max_batch_size = int(max_batch_size)
        self.batch_window_ms = float(batch_window_ms)
        self._thread = None

    def start(self):
        if self._thread is None:
            self._thread = _threads.spawn(self._loop, "serving", "batcher")

    @property
    def started(self):
        return self._thread is not None

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def join(self, timeout=None):
        """Wait for the dispatch thread to drain and exit (close the
        admission controller first)."""
        if self._thread is not None:
            self._thread.join(timeout)

    def _loop(self):
        while True:
            try:
                batch = self.admission.take_batch(
                    self.max_batch_size, self.batch_window_ms, self.reject)
                if batch is None:
                    return  # closed and drained
                self._dispatch(batch)
            except Exception:  # the dispatch thread must never die
                _log.exception("serving dispatch loop survived an "
                               "unexpected error; continuing")
                time.sleep(0.05)

    def reject(self, request, exc):
        """Fail one queued request with a typed error (deadline sweeps);
        counted only when this call delivered it."""
        if _fail_future(request.future, exc):
            metrics.record_rejection(getattr(exc, "reason", "serving_error"),
                                     model=request.model)
            metrics.record_queue_wait(
                (time.monotonic() - request.t_submit) * 1e3)

    def _dispatch(self, batch):
        """Run one assembled batch, split into groups where the model's
        own ``max_batch_size`` is tighter than the assembly cap."""
        name = batch[0].model
        try:
            model = self.registry.get(name)
        except Exception as exc:
            fail_batch(batch, exc, name)
            return
        group, group_rows = [], 0
        for r in batch:
            if group and group_rows + r.n_rows > model.max_batch_size:
                self._run_group(model, group, group_rows)
                group, group_rows = [], 0
            group.append(r)
            group_rows += r.n_rows
        if group:
            self._run_group(model, group, group_rows)

    def _run_group(self, model, batch, rows):
        try:
            run_group(model, batch, rows)
        except Exception as exc:  # the dispatch thread must survive
            fail_batch(batch, exc, model.name)

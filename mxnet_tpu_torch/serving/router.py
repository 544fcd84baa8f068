"""Fleet tier: replica groups behind one admission queue, with a router.

Counterpart of ``mxnet_tpu/serving/router.py``:

- :class:`Replica` — one serving replica: its OWN ``ModelRegistry`` (its
  own bound predictors, so device placement and failure are per
  replica), its own work lane and worker thread, health state, and the
  per-bucket cost table measured at warmup.
- :class:`ReplicaGroup` — N replicas of the same model set, each on the
  context ``ctxs`` gives it (on one card: ``[mx.gpu(0)] * 2``; several
  cards wait for the multi-device slice).
- :class:`Router` — consumes the shared admission queue exactly like
  ``DynamicBatcher`` (same assembly, deadline sweeps and typed
  rejections) but routes each assembled group to the least-loaded
  healthy replica's lane instead of running it inline.
- :class:`FleetServer` — the ``Server`` over a group: ``add_model``
  registers on every replica, ``warmup`` sweeps every replica and
  measures the per-bucket cost the router weighs with, ``close`` drains
  the lanes with the same bounded-deadline shedding.

Routing weight: a replica's load is the sum over its outstanding work of
``rows x measured per-row cost`` of the work's bucket (the cost comes
from the warmup verify sweep, after every plan is built, so it is
execution).  Before warmup measures anything it is the outstanding rows.
The running item counts as ``max(estimate, elapsed)``, so a replica that
turned slow after warmup shows it.  Ties break toward fewer rows, then
the lower index.

Health: a replica whose dispatch RAISES (not a typed per-request
rejection) is quarantined: the failed batch's futures get the error, the
replica takes no more work, and its queued lane is re-routed.  Only when
every replica is quarantined do requests fail, with the typed
:class:`~mxnet_tpu_torch.serving.errors.NoHealthyReplica`.  Quarantine
is one-strike and permanent.

Every replica binds the same graph at the same bucket shapes, so a
routed response equals a plain ``Predictor`` run at its recorded
``dispatch_bucket`` bit for bit, whichever replica served it.
"""
from __future__ import annotations

import logging
import os
import time
from collections import deque

import numpy as np

from .. import executor_cache
from .. import threads as _threads
from ..base import MXNetError
from . import metrics
from .batcher import DynamicBatcher, fail_batch, run_group
from .errors import BadRequest, NoHealthyReplica, ServerClosed, ServingError
from .registry import ModelRegistry, bucket_for
from .server import Server

_log = logging.getLogger(__name__)

ENV_REPLICAS = "MXNET_TPU_SERVING_REPLICAS"


def default_replicas():
    """Fleet width when the constructor does not pin one (default 1)."""
    try:
        n = int(os.environ.get(ENV_REPLICAS, "1"))
    except ValueError:
        _log.warning("malformed %s=%r; using 1 replica", ENV_REPLICAS,
                     os.environ.get(ENV_REPLICAS))
        return 1
    return max(1, n)


class Replica:
    """One serving replica: registry + work lane + worker thread +
    health + measured per-bucket cost."""

    def __init__(self, index, ctx=None):
        self.index = int(index)
        self.ctx = ctx
        self.registry = ModelRegistry()
        # (model_name, batch, rows, est_ms) work items, router-ordered
        self._lane = deque()
        self._cond = _threads.package_condition("Replica._cond")
        self._thread = None
        self._closed = False
        # what the router's least-loaded pick reads: rows and estimated
        # ms of the lane, and the running item apart (its weight grows
        # with the wall clock)
        self._outstanding_rows = 0
        self._outstanding_ms = 0.0
        self._running_est_ms = 0.0
        self._running_since = None
        self._running_rows = 0
        self.healthy = True
        self.quarantine_error = None
        self.dispatches = 0
        self.rows_served = 0
        # {(model_name, bucket): measured wall ms} from the verify sweep
        self.bucket_cost_ms = {}
        self._group = None  # set by ReplicaGroup

    # -- lifecycle -----------------------------------------------------------

    def start(self):
        if self._thread is None:
            self._thread = _threads.spawn(
                self._worker, "serving", "replica-%d" % self.index)

    @property
    def alive(self):
        return self._thread is not None and self._thread.is_alive()

    def close(self):
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def join(self, timeout=None):
        if self._thread is not None:
            self._thread.join(timeout)

    # -- load accounting ------------------------------------------------------

    def estimate_ms(self, model_name, bucket, rows):
        """Routing weight of one group: rows x measured per-row cost at
        its bucket; rows alone before warmup measured it."""
        cost = self.bucket_cost_ms.get((model_name, bucket))
        if cost is None or bucket <= 0:
            return float(rows)
        return rows * (cost / float(bucket))

    def load_score(self):
        """(outstanding ms, outstanding rows, index): the router picks
        the lexicographic minimum over healthy replicas."""
        with self._cond:
            running_ms = 0.0
            if self._running_since is not None:
                elapsed = (time.monotonic() - self._running_since) * 1e3
                running_ms = max(self._running_est_ms, elapsed)
            return (self._outstanding_ms + running_ms,
                    self._outstanding_rows + self._running_rows,
                    self.index)

    def outstanding(self):
        with self._cond:
            return len(self._lane) + (
                1 if self._running_since is not None else 0)

    # -- the lane -------------------------------------------------------------

    def enqueue(self, model_name, batch, rows, est_ms):
        """Router side: hand one assembled group to this replica."""
        with self._cond:
            if self._closed or not self.healthy:
                # the router re-checks; this guards a quarantine landing
                # between its pick and this enqueue
                raise NoHealthyReplica(
                    "replica %d is %s" % (
                        self.index,
                        "closed" if self._closed else "quarantined"))
            self._lane.append((model_name, batch, rows, est_ms))
            self._outstanding_rows += rows
            self._outstanding_ms += est_ms
            self._cond.notify()

    def _take(self):
        with self._cond:
            while not self._lane and not self._closed:
                self._cond.wait()
            if not self._lane:
                return None  # closed and drained
            item = self._lane.popleft()
            _, _, rows, est_ms = item
            self._outstanding_rows -= rows
            self._outstanding_ms -= est_ms
            self._running_rows = rows
            self._running_est_ms = est_ms
            self._running_since = time.monotonic()
            return item

    def _done(self):
        with self._cond:
            self._running_since = None
            self._running_rows = 0
            self._running_est_ms = 0.0

    def _worker(self):
        """Run routed groups until closed and drained, or quarantined."""
        while True:
            item = self._take()
            if item is None:
                return
            model_name, batch, rows, _ = item
            try:
                try:
                    model = self.registry.get(model_name)
                    run_group(model, batch, rows, replica=self.index)
                    self.dispatches += 1
                    self.rows_served += rows
                except Exception as exc:
                    # the failure path must not kill the worker while it
                    # still reads healthy: its lane would hang forever
                    try:
                        fail_batch(batch, exc, model_name)
                    except Exception:
                        _log.exception("replica %d could not deliver a "
                                       "batch failure", self.index)
                    if not isinstance(exc, ServingError):
                        # a typed rejection is the request's problem;
                        # anything else makes this replica suspect
                        try:
                            self._quarantine(exc)
                        except Exception:
                            _log.exception("replica %d quarantine "
                                           "bookkeeping failed", self.index)
                            with self._cond:
                                self.healthy = False
                                self.quarantine_error = exc
                        return
            finally:
                self._done()

    def _quarantine(self, exc):
        """Mark unhealthy and hand the queued lane back to the group for
        re-routing (drained, not dropped)."""
        with self._cond:
            self.healthy = False
            self.quarantine_error = exc
            stranded = list(self._lane)
            self._lane.clear()
            for _, _, rows, est_ms in stranded:
                self._outstanding_rows -= rows
                self._outstanding_ms -= est_ms
        _log.error("serving replica %d quarantined after dispatch failure "
                   "(%s: %s); re-routing %d queued group(s)", self.index,
                   type(exc).__name__, exc, len(stranded))
        metrics.record_replica_quarantined(
            self.index, "%s: %s" % (type(exc).__name__, exc))
        if self._group is not None:
            self._group.redispatch(stranded)

    # -- warmup ---------------------------------------------------------------

    def warmup_models(self):
        """First-pass warmup of every model here; {model: plan builds}."""
        return {name: sum(self.registry.get(name).warmup().values())
                for name in self.registry.names()}

    def verify_and_measure(self):
        """Second sweep: every bucket of every model runs once more,
        timed (execution only, every plan is built by now): the cost
        table the router reads.  Returns {model: {bucket: ms}}."""
        costs = {}
        for name in self.registry.names():
            model = self.registry.get(name)
            per_bucket = {}
            for b in model.buckets:
                zeros = {k: np.zeros((b,) + v, dtype=np.float32)
                         for k, v in model.input_shapes.items()}
                t0 = time.monotonic()
                model.run_batch(b, zeros)
                ms = (time.monotonic() - t0) * 1e3
                per_bucket[b] = ms
                self.bucket_cost_ms[(name, b)] = ms
            costs[name] = per_bucket
        return costs


class ReplicaGroup:
    """N replicas of one model set, plus the routing/redispatch core."""

    def __init__(self, n_replicas=None, ctxs=None):
        if n_replicas is None:
            n_replicas = len(ctxs) if ctxs else default_replicas()
        n = int(n_replicas)
        if n < 1:
            raise MXNetError("a replica group needs >= 1 replica")
        if ctxs is not None and len(ctxs) != n:
            raise MXNetError(
                "ctxs must name one context per replica (%d != %d)"
                % (len(ctxs), n))
        self.replicas = [Replica(i, ctx=ctxs[i] if ctxs else None)
                         for i in range(n)]
        for r in self.replicas:
            r._group = self

    def __len__(self):
        return len(self.replicas)

    @property
    def primary_registry(self):
        """Replica 0's registry: the validation view the shared
        admission path reads (every replica registers the same models)."""
        return self.replicas[0].registry

    def healthy_replicas(self):
        # a closed replica's worker may have drained and exited already
        return [r for r in self.replicas if r.healthy and not r._closed]

    def start(self):
        for r in self.replicas:
            r.start()

    def register(self, name, symbol, arg_params, aux_params, input_shapes,
                 max_batch_size=8, quantize=None, calibration=None,
                 slo_ms=None):
        """Register the model on EVERY replica, each on its context."""
        models = [
            r.registry.register(
                name, symbol, arg_params, aux_params, input_shapes,
                max_batch_size=max_batch_size, ctx=r.ctx,
                quantize=quantize, calibration=calibration, slo_ms=slo_ms)
            for r in self.replicas]
        return models[0]

    def models_named(self, name):
        """The per-replica twins of one registered model."""
        return [r.registry.get(name) for r in self.replicas]

    # -- routing --------------------------------------------------------------

    def pick(self):
        """The least-loaded healthy replica, or None when the whole group
        is quarantined."""
        scored = sorted((r.load_score(), r) for r in self.healthy_replicas())
        return scored[0][1] if scored else None

    def dispatch(self, model_name, batch, rows, bucket):
        """Route one assembled group; fails the batch typed when no
        healthy replica exists."""
        while True:
            replica = self.pick()
            if replica is None:
                fail_batch(batch, NoHealthyReplica(
                    "all %d replica(s) are quarantined; group for model "
                    "%r not dispatched" % (len(self.replicas),
                                           model_name)), model_name)
                return None
            est_ms = replica.estimate_ms(model_name, bucket, rows)
            try:
                replica.enqueue(model_name, batch, rows, est_ms)
            except NoHealthyReplica:
                continue  # lost the race with a quarantine; re-pick
            return replica

    def redispatch(self, stranded):
        """Re-route a quarantined replica's queued lane (called from the
        dying replica's worker thread)."""
        for model_name, batch, rows, _ in stranded:
            try:
                model = self.primary_registry.get(model_name)
                bucket = bucket_for(rows, model.buckets)
            except Exception:
                bucket = rows
            self.dispatch(model_name, batch, rows, bucket)

    # -- lifecycle ------------------------------------------------------------

    def close(self, deadline=None):
        """Drain every lane: close the lanes, join the workers until
        ``deadline`` (a monotonic time, None = wait), then shed what is
        still queued with typed ``ServerClosed``.  Returns the number of
        requests shed."""
        for r in self.replicas:
            r.close()
        shed = 0
        for r in self.replicas:
            timeout = None
            if deadline is not None:
                timeout = max(0.0, deadline - time.monotonic())
            r.join(timeout)
            if r.alive:
                with r._cond:
                    stranded = list(r._lane)
                    r._lane.clear()
                for model_name, batch, _, _ in stranded:
                    shed += len(batch)
                    fail_batch(batch, ServerClosed(
                        "fleet drain deadline expired before this routed "
                        "group was dispatched on replica %d" % r.index),
                        model_name)
        return shed

    @property
    def any_alive(self):
        return any(r.alive for r in self.replicas)

    def stats(self):
        """Per-replica routing facts for reports and tests."""
        return [{"replica": r.index,
                 "healthy": r.healthy,
                 "dispatches": r.dispatches,
                 "rows": r.rows_served,
                 "outstanding": r.outstanding(),
                 "bucket_cost_ms": {("%s:%d" % k): round(v, 4)
                                    for k, v in r.bucket_cost_ms.items()}}
                for r in self.replicas]


class Router(DynamicBatcher):
    """The fleet dispatch engine: ``DynamicBatcher``'s admission
    consumption, with assembled groups ROUTED to replica lanes."""

    def __init__(self, group, admission, max_batch_size=8,
                 batch_window_ms=2.0):
        super().__init__(group.primary_registry, admission,
                         max_batch_size=max_batch_size,
                         batch_window_ms=batch_window_ms)
        self.group = group

    def start(self):
        self.group.start()
        super().start()

    def _run_group(self, model, batch, rows):
        """Route instead of running inline; any failure lands on the
        batch's futures, never on the thread."""
        try:
            bucket = bucket_for(rows, model.buckets)
            self.group.dispatch(model.name, batch, rows, bucket)
        except Exception as exc:
            fail_batch(batch, exc, model.name)

    def join(self, timeout=None):
        """Drain: the router thread (which empties the admission queue
        into the lanes), then every lane, under ONE deadline."""
        deadline = (time.monotonic() + timeout) \
            if timeout is not None else None
        super().join(timeout)
        self.group.close(deadline)

    @property
    def alive(self):
        return super().alive or self.group.any_alive


class FleetServer(Server):
    """``Server`` over a :class:`ReplicaGroup`: N replicas of every
    registered model behind one admission queue and one futures API::

        fleet = serving.FleetServer(ctxs=[mx.gpu(0), mx.gpu(0)],
                                    max_batch_size=8)
        fleet.add_model("mlp", sym, args, input_shapes={"data": (8,)},
                        slo_ms=250.0)
        fleet.warmup()            # per-replica sweeps + cost measurement
        out = fleet.submit("mlp", {"data": x})
        fleet.close()
    """

    def __init__(self, n_replicas=None, ctxs=None, max_batch_size=8,
                 batch_window_ms=2.0, queue_depth=None, serve_http=False,
                 http_host="127.0.0.1", http_port=0, auto_start=True):
        # the group exists before Server.__init__ calls _make_batcher
        self.group = ReplicaGroup(n_replicas, ctxs=ctxs)
        # the fleet-size gauge: shed rate and queue depth read against
        # the replica count that produced them
        metrics.register_replica_gauge(self.group)
        super().__init__(registry=self.group.primary_registry,
                         max_batch_size=max_batch_size,
                         batch_window_ms=batch_window_ms,
                         queue_depth=queue_depth, serve_http=serve_http,
                         http_host=http_host, http_port=http_port,
                         auto_start=auto_start)

    def _make_batcher(self):
        return Router(self.group, self.admission,
                      max_batch_size=self.max_batch_size,
                      batch_window_ms=self.batch_window_ms)

    @property
    def n_replicas(self):
        return len(self.group)

    def add_model(self, name, symbol, arg_params, aux_params=None,
                  input_shapes=None, ctx=None, quantize=None,
                  calibration=None, slo_ms=None):
        """Register on EVERY replica.  ``ctx`` is refused: placement is
        the group's ``ctxs`` (one context per replica)."""
        if ctx is not None:
            raise MXNetError(
                "FleetServer.add_model does not take ctx: replica "
                "placement is the group's ctxs=[...] (one context per "
                "replica)")
        if not input_shapes:
            raise BadRequest("input_shapes is required: {input_name: "
                             "per-row feature shape}, e.g. {'data': (8,)}")
        return self.group.register(
            name, symbol, arg_params, aux_params, input_shapes,
            max_batch_size=self.max_batch_size, quantize=quantize,
            calibration=calibration, slo_ms=slo_ms)

    def warmup(self, verify=True):
        """Per-replica warmup, verification and cost measurement: every
        model on every replica, then (``verify``) a second timed sweep of
        every bucket that must build no plan; its times are the cost
        table the router weighs with."""
        report = {}
        for replica in self.group.replicas:
            for name, n in replica.warmup_models().items():
                entry = report.setdefault(
                    name, {"buckets": list(self.registry.get(name).buckets),
                           "traces_first_pass": 0, "per_replica": {}})
                entry["traces_first_pass"] += n
                entry["per_replica"][replica.index] = {
                    "traces_first_pass": n}
        if verify:
            with executor_cache.watch_traces() as second_sweep:
                for replica in self.group.replicas:
                    for name, per_bucket in \
                            replica.verify_and_measure().items():
                        report[name]["per_replica"][replica.index][
                            "bucket_cost_ms"] = {
                            str(b): round(ms, 4)
                            for b, ms in per_bucket.items()}
            if second_sweep.total():
                raise MXNetError(
                    "fleet warmup verification failed: %d plan builds on "
                    "the verify sweep across %d replicas (delta: %s)"
                    % (second_sweep.total(), len(self.group),
                       second_sweep.delta()))
        report["replicas"] = self.group.stats()
        return report

"""Model registry: named models bound into per-bucket predictors.

Counterpart of ``mxnet_tpu/serving/registry.py``.  A :class:`ServedModel`
binds its symbol and params through :class:`~mxnet_tpu_torch.predict.
Predictor`, one predictor per batch-size bucket, all sharing the base
predictor's weight arrays (``Predictor.reshaped``).  After
:meth:`ServedModel.warmup` each bucket's plan sits in the executor cache,
so steady-state dispatches build nothing (``executor_cache.watch_traces``).
``quantize="int8"`` (default: ``MXNET_TPU_QUANTIZE``) serves the int8
rewrite of the graph, done once in the base predictor and shared by every
bucket.  Bucket staging by the autotuner and the persistent-cache
``prewarm`` wait for their slices.
"""
from __future__ import annotations

import os

import numpy as np

from .. import executor_cache
from .. import threads as _threads
from ..predict import Predictor
from . import metrics
from .errors import ModelNotFound, RequestTooLarge


def bucket_sizes(max_batch_size):
    """Powers of two up to ``max_batch_size``, plus the max itself when
    it is not one: every dispatch pads to one of these."""
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1, got %r"
                         % (max_batch_size,))
    out = []
    b = 1
    while b < max_batch_size:
        out.append(b)
        b *= 2
    out.append(max_batch_size)
    return out


def bucket_for(n_rows, buckets):
    """Smallest bucket holding ``n_rows`` (buckets ascending)."""
    for b in buckets:
        if n_rows <= b:
            return b
    raise RequestTooLarge("batch of %d rows exceeds max_batch_size %d"
                          % (n_rows, buckets[-1]))


class ServedModel:
    """One model's serving state: per-bucket predictors over shared
    weights, plus the metadata the batcher needs."""

    def __init__(self, name, symbol, arg_params, aux_params, input_shapes,
                 max_batch_size=8, ctx=None, quantize=None,
                 calibration=None, slo_ms=None):
        self.name = name
        self.symbol = symbol
        self.buckets = bucket_sizes(max_batch_size)
        self.max_batch_size = max_batch_size
        # the declared p99 latency target (ms); None = none declared, the
        # env default covering fleets whose deploy config owns the number
        if slo_ms is None:
            env = os.environ.get("MXNET_TPU_SERVING_SLO_MS", "").strip()
            try:
                slo_ms = float(env) if env else None
            except ValueError:
                slo_ms = None
        self.slo_ms = float(slo_ms) if slo_ms else None
        if self.slo_ms:
            metrics.record_slo(name, self.slo_ms)
        if quantize is None:
            env = os.environ.get("MXNET_TPU_QUANTIZE", "").strip().lower()
            quantize = env if env not in ("", "0", "off", "none") else None
        self.quantize = quantize
        # feature shapes EXCLUDE the batch dim: {"data": (8,)} serves
        # requests shaped (rows, 8)
        self.input_shapes = {k: tuple(int(d) for d in v)
                             for k, v in input_shapes.items()}
        params = {"arg:%s" % k: v for k, v in arg_params.items()}
        params.update({"aux:%s" % k: v
                       for k, v in (aux_params or {}).items()})
        self._base = Predictor(symbol.tojson(), params,
                               self._bind_shapes(self.buckets[0]), ctx=ctx,
                               quantize=quantize, calibration=calibration)
        self.output_names = self._base.output_names
        self._by_bucket = {self.buckets[0]: self._base}
        self._lock = _threads.package_lock("ServedModel._lock")
        # serializes run_batch: a predictor's forward()+get_output() is
        # not atomic, and warmup from the caller thread must not
        # interleave with the dispatch thread on the same bucket
        self._run_lock = _threads.package_lock("ServedModel._run_lock")

    def _bind_shapes(self, bucket):
        return {k: (bucket,) + v for k, v in self.input_shapes.items()}

    def predictor_for(self, bucket):
        """The bucket's bound predictor, created on first use."""
        with self._lock:
            p = self._by_bucket.get(bucket)
            if p is None:
                p = self._base.reshaped(self._bind_shapes(bucket))
                self._by_bucket[bucket] = p
            return p

    def run_batch(self, bucket, inputs):
        """Run one padded batch (``inputs``: name -> array with leading
        dim ``bucket``); returns the outputs as host numpy arrays."""
        p = self.predictor_for(bucket)
        with self._run_lock:
            p.forward(**inputs)
            return [p.get_output(i).asnumpy()
                    for i in range(len(self.output_names))]

    def warmup(self):
        """Run every bucket once so its plan is cached; returns
        {bucket: plan builds added}."""
        traced = {}
        for b in self.buckets:
            with executor_cache.watch_traces() as w:
                self.run_batch(b, {k: np.zeros((b,) + v, dtype=np.float32)
                                   for k, v in self.input_shapes.items()})
            traced[b] = w.total()
        return traced


class ModelRegistry:
    """Name -> :class:`ServedModel` map shared by a Server."""

    def __init__(self):
        self._models = {}
        self._lock = _threads.package_lock("ModelRegistry._lock")

    def register(self, name, symbol, arg_params, aux_params, input_shapes,
                 max_batch_size=8, ctx=None, quantize=None,
                 calibration=None, slo_ms=None):
        """Register (or replace) ``name``; returns its ServedModel."""
        model = ServedModel(name, symbol, arg_params, aux_params,
                            input_shapes, max_batch_size=max_batch_size,
                            ctx=ctx, quantize=quantize,
                            calibration=calibration, slo_ms=slo_ms)
        with self._lock:
            self._models[name] = model
        return model

    def load(self, name, prefix, epoch, input_shapes, max_batch_size=8,
             ctx=None, quantize=None, calibration=None, slo_ms=None):
        """Register from ``save_checkpoint`` artifacts (prefix-symbol.json
        + prefix-%04d.params, written by either package)."""
        from ..model import load_checkpoint
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return self.register(name, symbol, arg_params, aux_params,
                             input_shapes, max_batch_size=max_batch_size,
                             ctx=ctx, quantize=quantize,
                             calibration=calibration, slo_ms=slo_ms)

    def get(self, name):
        with self._lock:
            model = self._models.get(name)
            have = sorted(self._models) if model is None else None
        if model is None:
            raise ModelNotFound("no model registered as %r (have: %s)"
                                % (name, have or "none"))
        return model

    def names(self):
        with self._lock:
            return sorted(self._models)

    def __contains__(self, name):
        with self._lock:
            return name in self._models

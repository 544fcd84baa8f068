"""Training callbacks.

Counterpart of ``mxnet_tpu/callback.py`` (ref: python/mxnet/callback.py,
do_checkpoint:55, Speedometer:120): ``module_checkpoint``,
``do_checkpoint``, ``log_train_metric``, ``Speedometer`` and
``ProgressBar``.  The Speedometer's log line is kept verbatim,
"Epoch[..] Batch [..]\\tSpeed: .. samples/sec" and the metric pairs, since
``tools/parse_log.py`` scrapes it.
"""
from __future__ import annotations

import logging
import math
import time


def _every(period, action):
    """Epoch-end callback running `action(epoch_no, sym, arg, aux)` once
    per `period` completed epochs (epoch_no is 1-based)."""
    period = max(1, int(period))

    def _cb(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            action(iter_no + 1, sym, arg, aux)

    return _cb


def module_checkpoint(mod, prefix, period=1, save_optimizer_states=False):
    """Checkpoint a Module every `period` epochs."""
    return _every(period, lambda n, *_:
                  mod.save_checkpoint(prefix, n, save_optimizer_states))


def do_checkpoint(prefix, period=1):
    """Per-epoch symbol+params checkpoint callback (ref: callback.py:55)."""
    from .model import save_checkpoint
    return _every(period, lambda n, sym, arg, aux:
                  save_checkpoint(prefix, n, sym, arg, aux))


def log_train_metric(period, auto_reset=False):
    """Log the evaluation metric every `period` batches."""

    def _cb(param):
        metric = param.eval_metric
        if param.nbatch % period or metric is None:
            return
        for name, value in metric.get_name_value():
            logging.info("Iter[%d] Batch[%d] Train-%s=%f",
                         param.epoch, param.nbatch, name, value)
        if auto_reset:
            metric.reset()

    return _cb


class Speedometer:
    """Log samples/sec (and metrics) every `frequent` batches
    (ref: callback.py:120; format scraped by tools/parse_log.py).

    ``telemetry=True`` additionally mirrors the throughput into the
    metrics registry (``speedometer.samples_per_sec`` gauge and
    histogram); the log lines are the same either way."""

    def __init__(self, batch_size, frequent=50, auto_reset=True,
                 telemetry=False):
        self.batch_size = batch_size
        self.frequent = frequent
        self.auto_reset = auto_reset
        self.telemetry = telemetry
        self._tic = None       # None = timer not started (epoch boundary)
        self._prev_batch = 0

    def _mirror(self, speed):
        from .observability import telemetry as _telemetry
        _telemetry.gauge("speedometer.samples_per_sec",
                         help="last Speedometer throughput").set(speed)
        _telemetry.histogram("speedometer.samples_per_sec_hist",
                             help="Speedometer throughput").observe(speed)

    def __call__(self, param):
        nbatch = param.nbatch
        if nbatch < self._prev_batch:
            self._tic = None   # a new epoch rewound the batch counter
        self._prev_batch = nbatch

        if self._tic is None:
            self._tic = time.time()
            return
        if nbatch % self.frequent:
            return

        speed = self.frequent * self.batch_size / (time.time() - self._tic)
        if self.telemetry:
            self._mirror(speed)
        metric = param.eval_metric
        if metric is None:
            logging.info("Iter[%d] Batch [%d]\tSpeed: %.2f samples/sec",
                         param.epoch, nbatch, speed)
        else:
            pairs = metric.get_name_value()
            if self.auto_reset:
                metric.reset()
            fmt = ("Epoch[%d] Batch [%d]\tSpeed: %.2f samples/sec"
                   + "\t%s=%f" * len(pairs))
            flat = [x for pair in pairs for x in pair]
            logging.info(fmt, param.epoch, nbatch, speed, *flat)
        self._tic = time.time()


class ProgressBar:
    """Text progress bar over `total` batches."""

    def __init__(self, total, length=80):
        self.bar_len = length
        self.total = total

    def __call__(self, param):
        frac = param.nbatch / float(self.total)
        filled = int(round(self.bar_len * frac))
        logging.info("[%s] %s%%\r",
                     ("=" * filled).ljust(self.bar_len, "-"),
                     math.ceil(100.0 * frac))

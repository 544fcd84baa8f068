"""Monitor: statistics of every op output, every ``interval`` batches.

Counterpart of ``mxnet_tpu/monitor.py`` (ref: python/mxnet/monitor.py).
``install`` sets an executor's monitor callback, so that each forward runs
op by op and hands every op output whose name matches ``pattern`` to
``stat_func`` between ``tic()`` and ``toc()``; ``toc()`` adds the
arguments' statistics and returns ``(step, name, rendered value)`` rows.
A monitored Module leaves the fused train step for the general path,
which has the per-op tap points (the fused step's optimizer state goes
to the Updater).  The default statistic is the JAX package's: the norm
over the square root of the size.  ``stats="health"``, the health
sentinel's readings, waits for the runtime-services slice.
"""
from __future__ import annotations

import logging
import re
from math import sqrt

from .base import MXNetError
from .ndarray import NDArray


def _default_stat(x):
    """Mean absolute scale: ||x|| / sqrt(n)."""
    return x.norm() / sqrt(x.size)


def _render(value):
    """A statistic (an NDArray scalar, an NDArray or a list) as text."""
    values = [value] if isinstance(value, NDArray) else value
    if not isinstance(values, list):
        raise AssertionError("a statistic is an NDArray or a list of them")
    parts = []
    for v in values:
        if isinstance(v, NDArray) and v.size == 1:
            parts.append(str(v.asscalar()))
        else:
            parts.append(str(v.asnumpy()))
    return ",".join(parts)


class Monitor:
    """Collect per-tensor statistics every ``interval`` batches."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False,
                 stats="tensors"):
        if stats not in ("tensors", "health"):
            raise ValueError("stats must be 'tensors' or 'health', got %r"
                             % (stats,))
        if stats == "health":
            raise MXNetError(
                "Monitor(stats='health') reads the health sentinel, which "
                "waits for the runtime-services slice (slice 8)")
        self.stats = stats
        self.stat_func = stat_func or _default_stat
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

        def stat_helper(name, arr):
            if self.activated and self.re_prog.match(name):
                self.queue.append((self.step, name, self.stat_func(arr)))

        self.stat_helper = stat_helper

    def install(self, exe):
        """Tap this executor's op outputs."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def _sync_args(self):
        for exe in self.exes:
            for arr in exe.arg_arrays:
                arr.wait_to_read()

    def tic(self):
        """Start collecting if this step falls on the interval."""
        if self.step % self.interval == 0:
            self._sync_args()
            self.queue = []
            self.activated = True
        self.step += 1

    def toc(self):
        """Stop collecting, add the matching arguments' statistics, and
        return [(step, name, rendered value)]."""
        if not self.activated:
            return []
        self._sync_args()
        for exe in self.exes:
            for name, arr in exe.arg_dict.items():
                if self.re_prog.match(name):
                    self.queue.append((self.step, name, self.stat_func(arr)))
        self.activated = False
        if self.sort:
            self.queue.sort(key=lambda item: item[1])
        results = [(step, name, _render(v)) for step, name, v in self.queue]
        self.queue = []
        return results

    def toc_print(self):
        for step, name, rendered in self.toc():
            logging.info("Batch: %7d %30s %s", step, name, rendered)

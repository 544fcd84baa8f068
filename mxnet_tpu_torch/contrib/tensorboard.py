"""TensorBoard bridge (ref: python/mxnet/contrib/tensorboard.py).

Counterpart of ``mxnet_tpu/contrib/tensorboard.py``.
`LogMetricsCallback` mirrors the reference class: a batch-end callback that
writes every metric to a TensorBoard event file.  The writer dependency is
resolved lazily and pluggably — anything with an `add_scalar(tag, value,
step)` method works (torch.utils.tensorboard.SummaryWriter, tensorboardX,
or the bundled JSONL fallback writer) — so the callback never hard-fails
when TensorBoard isn't installed.
"""
from __future__ import annotations

import json
import os
import time


class _JsonlWriter:
    """Fallback event writer: one JSON line per scalar, same fields as a
    TB scalar event.  Readable by parse_log-style tooling."""

    def __init__(self, logging_dir):
        os.makedirs(logging_dir, exist_ok=True)
        self._f = open(os.path.join(logging_dir, "events.jsonl"), "a")

    def add_scalar(self, tag, value, step):
        self._f.write(json.dumps(
            {"wall_time": time.time(), "step": int(step), "tag": tag,
             "value": float(value)}) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


def _make_writer(logging_dir):
    try:
        from torch.utils.tensorboard import SummaryWriter  # noqa: PLC0415
        return SummaryWriter(logging_dir)
    except Exception:
        return _JsonlWriter(logging_dir)


class LogMetricsCallback(object):
    """Log metrics periodically in TensorBoard (ref class of the same name).

    Usage matches the reference docstring::

        logging_dir = 'logs/'
        lmc = LogMetricsCallback(logging_dir)
        mod.fit(train_iter, batch_end_callback=[lmc], ...)
    """

    def __init__(self, logging_dir, prefix=None):
        self.prefix = prefix
        self.step = 0
        self.summary_writer = _make_writer(logging_dir)

    def __call__(self, param):
        """Callback to log training speed and metrics in TensorBoard."""
        if param.eval_metric is None:
            return
        name_value = param.eval_metric.get_name_value()
        for name, value in name_value:
            if self.prefix is not None:
                name = '%s-%s' % (self.prefix, name)
            self.summary_writer.add_scalar(name, value, self.step)
        self.step += 1

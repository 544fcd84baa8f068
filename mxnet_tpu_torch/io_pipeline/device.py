"""Device transfer stage: the double-buffered upload of host batches.

Counterpart of ``mxnet_tpu/io_pipeline/device.py``, built on the port's
``io._Uploader``: a batch's arrays are staged in pinned host buffers and
copied on a side stream, with an event recorded after the copies.  An
upload is split in two so that it can run ahead of its consumer:

- :meth:`DeviceTransfer.stage` issues the copies and returns a
  :class:`StagedBatch` (any thread may call it; uploads are serialized,
  since the pinned ring is shared);
- :meth:`StagedBatch.hand_over`, called on the consuming thread when the
  batch is handed out, makes the consumer's current stream wait for the
  copies' event and records the tensors as used on that stream.  A batch
  handed out before its copy has landed cannot be read early: the wait
  is on the device, in stream order.

The adapter keeps one staged batch pending, so the copy of batch N rides
under step N-1.  ``MXNET_TPU_IO_DOUBLE_BUFFER=0`` turns that lookahead
off (batches upload when they are pulled).  Without a context the arrays
stay host NDArrays, as the port's other iterators serve them.
"""
from __future__ import annotations

import os
import threading

import numpy as np
import torch

from ..io import DataBatch, DataDesc, _Uploader
from ..ndarray import NDArray
from ..observability import tracing as _tracing
from ..observability.instrument import note_pipeline_h2d


def double_buffer_enabled():
    return os.environ.get("MXNET_TPU_IO_DOUBLE_BUFFER", "1").strip() \
        not in ("0", "false", "off")


def _host_array(arr):
    """A host NDArray over ``arr``'s memory (no copy: the batch is owned)."""
    return NDArray(torch.from_numpy(np.ascontiguousarray(arr)))


class StagedBatch:
    """A batch whose upload has been issued; :meth:`hand_over` gives it to
    the calling thread's current stream."""

    __slots__ = ("batch", "event", "_uploader")

    def __init__(self, batch, event, uploader):
        self.batch = batch
        self.event = event
        self._uploader = uploader

    def hand_over(self):
        if self._uploader is None:
            return self.batch
        return self._uploader.hand_over(self.batch, self.event)


class DeviceTransfer:
    """Turn a HostBatch into a DataBatch on ``ctx`` (or on the host when
    ``ctx`` is None)."""

    def __init__(self, ctx=None, provide_data=None, provide_label=None):
        self._uploader = _Uploader(ctx) if ctx is not None else None
        self._lock = threading.Lock()
        self.provide_data = provide_data
        self.provide_label = provide_label

    def stage(self, host_batch):
        """Issue the upload of ``host_batch``; returns a StagedBatch.  The
        host time of issuing it is the ``io_pipeline.h2d_ms`` histogram
        (and a ``pipe:h2d`` span while the profiler records)."""
        t0 = _tracing.now_us()
        staged = self._stage(host_batch)
        t1 = _tracing.now_us()
        note_pipeline_h2d((t1 - t0) / 1e6)
        if _tracing.is_recording():
            _tracing.emit_complete(
                "pipe:h2d", t0, t1 - t0, category="io_pipeline", pid="io",
                args={"rows": int(host_batch.data.shape[0]),
                      "seq": host_batch.seq})
        return staged

    def _stage(self, host_batch):
        batch = DataBatch([_host_array(host_batch.data)],
                          [_host_array(host_batch.label)],
                          pad=host_batch.pad,
                          provide_data=self.provide_data,
                          provide_label=self.provide_label)
        if self._uploader is None:
            return StagedBatch(batch, None, None)
        with self._lock:
            batch, event = self._uploader.upload(batch)
        return StagedBatch(batch, event, self._uploader)

    def put(self, host_batch):
        """Upload ``host_batch`` and hand it to the calling thread."""
        return self.stage(host_batch).hand_over()


def describe_batch(host_batch, batch_size, data_name, label_name):
    """provide_data/provide_label descriptors from one assembled batch."""
    data_desc = [DataDesc(data_name,
                          (batch_size,) + tuple(host_batch.data.shape[1:]),
                          host_batch.data.dtype)]
    label_desc = [DataDesc(label_name,
                           (batch_size,) + tuple(host_batch.label.shape[1:]),
                           host_batch.label.dtype)]
    return data_desc, label_desc

"""The Pipeline: source -> decode/augment -> batch -> prefetch -> device.

Counterpart of ``mxnet_tpu/io_pipeline/pipeline.py``.  One object
composes the stage pieces into the full path from file bytes to device
memory:

- an epoch is planned up front (`sharding.epoch_plan`), a pure function
  of (seed, epoch), so the batch sequence is deterministic whatever the
  worker count;
- batch tasks run on the prefetch executor (thread pool by default,
  spawn-process pool for GIL-bound decode), each worker reading through
  its own source reader handle;
- the bounded reorder buffer releases batches in plan order;
- the device stage (`device.DeviceTransfer`) issues each batch's copy on
  a side stream; with the adapter's one-batch lookahead the copy of
  batch N rides under step N-1.

Use :meth:`as_dataiter` for the ``DataIter`` view that ``Module.fit``
and the scoring loops consume (``fit`` also accepts the Pipeline itself
and adapts it).
"""
from __future__ import annotations

import math
import threading

from ..base import MXNetError
from .device import DeviceTransfer, describe_batch, double_buffer_enabled
from .executor import PrefetchExecutor, ThreadedStage
from .sharding import epoch_plan
from .stages import (HostBatch, decode_task, process_decode_task,
                     process_pool_init)


class Pipeline:
    """High-throughput input pipeline over a record source.

    Parameters
    ----------
    source : RecordFileSource | ListSource | duck-typed source
        Owns the record set; must provide ``__len__`` and
        ``open_reader()``.
    decode : callable ``(raw, rng) -> (data, label)``
        Per-record decode/augment, run off the driving thread.  Must be
        picklable for ``mode='process'``.
    batch_size : int
    shuffle : bool
        Reshuffle every epoch, reproducibly from ``seed``.
    seed : int
        Root of every ordering and augmentation draw.
    num_workers, prefetch_depth : int | None
        ``None`` reads ``MXNET_TPU_IO_WORKERS`` /
        ``MXNET_TPU_IO_PREFETCH_DEPTH``.
    mode : 'thread' | 'process'
    ctx : Context | None
        Batches are copied onto this device as they are pulled; ``None``
        serves host NDArrays.
    double_buffer : bool | None
        ``None`` reads ``MXNET_TPU_IO_DOUBLE_BUFFER``; governs where the
        upload runs and the adapter's one-batch lookahead.
    last_batch_handle : 'pad' | 'discard'
    """

    def __init__(self, source, decode, batch_size, shuffle=False, seed=0,
                 num_workers=None, prefetch_depth=None, mode="thread",
                 ctx=None, double_buffer=None, data_name="data",
                 label_name="softmax_label", last_batch_handle="pad",
                 bucket_key=None):
        if batch_size < 1:
            raise MXNetError("batch_size must be >= 1")
        self.source = source
        self.decode = decode
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.seed = int(seed)
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.mode = mode
        self.ctx = ctx
        self.double_buffer = (double_buffer_enabled()
                              if double_buffer is None
                              else bool(double_buffer))
        self.data_name = data_name
        self.label_name = label_name
        self.last_batch_handle = last_batch_handle
        self.bucket_key = bucket_key
        self._probe_batch = None
        self._proc_exec = None  # persistent process executor (one spawn)

    # -- schema --------------------------------------------------------------
    def _probe(self):
        """Decode one record synchronously to learn the batch schema, with
        the same per-record seeding as the real epoch (the probe perturbs
        no RNG stream)."""
        if self._probe_batch is None:
            from .sharding import BatchTask, epoch_order
            first = int(epoch_order(len(self.source), self.seed, 0,
                                    self.shuffle)[0])
            task = BatchTask(0, 0, (0,), (first,), 0)
            reader = self.source.open_reader()
            try:
                self._probe_batch = decode_task(task, reader,
                                                self.decode, self.seed)
            finally:
                reader.close()
        return self._probe_batch

    @property
    def provide_data(self):
        data_desc, _ = describe_batch(self._probe(), self.batch_size,
                                      self.data_name, self.label_name)
        return data_desc

    @property
    def provide_label(self):
        _, label_desc = describe_batch(self._probe(), self.batch_size,
                                       self.data_name, self.label_name)
        return label_desc

    def __len__(self):
        """Batches per epoch."""
        n = len(self.source)
        if self.last_batch_handle == "discard":
            return n // self.batch_size
        return int(math.ceil(n / self.batch_size))

    # -- execution -----------------------------------------------------------
    def host_batches(self, epoch=0, transfer=None):
        """Generator over the epoch's batches, in plan order.  Closing it
        shuts the executor down cleanly (workers joined, readers closed),
        mid-epoch too.

        With a ``transfer`` (thread mode), each worker stages the upload
        of its batch right after assembling it, so that the pinned copy
        and the issue of the device copy land on a worker, never on the
        driving thread; the generator then yields StagedBatches."""
        plan = epoch_plan(len(self.source), self.batch_size, self.seed,
                          epoch, self.shuffle, self.last_batch_handle)
        if self.mode == "process":
            if self._proc_exec is None:
                # one executor per pipeline: the spawn pool persists
                # across epochs, and its initializer ships the source and
                # decoder to each worker once
                self._proc_exec = PrefetchExecutor(
                    process_decode_task, self.num_workers,
                    self.prefetch_depth, mode="process",
                    initializer=process_pool_init,
                    initargs=(self.source, self.decode, self.seed))
            yield from self._proc_exec.run(plan)
            return
        tls = threading.local()
        readers = []
        lock = threading.Lock()

        def run_one(task):
            reader = getattr(tls, "reader", None)
            if reader is None:
                reader = tls.reader = self.source.open_reader()
                with lock:
                    readers.append(reader)
            out = decode_task(task, reader, self.decode, self.seed)
            if transfer is not None:
                out = transfer.stage(out)
            return out

        ex = PrefetchExecutor(run_one, self.num_workers,
                              self.prefetch_depth, mode="thread")
        try:
            yield from ex.run(plan)
        finally:
            with lock:
                for reader in readers:
                    try:
                        reader.close()
                    except Exception:
                        pass
                readers[:] = []

    def _staged_batches(self, epoch=0):
        """Generator over the epoch's StagedBatches: each one's upload is
        issued, and :meth:`StagedBatch.hand_over` gives it to the consumer.

        Where the upload is issued (``double_buffer`` on):

        - **thread mode**: on the worker that assembled the batch, up to
          ``prefetch_depth`` batches ahead;
        - **process mode**: workers cannot touch the device, so an upload
          thread (`executor.ThreadedStage`) takes their results and
          issues the copies off the driving thread.

        With ``double_buffer`` off the upload is issued here, at pull
        time, on the driving thread."""
        transfer = DeviceTransfer(self.ctx, self.provide_data,
                                  self.provide_label)
        worker_side = self.mode == "thread" and self.double_buffer
        source = self.host_batches(
            epoch, transfer=transfer if worker_side else None)
        stage = None
        if self.mode == "process" and self.double_buffer:
            stage = ThreadedStage(
                (transfer.stage(hb) for hb in source),
                depth=self.prefetch_depth or 2, name="io_pipeline-upload")
            source = stage
        try:
            for item in source:
                if isinstance(item, HostBatch):
                    item = transfer.stage(item)
                if self.bucket_key is not None:
                    item.batch.bucket_key = self.bucket_key
                yield item
        finally:
            if stage is not None:
                stage.close()
            else:
                source.close()

    def batches(self, epoch=0):
        """Generator over the epoch's DataBatches, on ``ctx`` (each handed
        to the calling thread's current stream as it is yielded)."""
        gen = self._staged_batches(epoch)
        try:
            for item in gen:
                yield item.hand_over()
        finally:
            gen.close()

    def as_dataiter(self, warm_start=True):
        """The ``DataIter`` adapter (`adapter.PipelineDataIter`) that
        ``Module.fit`` and the scoring loops consume."""
        from .adapter import PipelineDataIter
        return PipelineDataIter(self, warm_start=warm_start)

    # -- lifecycle -----------------------------------------------------------
    def release_workers(self):
        """Shut down the persistent process pool and wait for its workers
        to exit (a no-op in thread mode, whose workers end with each epoch
        run).  Idempotent: the pool re-creates lazily if the pipeline is
        used again."""
        ex, self._proc_exec = self._proc_exec, None
        if ex is not None:
            ex.close()

    def close(self):
        self.release_workers()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

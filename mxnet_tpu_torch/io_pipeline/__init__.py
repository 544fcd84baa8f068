"""High-throughput input pipeline (ref: src/io's layered iterator stack:
IIterator<DataBatch>, ImageRecordIter2's threaded decode,
dmlc::ThreadedIter prefetch).

Counterpart of ``mxnet_tpu/io_pipeline/``, with the same names and the
same batches for the same seed:

- **multi-worker prefetch executor** (`executor.PrefetchExecutor`):
  thread pool by default, spawn-process pool for GIL-bound decode, with
  a **bounded reorder buffer**, so that a batch is a pure function of
  (seed, epoch, position) whatever the worker count, mode or depth;
- **sharded record sources** (`stages.RecordFileSource` over
  ``MXIndexedRecordIO``): one reader handle per worker, balanced
  ``num_parts`` sharding that covers every record exactly once;
- **composable stages** (source -> decode/augment -> batch -> prefetch):
  decode/augment runs off the driving thread, seeded per record
  (`sharding.record_seed`);
- **double-buffered device transfer** (`device.DeviceTransfer` over
  ``io._Uploader``: pinned buffers, a side stream, an event per batch)
  and the adapter's one-batch lookahead: the copy of batch N runs while
  step N-1 computes;
- **DataIter adapter** (`adapter.PipelineDataIter`): ``Module.fit`` and
  the scoring loops consume the pipeline unchanged (``fit`` also accepts
  the Pipeline itself, and closes the adapter it makes).

Knobs: ``MXNET_TPU_IO_WORKERS``, ``MXNET_TPU_IO_PREFETCH_DEPTH``,
``MXNET_TPU_IO_DOUBLE_BUFFER``.
"""
from .adapter import PipelineDataIter
from .device import DeviceTransfer, double_buffer_enabled
from .executor import (PipelineClosed, PrefetchExecutor, ReorderBuffer,
                       default_num_workers, default_prefetch_depth)
from .pipeline import Pipeline
from .sharding import (BatchTask, epoch_order, epoch_plan, epoch_seed,
                       record_seed, shard_records)
from .stages import (HostBatch, ImageRecordDecoder, ListSource,
                     NDArrayRecordDecoder, RecordFileSource,
                     assemble_batch, decode_task)

__all__ = [
    "Pipeline", "PipelineDataIter", "PrefetchExecutor", "ReorderBuffer",
    "PipelineClosed", "RecordFileSource", "ListSource",
    "ImageRecordDecoder", "NDArrayRecordDecoder", "HostBatch",
    "BatchTask", "DeviceTransfer", "assemble_batch", "decode_task",
    "epoch_order", "epoch_plan", "epoch_seed", "record_seed",
    "shard_records", "default_num_workers", "default_prefetch_depth",
    "double_buffer_enabled",
]

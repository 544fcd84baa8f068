"""``DataIter`` adapter over a Pipeline.

Counterpart of ``mxnet_tpu/io_pipeline/adapter.py``.  ``Module.fit`` and
the scoring loops consume it unchanged: it is a real
:class:`~mxnet_tpu_torch.io.DataIter`.

Lifecycle is explicit: ``close()`` / ``with`` shuts down the in-flight
epoch (workers joined, readers closed, a process pool released), and a
``reset()`` mid-epoch does the same before arming the next epoch.

With double-buffering on (``MXNET_TPU_IO_DOUBLE_BUFFER``, the default)
the adapter keeps uploaded batches pending: ``next()`` hands back the
oldest and at once pulls the following one, whose copy then runs on the
side stream while the caller computes.  A batch is handed to the
consumer's stream (``StagedBatch.hand_over``: the stream waits for the
copy's event) only when ``next()`` returns it, so that a step never
waits for the copy of the batch after it.
"""
from __future__ import annotations

from collections import deque

from ..base import MXNetError
from ..io import DataIter
from ..observability.instrument import (note_pipeline_h2d_ahead,
                                        suppress_pipeline_wait)


class PipelineDataIter(DataIter):
    def __init__(self, pipeline, warm_start=True):
        super().__init__(pipeline.batch_size)
        self._pipeline = pipeline
        self._epoch = 0
        self._gen = None
        self._pending = None  # deque of staged batches, oldest first
        self._exhausted = False
        self._closed = False
        # batches held ahead of the consumer: more than one, so that an
        # epoch's first steps do not pay the pipeline's refill (arming
        # happens at reset(), outside the fit loop's steps)
        self._prime = max(1, min(2, pipeline.prefetch_depth or 2)) \
            if pipeline.double_buffer else 0
        if pipeline.bucket_key is not None:
            self.default_bucket_key = pipeline.bucket_key
        if warm_start:
            # arm epoch 0 now: workers fill the prefetch buffer while the
            # consumer binds, so step 0 does not wait for the spin-up
            self._arm()

    # -- schema --------------------------------------------------------------
    @property
    def provide_data(self):
        return self._pipeline.provide_data

    @property
    def provide_label(self):
        return self._pipeline.provide_label

    @property
    def epoch(self):
        return self._epoch

    # -- iteration -----------------------------------------------------------
    def _arm(self):
        self._gen = self._pipeline._staged_batches(self._epoch)
        self._exhausted = False
        if self._prime:
            self._pending = deque()
            # priming waits on the pipeline's spin-up, outside the fit
            # loop's steps: it must not count into the starvation ratio
            with suppress_pipeline_wait():
                for _ in range(self._prime):
                    staged = next(self._gen, None)
                    if staged is None:
                        self._exhausted = True
                        break
                    self._pending.append(staged)

    def next(self):
        if self._closed:
            raise MXNetError("PipelineDataIter is closed")
        if self._gen is None:
            self._arm()
        if self._prime:
            if not self._pending:
                raise StopIteration
            out = self._pending.popleft()
            # pull (and thereby upload) the next batch before handing
            # this one back: its copy rides under the caller's compute
            if not self._exhausted:
                upcoming = next(self._gen, None)
                if upcoming is not None:
                    self._pending.append(upcoming)
                    note_pipeline_h2d_ahead()
                else:
                    self._exhausted = True
            return out.hand_over()
        staged = next(self._gen, None)
        if staged is None:
            self._exhausted = True
            raise StopIteration
        return staged.hand_over()

    def reset(self):
        """End the current epoch (shutting down any in-flight work) and
        arm the next one.  With ``shuffle`` the next epoch's order is a
        fresh deterministic permutation of the same seed.  Arming is
        eager, so the reset ``fit`` issues after its last epoch leaves
        one armed epoch behind until ``close()`` (which ``fit`` calls for
        the adapters it made from a raw Pipeline)."""
        if self._closed:
            raise MXNetError("PipelineDataIter is closed")
        self._teardown_gen()
        self._epoch += 1
        self._arm()

    def hard_reset(self):
        """Back to epoch 0 (a fresh identically-seeded run)."""
        if self._closed:
            raise MXNetError("PipelineDataIter is closed")
        self._teardown_gen()
        self._epoch = 0
        self._arm()

    # -- lifecycle -----------------------------------------------------------
    def _teardown_gen(self):
        gen, self._gen = self._gen, None
        self._pending = None
        if gen is not None:
            gen.close()  # GeneratorExit -> executor shutdown, readers closed

    def close(self):
        """Idempotent shutdown: joins the epoch's workers, closes its
        readers and releases the pipeline's process pool (which re-creates
        lazily if the pipeline is reused); the iterator is unusable
        afterwards."""
        if self._closed:
            return
        self._closed = True
        self._teardown_gen()
        self._pipeline.release_workers()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

"""Multi-worker prefetch executor with a bounded reorder buffer.

Counterpart of ``mxnet_tpu/io_pipeline/executor.py``.  The parallelism
model mirrors the reference's layered iterator stack (dmlc::ThreadedIter
in iter_prefetcher.h feeding ImageRecordIOParser2's decode pool): work
units, one per output batch, are numbered in the order the epoch plan
defines, workers complete them in whatever order the scheduler produces,
and a **bounded reorder buffer** releases them strictly in sequence.
Output order is therefore a pure function of the plan (seed, epoch),
never of worker count, pool mode or timing.

Two pool modes:

- ``thread`` (default): worker threads + the reorder buffer.  Right for
  decode work that releases the GIL (cv2, big-numpy transforms).
- ``process``: a spawn-context ``ProcessPoolExecutor`` with a bounded
  in-flight window consumed in submission order (the same reorder
  semantics, enforced by the window).  Right for GIL-bound pure-Python
  decode.  Spawn, never fork: a parent that holds a CUDA context cannot
  fork, and a spawn worker imports the package afresh without touching
  CUDA.  A pool that fails to start raises; nothing falls back to thread
  mode.

Knobs: ``MXNET_TPU_IO_WORKERS``, ``MXNET_TPU_IO_PREFETCH_DEPTH``.  The
consumer's blocked time is the ``io_pipeline.queue_wait_ms`` histogram
(and, while the profiler records, a ``pipe:queue_wait`` span); the task
queue's depth and the reorder buffer's fill are live gauges.
"""
from __future__ import annotations

import itertools
import os
import queue as _queue
import threading
import warnings

from .. import threads as _threads
from ..base import MXNetError
from ..observability import tracing as _tracing
from ..observability.instrument import (arm_pipeline_gauges,
                                        disarm_pipeline_gauges,
                                        note_pipeline_decode,
                                        note_pipeline_wait)


class PipelineClosed(MXNetError):
    """The pipeline was shut down while this operation was blocked."""


def _note_consumer_wait(t0_us, t1_us):
    """The one place consumer-blocked time becomes telemetry: the
    io_pipeline.queue_wait_ms observation plus (when recording and not
    suppressed by arm-time priming) the matching ``pipe:queue_wait``
    span.  Shared by the thread-pool get, the process-pool window, and
    the upload stage so the three paths cannot diverge."""
    if note_pipeline_wait((t1_us - t0_us) / 1e6) \
            and _tracing.is_recording():
        _tracing.emit_complete("pipe:queue_wait", t0_us, t1_us - t0_us,
                               category="io_pipeline", pid="io")


class _Failure:
    """A worker exception in transit through the reorder buffer."""

    __slots__ = ("exc",)

    def __init__(self, exc):
        self.exc = exc


def _env_int(name, default, minimum=1):
    raw = os.environ.get(name)
    if raw is None or not raw.strip():
        return default
    try:
        return max(minimum, int(raw))
    except ValueError:
        warnings.warn("%s=%r is not an integer; using %d"
                      % (name, raw, default))
        return default


def default_num_workers():
    """``MXNET_TPU_IO_WORKERS``, else min(4, cores): workers beyond the
    core count only thrash the scheduler."""
    cores = os.cpu_count() or 2
    return _env_int("MXNET_TPU_IO_WORKERS", max(1, min(4, cores)))


def default_prefetch_depth():
    """``MXNET_TPU_IO_PREFETCH_DEPTH``, else 2: batches buffered ready
    for the consumer beyond the ones workers are still finishing."""
    return _env_int("MXNET_TPU_IO_PREFETCH_DEPTH", 2)


class ReorderBuffer:
    """Release out-of-order completions strictly in sequence.

    ``put(seq, item)`` blocks while ``seq`` is ``capacity`` or more ahead
    of the next sequence number the consumer will take: the bound that
    keeps a fast worker from racing arbitrarily far ahead of a slow one.
    ``get()`` blocks until the next-in-order item arrives.  ``close()``
    wakes every blocked producer and consumer with
    :class:`PipelineClosed`.  ``max_fill`` records the high-water mark of
    completed-but-unreleased items (at most ``capacity``).
    """

    def __init__(self, capacity):
        if capacity < 1:
            raise ValueError("capacity must be >= 1, got %r" % (capacity,))
        self.capacity = capacity
        self.max_fill = 0
        self._items = {}
        self._next = 0
        self._closed = False
        self._cv = _threads.package_condition("ReorderBuffer._cv")

    def put(self, seq, item):
        with self._cv:
            if seq < self._next:
                raise MXNetError(
                    "reorder buffer: sequence %d already released "
                    "(next=%d)" % (seq, self._next))
            while not self._closed and seq >= self._next + self.capacity:
                self._cv.wait()
            if self._closed:
                raise PipelineClosed("reorder buffer closed")
            self._items[seq] = item
            self.max_fill = max(self.max_fill, len(self._items))
            self._cv.notify_all()

    def get(self):
        with self._cv:
            while not self._closed and self._next not in self._items:
                self._cv.wait()
            if self._closed:
                raise PipelineClosed("reorder buffer closed")
            item = self._items.pop(self._next)
            self._next += 1
            self._cv.notify_all()
            return item

    def fill(self):
        with self._cv:
            return len(self._items)

    def close(self):
        """Wake every waiter AND drop buffered items: completed batches
        can hold device memory, and a closed run must not pin it."""
        with self._cv:
            self._closed = True
            self._items.clear()
            self._cv.notify_all()


class PrefetchExecutor:
    """Run numbered tasks on a worker pool, yielding results in order.

    ``fn`` maps one task to one result; ``run(tasks)`` is a generator
    over ``fn(t)`` for each task, in task order, with up to
    ``num_workers`` tasks executing concurrently and up to ``depth``
    completed results buffered ahead of the consumer.  A task that
    raises re-raises at its position in the output sequence and ends the
    run.  Closing the generator (or letting it finish) stops the feeder,
    closes the reorder buffer and joins the worker threads: nothing
    outlives the epoch but a process pool, which :meth:`close` releases.
    """

    _POLL_S = 0.05  # worker/feeder wakeup cadence while blocked

    def __init__(self, fn, num_workers=None, depth=None, mode="thread",
                 name="io_pipeline", initializer=None, initargs=(),
                 timed=True):
        if mode not in ("thread", "process"):
            raise ValueError("mode must be 'thread' or 'process', got %r"
                             % (mode,))
        self.fn = fn
        self.num_workers = (default_num_workers() if num_workers is None
                            else max(1, int(num_workers)))
        self.depth = (default_prefetch_depth() if depth is None
                      else max(1, int(depth)))
        self.mode = mode
        self.name = name
        # process mode: run once in each spawn worker, the place to
        # register context (source, decoder) so that a task's pickle is
        # just the BatchTask
        self.initializer = initializer
        self.initargs = tuple(initargs)
        self._pool = None  # persistent process pool (mode='process')
        # timed=False when another stage (the process-mode upload thread)
        # consumes this run: its blocking is not the consumer's starvation
        self.timed = bool(timed)

    def close(self):
        """Release the persistent process pool, if any, and wait for its
        workers to exit.  Idempotent; the pool re-creates lazily on the
        next run."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True, cancel_futures=True)

    def __del__(self):
        try:
            pool, self._pool = self._pool, None
            if pool is not None:
                pool.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass

    def run(self, tasks):
        tasks = list(tasks)
        if not tasks:
            return iter(())
        if self.mode == "process":
            return self._run_process(tasks)
        return self._run_thread(tasks)

    # -- thread pool ---------------------------------------------------------
    def _run_thread(self, tasks):
        n = len(tasks)
        stop = threading.Event()
        task_q = _queue.Queue(maxsize=max(1, self.depth))
        rb = ReorderBuffer(self.depth + self.num_workers)

        def feeder():
            for seq, task in enumerate(tasks):
                while not stop.is_set():
                    try:
                        task_q.put((seq, task), timeout=self._POLL_S)
                        break
                    except _queue.Full:
                        continue
                if stop.is_set():
                    return

        def worker():
            while not stop.is_set():
                try:
                    seq, task = task_q.get(timeout=self._POLL_S)
                except _queue.Empty:
                    continue
                try:
                    out = self.fn(task)
                except Exception as exc:  # re-raised on the consumer side
                    out = _Failure(exc)
                try:
                    rb.put(seq, out)
                except PipelineClosed:
                    return

        # live per-stage queue-depth gauges, re-armed every run so they
        # survive a telemetry.reset() between epochs; the last-armed run
        # owns them when several pipelines are live
        gauge_token = arm_pipeline_gauges(task_q.qsize, rb.fill)
        threads = [_threads.spawn(feeder, "io_pipeline",
                                  "%s-feeder" % self.name, start=False)]
        threads += [_threads.spawn(worker, "io_pipeline",
                                   "%s-worker-%d" % (self.name, i),
                                   start=False)
                    for i in range(self.num_workers)]
        for t in threads:
            t.start()
        try:
            for _ in range(n):
                item = self._timed_get(rb) if self.timed else rb.get()
                if isinstance(item, _Failure):
                    raise item.exc
                yield item
        finally:
            stop.set()
            rb.close()
            # drain whatever the feeder parked so that workers hold no
            # task references, then join: bounded, every loop polls stop
            try:
                while True:
                    task_q.get_nowait()
            except _queue.Empty:
                pass
            for t in threads:
                t.join(timeout=5.0)
            leaked = [t.name for t in threads if t.is_alive()]
            if leaked:
                warnings.warn("io_pipeline workers did not stop: %s"
                              % leaked)
            disarm_pipeline_gauges(gauge_token)

    @staticmethod
    def _timed_get(rb):
        """One in-order take, with the consumer's blocked time recorded
        as the pipeline-starvation signal."""
        t0 = _tracing.now_us()
        item = rb.get()
        _note_consumer_wait(t0, _tracing.now_us())
        return item

    # -- process pool --------------------------------------------------------
    def _ensure_pool(self):
        # the pool persists across runs (epochs), so the interpreter start
        # of each worker is paid once per executor, not once per reset()
        if self._pool is None:
            import multiprocessing as mp
            from concurrent.futures import ProcessPoolExecutor
            self._pool = ProcessPoolExecutor(
                max_workers=self.num_workers,
                mp_context=mp.get_context("spawn"),
                initializer=self.initializer,
                initargs=self.initargs)
        return self._pool

    def _run_process(self, tasks):
        from collections import deque

        window = self.num_workers + self.depth
        pool = self._ensure_pool()
        pending = deque()
        gauge_token = arm_pipeline_gauges(lambda: len(pending), lambda: 0)
        try:
            it = iter(tasks)
            for task in itertools.islice(it, window):
                pending.append(pool.submit(self.fn, task))
            while pending:
                fut = pending.popleft()
                t0 = _tracing.now_us()
                res = fut.result()
                t1 = _tracing.now_us()
                if self.timed:
                    # this run is consumed directly: blocking here is
                    # consumer starvation
                    _note_consumer_wait(t0, t1)
                decode_s = getattr(res, "decode_s", None)
                if decode_s is not None:
                    # worker-measured decode time (the workers' registries
                    # never reach the parent); the span is back-dated to
                    # arrival minus duration
                    rows = getattr(getattr(res, "data", None), "shape",
                                   (0,))[0]
                    note_pipeline_decode(decode_s, int(rows))
                    if _tracing.is_recording():
                        _tracing.emit_complete(
                            "pipe:decode", t1 - decode_s * 1e6,
                            decode_s * 1e6, category="io_pipeline",
                            pid="io", args={"seq": getattr(res, "seq",
                                                           -1)})
                for task in itertools.islice(it, 1):
                    pending.append(pool.submit(self.fn, task))
                yield res
        finally:
            # the pool outlives the run; only the in-flight window is
            # abandoned
            for fut in pending:
                fut.cancel()
            disarm_pipeline_gauges(gauge_token)


class ThreadedStage:
    """Move a generator's consumption onto a background thread.

    Items flow through a bounded queue; the foreground ``__next__`` is a
    plain queue take.  Used to take per-batch work that must run in the
    driving process but not on the driving thread (the upload of
    process-pool batches) out of the consumer's critical path.
    ``close()`` stops the thread and closes the underlying generator (on
    the background thread, where it is legal)."""

    _POLL_S = 0.05
    _END = object()

    def __init__(self, gen, depth=2, name="io_pipeline-stage", timed=False):
        self._gen = gen
        # timed=True when the foreground consumer is the pipeline's
        # consumer (the process-mode upload stage)
        self._timed = bool(timed)
        self._q = _queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._done = False
        self._thread = _threads.spawn(self._run, "io_pipeline",
                                      "stage-%s" % name)

    def _run(self):
        try:
            try:
                for item in self._gen:
                    if not self._put(item):
                        return
            except Exception as exc:  # re-raised on the consumer side
                self._put(_Failure(exc))
                return
            self._put(self._END)
        finally:
            self._gen.close()

    def _put(self, item):
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=self._POLL_S)
                return True
            except _queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        t0 = _tracing.now_us() if self._timed else 0
        while True:
            if self._done:
                raise StopIteration
            if self._stop.is_set():
                raise PipelineClosed("stage closed")
            try:
                item = self._q.get(timeout=self._POLL_S)
            except _queue.Empty:
                continue
            if item is self._END:
                self._done = True
                raise StopIteration
            if isinstance(item, _Failure):
                # the producer thread exited after shipping this: a later
                # next() must see exhaustion, not poll forever
                self._done = True
                raise item.exc
            if self._timed:
                _note_consumer_wait(t0, _tracing.now_us())
            return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except _queue.Empty:
            pass
        self._thread.join(timeout=5.0)
        if self._thread.is_alive():
            warnings.warn("io_pipeline stage thread did not stop")

"""DataLoader (ref: python/mxnet/gluon/data/dataloader.py).

Counterpart of ``mxnet_tpu/gluon/data/dataloader.py``.  The reference
forks worker processes that pass NDArrays through shared memory; here,
as in the JAX package, ``num_workers`` threads batchify (numpy releases
the GIL), so no worker touches CUDA after a fork.  ``num_workers=0``
stays synchronous.  A batch lands on the context current where the
iteration started (``gpu(0)`` unless the caller is inside ``with
mx.cpu():``), also when a worker thread builds it.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ...context import Context, current_context
from ...ndarray import NDArray, array as nd_array
from .sampler import BatchSampler, RandomSampler, SequentialSampler

__all__ = ["DataLoader", "default_batchify_fn"]


def default_batchify_fn(data):
    """Stack samples into a batch (ref: dataloader.py:default_batchify_fn)."""
    if isinstance(data[0], NDArray):
        from ...ndarray import stack
        return stack(*data)
    if isinstance(data[0], tuple):
        data = zip(*data)
        return [default_batchify_fn(i) for i in data]
    data = np.asarray(data)
    return nd_array(data, dtype=data.dtype)


class DataLoader:
    def __init__(self, dataset, batch_size=None, shuffle=False, sampler=None,
                 last_batch=None, batch_sampler=None, batchify_fn=None,
                 num_workers=0):
        self._dataset = dataset
        if batch_sampler is None:
            if batch_size is None:
                raise ValueError(
                    "batch_size must be specified unless batch_sampler is "
                    "specified")
            if sampler is None:
                sampler = RandomSampler(len(dataset)) if shuffle else \
                    SequentialSampler(len(dataset))
            elif shuffle:
                raise ValueError(
                    "shuffle must not be specified if sampler is specified")
            batch_sampler = BatchSampler(sampler, batch_size,
                                         last_batch or "keep")
        elif (batch_size is not None or shuffle or sampler is not None
              or last_batch is not None):
            raise ValueError(
                "batch_size, shuffle, sampler and last_batch must not be "
                "specified if batch_sampler is specified.")
        self._batch_sampler = batch_sampler
        self._num_workers = num_workers
        self._batchify_fn = batchify_fn or default_batchify_fn

    def _make_batch(self, indices, ctx):
        # a Context of its own per call: entering one saves the previous
        # default on the instance, which threads must not share
        with Context(ctx):
            return self._batchify_fn([self._dataset[i] for i in indices])

    def __iter__(self):
        ctx = current_context()
        if self._num_workers == 0:
            for batch in self._batch_sampler:
                yield self._make_batch(batch, ctx)
            return
        # threaded prefetch: keep 2 * num_workers batches in flight
        with ThreadPoolExecutor(max_workers=self._num_workers) as pool:
            futures = []
            it = iter(self._batch_sampler)
            try:
                for _ in range(self._num_workers * 2):
                    futures.append(pool.submit(self._make_batch, next(it),
                                               ctx))
            except StopIteration:
                pass
            while futures:
                batch = futures.pop(0).result()
                try:
                    futures.append(pool.submit(self._make_batch, next(it),
                                               ctx))
                except StopIteration:
                    pass
                yield batch

    def __len__(self):
        return len(self._batch_sampler)

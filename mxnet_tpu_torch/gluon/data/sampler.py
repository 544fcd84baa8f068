"""Samplers (ref: python/mxnet/gluon/data/sampler.py).

Counterpart of ``mxnet_tpu/gluon/data/sampler.py``: an index stream plus
a batching wrapper whose last-batch policy is one of keep/discard/
rollover.  ``RandomSampler`` draws its order from numpy's global
generator, as the JAX package's does.
"""
from __future__ import annotations

from itertools import chain, islice

import numpy as np

__all__ = ["Sampler", "SequentialSampler", "RandomSampler", "BatchSampler"]


class Sampler:
    """An iterable of dataset indices with a known length."""

    def __iter__(self):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError


class _RangeSampler(Sampler):
    """Index stream over range(length); subclasses pick the order."""

    _shuffled = False

    def __init__(self, length):
        self._length = length

    def __len__(self):
        return self._length

    def __iter__(self):
        if self._shuffled:
            return iter(np.random.permutation(self._length))
        return iter(range(self._length))


class SequentialSampler(_RangeSampler):
    pass


class RandomSampler(_RangeSampler):
    _shuffled = True


class BatchSampler(Sampler):
    """Chunk an index sampler into batches.

    last_batch policy for a trailing partial chunk: 'keep' emits it,
    'discard' drops it, 'rollover' saves it as the head of the next
    epoch's first batch.
    """

    def __init__(self, sampler, batch_size, last_batch="keep"):
        if last_batch not in ("keep", "discard", "rollover"):
            raise ValueError(
                "last_batch must be one of 'keep', 'discard', or "
                "'rollover', but got %s" % last_batch)
        self._sampler = sampler
        self._batch_size = batch_size
        self._last_batch = last_batch
        self._carry = []

    def __iter__(self):
        feed = chain(self._carry, iter(self._sampler))
        self._carry = []
        while True:
            chunk = list(islice(feed, self._batch_size))
            if len(chunk) == self._batch_size:
                yield chunk
            else:
                break
        if not chunk:
            return
        if self._last_batch == "keep":
            yield chunk
        elif self._last_batch == "rollover":
            self._carry = chunk
        # 'discard': drop the partial chunk

    def __len__(self):
        n = len(self._sampler)
        if self._last_batch == "keep":
            return -(-n // self._batch_size)
        if self._last_batch == "discard":
            return n // self._batch_size
        return (n + len(self._carry)) // self._batch_size  # rollover

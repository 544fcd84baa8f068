"""Deterministic epoch planning: order, shards, batches, per-record seeds.

Counterpart of ``mxnet_tpu/io_pipeline/sharding.py``, the same integers
for the same arguments.

Everything here is a pure function of ``(seed, epoch, record count)`` —
the root of the pipeline's determinism contract: the batch sequence (and
every augmentation draw inside it) is bitwise-identical for a fixed seed
whatever the worker count, pool mode, or prefetch depth.
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError

_MASK = 0x7FFFFFFF


def epoch_seed(seed, epoch):
    """The RNG seed governing epoch ``epoch``'s shuffle order (same
    mixing as ImageRecordIter's reproducible-epoch reseed, io.py)."""
    return (int(seed) + 1000003 * int(epoch)) & _MASK


def record_seed(seed, epoch, gidx):
    """Per-record augmentation seed: a pure function of (pipeline seed,
    epoch, the record's position in the epoch order) — identical
    whatever worker decodes it (same formula as EnginePipelineIter)."""
    return ((int(seed) * 1000003 + int(epoch) * 7919)
            ^ (int(gidx) * 2654435761)) & _MASK


def epoch_order(n, seed, epoch, shuffle):
    """Positions 0..n-1 in this epoch's traversal order (a permutation
    when shuffling, identity otherwise)."""
    if not shuffle:
        return np.arange(n, dtype=np.int64)
    rng = np.random.RandomState(epoch_seed(seed, epoch))
    return rng.permutation(n).astype(np.int64)


def shard_records(n, num_shards, shard_index):
    """Positions assigned to shard ``shard_index`` of ``num_shards``.

    Balanced contiguous split: the first ``n % num_shards`` shards take
    one extra record, so the union over all shards covers every record
    exactly once (unlike the reference's truncating ``num_parts`` split,
    which silently drops the tail — the coverage property the tier-1
    test pins)."""
    if not (0 <= shard_index < num_shards):
        raise MXNetError("shard_index %d out of range for %d shards"
                         % (shard_index, num_shards))
    base, extra = divmod(n, num_shards)
    start = shard_index * base + min(shard_index, extra)
    stop = start + base + (1 if shard_index < extra else 0)
    return np.arange(start, stop, dtype=np.int64)


class BatchTask:
    """One unit of parallel work: decode+assemble one output batch.

    ``seq`` is the batch's position in the epoch (the reorder key);
    ``positions`` are epoch-order record positions (``gidx`` for the
    per-record seed); ``pad`` counts wrapped rows in a tail batch.
    Plain picklable data so process-pool workers can receive it.
    """

    __slots__ = ("seq", "epoch", "positions", "indices", "pad")

    def __init__(self, seq, epoch, positions, indices, pad):
        self.seq = seq
        self.epoch = epoch
        self.positions = positions  # gidx per row (seed input)
        self.indices = indices      # source record index per row
        self.pad = pad

    def __getstate__(self):
        return (self.seq, self.epoch, self.positions, self.indices,
                self.pad)

    def __setstate__(self, state):
        (self.seq, self.epoch, self.positions, self.indices,
         self.pad) = state


def epoch_plan(n, batch_size, seed, epoch, shuffle,
               last_batch_handle="pad"):
    """The full ordered task list for one epoch.

    ``pad``: the tail batch wraps to the epoch's first records and
    reports ``pad`` (reference batch-loader semantics — consumers trim);
    ``discard``: the tail is dropped; ``roll_over`` is not supported
    (the pipeline re-plans per epoch).  Every record appears exactly
    once as a non-pad row."""
    if batch_size < 1:
        raise MXNetError("batch_size must be >= 1")
    if n < 1:
        return []
    if last_batch_handle not in ("pad", "discard"):
        raise MXNetError("last_batch_handle must be 'pad' or 'discard', "
                         "got %r" % (last_batch_handle,))
    order = epoch_order(n, seed, epoch, shuffle)
    tasks = []
    seq = 0
    for lo in range(0, n, batch_size):
        hi = lo + batch_size
        pad = 0
        if hi > n:
            if last_batch_handle == "discard":
                break
            pad = hi - n
        positions = np.arange(lo, hi, dtype=np.int64) % n
        indices = order[positions]
        tasks.append(BatchTask(seq, epoch, tuple(int(p) for p in positions),
                               tuple(int(i) for i in indices), pad))
        seq += 1
    return tasks

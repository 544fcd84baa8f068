"""The distributed store: ``kvstore='dist_sync'`` (any name with
``dist``) across processes over ``torch.distributed``.

Counterpart of ``mxnet_tpu/kvstore/dist.py``, which replaces ps-lite's
parameter servers with collectives across the worker processes: there
are no server processes, every worker reduces the same keys in the same
order (the reference's sync-mode contract) and, updating on the store,
applies the same update to the same sum, so the workers' weights stay
equal.  ``dist_async`` is sync-equivalent, as in the JAX package.

- **Rendezvous.** ``base.maybe_initialize_distributed_from_env`` reads
  the environment ``tools/launch.py`` sets and joins the process group
  (gloo, over a TCP store at the coordinator's address) when the first
  dist store is made.  Without it, ``rank``/``num_workers`` read
  ``DMLC_WORKER_ID``/``DMLC_NUM_WORKER``, and reductions are local.  The
  first store of a process waits at a named barrier for its peers, then
  runs a warm-up collective.
- **Backend rule.** A store reduces over ``nccl`` when every rank's
  tensors sit on a distinct CUDA device (each rank writes its device's
  UUID into the store at the first reduction, and all read them all),
  else over ``gloo``: two ranks on one card (NCCL refuses a duplicate
  GPU) or on the host.  Gloo takes host tensors, so a CUDA tensor is
  staged through pinned memory and its sum copied back to its device: a
  transport, the computation stays on the device.  ``backend`` names the
  choice.
- **Batching.** ``push_pull_list`` reduces every key in one all-reduce
  per dtype or, under 2-bit compression, one all-gather of every key's
  concatenated codes (``wire_bytes_pushed`` counts what crossed).
- The JAX package keeps an LRU of jitted collective programs; torch's
  collectives are not compiled programs, so there is nothing to cache.
- Each cross-process collective reports its payload and host wall time
  as exposed communication (``record_comm_exposed``), as the JAX
  package's does.
"""
from __future__ import annotations

import datetime
import itertools
import os
import time

import torch
import torch.distributed as dist

from ..base import MXNetError, dist_store, maybe_initialize_distributed_from_env
from ..ndarray import NDArray
from ..observability.instrument import record_comm_exposed
from . import KVStore, _compression, _key_value

# process-global, so store keys are never reused within the job
_SEQUENCE = itertools.count()
_RENDEZVOUSED = []
_BARRIER_S = 180


def _multi_process():
    return dist.is_initialized() and dist.get_world_size() > 1


def _named_barrier(name):
    """Every rank at ``name`` before any goes on; a rank that calls it a
    different number of times fails here (timeout) instead of pairing
    one collective with another."""
    store, rank = dist_store(), dist.get_rank()
    store.set("%s/%d" % (name, rank), b"1")
    store.wait(["%s/%d" % (name, r) for r in range(dist.get_world_size())],
               datetime.timedelta(seconds=_BARRIER_S))


def _gloo_group():
    return None if dist.get_backend() == "gloo" \
        else dist.new_group(backend="gloo")


class DistKVStore(KVStore):
    def __init__(self, name="dist_sync"):
        super().__init__(name)
        # bytes handed to cross-process collectives by push (the 2-bit
        # codes under compression)
        self.wire_bytes_pushed = 0
        self.backend = None   # "nccl" or "gloo", at the first reduction
        self._group = None
        maybe_initialize_distributed_from_env()
        # the host transport: the default group when it is gloo's
        self._host_group = _gloo_group() if _multi_process() else None
        if _multi_process() and not _RENDEZVOUSED:
            # workers arrive with minutes of skew (imports, first builds):
            # the first store waits for all, then a warm-up collective
            # sets up the transport while they are aligned
            _RENDEZVOUSED.append(True)
            _named_barrier("mxnet_kvstore_init")
            self.barrier()

    @property
    def rank(self):
        if dist.is_initialized():
            return dist.get_rank()
        return int(os.environ.get("DMLC_WORKER_ID", 0))

    @property
    def num_workers(self):
        if dist.is_initialized():
            return dist.get_world_size()
        return int(os.environ.get("DMLC_NUM_WORKER", 1))

    def set_gradient_compression(self, compression_params):
        self._gc = _compression(compression_params)
        self._compression_params = compression_params

    # -- transport -------------------------------------------------------
    def _transport(self, device):
        """(backend, group) of this store, chosen at its first reduction
        by the backend rule (module docstring)."""
        if self.backend is None:
            store, rank = dist_store(), dist.get_rank()
            key = "mxnet_kvstore_device/%d/" % next(_SEQUENCE)
            mine = str(torch.cuda.get_device_properties(device).uuid) \
                if device.type == "cuda" else "host"
            store.set(key + str(rank), mine.encode())
            seen = [store.get(key + str(r)).decode()
                    for r in range(dist.get_world_size())]
            if "host" not in seen and len(set(seen)) == len(seen):
                self.backend = "nccl"
                self._group = dist.new_group(backend="nccl")
            else:
                self.backend = "gloo"
                self._group = self._host_group
        return self.backend, self._group

    def _allreduce(self, t):
        """The sum of ``t`` over the processes, on ``t``'s device."""
        if not _multi_process():
            return t
        backend, group = self._transport(t.device)
        if backend == "nccl" or not t.is_cuda:
            out = t.clone()
            dist.all_reduce(out, group=group)
            return out
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        dist.all_reduce(host, group=group)
        return host.to(t.device, non_blocking=True)

    def _allgather(self, t):
        """[processes, ...]: every process's ``t``, stacked, on ``t``'s
        device."""
        if not _multi_process():
            return t[None]
        backend, group = self._transport(t.device)
        staged = t if backend == "nccl" or not t.is_cuda else \
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
        parts = [torch.empty_like(staged)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, staged, group=group)
        return torch.stack(parts).to(t.device, non_blocking=True)

    # -- push / pull -----------------------------------------------------
    def push(self, key, value, priority=0):
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            merged = self._reduce(v, key=k)  # this process's contexts first
            g = merged.tensor
            t0 = time.perf_counter()
            if self._gc is not None:
                # the 2-bit codes are the payload: gather them, sum locally
                packed = self._gc.quantize(k, g)
                nbytes = packed.numel()
                summed = self._gc.dequantize_sum(self._allgather(packed),
                                                 g.shape, g.dtype)
            else:
                nbytes = g.numel() * g.element_size()
                summed = self._allreduce(g)
            self.wire_bytes_pushed += nbytes
            record_comm_exposed("push", nbytes, time.perf_counter() - t0,
                                self._type)
            self._apply(k, NDArray(summed))

    def push_pull_list(self, keys, push_values, pull_outs, priority=0):
        """``push`` + ``pull`` of every key with one collective: an
        all-reduce per dtype of the keys' concatenated values, or one
        all-gather of their concatenated 2-bit codes."""
        merged = [self._reduce(v, key=k) for k, v in zip(keys, push_values)]
        for k in keys:
            if self._stored.get(k) is None:
                raise MXNetError("key %r has not been initialized" % (k,))
        reduced = [None] * len(keys)
        t0 = time.perf_counter()
        wire0 = self.wire_bytes_pushed
        if self._gc is not None:
            packed = [self._gc.quantize(k, m.tensor)
                      for k, m in zip(keys, merged)]
            concat = torch.cat(packed)
            self.wire_bytes_pushed += concat.numel()
            gathered = self._allgather(concat)
            offset = 0
            for i, (m, p) in enumerate(zip(merged, packed)):
                rows = gathered[:, offset:offset + p.numel()]
                offset += p.numel()
                reduced[i] = self._gc.dequantize_sum(rows, m.shape,
                                                     m.tensor.dtype)
        else:
            groups = {}
            for i, m in enumerate(merged):
                groups.setdefault((m.tensor.dtype, m.tensor.device),
                                  []).append(i)
            for members in groups.values():
                flat = torch.cat([merged[i].tensor.reshape(-1)
                                  for i in members])
                self.wire_bytes_pushed += flat.numel() * flat.element_size()
                summed = self._allreduce(flat)
                offset = 0
                for i in members:
                    n = merged[i].size
                    reduced[i] = summed[offset:offset + n].view(
                        merged[i].shape)
                    offset += n
        record_comm_exposed("push_pull", self.wire_bytes_pushed - wire0,
                            time.perf_counter() - t0, self._type)
        for k, m, arr, out in zip(keys, merged, reduced, pull_outs):
            self._apply(k, NDArray(arr))
            self.pull(k, out=out, priority=priority)

    def barrier(self):
        """A named barrier (call-count skew fails loudly there), then a
        one-element all-reduce that pairs by order, as the JAX package's
        does."""
        if not _multi_process():
            return
        _named_barrier("mxnet_kvstore_barrier/%d" % next(_SEQUENCE))
        dist.all_reduce(torch.zeros(1), group=self._host_group)

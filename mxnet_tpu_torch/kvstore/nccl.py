"""The collective store: ``kvstore='tpu_ici'`` (any name with ``tpu`` or
``ici``) on CUDA.

Counterpart of ``mxnet_tpu/kvstore/tpu_ici.py``, which replaces
KVStoreNCCL (src/kvstore/kvstore_nccl.h:62) with XLA collectives over
the device mesh.  Here:

- ``allreduce_arrays`` sums a key's copies.  Copies on distinct CUDA
  devices go through one NCCL all-reduce (``torch.cuda.nccl.all_reduce``,
  in place on each card), and every card keeps its own replica of the
  sum.  Copies that share a device (``[gpu(0)] * 2``, or host contexts)
  are tree-summed where they sit, as the JAX package sums copies that are
  not on distinct devices (``tpu_ici.py:65-75``).
- ``push`` keeps the reduced value per device, so ``pull`` hands each
  context its own device's copy; ``push_pull`` is one reduction.
- ``push_pull_list`` flattens each context's gradients of one dtype into
  one buffer and reduces each (dtype, contexts) group once, then
  scatters the sums back (ref: kvstore_nccl.h GroupKVPairs).  Grouping is
  by context, not by physical device, so on one card this is the same
  sum as per key with one reduction a step.

As the reference's NCCL store, this store leaves the optimizer to each
context (``model._create_kvstore`` sets ``update_on_kvstore=False``): the
replicas apply one update to one reduced gradient and stay equal bit for
bit.  The NCCL branch runs only where the copies sit on distinct cards.
Pushes and pulls report bytes and host wall time (``record_kv``), and
the reductions their one-copy payload as exposed communication
(``record_comm_exposed``), as the JAX package's ``tpu_ici`` does.
"""
from __future__ import annotations

import time

import torch
import torch.distributed

from ..base import MXNetError
from ..ndarray import NDArray
from ..observability.instrument import record_comm_exposed, record_kv
from . import KVStore, _key_value, _tree_sum


def allreduce_arrays(tensors):
    """The sum of same-shaped tensors, one tensor per input position on
    that input's device.  Distinct CUDA devices: an NCCL all-reduce over
    copies; otherwise a tree sum where the first copy sits, which every
    position on that device shares (others get a copy)."""
    devs = [t.device for t in tensors]
    if len(set(devs)) == len(devs) and all(d.type == "cuda" for d in devs):
        outs = [t.clone() for t in tensors]
        torch.cuda.nccl.all_reduce(outs)
        return outs
    dev = devs[0]
    copies = {dev: _tree_sum([t if t.device == dev else t.to(dev)
                              for t in tensors])}
    for d in devs:
        if d not in copies:
            copies[d] = copies[dev].to(d)
    return [copies[d] for d in devs]


class NcclKVStore(KVStore):
    def __init__(self, name="tpu_ici", mesh=None):
        super().__init__(name)
        self._replicas = {}  # key -> {device: reduced value}
        self._mesh = mesh

    @property
    def mesh(self):
        """The store's ``mx.parallel`` mesh: the one it was given, else
        the current mesh (made on first use over every CUDA device)."""
        if self._mesh is None:
            from ..parallel.mesh import current_mesh
            self._mesh = current_mesh()
        return self._mesh

    @property
    def rank(self):
        dist = torch.distributed
        return dist.get_rank() if dist.is_initialized() else 0

    @property
    def num_workers(self):
        dist = torch.distributed
        return dist.get_world_size() if dist.is_initialized() else 1

    def _keep(self, k, sums):
        """Store a key's reduced value: its first copy, and one per
        device for ``pull``."""
        self._stored[k] = NDArray(sums[0])
        self._replicas[k] = {t.device: t for t in sums}

    def push(self, key, value, priority=0):
        t0 = time.perf_counter()
        comm_bytes = 0
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            stored = self._stored.get(k)
            if stored is None:
                raise MXNetError("key %r has not been initialized" % (k,))
            vals = [v] if isinstance(v, NDArray) else list(v)
            if stored.stype != "default" \
                    or any(x.stype != "default" for x in vals):
                # a sparse array's inherited tensor is an empty
                # placeholder: the dense collective would drop the
                # payload, so sparse values take the base store's path
                self._replicas.pop(k, None)
                KVStore.push(self, k, v, priority)
                continue
            if len(vals) == 1:
                sums = [vals[0].tensor.clone()]  # the value at push time
            else:
                # the collective's payload per copy (metadata, no sync)
                comm_bytes += vals[0].tensor.numel() \
                    * vals[0].tensor.element_size()
                sums = allreduce_arrays([x.tensor for x in vals])
            if self._updater is None:
                self._keep(k, sums)
                continue
            dev = stored.tensor.device
            self._apply(k, NDArray(next((t for t in sums if t.device == dev),
                                        sums[0])))
        dt = time.perf_counter() - t0
        record_kv("push", value, dt, self._type)
        if comm_bytes:
            # the store's reduction is exposed communication: the step
            # waits on it
            record_comm_exposed("push", comm_bytes, dt, self._type)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull needs out=")
        t0 = time.perf_counter()
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            if self._stored[k].stype != "default":
                KVStore.pull(self, k, out=olist, priority=priority)
                continue
            local = self._replicas.get(k, {})
            stored = self._stored[k].tensor
            for o in [olist] if isinstance(olist, NDArray) else olist:
                with torch.no_grad():
                    o.tensor.copy_(local.get(o.tensor.device, stored))
        record_kv("pull", out, time.perf_counter() - t0, self._type)

    def push_pull(self, key, push_value, pull_out, priority=0):
        """One reduction a key; each output reads its device's copy."""
        self.push(key, push_value, priority)
        self.pull(key, out=pull_out, priority=priority)

    def push_pull_list(self, keys, push_values, pull_outs, priority=0):
        """Every key's copies in one reduction per (dtype, contexts)
        group: each context's gradients flatten into one buffer, the
        buffers are reduced once and the sums scattered back into
        ``pull_outs`` (which may be the pushed arrays).  A key with an
        updater installed, a single copy or mixed dtypes goes alone."""
        groups, alone = {}, []
        for k, v, o in zip(keys, push_values, pull_outs):
            if self._stored.get(k) is None:
                raise MXNetError("key %r has not been initialized" % (k,))
            vals = [v] if isinstance(v, NDArray) else list(v)
            dtypes = {x.tensor.dtype for x in vals}
            if self._updater is not None or len(vals) < 2 \
                    or len(dtypes) != 1:
                alone.append((k, v, o))
                continue
            group = (dtypes.pop(), tuple(x.context for x in vals))
            groups.setdefault(group, []).append((k, vals, o))
        t0 = time.perf_counter()
        comm_bytes = 0
        for (_, ctxs), items in groups.items():
            flats = [torch.cat([vals[i].tensor.reshape(-1)
                                for _, vals, _ in items])
                     for i in range(len(ctxs))]
            comm_bytes += flats[0].numel() * flats[0].element_size()
            sums = allreduce_arrays(flats)
            offset = 0
            for k, vals, o in items:
                shape, n = vals[0].shape, vals[0].size
                self._keep(k, [s[offset:offset + n].view(shape)
                               for s in sums])
                offset += n
                self.pull(k, out=o, priority=priority)
        if comm_bytes:
            record_comm_exposed("push_pull", comm_bytes,
                                time.perf_counter() - t0, self._type)
        for k, v, o in alone:
            self.push_pull(k, v, o, priority)

    def broadcast(self, key, value, out, priority=0):
        self.init(key, value)
        self.pull(key, out=out, priority=priority)

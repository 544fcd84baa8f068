"""KVStore: gradient aggregation and parameter synchronization.

Counterpart of ``mxnet_tpu/kvstore/__init__.py`` (ref: src/kvstore/,
include/mxnet/kvstore.h).  Stores:

- ``'local'``, ``'device'`` and ``'nccl'`` (this module): one process
  over one or more contexts.  A push sums each key's copies at one merge
  owner in a balanced tree of adds; ``'device'`` spreads the owners over
  the contexts, least loaded first by bytes, and with 2-bit compression
  the codes cross to the owner, which dequantizes and sums.
- names with ``tpu`` or ``ici`` (``kvstore/nccl.py``): the collective
  store of the JAX package's ``tpu_ici``, on NCCL between distinct cards
  and a summed reduction for copies on one card.
- names with ``dist`` (``kvstore/dist.py``): several processes over
  ``torch.distributed``.

A context is named by its position among a key's pushed copies, so two
contexts on one card (``[gpu(0)] * 2``) are two merge owners and keep two
compression residuals.  Each push and pull reports its payload bytes and
host wall time (``observability.instrument.record_kv``), as the JAX
package's do.
"""
from __future__ import annotations

import time

import torch

from ..base import MXNetError
from ..ndarray import NDArray
from .. import optimizer as opt
from ..observability.instrument import record_kv


class KVStore:
    """Single-process key-value store (ref: include/mxnet/kvstore.h)."""

    def __init__(self, name="local"):
        self._type = name
        self._stored = {}
        self._updater = None
        self._optimizer = None
        self._compression_params = None
        self._gc = None          # GradientCompression when requested
        self._merge_owner = {}   # key -> position of the merge owner
        self._owner_load = {}    # position -> bytes of the keys it owns

    @property
    def type(self):
        return self._type

    @property
    def rank(self):
        return 0

    @property
    def num_workers(self):
        return 1

    def init(self, key, value):
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            if k in self._stored:
                raise MXNetError("key %r already initialized" % (k,))
            self._stored[k] = v.copy() if isinstance(v, NDArray) else v

    def _merge_ctx(self, key, vals):
        """Position of the merge owner of ``key`` among its copies.
        ``'device'`` spreads the keys over the contexts, least loaded
        first by bytes (ref: CommDevice::InitMergeBuffer, comm.h:731);
        the other stores merge at the first copy."""
        if "device" not in self._type:
            return 0
        owner = self._merge_owner.get(key)
        if owner is None:
            owner = min(range(len(vals)),
                        key=lambda i: self._owner_load.get(i, 0))
            v = vals[0].tensor
            self._owner_load[owner] = self._owner_load.get(owner, 0) \
                + v.numel() * v.element_size()
            self._merge_owner[key] = owner
        return owner

    def _reduce(self, vals, key=None):
        """The sum of a key's copies, on the merge owner's context."""
        if isinstance(vals, NDArray):
            return vals
        if len(vals) == 1:
            return vals[0]
        if any(v.stype != "default" for v in vals):
            return _sparse_sum(vals)
        owner = self._merge_ctx(key, vals)
        if self._gc is not None and key is not None:
            return self._reduce_compressed(key, vals, owner)
        dev = vals[owner].tensor.device
        # a balanced tree of adds: log2(n) deep, copies on the owner's
        # device read in place
        moved = [v.tensor if v.tensor.device == dev else v.tensor.to(dev)
                 for v in vals]
        return NDArray(_tree_sum(moved))

    def _reduce_compressed(self, key, vals, owner):
        """Each copy quantizes against its own residual (per key and
        context) on its device; the packed codes, 2 bits a value, cross
        to the merge owner, which dequantizes and sums (ref: the device
        comm's compression, kvstore_local.h + gradient_compression.h)."""
        dev = vals[owner].tensor.device
        rows = [self._gc.quantize((key, i), v.tensor).to(dev)
                for i, v in enumerate(vals)]
        summed = self._gc.dequantize_sum(torch.stack(rows), vals[0].shape,
                                         vals[0].tensor.dtype)
        return NDArray(summed)

    def _apply(self, k, merged):
        """A key's merged value to the updater, or into the store.  When
        the merge ran on a card and the store holds the host copy that
        ``init`` took, the stored value moves to that card once, and the
        updater's state is made there, so the update runs where the
        gradients are (ref: KVStoreLocal::PushImpl copies ``local`` to
        ``merged``'s GPU); otherwise the merged value moves to the
        stored value's device."""
        stored = self._stored.get(k)
        if stored is None:
            raise MXNetError("key %r has not been initialized" % (k,))
        m_dev, s_dev = _device(merged), _device(stored)
        if m_dev != s_dev:
            if m_dev.type == "cuda" and s_dev.type != "cuda":
                stored = self._stored[k] = stored.copyto(merged.context)
            else:
                merged = merged.copyto(stored.context)
        if self._updater is not None:
            self._updater(_updater_key(k), merged, stored)
        else:
            merged.copyto(stored)

    def push(self, key, value, priority=0):
        t0 = time.perf_counter()
        keys, values = _key_value(key, value)
        for k, v in zip(keys, values):
            self._apply(k, self._reduce(v, key=k))
        record_kv("push", value, time.perf_counter() - t0, self._type)

    def pull(self, key, out=None, priority=0, ignore_sparse=True):
        if out is None:
            raise MXNetError("pull needs out=")
        t0 = time.perf_counter()
        keys, outs = _key_value(key, out)
        for k, olist in zip(keys, outs):
            stored = self._stored[k]
            for o in [olist] if isinstance(olist, NDArray) else olist:
                stored.copyto(o)
        record_kv("pull", out, time.perf_counter() - t0, self._type)

    def row_sparse_pull(self, key, out=None, priority=0, row_ids=None):
        """Pull only the rows ``row_ids`` names (ref: kvstore.h
        row_sparse_pull).  On the stored value's device, with no host
        sync: the ids are sorted and clipped to the table, duplicates kept
        (static shapes; a duplicated id carries its row twice).  A
        RowSparseNDArray output becomes those rows at those ids; a dense
        output gets those rows of the stored value and zeros elsewhere."""
        from ..ndarray.sparse import RowSparseNDArray
        if out is None:
            raise MXNetError("row_sparse_pull needs out=")
        if row_ids is None:
            self.pull(key, out=out, priority=priority)
            return
        keys, outs = _key_value(key, out)
        if not isinstance(row_ids, (list, tuple)):
            row_ids = [row_ids] * len(keys)
        for k, olist, rid in zip(keys, outs, row_ids):
            stored = self._stored[k]
            dense = (stored.todense() if stored.stype != "default"
                     else stored).tensor
            rid = rid.tensor if isinstance(rid, NDArray) \
                else torch.as_tensor(rid)
            ids = torch.sort(rid.to(dense.device, torch.int64).reshape(-1)) \
                .values.clamp(0, dense.shape[0] - 1)
            rows = dense[ids]
            for o in olist if isinstance(olist, (list, tuple)) else [olist]:
                if isinstance(o, RowSparseNDArray):
                    dev = o.data.tensor.device
                    o._set(NDArray(rows.to(dev, copy=True)),
                           NDArray(ids.to(dev, copy=True)), dense.shape)
                elif o.stype == "default":
                    with torch.no_grad():
                        o.tensor.zero_()
                        o.tensor[ids.to(o.tensor.device)] = \
                            rows.to(o.tensor.device)
                else:
                    raise MXNetError("row_sparse_pull into a %s array: pull "
                                     "into a row_sparse or a dense array"
                                     % o.stype)

    def set_gradient_compression(self, compression_params):
        """2-bit compression of the cross-context hop; a store that is
        neither ``'device'`` nor ``'dist'`` raises (ref: kvstore.py checks
        the type), since it would compress nothing."""
        if "device" not in self._type and "dist" not in self._type:
            raise MXNetError(
                "gradient compression requires a 'device' or 'dist' "
                "kvstore; %r does not compress anything" % self._type)
        self._gc = _compression(compression_params)
        self._compression_params = compression_params

    def set_optimizer(self, optimizer):
        self._optimizer = optimizer
        self._set_updater(opt.get_updater(optimizer))

    def _set_updater(self, updater):
        self._updater = updater

    set_updater = _set_updater

    def barrier(self):
        pass

    def send_command_to_servers(self, head, body):
        pass

    def save_optimizer_states(self, fname, dump_optimizer=False):
        if self._updater is None:
            raise MXNetError("the store runs no optimizer; there are no "
                             "states to save")
        with open(fname, "wb") as fout:
            fout.write(self._updater.get_states(dump_optimizer))

    def load_optimizer_states(self, fname):
        if self._updater is None:
            raise MXNetError("the store runs no optimizer; there are no "
                             "states to load")
        with open(fname, "rb") as fin:
            self._updater.set_states(fin.read())


def _tree_sum(tensors):
    """Sum of same-device tensors as a balanced tree of adds (pairs in
    order, an odd one carried), a new tensor."""
    while len(tensors) > 1:
        nxt = [tensors[i] + tensors[i + 1]
               for i in range(0, len(tensors) - 1, 2)]
        if len(tensors) % 2:
            nxt.append(tensors[-1])
        tensors = nxt
    return tensors[0]


def _device(nd):
    """The torch device of an NDArray's payload (a sparse array's data)."""
    return (nd.data if nd.stype != "default" else nd).tensor.device


def _sparse_sum(vals):
    """The sum of a key's copies when one is sparse, on the first copy's
    context, added one after another: row_sparse copies give a
    row_sparse sum over the ids they name together (sorted, duplicates
    kept, each id's row the sum's), any dense copy a dense sum."""
    from ..ndarray.sparse import RowSparseNDArray
    ctx = vals[0].context
    moved = [v.as_in_context(ctx) for v in vals]
    acc = None
    for v in moved:
        t = v.todense().tensor if v.stype != "default" else v.tensor
        acc = t.clone() if acc is None else acc.add_(t)
    if any(v.stype != "row_sparse" for v in moved):
        return NDArray(acc)
    ids = torch.sort(torch.cat([v.indices.tensor.long()
                                for v in moved])).values
    return RowSparseNDArray(NDArray(acc[ids]), NDArray(ids), acc.shape)


def _compression(compression_params):
    from .gradient_compression import GradientCompression
    params = dict(compression_params or {})
    ctype = params.pop("type", "2bit")
    if ctype != "2bit":
        raise MXNetError("unknown compression type %r" % ctype)
    return GradientCompression(**params)


def _updater_key(k):
    return k


def _key_value(key, value):
    """(keys, values) as parallel lists; a value may be a list of copies,
    one per context."""
    if isinstance(key, (str, int)):
        return [key], [value]
    if isinstance(value, (list, tuple)) and len(key) == len(value):
        return list(key), list(value)
    # a flat list of values grouped by key
    n = len(value) // len(key)
    return list(key), [value[i * n:(i + 1) * n] for i in range(len(key))]


def create(name="local"):
    """A store by name (ref: kvstore.cc:38-71 reads the dist, device and
    nccl substrings)."""
    if not isinstance(name, str):
        raise TypeError("name must be a string")
    if name in ("local", "local_update_cpu", "local_allreduce_cpu",
                "device", "local_allreduce_device", "nccl"):
        return KVStore(name)
    if "tpu" in name or "ici" in name:
        from .nccl import NcclKVStore
        return NcclKVStore(name)
    if "dist" in name:
        from .dist import DistKVStore
        return DistKVStore(name)
    raise MXNetError("unknown kvstore type %r" % name)

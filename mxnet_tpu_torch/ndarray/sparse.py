"""Sparse NDArrays: the row_sparse and csr storage types.

Counterpart of ``mxnet_tpu/ndarray/sparse.py`` (ref:
include/mxnet/ndarray.h:59-63 storage types, python/mxnet/ndarray/
sparse.py).  A sparse array holds dense component arrays on one device:
``data`` and ``indices`` (row_sparse: the stored rows and their row ids;
csr: the stored values and their column ids, with ``indptr``), and its
dense shape.  Computation lowers to gathers, ``index_put`` and
``index_add`` on those components, on the device, without a host sync
where the JAX package has none (``retain``, ``dot``, ``todense``,
``row_sparse_pull``, a sparse push).  A row_sparse array may name a row
more than once (``retain`` and ``row_sparse_pull`` keep duplicated ids
with static shapes, as the JAX package does); duplicated rows carry
equal values, so writing them with ``index_put`` is well defined.

The classes subclass :class:`NDArray`, but hold no dense tensor: their
``tensor`` raises, and every op reaches them through ``_invoke``'s
sparse dispatch, which runs the op's sparse implementation or densifies
a read-only sparse input (the storage fallback).
"""
from __future__ import annotations

import numpy as np
import torch

from ..base import MXNetError, np_dtype, torch_dtype
from ..context import Context, current_context
from .ndarray import NDArray, array as nd_array, zeros as nd_zeros

__all__ = ["BaseSparseNDArray", "RowSparseNDArray", "CSRNDArray",
           "row_sparse_array", "csr_matrix", "zeros", "empty", "array",
           "cast_storage", "dot", "add", "retain"]


def _component(value, ctx, dtype=None):
    """An NDArray component on ``ctx`` from an NDArray (kept as it is
    when no ``dtype`` is asked for) or array-like."""
    if isinstance(value, NDArray):
        if dtype is not None and value.tensor.dtype != torch_dtype(dtype):
            return NDArray(value.tensor.to(torch_dtype(dtype)))
        return value
    return nd_array(value, ctx=ctx, dtype=dtype)


class BaseSparseNDArray(NDArray):
    """Common base of the sparse storage types (ref:
    sparse.py:BaseSparseNDArray)."""

    __slots__ = ("_data_arr", "_indices", "_sshape")
    _stype_name = None

    def _set(self, data, indices, shape):
        self._data_arr = data
        self._indices = indices
        self._sshape = tuple(int(d) for d in shape)
        # the inherited handle holds an empty placeholder on the payload's
        # device; ``tensor`` refuses to hand it out
        self._h.tensor = data.tensor.new_empty((0,))

    @property
    def tensor(self):
        raise MXNetError("a %s array holds no dense tensor; use todense()"
                         % self.stype)

    @property
    def stype(self):
        return self._stype_name

    @property
    def shape(self):
        return self._sshape

    @property
    def ndim(self):
        return len(self._sshape)

    @property
    def size(self):
        return int(np.prod(self._sshape))

    @property
    def dtype(self):
        return self._data_arr.dtype

    @property
    def context(self):
        return self._data_arr.context

    ctx = context

    @property
    def data(self):
        return self._data_arr

    @property
    def indices(self):
        return self._indices

    def __len__(self):
        return self._sshape[0]

    def asnumpy(self):
        return self.todense().asnumpy()

    def astype(self, dtype, copy=True):
        return self._with(NDArray(self._data_arr.tensor.to(
            torch_dtype(dtype))))

    def as_in_context(self, context):
        if self.context == context:
            return self
        return self.copyto(context)

    def wait_to_read(self):
        self._data_arr.wait_to_read()

    def attach_grad(self, grad_req="write", stype=None):
        raise MXNetError("attach_grad on a %s array: gradients are "
                         "dense; attach to a dense array" % self.stype)

    def detach(self):
        return self

    def _refuse(self, *args):
        raise MXNetError("not supported for this storage type")

    __iadd__ = __isub__ = __imul__ = __itruediv__ = __setitem__ = _refuse

    def __getstate__(self):
        raise MXNetError("a %s array does not pickle; pickle its "
                         "components" % self.stype)

    def tostype(self, stype):
        if stype == self.stype:
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError("cast_storage from %s to %s is not supported"
                         % (self.stype, stype))

    def copyto(self, other):
        if isinstance(other, Context):
            return self._with(self._data_arr.copyto(other),
                              [a.copyto(other) for a in self._aux()])
        if isinstance(other, type(self)):
            if other is self:
                raise MXNetError("cannot copy an array onto itself")
            # the payload moves to the destination's context
            moved = self.copyto(other.context)
            other._set(moved._data_arr, moved._indices, self._sshape)
            other._set_aux(moved._aux())
            return other
        if isinstance(other, NDArray) and other.stype == "default":
            return self.todense().copyto(other)
        raise TypeError("copyto does not support type " + str(type(other)))

    def copy(self):
        return self._with(NDArray(self._data_arr.tensor.clone()),
                          [NDArray(a.tensor.clone()) for a in self._aux()])

    def __repr__(self):
        return "\n<%s %s @%s>" % (type(self).__name__, "x".join(
            str(d) for d in self._sshape), self.context)


class RowSparseNDArray(BaseSparseNDArray):
    """First dimension sparse: data[K, ...] holds rows indices[K] (ref:
    sparse.py:RowSparseNDArray)."""

    __slots__ = ()
    _stype_name = "row_sparse"

    def __init__(self, data, indices, shape, ctx=None):
        ctx = ctx or (data.context if isinstance(data, NDArray)
                      else current_context())
        data = _component(data, ctx)
        NDArray.__init__(self, data.tensor.new_empty((0,)))
        self._set(data, _component(indices, ctx, np.int64), shape)

    def _aux(self):
        return [self._indices]

    def _set_aux(self, aux):
        self._indices = aux[0]

    def _with(self, data, aux=None):
        return RowSparseNDArray(data, (aux or self._aux())[0], self._sshape)

    def _aux_data(self, i):
        if i != 0:
            raise MXNetError("a row_sparse array has one aux array")
        return self._indices

    def todense(self):
        d = self._data_arr.tensor
        out = torch.zeros(self._sshape, dtype=d.dtype, device=d.device)
        out[self._indices.tensor.long()] = d
        return NDArray(out)

    def retain(self, row_ids):
        """Keep the rows ``row_ids`` names (ref: sparse_retain), on the
        device with static shapes: the result's indices are exactly the
        requested ids, a requested row that is not stored an explicit
        zero row (:func:`_retain_rows`).  No host sync."""
        dev = self._data_arr.tensor.device
        rid = row_ids.tensor if isinstance(row_ids, NDArray) \
            else torch.as_tensor(np.asarray(row_ids))
        data, idx = _retain_rows(self._data_arr.tensor,
                                 self._indices.tensor.long(),
                                 rid.to(device=dev, dtype=torch.int64))
        return RowSparseNDArray(NDArray(data), NDArray(idx), self._sshape)

    def __getitem__(self, key):
        raise MXNetError("a row_sparse array does not index; use retain "
                         "or todense()")


class CSRNDArray(BaseSparseNDArray):
    """A compressed-sparse-row matrix (ref: sparse.py:CSRNDArray):
    row r's values are data[indptr[r]:indptr[r + 1]] at columns
    indices[indptr[r]:indptr[r + 1]]."""

    __slots__ = ("_indptr",)
    _stype_name = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        ctx = ctx or (data.context if isinstance(data, NDArray)
                      else current_context())
        data = _component(data, ctx)
        NDArray.__init__(self, data.tensor.new_empty((0,)))
        self._indptr = _component(indptr, ctx, np.int64)
        self._set(data, _component(indices, ctx, np.int64), shape)

    @property
    def indptr(self):
        return self._indptr

    def _aux(self):
        return [self._indptr, self._indices]

    def _set_aux(self, aux):
        self._indptr, self._indices = aux

    def _with(self, data, aux=None):
        indptr, indices = aux or self._aux()
        return CSRNDArray(data, indices, indptr, self._sshape)

    def _aux_data(self, i):
        return self._aux()[i]

    def _rows(self):
        """The row of each stored value, on the device (no host sync)."""
        return csr_rows(self._indptr.tensor, self._data_arr.tensor.shape[0])

    def todense(self):
        d = self._data_arr.tensor
        out = torch.zeros(self._sshape, dtype=d.dtype, device=d.device)
        out[self._rows(), self._indices.tensor.long()] = d
        return NDArray(out)

    def __getitem__(self, key):
        if not isinstance(key, slice) or key.step not in (None, 1):
            raise MXNetError("CSRNDArray only supports slice on axis 0")
        start, stop, _ = key.indices(self._sshape[0])
        ptr = self._indptr.tensor
        lo, hi = (int(v) for v in ptr[[start, stop]].tolist())
        return CSRNDArray(NDArray(self._data_arr.tensor[lo:hi]),
                          NDArray(self._indices.tensor[lo:hi]),
                          NDArray(ptr[start:stop + 1] - lo),
                          (stop - start, self._sshape[1]))


def csr_rows(indptr, nnz):
    """The row of each of ``nnz`` stored values of a CSR matrix with row
    pointer ``indptr``, as a device tensor: the last row whose pointer is
    at or before the value's position."""
    pos = torch.arange(nnz, device=indptr.device)
    return torch.searchsorted(indptr[1:], pos, right=True)


def _retain_rows(data, cur_idx, rid):
    """The static-shape retain behind :meth:`RowSparseNDArray.retain`: for
    each requested id, a binary search of the stored ids (sorted first,
    as the JAX package does defensively) and a gather of its row, zeros
    when absent.  Returns (rows, rid)."""
    cur, order = torch.sort(cur_idx)
    if cur.numel() == 0:
        return data.new_zeros((rid.shape[0],) + tuple(data.shape[1:])), rid
    pos = torch.clamp(torch.searchsorted(cur, rid), 0, cur.numel() - 1)
    found = cur[pos] == rid
    rows = data[order[pos]]
    rows = torch.where(found.reshape((-1,) + (1,) * (data.ndim - 1)), rows,
                       torch.zeros((), dtype=data.dtype, device=data.device))
    return rows, rid


# ---------------------------------------------------------------------------
# Creation
# ---------------------------------------------------------------------------

def _host(value, dtype):
    return value.asnumpy().astype(dtype, copy=False) \
        if isinstance(value, NDArray) else np.asarray(value, dtype)


def row_sparse_array(arg1, shape=None, ctx=None, dtype=None):
    """A RowSparseNDArray from ``(data, indices)`` (rows sorted by id) or
    from a dense source (ref: sparse.py:row_sparse_array)."""
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 2:
        data = _host(arg1[0], np_dtype(dtype or np.float32))
        indices = _host(arg1[1], np.int64)
        o = np.argsort(indices, kind="stable")
        return RowSparseNDArray(
            nd_array(data[o], ctx=ctx, dtype=data.dtype),
            nd_array(indices[o], ctx=ctx, dtype=np.int64),
            shape or ((int(indices.max()) + 1,) + data.shape[1:]))
    if isinstance(arg1, NDArray):
        return arg1.tostype("row_sparse")
    arr = np.asarray(arg1, np_dtype(dtype or np.float32))
    return cast_storage(nd_array(arr, ctx=ctx, dtype=arr.dtype),
                        "row_sparse", shape)


def csr_matrix(arg1, shape=None, ctx=None, dtype=None):
    """A CSRNDArray from ``(data, indices, indptr)`` or a dense source
    (ref: sparse.py:csr_matrix)."""
    ctx = ctx or current_context()
    if isinstance(arg1, tuple) and len(arg1) == 3:
        data, indices, indptr = arg1
        return CSRNDArray(
            nd_array(_host(data, np_dtype(dtype or np.float32)), ctx=ctx,
                     dtype=dtype or np.float32),
            nd_array(_host(indices, np.int64), ctx=ctx, dtype=np.int64),
            nd_array(_host(indptr, np.int64), ctx=ctx, dtype=np.int64),
            shape)
    if isinstance(arg1, NDArray):
        return arg1.tostype("csr")
    arr = np.asarray(arg1, np_dtype(dtype or np.float32))
    return cast_storage(nd_array(arr, ctx=ctx, dtype=arr.dtype), "csr",
                        shape)


def zeros(stype, shape, ctx=None, dtype=None):
    ctx = ctx or current_context()
    dtype = np_dtype(dtype or np.float32)
    shape = tuple(int(d) for d in shape)
    if stype == "row_sparse":
        return RowSparseNDArray(
            nd_zeros((0,) + shape[1:], ctx=ctx, dtype=dtype),
            nd_zeros((0,), ctx=ctx, dtype=np.int64), shape)
    if stype == "csr":
        return CSRNDArray(nd_zeros((0,), ctx=ctx, dtype=dtype),
                          nd_zeros((0,), ctx=ctx, dtype=np.int64),
                          nd_zeros((shape[0] + 1,), ctx=ctx, dtype=np.int64),
                          shape)
    if stype == "default":
        return nd_zeros(shape, ctx=ctx, dtype=dtype)
    raise MXNetError("unknown storage type %r" % stype)


def empty(stype, shape, ctx=None, dtype=None):
    return zeros(stype, shape, ctx, dtype)


def array(source_array, ctx=None, dtype=None):
    """A sparse array from a sparse array (returned as it is) or a scipy
    sparse matrix (as CSR)."""
    if isinstance(source_array, BaseSparseNDArray):
        return source_array
    try:
        import scipy.sparse as sp
    except ImportError:
        sp = None
    if sp is not None and sp.issparse(source_array):
        csr = source_array.tocsr()
        return csr_matrix((csr.data, csr.indices, csr.indptr),
                          shape=csr.shape, ctx=ctx,
                          dtype=dtype or csr.dtype)
    raise MXNetError("use row_sparse_array/csr_matrix for dense sources")


def rand_sparse_ndarray(shape, stype, density=None, dtype=None):
    """(a random sparse array on the current context, its dense numpy
    value): values
    uniform in [-1, 1), each kept with probability ``density`` (default
    0.5), drawn from numpy's global generator."""
    density = 0.5 if density is None else density
    dense = np.random.uniform(-1, 1, shape).astype(np_dtype(dtype
                                                            or np.float32))
    dense[np.random.uniform(size=shape) >= density] = 0
    return cast_storage(nd_array(dense, dtype=dense.dtype), stype), dense


# ---------------------------------------------------------------------------
# Storage casts and ops
# ---------------------------------------------------------------------------

def cast_storage(arr, stype, shape=None):
    """Convert between storage types (ref: cast_storage-inl.h).  Dense to
    sparse finds the nonzero rows or values (a host sync, as the JAX
    package's numpy conversion)."""
    if stype == "default":
        return arr.todense() if isinstance(arr, BaseSparseNDArray) else arr
    if isinstance(arr, BaseSparseNDArray):
        return arr.tostype(stype)
    t = arr.tensor.detach()
    shape = tuple(shape or t.shape)
    if stype == "row_sparse":
        nz = torch.nonzero(t.reshape(t.shape[0], -1).ne(0).any(dim=1))
        nz = nz.reshape(-1)
        return RowSparseNDArray(NDArray(t[nz]), NDArray(nz), shape)
    if stype == "csr":
        if t.ndim != 2:
            raise MXNetError("csr storage requires a 2D array")
        mask = t.ne(0)
        indptr = torch.cat([torch.zeros(1, dtype=torch.int64,
                                        device=t.device),
                            torch.cumsum(mask.sum(dim=1), 0)])
        return CSRNDArray(NDArray(t[mask]),
                          NDArray(torch.nonzero(mask)[:, 1]),
                          NDArray(indptr), shape)
    raise MXNetError("unknown storage type %r" % stype)


def dot(lhs, rhs, transpose_a=False, transpose_b=False):
    """Sparse-aware dot (ref: src/operator/tensor/dot-inl.h).  CSR x dense
    is a gather of the right-hand rows and an ``index_add`` into the
    output's rows, on the device (``transpose_a``: the left-hand's column
    ids are the output's rows); the result is dense.  Other storage
    combinations densify."""
    if isinstance(lhs, CSRNDArray) and not isinstance(
            rhs, BaseSparseNDArray) and not transpose_b:
        data = lhs.data.tensor
        cols = lhs.indices.tensor.long()
        rows = lhs._rows()
        r = rhs.tensor
        if transpose_a:
            gathered = r[rows] * data[:, None]
            out = torch.zeros((lhs.shape[1], r.shape[1]), dtype=r.dtype,
                              device=r.device)
            return NDArray(out.index_add(0, cols, gathered))
        gathered = r[cols] * data[:, None]
        out = torch.zeros((lhs.shape[0], r.shape[1]), dtype=r.dtype,
                          device=r.device)
        return NDArray(out.index_add(0, rows, gathered))
    left = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    right = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return left.dot(right, transpose_a, transpose_b)


def add(lhs, rhs):
    left = lhs.todense() if isinstance(lhs, BaseSparseNDArray) else lhs
    right = rhs.todense() if isinstance(rhs, BaseSparseNDArray) else rhs
    return left + right


def retain(data, indices):
    """Sparse retain (ref: sparse_retain op)."""
    if isinstance(data, RowSparseNDArray):
        return data.retain(indices)
    raise MXNetError("retain only supports row_sparse")

"""CSRNDArray: the compressed-sparse-row batch of ``io.LibSVMIter``.

The part of ``mxnet_tpu/ndarray/sparse.py`` that the iterators need: a
host container of ``data``, ``indices`` and ``indptr`` with its dense
shape, and ``todense``/``tostype``/``asnumpy``.
The sparse-storage ops and ``RowSparseNDArray`` wait for the op-surface
slice (slice 7).
"""
from __future__ import annotations

import numpy as np

from ..base import MXNetError
from ..context import cpu
from .ndarray import NDArray, array as nd_array


class CSRNDArray:
    """A 2-D compressed-sparse-row array (ref: sparse.py:CSRNDArray)."""

    stype = "csr"

    def __init__(self, data, indices, indptr, shape, ctx=None):
        ctx = ctx or cpu()
        self._data_arr = data if isinstance(data, NDArray) \
            else nd_array(data, ctx=ctx)
        self._indices = indices if isinstance(indices, NDArray) \
            else nd_array(indices, ctx=ctx, dtype=np.int64)
        self._indptr = indptr if isinstance(indptr, NDArray) \
            else nd_array(indptr, ctx=ctx, dtype=np.int64)
        self._sshape = tuple(int(d) for d in shape)

    @property
    def shape(self):
        return self._sshape

    @property
    def dtype(self):
        return self._data_arr.dtype

    @property
    def context(self):
        return self._data_arr.context

    @property
    def data(self):
        return self._data_arr

    @property
    def indices(self):
        return self._indices

    @property
    def indptr(self):
        return self._indptr

    def todense(self):
        data = self._data_arr.asnumpy()
        indices = self._indices.asnumpy()
        indptr = self._indptr.asnumpy()
        out = np.zeros(self._sshape, data.dtype)
        for r in range(self._sshape[0]):
            lo, hi = indptr[r], indptr[r + 1]
            out[r, indices[lo:hi]] = data[lo:hi]
        return nd_array(out, ctx=self.context)

    def asnumpy(self):
        return self.todense().asnumpy()

    def tostype(self, stype):
        if stype == "csr":
            return self
        if stype == "default":
            return self.todense()
        raise MXNetError("cast_storage from csr to %s is not supported"
                         % stype)

    def __repr__(self):
        return "\n<CSRNDArray %s @%s>" % (
            "x".join(str(d) for d in self._sshape), self.context)

"""Datasets (ref: python/mxnet/gluon/data/dataset.py).

Counterpart of ``mxnet_tpu/gluon/data/dataset.py``: random access by
index plus length, composable through ``transform``; ``transform_first``
is the same view with the function lifted to act on element 0 only.
``RecordFileDataset`` and ``_DownloadedDataset`` wait for the data I/O
slice (``recordio``).
"""
from __future__ import annotations

from ...ndarray import NDArray

__all__ = ["Dataset", "SimpleDataset", "ArrayDataset"]


class Dataset:
    """Random-access collection: __getitem__ + __len__."""

    def __getitem__(self, idx):
        raise NotImplementedError

    def __len__(self):
        raise NotImplementedError

    def transform(self, fn, lazy=True):
        """A view whose items are fn(*item); lazy=False materializes."""
        view = _MappedDataset(self, fn)
        if lazy:
            return view
        return SimpleDataset([view[i] for i in range(len(view))])

    def transform_first(self, fn, lazy=True):
        """Apply fn to element 0 of each item, passing the rest through
        (the standard image-transform-but-not-label hook)."""
        return self.transform(_FirstOnly(fn), lazy)


class _FirstOnly:
    """fn on the first element only (a class rather than a closure, so
    that it pickles)."""

    def __init__(self, fn):
        self._fn = fn

    def __call__(self, first, *rest):
        if rest:
            return (self._fn(first),) + rest
        return self._fn(first)


class _MappedDataset(Dataset):
    """Lazy elementwise view over a base dataset."""

    def __init__(self, base, fn):
        self._base = base
        self._fn = fn

    def __len__(self):
        return len(self._base)

    def __getitem__(self, idx):
        item = self._base[idx]
        if isinstance(item, tuple):
            return self._fn(*item)
        return self._fn(item)


class SimpleDataset(Dataset):
    """Wrap any indexable (list, numpy array, ...) as a Dataset."""

    def __init__(self, data):
        self._data = data

    def __len__(self):
        return len(self._data)

    def __getitem__(self, idx):
        return self._data[idx]


class ArrayDataset(Dataset):
    """Zip several equal-length array-likes; items are tuples (or the
    bare element when only one source is given)."""

    def __init__(self, *sources):
        if not sources:
            raise AssertionError("Needs at least 1 arrays")
        lengths = [len(s) for s in sources]
        if len(set(lengths)) != 1:
            raise AssertionError(
                "All arrays must have the same length; got %s" % lengths)
        self._length = lengths[0]
        # a 1-D device array is read as host numpy: one device read per
        # scalar item would stall on the device each time
        self._sources = [s.asnumpy()
                         if isinstance(s, NDArray) and s.ndim == 1 else s
                         for s in sources]

    def __len__(self):
        return self._length

    def __getitem__(self, idx):
        if len(self._sources) == 1:
            return self._sources[0][idx]
        return tuple(s[idx] for s in self._sources)

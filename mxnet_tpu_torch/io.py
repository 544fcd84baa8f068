"""Data iterators: ``mxnet_tpu/io.py`` but its record and device paths.

``DataDesc``, ``DataBatch``, the ``DataIter`` protocol, ``NDArrayIter``
(with ``last_batch_handle`` ``pad``/``discard``/``roll_over`` and
``provide_data``/``provide_label``), ``ResizeIter``, the threaded
``PrefetchingIter``, the file iterators ``MNISTIter`` (idx files, plain
or gzipped), ``CSVIter`` and ``LibSVMIter`` (CSR batches), and
``MXDataIter``, which creates one of them by name.  An iterator's arrays
live on the host (``cpu()``): a batch is host data until the executor
group copies it into the bound arrays on the card.  ``ImageRecordIter``
and the JAX package's device-side prefetchers wait for the data-I/O
slice (slice 5).
"""
from __future__ import annotations

import gzip
import os
import struct
import threading
import warnings
from collections import namedtuple

import numpy as np

from . import threads as _threads
from .base import MXNetError
from .context import cpu
from .ndarray import NDArray, array
from .test_utils import synthetic_image_dataset


class DataDesc(namedtuple("DataDesc", ["name", "shape"])):
    def __new__(cls, name, shape, dtype=np.float32, layout="NCHW"):
        ret = super().__new__(cls, name, shape)
        ret.dtype = dtype
        ret.layout = layout
        return ret

    def __repr__(self):
        return "DataDesc[%s,%s,%s,%s]" % (self.name, self.shape, self.dtype,
                                          self.layout)

    @staticmethod
    def get_batch_axis(layout):
        if layout is None:
            return 0
        return layout.find("N")


class DataBatch:
    def __init__(self, data, label=None, pad=None, index=None,
                 bucket_key=None, provide_data=None, provide_label=None):
        if data is not None and not isinstance(data, (list, tuple)):
            raise TypeError("Data must be list of NDArrays")
        if label is not None and not isinstance(label, (list, tuple)):
            raise TypeError("Label must be list of NDArrays")
        self.data = data
        self.label = label
        self.pad = pad
        self.index = index
        self.bucket_key = bucket_key
        self.provide_data = provide_data
        self.provide_label = provide_label


class DataIter:
    """Base data iterator (ref: io.py:177)."""

    def __init__(self, batch_size=0):
        self.batch_size = batch_size

    def __iter__(self):
        return self

    def reset(self):
        pass

    def next(self):
        if self.iter_next():
            return DataBatch(data=self.getdata(), label=self.getlabel(),
                             pad=self.getpad(), index=self.getindex())
        raise StopIteration

    def __next__(self):
        return self.next()

    def iter_next(self):
        pass

    def getdata(self):
        pass

    def getlabel(self):
        pass

    def getindex(self):
        return None

    def getpad(self):
        pass


class ResizeIter(DataIter):
    """An iterator of ``size`` batches a epoch over ``data_iter``, which is
    reset whenever it runs out (ref: io.py:279)."""

    def __init__(self, data_iter, size, reset_internal=True):
        super().__init__()
        self.data_iter = data_iter
        self.size = size
        self.reset_internal = reset_internal
        self.cur = 0
        self.current_batch = None
        self.provide_data = data_iter.provide_data
        self.provide_label = data_iter.provide_label
        self.batch_size = data_iter.batch_size
        if hasattr(data_iter, "default_bucket_key"):
            self.default_bucket_key = data_iter.default_bucket_key

    def reset(self):
        self.cur = 0
        if self.reset_internal:
            self.data_iter.reset()

    def iter_next(self):
        if self.cur == self.size:
            return False
        try:
            self.current_batch = self.data_iter.next()
        except StopIteration:
            self.data_iter.reset()
            self.current_batch = self.data_iter.next()
        self.cur += 1
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _renamed(descs, names):
    return [DataDesc(names[d.name], d.shape, d.dtype)
            if isinstance(d, DataDesc) else DataDesc(names[d[0]], d[1])
            for d in descs]


class PrefetchingIter(DataIter):
    """Fetch the next batch of one or more iterators on worker threads
    while the current one trains (ref: io.py:344).  ``close()`` (or a
    ``with`` block) stops and joins the workers."""

    def __init__(self, iters, rename_data=None, rename_label=None):
        super().__init__()
        if not isinstance(iters, list):
            iters = [iters]
        if not iters:
            raise AssertionError("PrefetchingIter needs an iterator")
        self.n_iter = len(iters)
        self.iters = iters
        self.rename_data = rename_data
        self.rename_label = rename_label
        self.batch_size = self.provide_data[0][1][0]
        self.data_ready = [threading.Event() for _ in range(self.n_iter)]
        self.data_taken = [threading.Event() for _ in range(self.n_iter)]
        for e in self.data_taken:
            e.set()
        self.started = True
        self._closed = False
        self.current_batch = None
        self.next_batch = [None for _ in range(self.n_iter)]

        def prefetch_func(self, i):
            while True:
                self.data_taken[i].wait()
                if not self.started:
                    break
                try:
                    self.next_batch[i] = self.iters[i].next()
                except StopIteration:
                    self.next_batch[i] = None
                self.data_taken[i].clear()
                # close() clears ``started`` before it sets data_taken: a
                # close during next() must not leave this worker waiting
                if not self.started:
                    break
                self.data_ready[i].set()

        self.prefetch_threads = [
            _threads.spawn(prefetch_func, "io", "prefetch-%d" % i,
                           args=(self, i))
            for i in range(self.n_iter)]

    def close(self):
        """Stop and join the workers (idempotent); a worker stuck in a
        base iterator's ``next()`` is abandoned after a bounded join."""
        if self._closed:
            return
        self._closed = True
        self.started = False
        for e in self.data_taken:
            e.set()
        for thread in self.prefetch_threads:
            thread.join(timeout=5.0)
        leaked = [t for t in self.prefetch_threads if t.is_alive()]
        if leaked:
            warnings.warn("PrefetchingIter: %d worker(s) blocked in the "
                          "base iterator were abandoned at close"
                          % len(leaked))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @property
    def provide_data(self):
        if self.rename_data is None:
            return sum([i.provide_data for i in self.iters], [])
        return sum([_renamed(i.provide_data, r)
                    for r, i in zip(self.rename_data, self.iters)], [])

    @property
    def provide_label(self):
        if self.rename_label is None:
            return sum([i.provide_label for i in self.iters], [])
        return sum([_renamed(i.provide_label, r)
                    for r, i in zip(self.rename_label, self.iters)], [])

    def reset(self):
        if self._closed:
            raise MXNetError("PrefetchingIter is closed")
        for e in self.data_ready:
            e.wait()
        for i in self.iters:
            i.reset()
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()

    def iter_next(self):
        if self._closed:
            raise MXNetError("PrefetchingIter is closed")
        for e in self.data_ready:
            e.wait()
        if self.next_batch[0] is None:
            if any(b is not None for b in self.next_batch):
                raise AssertionError("Number of entry mismatches between "
                                     "iterators")
            return False
        if any(b.pad != self.next_batch[0].pad for b in self.next_batch):
            raise AssertionError("Number of entry mismatches between "
                                 "iterators")
        self.current_batch = DataBatch(
            sum([batch.data for batch in self.next_batch], []),
            sum([batch.label for batch in self.next_batch], []),
            self.next_batch[0].pad, self.next_batch[0].index,
            provide_data=self.provide_data, provide_label=self.provide_label)
        for e in self.data_ready:
            e.clear()
        for e in self.data_taken:
            e.set()
        return True

    def next(self):
        if self.iter_next():
            return self.current_batch
        raise StopIteration

    def getdata(self):
        return self.current_batch.data

    def getlabel(self):
        return self.current_batch.label

    def getindex(self):
        return self.current_batch.index

    def getpad(self):
        return self.current_batch.pad


def _init_data(data, allow_empty, default_name):
    """Normalize data/label inputs to a sorted [(name, host ndarray)]."""
    if data is None:
        if not allow_empty:
            raise ValueError("NDArrayIter needs data")
        data = []
    if isinstance(data, (np.ndarray, NDArray)):
        data = [data]
    if isinstance(data, list):
        if not allow_empty and not data:
            raise ValueError("NDArrayIter needs data")
        if len(data) == 1:
            data = {default_name: data[0]}
        else:
            data = {"_%d_%s" % (i, default_name): d
                    for i, d in enumerate(data)}
    if not isinstance(data, dict):
        raise TypeError("Input must be NDArray, numpy.ndarray, a list of "
                        "them or dict with them as values")
    return sorted((k, v.asnumpy() if isinstance(v, NDArray)
                   else np.asarray(v)) for k, v in data.items())


class NDArrayIter(DataIter):
    """Iterate over NDArray/numpy data (ref: io.py:541)."""

    def __init__(self, data, label=None, batch_size=1, shuffle=False,
                 last_batch_handle="pad", data_name="data",
                 label_name="softmax_label"):
        super().__init__(batch_size)
        self.data = _init_data(data, False, data_name)
        self.label = _init_data(label, True, label_name)
        n = self.data[0][1].shape[0]
        self.idx = np.arange(n)
        if shuffle:
            np.random.shuffle(self.idx)
            self.data = [(k, v[self.idx]) for k, v in self.data]
            self.label = [(k, v[self.idx]) for k, v in self.label]
        if last_batch_handle == "discard":
            self.idx = self.idx[:n - n % batch_size]
        self.num_data = self.idx.shape[0]
        if self.num_data < batch_size:
            raise ValueError("batch_size needs to be smaller than data size.")
        self.cursor = -batch_size
        self.last_batch_handle = last_batch_handle

    @property
    def provide_data(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.data]

    @property
    def provide_label(self):
        return [DataDesc(k, (self.batch_size,) + v.shape[1:], v.dtype)
                for k, v in self.label]

    def hard_reset(self):
        self.cursor = -self.batch_size

    def reset(self):
        if self.last_batch_handle == "roll_over" and \
                self.cursor > self.num_data:
            self.cursor = -self.batch_size \
                + (self.cursor % self.num_data) % self.batch_size
        else:
            self.cursor = -self.batch_size

    def iter_next(self):
        self.cursor += self.batch_size
        return self.cursor < self.num_data

    def _getdata(self, sources):
        if self.cursor >= self.num_data:
            raise ValueError("DataIter needs reset.")
        lo, hi = self.cursor, self.cursor + self.batch_size
        if hi <= self.num_data:
            return [array(v[lo:hi], ctx=cpu()) for _, v in sources]
        pad = hi - self.num_data
        return [array(np.concatenate((v[lo:self.num_data], v[:pad])),
                      ctx=cpu()) for _, v in sources]

    def getdata(self):
        return self._getdata(self.data)

    def getlabel(self):
        return self._getdata(self.label)

    def getpad(self):
        if self.last_batch_handle == "pad" and \
                self.cursor + self.batch_size > self.num_data:
            return self.cursor + self.batch_size - self.num_data
        return 0


class _WrappedIter(DataIter):
    """An iterator that serves the batches of an inner ``NDArrayIter``."""

    @property
    def provide_data(self):
        return self._inner.provide_data

    @property
    def provide_label(self):
        return self._inner.provide_label

    def reset(self):
        self._inner.reset()

    def next(self):
        return self._inner.next()


class MNISTIter(_WrappedIter):
    """Batches of MNIST's idx files, plain or gzipped (ref:
    src/io/iter_mnist.cc).  Without the files it serves synthetic data of
    the same shapes, with a warning, as the JAX package does; with only
    one of them it raises."""

    def __init__(self, image="train-images-idx3-ubyte",
                 label="train-labels-idx1-ubyte", batch_size=128,
                 shuffle=True, flat=False, seed=0, silent=False, num_parts=1,
                 part_index=0, **kwargs):
        super().__init__(batch_size)

        def present(p):
            return os.path.exists(p) or os.path.exists(p + ".gz")

        if present(image) and present(label):
            images = self._read_images(image)
            labels = self._read_labels(label)
        elif present(image) or present(label):
            raise MXNetError(
                "MNIST files partially present (%s / %s); place both "
                "files there" % (image, label))
        else:
            train = "train" in os.path.basename(image)
            data, labels = synthetic_image_dataset(
                (28, 28), 1, 2048 if train else 512, seed=42 if train else 43,
                what="mnist", root=os.path.dirname(image) or ".")
            images = data[:, :, :, 0].astype(np.float32) / 255.0
            labels = labels.astype(np.float32)
        if num_parts > 1:
            n = images.shape[0] // num_parts
            s = part_index * n
            images, labels = images[s:s + n], labels[s:s + n]
        if shuffle:
            perm = np.random.RandomState(seed).permutation(images.shape[0])
            images, labels = images[perm], labels[perm]
        self._inner = NDArrayIter(
            images.reshape(len(images), -1) if flat else
            images.reshape(len(images), 1, 28, 28),
            labels, batch_size=batch_size, shuffle=False)

    @staticmethod
    def _open(path):
        if path.endswith(".gz"):
            return gzip.open(path, "rb")
        if not os.path.exists(path) and os.path.exists(path + ".gz"):
            return gzip.open(path + ".gz", "rb")
        return open(path, "rb")

    def _read_images(self, path):
        with self._open(path) as f:
            magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
            if magic != 2051:
                raise MXNetError("bad MNIST image file %s" % path)
            data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
        return data.reshape(n, rows, cols).astype(np.float32) / 255.0

    def _read_labels(self, path):
        with self._open(path) as f:
            magic, n = struct.unpack(">II", f.read(8))
            if magic != 2049:
                raise MXNetError("bad MNIST label file %s" % path)
            return np.frombuffer(f.read(n), dtype=np.uint8).astype(
                np.float32)


class CSVIter(_WrappedIter):
    """Batches of a CSV file's rows, each reshaped to ``data_shape``
    (ref: src/io/iter_csv.cc); labels from ``label_csv``, else zeros."""

    def __init__(self, data_csv, data_shape, label_csv=None,
                 label_shape=(1,), batch_size=1, round_batch=True, **kwargs):
        super().__init__(batch_size)
        data = np.loadtxt(data_csv, delimiter=",", dtype=np.float32)
        data = data.reshape((-1,) + tuple(data_shape))
        if label_csv is not None:
            label = np.loadtxt(label_csv, delimiter=",", dtype=np.float32)
            label = label.reshape((-1,) + tuple(label_shape))
            if label_shape == (1,):
                label = label.reshape(-1)
        else:
            label = np.zeros(data.shape[0], dtype=np.float32)
        self._inner = NDArrayIter(
            data, label, batch_size=batch_size,
            last_batch_handle="pad" if round_batch else "discard",
            label_name="label")


def _parse_libsvm(path):
    """(labels[R, L], indptr[R+1], indices, values) of a libsvm file:
    lines of ``label[,label...] idx:val ...`` with 0-based indices."""
    labels, indptr, indices, values = [], [0], [], []
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            head, *feats = line.split()
            row_labels = [float(x) for x in head.split(",")]
            if labels and len(row_labels) != len(labels[0]):
                raise MXNetError(
                    "%s:%d: %d label(s) but earlier rows have %d"
                    % (path, lineno, len(row_labels), len(labels[0])))
            labels.append(row_labels)
            for tok in feats:
                idx, val = tok.split(":")
                indices.append(int(idx))
                values.append(float(val))
            indptr.append(len(indices))
    if not labels:
        raise MXNetError("%s: no data rows" % (path,))
    return (np.asarray(labels, np.float32), np.asarray(indptr, np.int64),
            np.asarray(indices, np.int64), np.asarray(values, np.float32))


class LibSVMIter(DataIter):
    """CSR batches of a libsvm file (ref: src/io/iter_libsvm.cc): data a
    ``CSRNDArray`` of shape (batch_size,) + data_shape, labels dense, one
    per row or vectors from ``label_libsvm``.  The last partial batch is
    padded with rows from the start, ``pad`` set."""

    def __init__(self, data_libsvm, data_shape, label_libsvm=None,
                 label_shape=None, batch_size=1, round_batch=True,
                 data_name="data", label_name="softmax_label", **kwargs):
        super().__init__(batch_size)
        labels, self._indptr, self._indices, self._values = \
            _parse_libsvm(data_libsvm)
        self._labels = labels[:, 0] if labels.shape[1] == 1 else labels
        if label_libsvm is not None:
            ext_labels, lptr, lidx, lval = _parse_libsvm(label_libsvm)
            if len(ext_labels) != len(labels):
                raise MXNetError(
                    "label_libsvm has %d rows but data_libsvm has %d"
                    % (len(ext_labels), len(labels)))
            dim = int(label_shape[0]) if label_shape else (
                int(lidx.max()) + 1 if lidx.size else 1)
            dense = np.zeros((len(ext_labels), dim), np.float32)
            for r in range(len(ext_labels)):
                dense[r, lidx[lptr[r]:lptr[r + 1]]] = lval[lptr[r]:lptr[r + 1]]
            self._labels = dense
        self._data_shape = tuple(int(x) for x in data_shape)
        self._data_name = data_name
        self._label_name = label_name
        self._round_batch = bool(round_batch)
        self.num_rows = len(self._indptr) - 1
        self._row_nnz = np.diff(self._indptr)
        if self._indices.size and \
                int(self._indices.max()) >= self._data_shape[0]:
            raise MXNetError(
                "libsvm feature index %d out of range for data_shape %s "
                "(indices are 0-based)"
                % (int(self._indices.max()), self._data_shape))
        self._cursor = 0

    @property
    def provide_data(self):
        return [DataDesc(self._data_name,
                         (self.batch_size,) + self._data_shape)]

    @property
    def provide_label(self):
        shape = (self.batch_size,) + (
            self._labels.shape[1:] if self._labels.ndim > 1 else ())
        return [DataDesc(self._label_name, shape)]

    def reset(self):
        self._cursor = 0

    def _row_batch(self, rows):
        from .ndarray.sparse import CSRNDArray
        counts = self._row_nnz[rows]
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        spans = [np.arange(self._indptr[r], self._indptr[r + 1])
                 for r in rows]
        flat = np.concatenate(spans).astype(np.int64) if spans else \
            np.zeros((0,), np.int64)
        return CSRNDArray(self._values[flat], self._indices[flat], indptr,
                          (len(rows),) + self._data_shape)

    def next(self):
        if self._cursor >= self.num_rows:
            raise StopIteration
        end = self._cursor + self.batch_size
        pad = max(0, end - self.num_rows)
        rows = np.arange(self._cursor, end) % self.num_rows
        self._cursor = end
        return DataBatch(data=[self._row_batch(rows)],
                         label=[array(self._labels[rows], ctx=cpu())],
                         pad=pad, provide_data=self.provide_data,
                         provide_label=self.provide_label)


_DATA_ITER_REGISTRY = {
    "MNISTIter": MNISTIter,
    "CSVIter": CSVIter,
    "LibSVMIter": LibSVMIter,
    "NDArrayIter": NDArrayIter,
}


def MXDataIter(name, **kwargs):
    """Create a registered iterator by name (ref: io.py:759, which wraps
    the C++ iterator registry)."""
    if name in ("ImageRecordIter", "ImageRecordIter_v1"):
        raise MXNetError("%s waits for the data-I/O slice (slice 5)" % name)
    try:
        creator = _DATA_ITER_REGISTRY[name]
    except KeyError:
        raise MXNetError(
            "unknown data iterator %r; registered: %s"
            % (name, sorted(_DATA_ITER_REGISTRY)))
    return creator(**kwargs)

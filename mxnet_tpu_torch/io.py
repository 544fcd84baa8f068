"""Data iterators (ref: python/mxnet/io.py and src/io/).

Counterpart of ``mxnet_tpu/io.py``: ``DataDesc``, ``DataBatch``, the
``DataIter`` protocol, ``NDArrayIter`` (with ``last_batch_handle``
``pad``/``discard``/``roll_over``, over arrays or an out-of-core
``h5py`` dataset), ``ResizeIter``, the threaded ``PrefetchingIter``, the
file iterators ``MNISTIter`` (idx files, plain or gzipped), ``CSVIter``,
``LibSVMIter`` (CSR batches) and ``ImageRecordIter`` (packed ``.rec``
images through ``image.ImageIter``, decoded and augmented on the host by
the native engine's workers with ``preprocess_threads``), and
``MXDataIter``, which creates one of them by name.  An iterator's arrays
live on the host (``cpu()``): a batch is host data until the executor
group copies it into the bound arrays on the card.  Given a card's
context, ``DevicePrefetchIter`` and ``EnginePipelineIter`` hand out
batches already on it, copied from pinned host buffers on a side stream
(``_Uploader``).
"""
from __future__ import annotations

import gzip
import os
import struct
import threading
import warnings
from collections import namedtuple

import numpy as np
import torch

from . import threads as _threads
from .base import MXNetError
from .context import cpu, current_context
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


def _is_h5_dataset(obj):
    """An ``h5py.Dataset``, told without importing h5py (it is optional:
    the reference's NDArrayIter takes h5py input where the library
    exists)."""
    mod = type(obj).__module__
    return mod.startswith("h5py") and type(obj).__name__ == "Dataset"


def _init_data(data, allow_empty, default_name):
    """Normalize data/label inputs to a sorted [(name, host ndarray)]; an
    h5py dataset stays as it is, and batches read their rows from it."""
    if data is None:
        if not allow_empty:
            raise ValueError("NDArrayIter needs data")
        data = []
    if isinstance(data, (np.ndarray, NDArray)) or _is_h5_dataset(data):
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
    return sorted((k, v if _is_h5_dataset(v) else v.asnumpy()
                   if isinstance(v, NDArray) else np.asarray(v))
                  for k, v in data.items())


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
            if any(_is_h5_dataset(v) for _, v in self.data + self.label):
                raise MXNetError(
                    "shuffle=True cannot reorder an out-of-core h5py "
                    "dataset; pre-shuffle the file or load it into memory "
                    "(np.asarray(dset)) first")
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
        if hi <= self.num_data:  # an h5py dataset reads just these rows
            return [array(np.asarray(v[lo:hi]), ctx=cpu())
                    for _, v in sources]
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
                          (len(rows),) + self._data_shape, ctx=cpu())

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


def _build_rec_index(path_imgrec, path_idx):
    """Scan a bare ``.rec`` once and write a ``key\\toffset`` index, so that
    shuffling and ``num_parts`` sharding work without a pre-built ``.idx``
    (the reference's chunk shuffle reads bare ``.rec`` files too).  Written
    to a private temporary file and renamed into place: a concurrent build
    must never leave a half-written index visible, which would silently train on a
    truncated record set."""
    from . import recordio as _rio
    reader = _rio.MXRecordIO(path_imgrec, "r")
    tmp = "%s.build.%d.%d" % (path_idx, os.getpid(), threading.get_ident())
    try:
        with open(tmp, "w") as f:
            i = 0
            while True:
                pos = reader.tell()
                if reader.read() is None:
                    break
                f.write("%d\t%d\n" % (i, pos))
                i += 1
        os.replace(tmp, path_idx)
    finally:
        reader.close()
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def ImageRecordIter(path_imgrec=None, path_imgidx=None, data_shape=None,
                    batch_size=1, label_width=1, shuffle=False,
                    resize=0, rand_crop=False, rand_mirror=False,
                    mean_r=0.0, mean_g=0.0, mean_b=0.0,
                    std_r=0.0, std_g=0.0, std_b=0.0,
                    brightness=0.0, contrast=0.0, saturation=0.0,
                    pca_noise=0.0, num_parts=1, part_index=0,
                    data_name="data", label_name="softmax_label",
                    seed=None, preprocess_threads=0, ctx=None, **kwargs):
    """Image pipeline over packed ``.rec`` files (ref: ImageRecordIter2,
    src/io/iter_image_recordio_2.cc, with its flat kwargs surface) over
    ``image.ImageIter``: records read by the native reader, decoded and
    augmented on the host, with ``preprocess_threads`` by the native
    engine's workers (``EnginePipelineIter``).  Given ``ctx``, batches come
    on that context (``DevicePrefetchIter`` without workers).

    ``seed`` seeds Python's ``random`` and numpy's global generator, and
    every ``reset()`` re-seeds them from ``(seed, epoch)``, exactly as the
    JAX package does, so that the same seed gives the same batches there
    and here.  Unrecognized reference knobs are accepted and ignored."""
    import random as _pyrandom
    from .image import CreateAugmenter, ImageIter

    if data_shape is None:
        raise MXNetError("ImageRecordIter requires data_shape")
    data_shape = tuple(int(x) for x in data_shape)
    if seed is not None:
        # the augmenters draw from the process-global generators, so
        # seeding here affects (and is affected by) other users of them;
        # reset() re-seeds (below), so each epoch's order is reproducible
        _pyrandom.seed(int(seed))
        np.random.seed(int(seed) & 0x7FFFFFFF)
    mean = None
    if mean_r or mean_g or mean_b:
        mean = np.array([mean_r, mean_g, mean_b], np.float32)
    std = None
    if std_r or std_g or std_b:
        std = np.array([std_r or 1.0, std_g or 1.0, std_b or 1.0],
                       np.float32)
    if mean is not None and std is None:
        std = np.array([1.0, 1.0, 1.0], np.float32)
    if std is not None and mean is None:
        mean = np.array([0.0, 0.0, 0.0], np.float32)  # std alone: divide
    if (shuffle or num_parts > 1) and path_imgrec and not path_imgidx:
        # shuffling and sharding need random access: index the file once
        path_imgidx = path_imgrec + ".autoidx"
        if not os.path.exists(path_imgidx):
            _build_rec_index(path_imgrec, path_imgidx)
    aug = CreateAugmenter(data_shape, resize=resize, rand_crop=rand_crop,
                          rand_mirror=rand_mirror, mean=mean, std=std,
                          brightness=brightness, contrast=contrast,
                          saturation=saturation, pca_noise=pca_noise)
    it = ImageIter(batch_size=batch_size, data_shape=data_shape,
                   label_width=label_width, path_imgrec=path_imgrec,
                   path_imgidx=path_imgidx, shuffle=shuffle,
                   part_index=part_index, num_parts=num_parts,
                   aug_list=aug, data_name=data_name,
                   label_name=label_name)
    if seed is not None:
        # reproducible epochs: reset() re-seeds the global generators from
        # (seed, epoch), so epoch k's shuffle and augmentation depend only
        # on the seed, while successive epochs draw differently
        base_reset = it.reset
        # construction consumed the first stream (ImageIter's own reset),
        # so the first wrapped reset starts at epoch 1
        epoch_box = [1]

        def _reset_with_seed():
            epoch_seed = (int(seed) + 1000003 * epoch_box[0]) & 0x7FFFFFFF
            epoch_box[0] += 1
            _pyrandom.seed(epoch_seed)
            np.random.seed(epoch_seed)
            base_reset()

        it.reset = _reset_with_seed
    if preprocess_threads and int(preprocess_threads) > 0:
        # the reference's decode thread pool (iter_image_recordio_2.cc) as
        # native engine ops: a serialized record read fans out to
        # preprocess_threads decode/augment ops (a per-record RNG keeps the
        # augmentation independent of the interleaving), then one assemble
        try:
            return EnginePipelineIter(it, ctx=ctx,
                                      num_workers=int(preprocess_threads),
                                      seed=seed)
        except RuntimeError:
            pass  # no native engine: DevicePrefetchIter below still uploads
    if ctx is not None:
        return DevicePrefetchIter(it, ctx=ctx)
    return it


def ImageRecordIter_v1(**kwargs):
    return ImageRecordIter(**kwargs)


# pinned host buffers of the upload ring: one slot filled while the copy
# of the other is in flight
UPLOAD_SLOTS = 2


class _Uploader:
    """Copies host batches to ``ctx`` (ref: the reference's copy-lane
    engine ops, FnProperty::kCopyFromCPU).

    On a card, each batch's arrays are staged in pinned host buffers and
    copied on a side stream; an event recorded after the copies marks them
    done.  The pinned buffers are a ring of UPLOAD_SLOTS slots: before a
    slot is refilled, the host waits for the event of the copy that last
    read it.  :meth:`hand_over` makes the consumer's current stream wait for
    the batch's event and records the batch's tensors as used on that
    stream, so that the caching allocator does not give their memory to
    the side stream while the consumer still reads it.  A host context
    passes host arrays through."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.device = ctx.torch_device()
        self.cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if self.cuda else None
        self._slots = [{"pinned": [], "event": None}
                       for _ in range(UPLOAD_SLOTS)]
        self._next = 0

    def _copy(self, dst, src):
        """The side stream's copy of one array (the ordering tests delay
        the side stream here)."""
        dst.copy_(src, non_blocking=True)

    def upload(self, batch):
        """(batch on ``ctx``, the event its copies record or None)."""
        arrays = list(batch.data) + list(batch.label or [])
        tensors = [a.tensor if isinstance(a, NDArray)
                   else torch.as_tensor(np.asarray(a)) for a in arrays]
        if not self.cuda or all(t.device == self.device for t in tensors):
            out, event = [t.to(self.device) for t in tensors], None
        else:
            slot = self._slots[self._next % len(self._slots)]
            self._next += 1
            if slot["event"] is not None:
                slot["event"].synchronize()  # its last copy has read it
            pinned = slot["pinned"]
            del pinned[len(tensors):]
            for i, t in enumerate(tensors):
                if i == len(pinned):
                    pinned.append(None)
                if pinned[i] is None or pinned[i].shape != t.shape \
                        or pinned[i].dtype != t.dtype:
                    pinned[i] = torch.empty(t.shape, dtype=t.dtype,
                                            pin_memory=True)
                pinned[i].copy_(t)
            out = []
            with torch.cuda.stream(self.stream):
                for p in pinned:
                    d = torch.empty(p.shape, dtype=p.dtype,
                                    device=self.device)
                    self._copy(d, p)
                    out.append(d)
            event = torch.cuda.Event()
            event.record(self.stream)
            slot["event"] = event
        n = len(batch.data)
        arrays = [NDArray(t) for t in out]
        return DataBatch(arrays[:n], arrays[n:] if batch.label else
                         batch.label, pad=batch.pad, index=batch.index,
                         bucket_key=batch.bucket_key,
                         provide_data=batch.provide_data,
                         provide_label=batch.provide_label), event

    def hand_over(self, batch, event):
        """The batch, safe to use on the consumer's current stream."""
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for a in list(batch.data) + list(batch.label or []):
                a.tensor.record_stream(cur)
        return batch


class DevicePrefetchIter(DataIter):
    """Batches of ``base_iter`` on ``ctx`` (default: the current context),
    each copied one batch ahead of its consumption: the copy of batch N+1
    is issued on the side stream when batch N is handed out, so it runs
    under the consumer's step N (``_Uploader``)."""

    def __init__(self, base_iter, ctx=None):
        super().__init__()
        self._base = base_iter
        self._ctx = ctx or current_context()
        self._uploader = _Uploader(self._ctx)
        self._pending = None
        self.batch_size = getattr(base_iter, "batch_size", None)

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def reset(self):
        self._base.reset()
        self._pending = None

    def _fetch(self):
        try:
            return self._uploader.upload(self._base.next())
        except StopIteration:
            return None

    def next(self):
        if self._pending is None:
            self._pending = self._fetch()
            if self._pending is None:
                raise StopIteration
        out = self._pending
        self._pending = self._fetch()  # the next copy, under this step
        return self._uploader.hand_over(*out)


class EnginePipelineIter(DataIter):
    """Engine-scheduled input pipeline: record read, decode/augment and
    batch assembly run as ``NativeEngine`` ops with variable dependencies
    (the reference's ImageRecordIOParser2: a prefetching reader feeding a
    decode thread pool, iter_image_recordio_2.cc).  With a base iterator
    that gives single samples (``ImageIter``) the stages are:

      read op     (serialized on the iterator's variable) pulls a batch of
                  raw records: cheap, and it fixes the order;
      decode ops  one per worker, each decoding a contiguous shard of the
                  batch concurrently.  Each record's augmentation draws
                  come from a per-record RNG (``image.seed_augmenter_rng``,
                  or three uniforms for the resize/crop/flip chain), so the
                  augmentation a record receives is a function of (seed,
                  epoch, index) alone, whatever the interleaving;
      assemble op (after every shard) builds the host DataBatch.

    Given ``ctx``, ``next()`` hands the batch out on that context through
    the pinned buffers and side stream of ``_Uploader``.  Batches equal
    the JAX package's ``EnginePipelineIter``'s for the same seed."""

    def __init__(self, base, depth=2, ctx=None, num_workers=2, engine=None,
                 seed=None):
        from .io_native import NativeEngine
        super().__init__(base.batch_size)
        self._base = base
        # workers beyond cores + 2 only thrash the scheduler
        cap = (os.cpu_count() or 2) + 2
        self._n_workers = max(1, min(int(num_workers), cap))
        # one thread more, so the serialized read op overlaps the shards
        self._engine = engine or NativeEngine(self._n_workers + 1)
        self._uploader = _Uploader(ctx) if ctx is not None else None
        self._iter_var = self._engine.new_var()
        # the staged pipeline engages whenever the base gives samples, also
        # at num_workers=1, so the per-record augmentation stream is the
        # same whatever the worker count
        self._parallel = (hasattr(base, "next_sample")
                          and hasattr(base, "imdecode")
                          and hasattr(base, "augmentation_transform")
                          and hasattr(base, "data_shape"))
        self._slots = [{"var": self._engine.new_var(), "batch": None,
                        "stop": False, "error": None,
                        "shard_vars": tuple(self._engine.new_var()
                                            for _ in range(self._n_workers))
                        if self._parallel else ()}
                       for _ in range(max(1, depth))]
        self._idx = 0
        self._armed = False
        self._plan = None
        self._seed = int(seed) if seed is not None \
            else int.from_bytes(os.urandom(4), "little")
        self._epoch = 0
        self._sample_idx = 0

    @property
    def provide_data(self):
        return self._base.provide_data

    @property
    def provide_label(self):
        return self._base.provide_label

    def _arm(self, slot):
        if self._parallel:
            self._arm_parallel(slot)
            return

        def produce():
            try:
                slot["batch"] = self._base.next()
                slot["stop"] = False
            except StopIteration:
                slot["batch"], slot["stop"] = None, True
            except Exception as e:  # raised on the consumer's thread
                slot["error"] = e

        # produce ops serialize on the iterator's variable (the base
        # iterator and the augmenter RNG are single-threaded state)
        self._engine.push(produce, mutable_vars=(self._iter_var,
                                                 slot["var"]))

    def _record_seed(self, gidx):
        """Per-record augmentation seed: a function of (iterator seed,
        epoch, running sample index)."""
        return ((self._seed * 1000003 + self._epoch * 7919)
                ^ (gidx * 2654435761)) & 0x7FFFFFFF

    def _augment_plan(self):
        """Split the base augmenter list into a per-image geometry stage
        and a batch-level arithmetic stage, preferring the native chain.

        1. native: the standard chain (short-side resize -> random/center
           crop -> flip -> mean/std normalize) as one C call per worker
           shard (``src/image_decode.cc``), writing normalized f32 CHW
           into the batch without the GIL;
        2. the same chain in Python (the codec's resize releases the GIL),
           normalized once per batch;
        3. generic: any other augmenter list, per image.

        Returns a dict plan, or None for the generic tier."""
        from .image import image as _im
        from .io_native import get_imgdec_lib
        augs = list(getattr(self._base, "auglist", ()))
        mean = std = None
        while augs and isinstance(augs[-1], (_im.CastAug,
                                             _im.ColorNormalizeAug)):
            a = augs.pop()
            if isinstance(a, _im.ColorNormalizeAug):
                mean, std = a.mean, a.std
        geom = (_im.ResizeAug, _im.ForceResizeAug, _im.RandomCropAug,
                _im.CenterCropAug, _im.RandomSizedCropAug,
                _im.HorizontalFlipAug)
        if not all(isinstance(a, geom) for a in augs):
            return None
        plan = {"geom": augs, "mean": mean, "std": std, "native": False,
                "seq": None}
        # the seq chain (3 channels; resize? -> one crop? -> flip?) draws
        # its randomness as three uniforms from the per-record RNG, so its
        # Python and native forms give the same stream
        c = self._base.data_shape[0]
        seq = {"resize": 0, "interp": 2, "crop_mode": 0, "flip_p": -1.0}
        stage = 0
        ok = c == 3
        for a in augs:
            if isinstance(a, _im.ResizeAug) and stage == 0:
                seq["resize"], seq["interp"] = int(a.size), int(a.interp)
                stage = 1
            elif isinstance(a, _im.RandomCropAug) and stage <= 1:
                seq["crop_mode"], seq["interp"] = 1, int(a.interp)
                stage = 2
            elif isinstance(a, _im.CenterCropAug) and stage <= 1:
                seq["crop_mode"], seq["interp"] = 2, int(a.interp)
                stage = 2
            elif isinstance(a, _im.HorizontalFlipAug) and stage <= 2:
                seq["flip_p"] = float(a.p)
                stage = 3
            else:
                ok = False
                break
        if ok:
            plan["seq"] = seq
            plan["native"] = get_imgdec_lib() is not None
        return plan

    def _arm_parallel(self, slot):
        base = self._base
        W = self._n_workers
        B = self.batch_size
        c, h, w = base.data_shape
        lw = getattr(base, "label_width", 1)
        if self._plan is None:
            self._plan = (self._augment_plan(),)
        plan = self._plan[0]

        def read():
            try:
                raw = []
                try:
                    while len(raw) < B:
                        label, s = base.next_sample()
                        raw.append((label, s, self._sample_idx))
                        self._sample_idx += 1
                except StopIteration:
                    pass
                slot["raw"] = raw
                slot["pad"] = B - len(raw)
                slot["stop"] = not raw
                if raw:
                    # the geometry stage writes uint8 CHW per image on the
                    # workers; assemble casts and normalizes the batch (the
                    # native chain writes normalized f32 itself)
                    dt = np.uint8 if plan and not plan["native"] \
                        else np.float32
                    slot["data"] = np.zeros((B, c, h, w), dt)
                    slot["label"] = np.zeros(
                        (B, lw) if lw > 1 else (B,), np.float32)
            except Exception as e:  # raised on the consumer's thread
                slot["error"] = e

        # the read op serializes on the iterator's variable (the stream
        # position is the only single-threaded state left)
        self._engine.push(read, mutable_vars=(self._iter_var, slot["var"]))

        def u01(gidx):
            """The seq chain's randomness: three uniforms per record (crop
            x, crop y, flip), the same for its Python and native forms."""
            import random as _pyrandom
            rng = _pyrandom.Random(self._record_seed(gidx))
            return rng.random(), rng.random(), rng.random()

        def decode_seq_py(lo, hi):
            from .image import image as _im
            seq = plan["seq"]
            raw = slot["raw"]
            for j in range(lo, hi):
                label, s, gidx = raw[j]
                ux, uy, uflip = u01(gidx)
                img = base.imdecode_np(s) if hasattr(base, "imdecode_np") \
                    else base.imdecode(s).asnumpy()
                if seq["resize"]:
                    img = _im.resize_short(img, seq["resize"],
                                           seq["interp"])
                ih, iw = img.shape[:2]
                if seq["crop_mode"]:
                    cw, ch = _im.scale_down((iw, ih), (w, h))
                    if seq["crop_mode"] == 1:
                        x0 = min(int(ux * (iw - cw + 1)), iw - cw)
                        y0 = min(int(uy * (ih - ch + 1)), ih - ch)
                    else:
                        x0, y0 = (iw - cw) // 2, (ih - ch) // 2
                    img = img[y0:y0 + ch, x0:x0 + cw]
                    if (cw, ch) != (w, h):
                        img = _im.imresize(img, w, h, seq["interp"])
                elif (ih, iw) != (h, w):
                    img = _im.imresize(img, w, h, seq["interp"])
                if seq["flip_p"] >= 0 and uflip < seq["flip_p"]:
                    img = img[:, ::-1]
                slot["data"][j] = img.transpose(2, 0, 1)
                slot["label"][j] = label

        def decode_native(lo, hi):
            """One C call for the shard [lo, hi): decode, geometry and
            normalize into the f32 CHW batch, without the GIL."""
            import ctypes
            from . import io_native
            lib = io_native.get_imgdec_lib()
            seq = plan["seq"]
            raw = slot["raw"]
            n = hi - lo
            bufs = (ctypes.c_void_p * n)()
            lens = (ctypes.c_int64 * n)()
            keep = []
            draws = np.empty((n, 3), np.float32)
            for t in range(n):
                label, s, gidx = raw[lo + t]
                b = s if isinstance(s, bytes) else bytes(s)
                keep.append(b)
                bufs[t] = ctypes.cast(ctypes.c_char_p(b), ctypes.c_void_p)
                lens[t] = len(b)
                draws[t] = u01(gidx)
                slot["label"][lo + t] = label
            f32p = ctypes.POINTER(ctypes.c_float)

            def fp(a):
                return a.ctypes.data_as(f32p) if a is not None else None

            mean = np.ascontiguousarray(plan["mean"], np.float32).reshape(-1) \
                if plan["mean"] is not None else None
            std = np.ascontiguousarray(plan["std"], np.float32).reshape(-1) \
                if plan["std"] is not None else None
            out = slot["data"][lo:hi]  # a contiguous f32 view
            err = ctypes.create_string_buffer(256)
            rc = lib.img_decode_chain(
                bufs, lens, n, seq["resize"], seq["interp"],
                seq["crop_mode"], fp(draws), seq["flip_p"], h, w,
                fp(mean), fp(std), out.ctypes.data_as(f32p), err, 256)
            io_native.OPENED["imgdec_calls"] += 1
            if rc != 0:
                raise MXNetError("native decode failed: %s"
                                 % err.value.decode())

        def make_decode(k):
            def decode():
                from .image import image as _image
                try:
                    raw = slot.get("raw") or ()
                    if slot["error"] is not None or not raw:
                        return
                    chunk = (len(raw) + W - 1) // W
                    lo = min(k * chunk, len(raw))
                    hi = min(lo + chunk, len(raw))
                    if lo == hi:
                        return
                    if plan and plan["seq"]:
                        if plan["native"]:
                            decode_native(lo, hi)
                        else:
                            decode_seq_py(lo, hi)
                        return
                    for j in range(lo, hi):
                        label, s, gidx = raw[j]
                        _image.seed_augmenter_rng(self._record_seed(gidx))
                        if plan:
                            # plannable but not seq-able (a random-sized
                            # crop): geometry per image, normalize per batch
                            data = base.imdecode_np(s) if hasattr(
                                base, "imdecode_np") \
                                else base.imdecode(s).asnumpy()
                            for a in plan["geom"]:
                                data = a(data)
                        else:
                            # generic: the whole list per image, in numpy
                            # when every augmenter is builtin, else through
                            # the NDArray contract of user augmenters
                            if getattr(base, "_all_builtin_augs", False) \
                                    and hasattr(base, "imdecode_np"):
                                data = base.imdecode_np(s)
                            else:
                                data = base.imdecode(s)
                            data = base.augmentation_transform(data)
                            if hasattr(data, "asnumpy"):
                                data = data.asnumpy()
                        slot["data"][j] = data.transpose(2, 0, 1)
                        slot["label"][j] = label
                except Exception as e:
                    slot["error"] = e
            return decode

        for k in range(W):
            self._engine.push(make_decode(k), const_vars=(slot["var"],),
                              mutable_vars=(slot["shard_vars"][k],))

        def assemble():
            if slot["error"] is not None or slot.get("stop") or \
                    slot.get("raw") is None:
                return
            try:
                data = slot["data"]  # already CHW
                if plan and not plan["native"]:
                    # whole-batch passes: u8 -> f32 (+ mean/std)
                    mean, std = plan["mean"], plan["std"]
                    if mean is not None:
                        data = np.subtract(
                            data, np.asarray(mean, np.float32)
                            .reshape(1, -1, 1, 1), dtype=np.float32)
                    else:
                        data = data.astype(np.float32)
                    if std is not None:
                        data /= np.asarray(std, np.float32) \
                            .reshape(1, -1, 1, 1)
                slot["batch"] = DataBatch(
                    [array(data, ctx=cpu())],
                    [array(slot["label"], ctx=cpu())], pad=slot["pad"])
                slot["raw"] = slot["data"] = slot["label"] = None
            except Exception as e:
                slot["error"] = e

        self._engine.push(assemble, const_vars=slot["shard_vars"],
                          mutable_vars=(slot["var"],))

    def _arm_all(self):
        for s in self._slots:
            s["batch"], s["stop"], s["error"] = None, False, None
            self._arm(s)
        self._armed = True

    def next(self):
        if not self._armed:
            self._arm_all()
        slot = self._slots[self._idx % len(self._slots)]
        self._engine.wait_for_var(slot["var"])
        if slot["error"] is not None:
            # raise the error but keep the pipeline usable: re-arm the
            # slot and advance, as the success path does
            err = slot["error"]
            slot["error"], slot["batch"] = None, None
            self._arm(slot)
            self._idx += 1
            raise err
        if slot["stop"]:
            raise StopIteration
        batch = slot["batch"]
        slot["batch"] = None
        self._arm(slot)  # refill behind the consumer
        self._idx += 1
        if self._uploader is not None:
            batch = self._uploader.hand_over(*self._uploader.upload(batch))
        return batch

    def reset(self):
        self._engine.wait_for_all()
        self._base.reset()
        self._armed = False
        self._idx = 0
        self._epoch += 1
        self._sample_idx = 0

    def close(self):
        """Finish the queued ops and stop the engine's workers."""
        self._engine.wait_for_all()
        self._engine.close()


_DATA_ITER_REGISTRY = {
    "MNISTIter": MNISTIter,
    "CSVIter": CSVIter,
    "LibSVMIter": LibSVMIter,
    "ImageRecordIter": ImageRecordIter,
    "ImageRecordIter_v1": ImageRecordIter_v1,
    "NDArrayIter": NDArrayIter,
}


def MXDataIter(name, **kwargs):
    """Create a registered iterator by name (ref: io.py:759, which wraps
    the C++ iterator registry)."""
    try:
        creator = _DATA_ITER_REGISTRY[name]
    except KeyError:
        raise MXNetError(
            "unknown data iterator %r; registered: %s"
            % (name, sorted(_DATA_ITER_REGISTRY)))
    return creator(**kwargs)

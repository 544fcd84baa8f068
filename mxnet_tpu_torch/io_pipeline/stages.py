"""Pipeline stages: sources, decoders, batch assembly.

Counterpart of ``mxnet_tpu/io_pipeline/stages.py``: the same sources,
decoders and assembly over the port's ``recordio`` and ``image.image``,
so that the same seed gives the JAX package's batches bit for bit.  The
stage contract mirrors the reference's layered iterator design
(src/io: source -> parser/augmenter -> batch loader -> prefetcher,
iter_prefetcher.h) with the host-parallel split this package needs:

- a **source** owns the record set and hands each worker its own reader
  (``open_reader()``) — random-access readers are not thread-safe, so
  sharded access means one reader handle per worker, never a shared
  seek+read;
- a **decoder** is a picklable callable ``(raw_bytes, rng) -> (data,
  label)`` run off the driving thread, with ``rng`` seeded per record
  (`sharding.record_seed`) so augmentation is a pure function of
  (seed, epoch, position);
- **assembly** stacks decoded rows into the contiguous batch arrays the
  device transfer uploads.

Sources and decoders are plain picklable objects so the process pool
can ship them to spawn workers.
"""
from __future__ import annotations

import os

import numpy as np

from ..base import MXNetError


class RecordFileSource:
    """Sharded random-access source over a packed ``.rec`` file.

    Uses ``MXIndexedRecordIO``; a missing ``.idx`` is built once
    (``<rec>.autoidx``, same convention as ``io.ImageRecordIter``).
    ``num_parts``/``part_index`` select this host's balanced shard
    (`sharding.shard_records` — every record lands in exactly one
    part).  Holds only paths and the key list, so it pickles cleanly
    into process-pool workers; every reader handle is opened on demand.
    """

    def __init__(self, path_imgrec, path_imgidx=None, key_type=int,
                 num_parts=1, part_index=0):
        from ..io import _build_rec_index
        if path_imgidx is None:
            path_imgidx = path_imgrec + ".autoidx"
            if not os.path.exists(path_imgidx):
                _build_rec_index(path_imgrec, path_imgidx)
        self.path_imgrec = path_imgrec
        self.path_imgidx = path_imgidx
        self.key_type = key_type
        reader = self._open()
        try:
            keys = list(reader.keys)
        finally:
            reader.close()
        if not keys:
            raise MXNetError("no records indexed by %s" % path_imgidx)
        if num_parts > 1:
            from .sharding import shard_records
            picks = shard_records(len(keys), num_parts, part_index)
            keys = [keys[i] for i in picks]
        self.keys = keys

    def _open(self):
        from ..recordio import MXIndexedRecordIO
        return MXIndexedRecordIO(self.path_imgidx, self.path_imgrec, "r",
                                 key_type=self.key_type)

    def __len__(self):
        return len(self.keys)

    def open_reader(self):
        """A fresh reader handle for one worker: ``read(i)`` returns the
        raw payload of record ``self.keys[i]``; ``close()`` releases the
        file handle."""
        return _RecordReader(self._open(), self.keys)


class _RecordReader:
    __slots__ = ("_rio", "_keys")

    def __init__(self, rio, keys):
        self._rio = rio
        self._keys = keys

    def read(self, index):
        return self._rio.read_idx(self._keys[index])

    def close(self):
        self._rio.close()


class ListSource:
    """In-memory source over a list of raw items (tests, smoke benches).
    Items pass to the decoder unchanged."""

    def __init__(self, items):
        if not items:
            raise MXNetError("ListSource needs at least one item")
        self.items = list(items)

    def __len__(self):
        return len(self.items)

    def open_reader(self):
        return _ListReader(self.items)


class _ListReader:
    __slots__ = ("_items",)

    def __init__(self, items):
        self._items = items

    def read(self, index):
        return self._items[index]

    def close(self):
        pass


# -- decoders ----------------------------------------------------------------

class RecordRng:
    """Per-record RNG, constructed lazily on first draw.

    A ``np.random.RandomState`` seeding costs ~190 us (full Mersenne
    init) — paid per RECORD it would dominate a cheap decode (measured:
    6.8 ms/batch of pure seeding at batch 32).  Decoders that draw no
    randomness therefore get this proxy and pay ~nothing for the
    determinism contract; the first attribute access materializes the
    seeded RandomState, after which it behaves identically."""

    __slots__ = ("_seed", "_rng")

    def __init__(self, seed):
        self._seed = seed
        self._rng = None

    def __getattr__(self, name):
        rng = self._rng
        if rng is None:
            rng = self._rng = np.random.RandomState(self._seed)
        return getattr(rng, name)


class NDArrayRecordDecoder:
    """Decode a recordio payload of ``pack(IRHeader, arr.tobytes())``
    into ``(arr.reshape(shape), label)`` — the cheap non-image decode
    the io smoke and tests use."""

    def __init__(self, shape, dtype="float32"):
        self.shape = tuple(int(d) for d in shape)
        self.dtype = np.dtype(dtype)
        self._n = 1
        for d in self.shape:
            self._n *= d

    def __call__(self, raw, rng):
        from ..recordio import unpack
        header, payload = unpack(raw)
        data = np.frombuffer(payload, dtype=self.dtype)
        data = np.array(data[:self._n].reshape(self.shape))  # owned copy
        label = header.label
        if not np.isscalar(label):
            label = np.asarray(label, np.float32)
        return data, label


class ImageRecordDecoder:
    """JPEG record -> augmented f32 CHW, per-record-seeded geometry.

    The standard training chain (short-side resize -> random/center
    crop -> flip -> mean/std normalize) with every random draw taken
    from the per-record ``rng`` — so a record's augmentation is
    identical whatever worker (thread OR process) decodes it."""

    def __init__(self, data_shape, resize=0, rand_crop=False,
                 rand_mirror=False, mean=None, std=None, interp=2):
        self.data_shape = tuple(int(d) for d in data_shape)  # (C, H, W)
        self.resize = int(resize)
        self.rand_crop = bool(rand_crop)
        self.rand_mirror = bool(rand_mirror)
        self.mean = (np.asarray(mean, np.float32).reshape(-1)
                     if mean is not None else None)
        self.std = (np.asarray(std, np.float32).reshape(-1)
                    if std is not None else None)
        self.interp = int(interp)

    def __call__(self, raw, rng):
        from ..image import image as _im
        from ..recordio import unpack, _imdecode
        header, payload = unpack(raw)
        img = _imdecode(payload)  # HWC uint8 (BGR, cv2 convention)
        c, h, w = self.data_shape
        if self.resize:
            img = _im.resize_short(img, self.resize, self.interp)
        ih, iw = img.shape[:2]
        cw, ch = _im.scale_down((iw, ih), (w, h))
        if self.rand_crop:
            x0 = min(int(rng.uniform() * (iw - cw + 1)), iw - cw)
            y0 = min(int(rng.uniform() * (ih - ch + 1)), ih - ch)
        else:
            x0, y0 = (iw - cw) // 2, (ih - ch) // 2
        img = img[y0:y0 + ch, x0:x0 + cw]
        if (cw, ch) != (w, h):
            img = _im.imresize(img, w, h, self.interp)
        if self.rand_mirror and rng.uniform() < 0.5:
            img = img[:, ::-1]
        data = img.astype(np.float32)
        if self.mean is not None:
            data -= self.mean.reshape(1, 1, -1)
        if self.std is not None:
            data /= self.std.reshape(1, 1, -1)
        label = header.label
        if not np.isscalar(label):
            label = np.asarray(label, np.float32)
        return data.transpose(2, 0, 1), label


# -- batch assembly ----------------------------------------------------------

class HostBatch:
    """One assembled batch on the host: contiguous data/label arrays
    plus the pad row count (``seq`` keeps the epoch position for
    debugging).  ``decode_s`` carries the worker-measured decode wall
    time of a process-pool batch."""

    __slots__ = ("seq", "data", "label", "pad", "decode_s")

    def __init__(self, seq, data, label, pad, decode_s=None):
        self.seq = seq
        self.data = data
        self.label = label
        self.pad = pad
        self.decode_s = decode_s

    def __getstate__(self):
        return (self.seq, self.data, self.label, self.pad, self.decode_s)

    def __setstate__(self, state):
        (self.seq, self.data, self.label, self.pad,
         self.decode_s) = state


def assemble_batch(task, rows, labels):
    """Stack decoded rows into one contiguous HostBatch."""
    data = np.ascontiguousarray(np.stack(rows))
    label = np.asarray(labels, dtype=np.float32)
    return HostBatch(task.seq, data, label, task.pad)


def decode_task(task, reader, decode, seed):
    """Run one BatchTask against an open reader: read + per-record-seeded
    decode for every row, then assemble.  Shared by the thread workers
    and the process-pool entry point below."""
    from .sharding import record_seed
    rows, labels = [], []
    for gidx, index in zip(task.positions, task.indices):
        raw = reader.read(index)
        rng = RecordRng(record_seed(seed, task.epoch, gidx))
        data, label = decode(raw, rng)
        rows.append(data)
        labels.append(label)
    return assemble_batch(task, rows, labels)


# per-worker-process run context, installed by the pool INITIALIZER so
# the source (whose key list scales with the dataset) and decoder ship
# to each worker exactly once — never pickled per task
_PROC_CTX = {}


def process_pool_init(source, decode, seed):
    """ProcessPoolExecutor initializer (runs once in each spawn worker):
    register the run context; the reader opens lazily on first task and
    lives as long as the worker."""
    _PROC_CTX["ctx"] = (source, decode, seed)
    _PROC_CTX["reader"] = None


def process_decode_task(task):
    """Top-level (picklable) process-pool entry point; per-task payload
    is just the BatchTask — the context came via `process_pool_init`.
    Decode wall time is measured here (the worker's clock) and rides
    back on the batch."""
    import time
    source, decode, seed = _PROC_CTX["ctx"]
    reader = _PROC_CTX["reader"]
    if reader is None:
        reader = _PROC_CTX["reader"] = source.open_reader()
    t0 = time.perf_counter()
    out = decode_task(task, reader, decode, seed)
    out.decode_s = time.perf_counter() - t0
    return out

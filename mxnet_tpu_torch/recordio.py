"""RecordIO: packed binary record files (ref: python/mxnet/recordio.py +
dmlc/recordio.h).

Counterpart of ``mxnet_tpu/recordio.py``, writing and reading the same
bytes: records framed with the dmlc magic number and length, and the
``IRHeader`` image-record struct, so ``.rec``/``.idx`` files written by
either package read in the other.  Framing runs in the native library
(``io_native``, ``src/recordio.cc``) when it builds, else in Python (the
plain version); image coding goes through ``image.codec``."""
from __future__ import annotations

import os
import struct
from collections import namedtuple

import numpy as np

from .base import MXNetError

_MAGIC = 0xced7230a


def _pack_record(data):
    length = len(data)
    header = struct.pack("<II", _MAGIC, length)
    pad = (4 - length % 4) % 4
    return header + data + b"\x00" * pad


def _native_lib():
    try:
        from . import io_native
        return io_native.get_lib() and io_native
    except Exception:
        return None


class MXRecordIO:
    """Sequential record reader/writer (ref: recordio.py:36): framing in
    the native library (``src/recordio.cc``) when it builds, else in
    Python."""

    def __init__(self, uri, flag):
        self.uri = uri
        self.flag = flag
        self.handle = None
        self._native = None
        self.open()

    def open(self):
        from .filesystem import is_remote, open_uri
        # remote URIs (s3://, hdfs://, ... via filesystem.register_scheme)
        # stream through the python path — the native reader mmaps local
        # files
        native = None if is_remote(self.uri) else _native_lib()
        if self.flag == "w":
            if native is not None:
                self._native = native.NativeRecordWriter(self.uri)
            else:
                self.handle = open_uri(self.uri, "wb")
            self.writable = True
        elif self.flag == "r":
            if native is not None:
                # non-prefetch reader: seek() must work for indexed reads
                self._native = native.NativeRecordReader(self.uri,
                                                         prefetch=False)
            else:
                self.handle = open_uri(self.uri, "rb")
            self.writable = False
        else:
            raise ValueError("Invalid flag %s" % self.flag)
        self.is_open = True

    def close(self):
        if self.is_open:
            if self._native is not None:
                self._native.close()
                self._native = None
            if self.handle is not None:
                self.handle.close()
                self.handle = None
            self.is_open = False

    def reset(self):
        self.close()
        self.open()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def write(self, buf):
        assert self.writable
        if self._native is not None:
            self._native.write(buf)
            return
        self.handle.write(_pack_record(buf))

    def read(self):
        assert not self.writable
        if self._native is not None:
            return self._native.read()
        header = self.handle.read(8)
        if len(header) < 8:
            return None
        magic, length = struct.unpack("<II", header)
        if magic != _MAGIC:
            raise MXNetError("invalid record magic in %s" % self.uri)
        data = self.handle.read(length)
        pad = (4 - length % 4) % 4
        if pad:
            self.handle.read(pad)
        return data

    def tell(self):
        if self._native is not None:
            return self._native.tell()
        return self.handle.tell()

    def seek(self, pos):
        assert not self.writable
        if self._native is not None:
            self._native.seek(pos)
            return
        self.handle.seek(pos)


class MXIndexedRecordIO(MXRecordIO):
    """Indexed record IO supporting random read (ref: recordio.py:170)."""

    def __init__(self, idx_path, uri, flag, key_type=int):
        self.idx_path = idx_path
        self.idx = {}
        self.keys = []
        self.key_type = key_type
        self.fidx = None
        super().__init__(uri, flag)

    def open(self):
        from .filesystem import is_remote, open_uri
        super().open()
        self.idx = {}
        self.keys = []
        if self.flag == "r" and (is_remote(self.idx_path)
                                 or os.path.isfile(self.idx_path)):
            self.fidx = open_uri(self.idx_path, "r")
            for line in iter(self.fidx.readline, ""):
                line = line.strip().split("\t")
                key = self.key_type(line[0])
                self.idx[key] = int(line[1])
                self.keys.append(key)
        elif self.flag == "w":
            self.fidx = open_uri(self.idx_path, "w")

    def close(self):
        if not self.is_open:
            return
        super().close()
        if self.fidx is not None:
            self.fidx.close()
            self.fidx = None

    def read_idx(self, idx):
        self.seek(self.idx[idx])
        return self.read()

    def write_idx(self, idx, buf):
        key = self.key_type(idx)
        pos = self.tell()
        self.write(buf)
        self.fidx.write("%s\t%d\n" % (str(key), pos))
        self.idx[key] = pos
        self.keys.append(key)


IRHeader = namedtuple("HEADER", ["flag", "label", "id", "id2"])
_IR_FORMAT = "IfQQ"
_IR_SIZE = struct.calcsize(_IR_FORMAT)


def pack(header, s):
    """Pack an IRHeader + data into a record payload (ref: recordio.py:291)."""
    header = IRHeader(*header)
    if isinstance(header.label, (int, float)):
        header = header._replace(flag=0)
        packed = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                             header.id2)
    else:
        label = np.asarray(header.label, dtype=np.float32)
        header = header._replace(flag=label.size, label=0)
        packed = struct.pack(_IR_FORMAT, header.flag, header.label, header.id,
                             header.id2) + label.tobytes()
    return packed + s


def unpack(s):
    header = IRHeader(*struct.unpack(_IR_FORMAT, s[:_IR_SIZE]))
    s = s[_IR_SIZE:]
    if header.flag > 0:
        label = np.frombuffer(s[:header.flag * 4], dtype=np.float32)
        s = s[header.flag * 4:]
        header = header._replace(label=label)
    return header, s


def unpack_img(s, iscolor=-1):
    header, s = unpack(s)
    img = _imdecode(s, iscolor)
    return header, img


def pack_img(header, img, quality=95, img_fmt=".jpg"):
    encoded = _imencode(img, quality, img_fmt)
    return pack(header, encoded)


def _imdecode(buf, iscolor=-1):
    from .image import codec
    return codec.decode(buf, iscolor)


def _imencode(img, quality=95, img_fmt=".jpg"):
    from .image import codec
    return codec.encode(img, quality, img_fmt)

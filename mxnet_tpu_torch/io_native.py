"""Native (C++) host runtime: the record reader and writer, the dependency
engine, and the image decode chain.

Counterpart of the record and engine half of
``mxnet_tpu/io_native/__init__.py`` (``get_lib``, ``NativeRecordReader``,
``NativeRecordWriter``, ``NativeEngine``, ``get_imgdec_lib``), over the
same sources: ``src/recordio.cc`` and ``src/engine.cc`` compiled with
``g++`` into one library, and ``src/image_decode.cc`` into another where
OpenCV's headers exist.  The libraries are built at first use into the
package's ``_build/`` directory, named by a digest of their sources and
flags, written to a temporary name and renamed into place, so that
concurrent builds (test workers, threads) never load a half-written
file.  Where ``g++`` or a source is missing, :func:`get_lib` returns None
and ``recordio`` frames records in Python (the plain version); where
OpenCV's headers are missing, :func:`get_imgdec_lib` returns None and the
engine pipeline decodes each record in Python.  ``MXNET_TPU_IO_NATIVE=0``
(the JAX package's switch, read at each call) makes both return None.

:data:`OPENED` counts the native readers, writers and engines created and
the decode-chain calls made, so that a run can show which path it took.
The C APIs of the JAX package's module (predict, train, core) are not
here.
"""
from __future__ import annotations

import ctypes
import hashlib
import itertools
import os
import subprocess
import sys

from . import threads as _threads
from .base import MXNetError

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
SRC_DIR = os.path.join(os.path.dirname(_PKG_DIR), "src")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
OPENCV_INCLUDE = "/usr/include/opencv4"
_GXX = ("g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_RUNTIME_SRCS = ("recordio.cc", "engine.cc")
_IMGDEC_LIBS = ("-lopencv_core", "-lopencv_imgcodecs", "-lopencv_imgproc")

OPENED = {"reader": 0, "writer": 0, "engine": 0, "imgdec_calls": 0}

_lock = _threads.package_lock("io_native._lock")
_build_seq = itertools.count()
_libs = {}


def _library_path(stem, srcs, flags):
    digest = hashlib.sha256(repr(flags).encode())
    for src in srcs:
        with open(src, "rb") as f:
            digest.update(f.read())
    return os.path.join(BUILD_DIR, "lib%s-%s.so"
                        % (stem, digest.hexdigest()[:12]))


def _run_gxx(cmd, out_path):
    """Run ``cmd`` with ``out_path`` replaced by a private temporary name
    (process id and a process-wide counter, so two threads of one process
    never share it), then rename the result into place: a half-written
    library is never visible under ``out_path``."""
    tmp = "%s.build.%d.%d" % (out_path, os.getpid(), next(_build_seq))
    try:
        res = subprocess.run([c if c != out_path else tmp for c in cmd],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise MXNetError("%s failed:\n%s" % (" ".join(cmd[:1]),
                                                 res.stderr[-2000:]))
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _build(stem, srcs, flags=(), libs=()):
    """Compile ``srcs`` into ``_build/lib<stem>-<digest>.so`` unless it is
    there; returns its path (through :func:`_run_gxx`)."""
    out = _library_path(stem, srcs, flags + libs)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    _run_gxx(list(_GXX) + list(flags) + ["-o", out] + list(srcs)
             + list(libs), out)
    return out


def _load(key, build_and_declare):
    """The library ``key``, built and declared at first call; None (and
    never retried) when it cannot be built."""
    with _lock:
        if key not in _libs:
            try:
                _libs[key] = build_and_declare()
            except (OSError, MXNetError, subprocess.SubprocessError):
                _libs[key] = None
        return _libs[key]


def native_disabled():
    """Whether ``MXNET_TPU_IO_NATIVE=0`` sends every native path (record
    framing, engine, decode chain) onto its Python version."""
    return os.environ.get("MXNET_TPU_IO_NATIVE", "1").strip().lower() \
        in ("0", "false", "off")


def get_lib():
    """The record and engine library, built on first use; None where the
    toolchain or the sources are missing, or the native paths are off."""
    if native_disabled():
        return None
    def build():
        srcs = [os.path.join(SRC_DIR, f) for f in _RUNTIME_SRCS]
        if not all(os.path.exists(s) for s in srcs):
            return None
        lib = ctypes.CDLL(_build("mxnet_native", srcs))
        _declare(lib)
        return lib
    return _load("runtime", build)


def _declare(lib):
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn, res, args in (
            ("rio_reader_open", vp, [ctypes.c_char_p]),
            ("rio_reader_next", u8p, [vp, i64p]),
            ("rio_reader_seek", None, [vp, i64]),
            ("rio_reader_tell", i64, [vp]),
            ("rio_reader_close", None, [vp]),
            ("rio_writer_open", vp, [ctypes.c_char_p]),
            ("rio_writer_write", i64, [vp, ctypes.c_char_p, i64]),
            ("rio_writer_tell", i64, [vp]),
            ("rio_writer_close", None, [vp]),
            ("rio_prefetch_open", vp, [ctypes.c_char_p, i64]),
            ("rio_prefetch_next", u8p, [vp, i64p]),
            ("rio_prefetch_close", None, [vp]),
            ("engine_create", vp, [ctypes.c_int]),
            ("engine_destroy", None, [vp]),
            ("engine_new_var", i64, [vp]),
            ("engine_push", None, [vp, vp, vp, i64p, ctypes.c_int, i64p,
                                   ctypes.c_int]),
            ("engine_wait_for_var", None, [vp, i64]),
            ("engine_wait_for_all", None, [vp])):
        f = getattr(lib, fn)
        f.restype = res
        f.argtypes = args


def _runtime():
    lib = get_lib()
    if lib is None:
        raise RuntimeError("the native record/engine library is unavailable "
                           "(g++ or src/%s missing, or MXNET_TPU_IO_NATIVE=0)"
                           % " / src/".join(_RUNTIME_SRCS))
    return lib


class NativeRecordReader:
    """Sequential reader over the native library: a seekable one, or with
    ``prefetch`` a threaded read-ahead of ``capacity`` records."""

    def __init__(self, path, prefetch=True, capacity=256):
        lib = _runtime()
        self._lib = lib
        self._prefetch = prefetch
        if prefetch:
            self._h = lib.rio_prefetch_open(path.encode(), capacity)
        else:
            self._h = lib.rio_reader_open(path.encode())
        if not self._h:
            raise FileNotFoundError(2, "cannot open record file", path)
        self._len = ctypes.c_int64(0)
        OPENED["reader"] += 1

    def read(self):
        """The next record's payload, or None at the end.  A corrupt stream
        (bad magic, truncated payload) raises, as the Python framing
        does."""
        nxt = self._lib.rio_prefetch_next if self._prefetch \
            else self._lib.rio_reader_next
        ptr = nxt(self._h, ctypes.byref(self._len))
        if self._len.value == -1:
            return None
        if self._len.value < 0:
            raise MXNetError("invalid record magic (corrupt record file)")
        return ctypes.string_at(ptr, self._len.value)

    def seek(self, pos):
        assert not self._prefetch, "prefetch reader is sequential"
        self._lib.rio_reader_seek(self._h, pos)

    def tell(self):
        assert not self._prefetch
        return self._lib.rio_reader_tell(self._h)

    def close(self):
        if self._h:
            if self._prefetch:
                self._lib.rio_prefetch_close(self._h)
            else:
                self._lib.rio_reader_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def __iter__(self):
        while True:
            rec = self.read()
            if rec is None:
                return
            yield rec


class NativeRecordWriter:
    def __init__(self, path):
        lib = _runtime()
        self._lib = lib
        self._h = lib.rio_writer_open(path.encode())
        if not self._h:
            raise FileNotFoundError(2, "cannot open record file", path)
        OPENED["writer"] += 1

    def write(self, buf):
        """Write one record; returns its byte offset (for ``.idx`` files)."""
        return self._lib.rio_writer_write(self._h, bytes(buf), len(buf))

    def tell(self):
        return self._lib.rio_writer_tell(self._h)

    def close(self):
        if self._h:
            self._lib.rio_writer_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


_CB_TYPE = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


class NativeEngine:
    """Host-side dependency engine (ref semantics: Engine::Push/WaitForVar/
    WaitForAll, include/mxnet/engine.h)."""

    _live = None  # weak set of engines, closed at exit (see below)

    def __init__(self, num_workers=2):
        lib = _runtime()
        self._lib = lib
        self._h = lib.engine_create(num_workers)
        self._keep = {}  # op id -> callback keepalive
        self._next = 0
        self._cb_lock = _threads.package_lock("NativeEngine._cb_lock")
        # an engine destroyed during interpreter finalization deadlocks: the
        # C++ destructor joins worker threads whose Python callbacks can no
        # longer take the GIL.  Close every live engine at exit instead.
        if NativeEngine._live is None:
            import atexit
            import weakref
            NativeEngine._live = weakref.WeakSet()
            atexit.register(NativeEngine._close_all)
        NativeEngine._live.add(self)
        OPENED["engine"] += 1

    @classmethod
    def _close_all(cls):
        for eng in list(cls._live or ()):
            try:
                eng.close()
            except Exception:
                pass

    def new_var(self):
        return self._lib.engine_new_var(self._h)

    def push(self, fn, const_vars=(), mutable_vars=()):
        """Schedule ``fn()`` after every earlier op that writes one of
        ``const_vars`` or reads or writes one of ``mutable_vars``."""
        with self._cb_lock:
            op_id = self._next
            self._next += 1

        def trampoline(_):
            try:
                fn()
            finally:
                with self._cb_lock:
                    self._keep.pop(op_id, None)

        cb = _CB_TYPE(trampoline)
        with self._cb_lock:
            self._keep[op_id] = cb
        reads = (ctypes.c_int64 * len(const_vars))(*const_vars)
        writes = (ctypes.c_int64 * len(mutable_vars))(*mutable_vars)
        self._lib.engine_push(
            self._h, ctypes.cast(cb, ctypes.c_void_p), None,
            reads, len(const_vars), writes, len(mutable_vars))

    def wait_for_var(self, var):
        self._lib.engine_wait_for_var(self._h, var)

    def wait_for_all(self):
        self._lib.engine_wait_for_all(self._h)

    def close(self):
        if self._h:
            if sys.is_finalizing():
                # too late to join threads running Python callbacks: leak
                # the handle rather than deadlock in the destructor
                self._h = None
                return
            self._lib.engine_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def get_imgdec_lib():
    """The native decode and augment chain (``src/image_decode.cc``: short
    side resize, crop, flip and normalize of a shard of JPEG records in
    one call, without the GIL), built on first use where OpenCV's headers
    exist; None elsewhere, or where the native paths are off."""
    if native_disabled():
        return None
    def build():
        src = os.path.join(SRC_DIR, "image_decode.cc")
        if not (os.path.exists(src) and os.path.isdir(OPENCV_INCLUDE)):
            return None
        lib = ctypes.CDLL(_build("mxnet_imgdec", [src],
                                 ("-I" + OPENCV_INCLUDE,), _IMGDEC_LIBS))
        vpp = ctypes.POINTER(ctypes.c_void_p)
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.img_decode_chain.restype = ctypes.c_int
        lib.img_decode_chain.argtypes = [
            vpp, i64p, ctypes.c_int,              # bufs, lens, n
            ctypes.c_int, ctypes.c_int,           # resize_short, interp
            ctypes.c_int,                         # crop_mode
            f32p, ctypes.c_float,                 # u01, flip_p
            ctypes.c_int, ctypes.c_int,           # out_h, out_w
            f32p, f32p,                           # mean, std
            f32p,                                 # out
            ctypes.c_char_p, ctypes.c_int]        # err, errlen
        return lib
    return _load("imgdec", build)

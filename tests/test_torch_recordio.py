"""The port's ``recordio``, ``io_native`` record path and ``filesystem``
against the JAX package, on the CPU.

Files written by either package are the same bytes and read in the
other (plain and indexed); ``pack``/``unpack``/``pack_img``/``unpack_img``
agree field for field and pixel for pixel (both encode and decode with
cv2 here); the native reader and writer (``src/recordio.cc``, built into
the port's ``_build/``) agree with the Python framing, which the tests
reach by making the port's loader report no library; ``_build_rec_index``
writes the JAX package's index; remote schemes route through
``filesystem.register_scheme``."""
import io
import os

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import io as jio
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import filesystem, io_native
from mxnet_tpu_torch import io as tio
from mxnet_tpu_torch import recordio as trec


def _payloads(n=9, seed=0):
    rng = np.random.RandomState(seed)
    # lengths 0..3 mod 4 exercise the padding
    return [rng.randint(0, 256, rng.randint(0, 40)).astype(np.uint8)
            .tobytes() for _ in range(n)]


def _write(rec, prefix, payloads, indexed):
    if indexed:
        w = rec.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
    else:
        w = rec.MXRecordIO(prefix + ".rec", "w")
        for p in payloads:
            w.write(p)
    w.close()


def _read_all(rec, path):
    r = rec.MXRecordIO(path, "r")
    out = []
    while True:
        s = r.read()
        if s is None:
            break
        out.append(s)
    r.close()
    return out


def _python_framing(monkeypatch):
    """The port's record path without the native library."""
    monkeypatch.setattr(trec, "_native_lib", lambda: None)


@pytest.mark.parametrize("indexed", [False, True], ids=["plain", "indexed"])
@pytest.mark.parametrize("framing", ["native", "python"])
def test_files_are_the_same_bytes_and_cross_read(tmp_path, monkeypatch,
                                                 indexed, framing):
    if framing == "python":
        _python_framing(monkeypatch)
    payloads = _payloads()
    _write(jrec, str(tmp_path / "j"), payloads, indexed)
    _write(trec, str(tmp_path / "t"), payloads, indexed)
    for ext in (".rec", ".idx") if indexed else (".rec",):
        assert (tmp_path / ("j" + ext)).read_bytes() == \
            (tmp_path / ("t" + ext)).read_bytes()
    assert _read_all(trec, str(tmp_path / "j.rec")) == payloads
    assert _read_all(jrec, str(tmp_path / "t.rec")) == payloads
    if indexed:
        r = trec.MXIndexedRecordIO(str(tmp_path / "j.idx"),
                                   str(tmp_path / "j.rec"), "r")
        assert r.keys == list(range(len(payloads)))
        for k in (4, 0, 8, 3):
            assert r.read_idx(k) == payloads[k]
        r.close()


def test_native_and_python_readers_agree(tmp_path, monkeypatch):
    assert io_native.get_lib() is not None, "g++ builds the native library"
    payloads = _payloads(20, seed=1)
    _write(jrec, str(tmp_path / "a"), payloads, True)
    path = str(tmp_path / "a.rec")
    before = io_native.OPENED["reader"]
    native = _read_all(trec, path)
    assert io_native.OPENED["reader"] == before + 1
    prefetch = list(io_native.NativeRecordReader(path, prefetch=True))
    monkeypatch.setattr(trec, "_native_lib", lambda: None)
    python = _read_all(trec, path)
    assert io_native.OPENED["reader"] == before + 2
    assert native == python == prefetch == payloads
    # tell/seek agree between the two framings
    offsets = {}
    for name in ("python", "native"):
        if name == "native":
            monkeypatch.setattr(trec, "_native_lib",
                                lambda: io_native.get_lib() and io_native)
        r = trec.MXRecordIO(path, "r")
        pos = []
        while True:
            pos.append(r.tell())
            if r.read() is None:
                break
        r.seek(pos[5])
        assert r.read() == payloads[5]
        r.close()
        offsets[name] = pos
    assert offsets["python"] == offsets["native"]


@pytest.mark.parametrize("framing", ["native", "python"])
def test_corrupt_record_raises(tmp_path, monkeypatch, framing):
    if framing == "python":
        _python_framing(monkeypatch)
    path = tmp_path / "bad.rec"
    path.write_bytes(b"\x00" * 16)
    r = trec.MXRecordIO(str(path), "r")
    with pytest.raises(mx.MXNetError):
        r.read()
    r.close()


def test_pack_unpack_agree():
    for header, payload in (
            (jrec.IRHeader(0, 3.0, 7, 0), b"abc"),
            (jrec.IRHeader(0, [1.0, 2.5, -3.0], 8, 9), b"\x00\x01"),
            (jrec.IRHeader(5, 0.5, 2 ** 40, 3), b""),
            (jrec.IRHeader(0, np.arange(4, dtype=np.float32), 1, 2),
             b"xyz" * 10)):
        jp = jrec.pack(header, payload)
        tp = trec.pack(trec.IRHeader(*header), payload)
        assert jp == tp
        jh, js = jrec.unpack(jp)
        th, ts = trec.unpack(tp)
        assert js == ts == payload
        assert (jh.flag, jh.id, jh.id2) == (th.flag, th.id, th.id2)
        np.testing.assert_array_equal(np.asarray(jh.label),
                                      np.asarray(th.label))


@pytest.mark.parametrize("quality", [95, 60])
@pytest.mark.parametrize("fmt", [".jpg", ".png"])
def test_pack_img_unpack_img_agree(quality, fmt):
    rng = np.random.RandomState(quality)
    img = rng.randint(0, 256, (23, 31, 3)).astype(np.uint8)
    header = jrec.IRHeader(0, 4.0, 11, 0)
    jp = jrec.pack_img(header, img, quality=quality, img_fmt=fmt)
    tp = trec.pack_img(header, img, quality=quality, img_fmt=fmt)
    assert jp == tp
    for iscolor in (-1, 0, 1):
        (jh, ji), (th, ti) = jrec.unpack_img(jp, iscolor), \
            trec.unpack_img(tp, iscolor)
        assert jh == th
        np.testing.assert_array_equal(ji, ti)
    if fmt == ".png":
        np.testing.assert_array_equal(trec.unpack_img(tp)[1], img)


def test_unpack_img_of_unreadable_data_raises():
    bad = trec.pack(trec.IRHeader(0, 1.0, 0, 0), b"not an image")
    with pytest.raises(mx.MXNetError, match="cv2.*PIL"):
        trec.unpack_img(bad)


@pytest.mark.parametrize("framing", ["native", "python"])
def test_build_rec_index_matches(tmp_path, monkeypatch, framing):
    if framing == "python":
        _python_framing(monkeypatch)
    _write(jrec, str(tmp_path / "d"), _payloads(13, seed=2), False)
    rec = str(tmp_path / "d.rec")
    jio._build_rec_index(rec, str(tmp_path / "j.idx"))
    tio._build_rec_index(rec, str(tmp_path / "t.idx"))
    text = (tmp_path / "t.idx").read_text()
    assert text == (tmp_path / "j.idx").read_text()
    assert len(text.splitlines()) == 13
    assert not [p for p in os.listdir(tmp_path) if ".build." in p]


def test_native_writer_offsets_make_the_index(tmp_path):
    w = io_native.NativeRecordWriter(str(tmp_path / "w.rec"))
    offsets = [w.write(p) for p in _payloads(6, seed=3)]
    w.close()
    r = io_native.NativeRecordReader(str(tmp_path / "w.rec"),
                                     prefetch=False)
    for off, p in zip(offsets, _payloads(6, seed=3)):
        r.seek(off)
        assert r.read() == p
    r.close()


def test_native_engine_orders_writes():
    eng = io_native.NativeEngine(3)
    v = eng.new_var()
    seen = []
    for i in range(20):
        eng.push(lambda i=i: seen.append(i), mutable_vars=(v,))
    eng.wait_for_var(v)
    eng.wait_for_all()
    assert seen == list(range(20))
    eng.close()


@pytest.mark.parametrize("value", ["0", "off"])
def test_native_switch_sends_every_path_to_python(tmp_path, monkeypatch,
                                                  value):
    """``MXNET_TPU_IO_NATIVE=0`` (the JAX package's switch): no native
    library, records framed in Python, the same bytes as the native
    writer's, and the engine refuses as the JAX package's does."""
    payloads = _payloads(seed=3)
    _write(trec, str(tmp_path / "n"), payloads, indexed=True)
    monkeypatch.setenv("MXNET_TPU_IO_NATIVE", value)
    assert io_native.get_lib() is None
    assert io_native.get_imgdec_lib() is None
    w = trec.MXIndexedRecordIO(str(tmp_path / "p.idx"),
                               str(tmp_path / "p.rec"), "w")
    assert w._native is None and w.handle is not None
    for i, p in enumerate(payloads):
        w.write_idx(i, p)
    w.close()
    for ext in (".rec", ".idx"):
        with open(str(tmp_path / "p") + ext, "rb") as a, \
                open(str(tmp_path / "n") + ext, "rb") as b:
            assert a.read() == b.read()
    assert _read_all(trec, str(tmp_path / "p.rec")) == payloads
    with pytest.raises(RuntimeError, match="MXNET_TPU_IO_NATIVE"):
        io_native.NativeEngine(2)
    monkeypatch.delenv("MXNET_TPU_IO_NATIVE")
    assert io_native.get_lib() is not None


def test_libraries_build_into_the_port_package():
    assert io_native.get_lib() is not None
    built = os.listdir(io_native.BUILD_DIR)
    assert any(f.startswith("libmxnet_native-") for f in built)
    assert os.path.realpath(io_native.BUILD_DIR).startswith(
        os.path.realpath(os.path.dirname(mx.__file__)))


@pytest.mark.parametrize("uri,want", [
    ("s3://bucket/key.rec", ("s3", "bucket/key.rec")),
    ("HDFS://nn/x", ("hdfs", "nn/x")),
    ("file:///tmp/a.rec", ("file", "/tmp/a.rec")),
    ("/tmp/a.rec", ("", "/tmp/a.rec")),
    ("C://windows/path", ("", "C://windows/path")),
])
def test_split_uri(uri, want):
    assert filesystem.split_uri(uri) == want
    from mxnet_tpu import filesystem as jfs
    assert jfs.split_uri(uri) == want
    assert filesystem.is_remote(uri) == jfs.is_remote(uri)


def test_registered_scheme_streams_records(tmp_path):
    store = {}

    class Mem(io.BytesIO):
        def __init__(self, key, mode):
            super().__init__(store.get(key, b"") if "r" in mode else b"")
            self.key, self.mode = key, mode

        def close(self):
            if "w" in self.mode:
                store[self.key] = self.getvalue()
            super().close()

    def opener(path, mode):
        if "b" not in mode:  # the index file is text
            return io.TextIOWrapper(Mem(path, mode + "b"), newline="")
        return Mem(path, mode)

    assert filesystem.register_scheme("mem", opener) is None
    try:
        payloads = _payloads(5, seed=4)
        w = trec.MXIndexedRecordIO("mem://d.idx", "mem://d.rec", "w")
        for i, p in enumerate(payloads):
            w.write_idx(i, p)
        w.close()
        _write(jrec, str(tmp_path / "j"), payloads, True)
        assert store["d.rec"] == (tmp_path / "j.rec").read_bytes()
        assert store["d.idx"] == (tmp_path / "j.idx").read_bytes()
        r = trec.MXIndexedRecordIO("mem://d.idx", "mem://d.rec", "r")
        assert [r.read_idx(k) for k in (3, 1)] == [payloads[3], payloads[1]]
        r.close()
    finally:
        filesystem.unregister_scheme("mem")
    with pytest.raises(mx.MXNetError, match="register_scheme"):
        filesystem.open_uri("mem://d.rec")

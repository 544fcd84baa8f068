"""The port's image iterators against the JAX package, on the CPU:
``ImageIter`` (``.rec``, ``.lst`` and in-memory lists) and
``ImageRecordIter`` with shuffle, seed and ``num_parts`` over two epochs,
``preprocess_threads`` 1 and 4 through ``EnginePipelineIter`` on each of
its tiers (the native decode chain, the same chain in Python, geometry
per image, the generic list), ``DevicePrefetchIter`` on the host, and
``NDArrayIter`` over an h5py dataset.  Every batch is compared bit for
bit: both packages decode and resize with cv2 here and draw their
augmentation from the same seeds."""
import os
import random

import cv2
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import recordio as jrec

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import io_native

PKGS = (jmx, mx)
MEAN = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939)
N_IMAGES = 22


def _images(n=N_IMAGES, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        h, w = rng.randint(26, 40), rng.randint(26, 48)
        img = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        out.append(cv2.GaussianBlur(img, (5, 5), 1.0))
    return out


@pytest.fixture(scope="module")
def rec(tmp_path_factory):
    """An indexed .rec of small JPEGs (labels 0-4) and a bare copy."""
    d = tmp_path_factory.mktemp("rec")
    w = jrec.MXIndexedRecordIO(str(d / "a.idx"), str(d / "a.rec"), "w")
    for i, img in enumerate(_images()):
        w.write_idx(i, jrec.pack_img(jrec.IRHeader(0, float(i % 5), i, 0),
                                     img, quality=90))
    w.close()
    (d / "bare.rec").write_bytes((d / "a.rec").read_bytes())
    return d


def _drain(it, epochs=2):
    out = []
    for _ in range(epochs):
        for b in it:
            out.append((b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad))
        it.reset()
    return out


def _same(a, b):
    assert len(a) == len(b) > 0
    for (da, la, pa), (db, lb, pb) in zip(a, b):
        assert pa == pb
        assert da.dtype == db.dtype and da.shape == db.shape
        np.testing.assert_array_equal(da, db)
        np.testing.assert_array_equal(la, lb)


def _record_iter(pkg, rec, **kw):
    args = dict(path_imgrec=str(rec / "a.rec"), path_imgidx=str(rec / "a.idx"),
                data_shape=(3, 24, 24), batch_size=4, shuffle=True,
                rand_crop=True, rand_mirror=True, resize=28, seed=7, **MEAN)
    args.update(kw)
    return pkg.io.ImageRecordIter(**args)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_parts=2, part_index=1),
    dict(shuffle=False, rand_crop=False, resize=0),
    dict(std_r=58.4, std_g=57.1, std_b=57.4, brightness=0.2, contrast=0.2,
         saturation=0.2, pca_noise=0.1),
], ids=["shuffle-crop-mirror", "num_parts", "center", "jitter"])
def test_image_record_iter_matches(rec, kw):
    a = _drain(_record_iter(jmx, rec, **kw))
    b = _drain(_record_iter(mx, rec, **kw))
    _same(a, b)
    assert b[0][0].shape == (4, 3, 24, 24)
    # a second epoch is reseeded from (seed, epoch): it differs from the first
    n = len(b) // 2
    if kw.get("shuffle", True):
        assert not all(np.array_equal(x[0], y[0])
                       for x, y in zip(b[:n], b[n:]))


def test_image_record_iter_bare_rec_builds_index(rec):
    for name, pkg in (("j", jmx), ("t", mx)):
        path = rec / ("bare_%s.rec" % name)
        path.write_bytes((rec / "a.rec").read_bytes())
        it = pkg.io.ImageRecordIter(path_imgrec=str(path),
                                    data_shape=(3, 24, 24), batch_size=5,
                                    shuffle=True, seed=3, rand_crop=True)
        assert os.path.exists(str(path) + ".autoidx")
        if name == "j":
            a = _drain(it)
        else:
            b = _drain(it)
    _same(a, b)
    assert (rec / "bare_j.rec.autoidx").read_text() == \
        (rec / "bare_t.rec.autoidx").read_text()


def test_mx_data_iter_creates_image_record_iter(rec):
    it = mx.io.MXDataIter("ImageRecordIter", path_imgrec=str(rec / "a.rec"),
                          data_shape=(3, 24, 24), batch_size=4)
    first = next(iter(it))
    assert first.data[0].shape == (4, 3, 24, 24)
    assert first.data[0].context == mx.cpu()
    assert mx.io.ImageRecordIter_v1(path_imgrec=str(rec / "a.rec"),
                                    data_shape=(3, 24, 24),
                                    batch_size=4).provide_data[0].shape \
        == (4, 3, 24, 24)


@pytest.mark.parametrize("tier", ["native", "python"])
def test_preprocess_threads_bit_for_bit(rec, monkeypatch, tier):
    """preprocess_threads 1 and 4 give the same batches (a per-record RNG),
    equal to the JAX package's, on the native chain and on its Python
    form."""
    if tier == "python":
        monkeypatch.setattr(io_native, "get_imgdec_lib", lambda: None)
        import mxnet_tpu.io_native as jnat
        monkeypatch.setattr(jnat, "get_imgdec_lib", lambda: None)
    else:
        assert io_native.get_imgdec_lib() is not None, \
            "OpenCV's headers are here: the native chain builds"
    runs = {}
    for pkg in PKGS:
        for threads in (1, 4):
            before = dict(io_native.OPENED)
            it = _record_iter(pkg, rec, preprocess_threads=threads)
            runs[(pkg.__name__, threads)] = _drain(it)
            if pkg is mx:
                assert type(it).__name__ == "EnginePipelineIter"
                assert io_native.OPENED["engine"] == before["engine"] + 1
                assert (io_native.OPENED["imgdec_calls"]
                        > before["imgdec_calls"]) == (tier == "native")
                it.close()
    _same(runs[("mxnet_tpu_torch", 1)], runs[("mxnet_tpu_torch", 4)])
    _same(runs[("mxnet_tpu", 4)], runs[("mxnet_tpu_torch", 4)])
    _same(runs[("mxnet_tpu", 1)], runs[("mxnet_tpu_torch", 1)])


@pytest.mark.parametrize("augs", ["geometry", "generic"])
def test_engine_pipeline_other_tiers(rec, augs):
    """A random-sized crop (geometry per image) and a jittered list (the
    generic tier, per-record seeded) through EnginePipelineIter: threads 1
    and 3 agree, and equal the JAX package's."""
    def make(pkg, threads):
        img = pkg.image
        if augs == "geometry":
            aug_list = [img.RandomSizedCropAug((24, 24), 0.3, (0.75, 1.33)),
                        img.HorizontalFlipAug(0.5), img.CastAug()]
        else:
            aug_list = img.CreateAugmenter((3, 24, 24), rand_crop=True,
                                           brightness=0.3, hue=0.1,
                                           pca_noise=0.1)
        base = img.ImageIter(4, (3, 24, 24), path_imgrec=str(rec / "a.rec"),
                             path_imgidx=str(rec / "a.idx"), aug_list=aug_list)
        return pkg.io.EnginePipelineIter(base, num_workers=threads, seed=5)

    runs = {(pkg.__name__, t): _drain(make(pkg, t))
            for pkg in PKGS for t in (1, 3)}
    _same(runs[("mxnet_tpu_torch", 1)], runs[("mxnet_tpu_torch", 3)])
    _same(runs[("mxnet_tpu", 3)], runs[("mxnet_tpu_torch", 3)])


def test_image_iter_rec_and_lists(rec, tmp_path):
    imgs = _images(9, seed=1)
    entries = []
    for i, img in enumerate(imgs):
        name = "img%d.png" % i
        cv2.imwrite(str(tmp_path / name), img)
        entries.append((float(i % 3), name))
    with open(tmp_path / "a.lst", "w") as f:
        for i, (label, name) in enumerate(entries):
            f.write("%d\t%f\t%s\n" % (i, label, name))
    cases = [
        dict(path_imgrec=str(rec / "a.rec"), path_imgidx=str(rec / "a.idx"),
             shuffle=True, rand_crop=True, rand_mirror=True, num_parts=2,
             part_index=0),
        dict(path_imgrec=str(rec / "a.rec"), rand_crop=True),
        dict(path_imglist=str(tmp_path / "a.lst"),
             path_root=str(tmp_path), shuffle=True, rand_mirror=True),
        dict(imglist=[[lab, name] for lab, name in entries],
             path_root=str(tmp_path), resize=30, rand_crop=True),
    ]
    for kw in cases:
        runs = []
        for pkg in PKGS:
            random.seed(11)  # ImageIter shuffles and crops with these
            np.random.seed(11)
            it = pkg.image.ImageIter(batch_size=4, data_shape=(3, 24, 24),
                                     **kw)
            runs.append(_drain(it))
        _same(*runs)


def test_device_prefetch_iter_on_the_host(rec):
    base = _drain(_record_iter(mx, rec))
    it = mx.io.DevicePrefetchIter(_record_iter(mx, rec), ctx=mx.cpu())
    assert it.provide_data[0].shape == (4, 3, 24, 24)
    got = _drain(it)
    _same(base, got)
    direct = _record_iter(mx, rec, ctx=mx.cpu())
    assert type(direct).__name__ == "DevicePrefetchIter"
    _same(base, _drain(direct))
    first = next(iter(_record_iter(mx, rec, ctx=mx.cpu(),
                                   preprocess_threads=2)))
    assert first.data[0].context == mx.cpu()


def test_ndarray_iter_over_h5py(tmp_path):
    h5py = pytest.importorskip("h5py")
    rng = np.random.RandomState(0)
    x = rng.rand(23, 3, 4).astype(np.float32)
    y = rng.randint(0, 5, 23).astype(np.float32)
    with h5py.File(str(tmp_path / "d.h5"), "w") as f:
        f["x"] = x
        f["y"] = y
    runs = []
    with h5py.File(str(tmp_path / "d.h5"), "r") as f:
        for pkg in PKGS:
            for handle in ("pad", "discard", "roll_over"):
                it = pkg.io.NDArrayIter(f["x"], f["y"], batch_size=5,
                                        last_batch_handle=handle)
                assert it.provide_data[0].shape == (5, 3, 4)
                runs.append(_drain(it))
            with pytest.raises(pkg.MXNetError, match="h5py"):
                pkg.io.NDArrayIter(f["x"], f["y"], batch_size=5,
                                   shuffle=True)
    for a, b in zip(runs[:3], runs[3:]):
        _same(a, b)
    np.testing.assert_array_equal(
        np.concatenate([d for d, _, _ in runs[3][:4]]), x[:20])

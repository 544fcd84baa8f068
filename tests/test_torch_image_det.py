"""The port's detection data (``mx.image.det``: the box helpers, the
detection augmenters, ``CreateDetAugmenter`` and ``ImageDetIter``)
against the JAX package's, on the CPU.

Both packages decode and resize with cv2 here and the augmenters draw
through each image module's per-thread RNG (``seed_augmenter_rng``) or,
for ``ImageIter``'s shuffle, Python's ``random``: seeded alike, the two
packages give the same boxes and pixels bit for bit.
"""
import os
import random

import cv2
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.image import detection as jdet
from mxnet_tpu.image import image as jimage

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.image import detection as det
from mxnet_tpu_torch.image import image as timage

SIDES = ((jdet, jimage, jmx), (det, timage, mx))
N_IMG = 12


def _det_label(objects, extra_header=()):
    """im2rec's detection layout: [header_width, object_width, ...header...,
    objects...]."""
    objects = np.asarray(objects, np.float32)
    header = [2 + len(extra_header), objects.shape[1], *extra_header]
    return np.concatenate([np.asarray(header, np.float32), objects.ravel()])


@pytest.fixture(scope="module")
def det_rec(tmp_path_factory):
    """N_IMG JPEG records of 50-80 x 60-100 pixels with 1-4 boxes each (a
    bright block per box) and one extra header field, written by the JAX
    package's recordio."""
    root = tmp_path_factory.mktemp("det")
    rec, idx = str(root / "det.rec"), str(root / "det.idx")
    writer = jmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    rng = np.random.RandomState(0)
    for i in range(N_IMG):
        h, w = rng.randint(50, 81), rng.randint(60, 101)
        img = cv2.GaussianBlur(rng.randint(0, 80, (h, w, 3)).astype(np.uint8),
                               (5, 5), 1.0)
        boxes = []
        for _ in range(rng.randint(1, 5)):
            x1, y1 = rng.uniform(0, 0.6, 2)
            x2, y2 = x1 + rng.uniform(0.15, 0.4), y1 + rng.uniform(0.15, 0.4)
            img[int(y1 * h):int(y2 * h), int(x1 * w):int(x2 * w)] = 200
            boxes.append([float(rng.randint(0, 20)), x1, y1, min(x2, 1.0),
                          min(y2, 1.0), 0.0])
        ok, buf = cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_QUALITY, 92])
        assert ok
        writer.write_idx(i, jmx.recordio.pack(jmx.recordio.IRHeader(
            0, _det_label(boxes, extra_header=(float(i),)), i, 0),
            buf.tobytes()))
    writer.close()
    return rec, idx


def _seeded(image_mod, seed):
    random.seed(seed)
    np.random.seed(seed)
    image_mod.seed_augmenter_rng(seed)


def test_parse_label_layout():
    flat = _det_label([[0, .1, .2, .5, .6], [1, .3, .3, .9, .8]],
                      extra_header=(7.0, 8.0))
    for d, _, _ in SIDES:
        parsed = d.ImageDetIter._parse_label(flat)
        assert parsed.shape == (2, 5) and parsed[1, 0] == 1.0
    degenerate = _det_label([[0, .5, .2, .1, .6], [1, .3, .3, .9, .8]])
    np.testing.assert_array_equal(det.ImageDetIter._parse_label(degenerate),
                                  jdet.ImageDetIter._parse_label(degenerate))
    assert det.ImageDetIter._parse_label(degenerate).shape == (1, 5)
    for bad, match in ((_det_label([[0, .5, .2, .1, .6]]), "no valid"),
                       (np.zeros(5, np.float32), "invalid"),
                       (np.array([2, 5, 0, .1, .1, .5, .5, 1], np.float32),
                        "inconsistent")):
        with pytest.raises(RuntimeError, match=match):
            det.ImageDetIter._parse_label(bad)
    nd_flat = mx.nd.array(flat, ctx=mx.cpu())
    np.testing.assert_array_equal(det.ImageDetIter._parse_label(nd_flat),
                                  jdet.ImageDetIter._parse_label(flat))


def test_flip_mirrors_image_and_boxes():
    rng = np.random.RandomState(1)
    img = rng.randint(0, 255, (16, 24, 3)).astype(np.uint8)
    label = np.array([[0, 0.1, 0.2, 0.5, 0.8], [3, 0.6, 0.0, 1.0, 0.4]],
                     np.float32)
    outs = []
    for d, image_mod, _ in SIDES:
        _seeded(image_mod, 0)
        try:
            aug = d.DetHorizontalFlipAug(p=1.0)
            out, lab = aug(img, label)
            twice, lab2 = aug(out, lab)
        finally:
            image_mod.seed_augmenter_rng(None)
        np.testing.assert_array_equal(out, img[:, ::-1])
        np.testing.assert_array_equal(twice, img)
        np.testing.assert_allclose(lab2, label, atol=1e-6)
        outs.append(lab)
    np.testing.assert_allclose(outs[1][0, 1:5], [0.5, 0.2, 0.9, 0.8],
                               atol=1e-6)
    np.testing.assert_array_equal(outs[0], outs[1])
    # an NDArray keeps its context; p=0 leaves both untouched
    nd_out, _ = det.DetHorizontalFlipAug(1.0)(
        mx.nd.array(img, ctx=mx.cpu(), dtype="uint8"), label)
    assert nd_out.context == mx.cpu()
    np.testing.assert_array_equal(nd_out.asnumpy(), img[:, ::-1])
    same, same_lab = det.DetHorizontalFlipAug(0.0)(img, label)
    assert same is img and same_lab is label


@pytest.mark.parametrize("seed", [3, 8])
def test_crop_boxes_are_the_jax_packages(seed):
    # each pixel holds its own row and column: a crop names its window
    img = np.zeros((64, 80, 3), np.uint8)
    img[..., 0] = np.arange(64)[:, None]
    img[..., 1] = np.arange(80)[None, :]
    label = np.array([[1, 0.25, 0.25, 0.75, 0.75], [2, 0.0, 0.5, 0.3, 1.0]],
                     np.float32)
    runs = []
    for d, image_mod, _ in SIDES:
        _seeded(image_mod, seed)
        try:
            aug = d.DetRandomCropAug(min_object_covered=0.5,
                                     area_range=(0.3, 1.0), max_attempts=50)
            runs.append([aug(img, label) for _ in range(20)])
        finally:
            image_mod.seed_augmenter_rng(None)
    cropped = 0
    for (ja, jl), (ta, tl) in zip(*runs):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tl, jl)
        assert (tl[:, 1:5] >= 0).all() and (tl[:, 1:5] <= 1).all()
        assert (tl[:, 3] > tl[:, 1]).all() and (tl[:, 4] > tl[:, 2]).all()
        if ta.shape != img.shape:
            cropped += 1
            y, x = int(ta[0, 0, 0]), int(ta[0, 0, 1])
            h, w = ta.shape[:2]
            np.testing.assert_array_equal(ta, img[y:y + h, x:x + w])
            # a surviving box is the old one in the window's coordinates
            for row in tl:
                old = label[label[:, 0] == row[0]][0]
                want = np.clip([(old[1] * 80 - x) / w, (old[2] * 64 - y) / h,
                                (old[3] * 80 - x) / w, (old[4] * 64 - y) / h],
                               0, 1)
                np.testing.assert_allclose(row[1:5], want, atol=1e-5)
    assert cropped > 0


def test_pad_boxes_are_the_jax_packages():
    img = np.full((32, 40, 3), 7, np.uint8)
    label = np.array([[0, 0.0, 0.0, 1.0, 1.0]], np.float32)
    runs = []
    for d, image_mod, _ in SIDES:
        _seeded(image_mod, 4)
        try:
            aug = d.DetRandomPadAug(area_range=(1.5, 3.0))
            runs.append([aug(img, label) for _ in range(10)])
        finally:
            image_mod.seed_augmenter_rng(None)
    for (ja, jl), (ta, tl) in zip(*runs):
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(tl, jl)
        assert ta.shape[0] > 32 and ta.shape[1] > 40
        x1 = int(round(tl[0, 1] * ta.shape[1]))
        y1 = int(round(tl[0, 2] * ta.shape[0]))
        x2 = int(round(tl[0, 3] * ta.shape[1]))
        y2 = int(round(tl[0, 4] * ta.shape[0]))
        assert (ta[y1:y2, x1:x2] == 7).all()
        assert (x2 - x1, y2 - y1) == (40, 32)
        assert (ta == 128).sum() == ta.size - img.size
    nd_out, _ = det.DetRandomPadAug(area_range=(1.5, 3.0))(
        mx.nd.array(img, ctx=mx.cpu(), dtype="uint8"), label)
    assert nd_out.context == mx.cpu() and nd_out.shape[0] > 32


def test_create_det_augmenter_chain_is_the_jax_packages():
    kw = dict(rand_crop=0.5, rand_pad=0.5, rand_mirror=True, mean=True,
              std=True, brightness=0.2, contrast=0.2, saturation=0.2,
              hue=0.1, pca_noise=0.05, rand_gray=0.2)
    chains = [d.CreateDetAugmenter((3, 48, 48), **kw) for d, _, _ in SIDES]
    assert [type(a).__name__ for a in chains[0]] == \
        [type(a).__name__ for a in chains[1]]
    assert [str(a.dumps()) for a in chains[0]] == \
        [str(a.dumps()) for a in chains[1]]
    rng = np.random.RandomState(2)
    img = rng.randint(0, 256, (60, 90, 3)).astype(np.uint8)
    label = np.array([[1, 0.1, 0.1, 0.6, 0.7], [4, 0.4, 0.3, 0.9, 0.95]],
                     np.float32)
    outs = []
    for chain, (_, image_mod, _) in zip(chains, SIDES):
        _seeded(image_mod, 6)
        try:
            got = []
            for _ in range(12):
                data, lab = img, label
                for aug in chain:
                    data, lab = aug(data, lab)
                got.append((data, lab))
        finally:
            image_mod.seed_augmenter_rng(None)
        outs.append(got)
    for (jd, jl), (td, tl) in zip(*outs):
        assert td.shape == (48, 48, 3) and td.dtype == jd.dtype
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)


def _iter_batches(side, rec, idx, seed, **kw):
    d, image_mod, _ = side
    _seeded(image_mod, seed)
    try:
        it = d.ImageDetIter(batch_size=5, data_shape=(3, 64, 64),
                            path_imgrec=rec, path_imgidx=idx, **kw)
        batches = [(b.data[0].asnumpy(), b.label[0].asnumpy(), b.pad)
                   for b in it]
        return it, batches
    finally:
        image_mod.seed_augmenter_rng(None)


@pytest.mark.parametrize("kw", [
    {},
    {"shuffle": True, "rand_crop": 0.5, "rand_pad": 0.5, "rand_mirror": True,
     "mean": True, "std": True},
    {"shuffle": True, "resize": 72, "rand_crop": 1, "min_object_covered":
     [0.1, 0.5], "area_range": (0.3, 1.0), "rand_mirror": True}],
    ids=["plain", "ssd-train", "multi-crop"])
def test_det_iter_batches_are_the_jax_packages(det_rec, kw):
    rec, idx = det_rec
    (jit, want), (tit, got) = (_iter_batches(side, rec, idx, 9, **kw)
                               for side in SIDES)
    # up to 4 boxes of 6 columns (class, corners, one extra)
    assert tit.label_shape == jit.label_shape == (4, 6)
    assert tit.provide_label[0].shape == (5, 4, 6)
    assert tit.provide_label[0].name == "label"
    assert len(got) == len(want) == 3 and got[-1][2] == 3
    for (jd, jl, jp), (td, tl, tp) in zip(want, got):
        assert td.shape == (5, 3, 64, 64) and tl.shape == (5, 4, 6)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
        assert tp == jp
        live = tl[tl[..., 0] >= 0]
        assert (live[:, 1:5] >= 0).all() and (live[:, 1:5] <= 1).all()
        assert (live[:, 3] > live[:, 1]).all()
        assert (live[:, 4] > live[:, 2]).all()
        pad_rows = tl[tl[..., 0] < 0]
        assert (pad_rows == -1).all()


def test_det_iter_batches_are_host_ndarrays(det_rec):
    rec, idx = det_rec
    it = det.ImageDetIter(batch_size=4, data_shape=(3, 32, 32),
                          path_imgrec=rec, path_imgidx=idx)
    batch = next(iter(it))
    assert batch.data[0].context == mx.cpu()
    assert batch.label[0].context == mx.cpu()
    it.reset()
    assert sum(b.data[0].shape[0] - b.pad for b in it) == N_IMG


def test_sync_label_shape(det_rec):
    rec, idx = det_rec
    for d, _, _ in SIDES:
        a = d.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                           path_imgrec=rec, path_imgidx=idx)
        b = d.ImageDetIter(batch_size=2, data_shape=(3, 32, 32),
                           path_imgrec=rec, path_imgidx=idx)
        b.reshape(label_shape=(6, 6))
        assert a.sync_label_shape(b) is b
        assert a.label_shape == b.label_shape == (6, 6)
        assert a.provide_label[0].shape == (2, 6, 6)
        with pytest.raises(ValueError, match="reduce"):
            a.reshape(label_shape=(2, 6))
        with pytest.raises(ValueError, match="width"):
            a.reshape(label_shape=(6, 5))
        with pytest.raises(ValueError, match="length 2"):
            a.reshape(label_shape=(6,))
        a.reshape(data_shape=(3, 40, 40))
        assert a.provide_data[0].shape == (2, 3, 40, 40)


def test_det_iter_skips_records_whose_boxes_all_vanish(tmp_path):
    """A record whose augmented label has no valid box is skipped, in both
    packages alike (the reference's logged skip)."""
    rec, idx = str(tmp_path / "s.rec"), str(tmp_path / "s.idx")
    writer = jmx.recordio.MXIndexedRecordIO(idx, rec, "w")
    img = np.full((40, 40, 3), 90, np.uint8)
    ok, buf = cv2.imencode(".png", img)
    for i, cls in enumerate((0.0, -1.0, 2.0)):  # class -1 is invalid
        writer.write_idx(i, jmx.recordio.pack(jmx.recordio.IRHeader(
            0, _det_label([[cls, 0.1, 0.1, 0.5, 0.5]]), i, 0),
            buf.tobytes()))
    writer.close()
    for d, _, _ in SIDES:
        it = d.ImageDetIter(batch_size=3, data_shape=(3, 20, 20),
                            path_imgrec=rec, path_imgidx=idx)
        batch = next(iter(it))
        lab = batch.label[0].asnumpy()
        assert batch.pad == 1
        assert lab[:2, 0, 0].tolist() == [0.0, 2.0]
    assert os.path.exists(rec)

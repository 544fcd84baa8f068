"""The port's ``mx.image`` (decode, resize, crops, every augmenter,
``CreateAugmenter``) and ``image.codec`` against the JAX package and cv2,
on the CPU.

Both packages decode and resize with cv2 here, and the augmenters draw
through the same global (or per-thread) generators, so the same seeds
give the same pixels: numpy inputs are compared bit for bit, NDArray
inputs (computed by the JAX package in f32 on its device) within 1e-5.
Without cv2 (the tests hide it) the codec decodes and encodes with PIL
and a resize raises naming cv2; without any codec decode and encode raise
naming cv2 and PIL."""
import random
import threading

import cv2
import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import image as jimg

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import image as timg
from mxnet_tpu_torch.image import codec

PAIRS = ((jimg, jmx), (timg, mx))


def _smooth(h, w, seed=0, c=3):
    rng = np.random.RandomState(seed)
    img = rng.randint(0, 256, (h, w, c)).astype(np.uint8)
    return cv2.GaussianBlur(img, (5, 5), 1.5).reshape(h, w, c)


def _jpeg(h=37, w=53, seed=0):
    ok, buf = cv2.imencode(".jpg", _smooth(h, w, seed),
                           [cv2.IMWRITE_JPEG_QUALITY, 90])
    assert ok
    return buf.tobytes()


def _both(fn, seed=3):
    """fn(image module) in each package after the same seeding."""
    out = []
    for mod, _ in PAIRS:
        random.seed(seed)
        np.random.seed(seed)
        out.append(fn(mod))
    return out


def _np(x):
    return x.asnumpy() if hasattr(x, "asnumpy") else np.asarray(x)


@pytest.mark.parametrize("flag", [1, 0])
@pytest.mark.parametrize("to_rgb", [True, False])
def test_imdecode_and_imread(tmp_path, flag, to_rgb):
    buf = _jpeg()
    a, b = (_np(m.imdecode(buf, flag=flag, to_rgb=to_rgb)) for m, _ in PAIRS)
    np.testing.assert_array_equal(a, b)
    assert b.dtype == np.uint8 and b.shape[2] == (3 if flag else 1)
    path = tmp_path / "x.jpg"
    path.write_bytes(buf)
    np.testing.assert_array_equal(_np(timg.imread(str(path), flag=flag,
                                                  to_rgb=to_rgb)), a)
    assert timg.imdecode(buf).context == mx.cpu()


def test_imdecode_of_bad_data_raises():
    with pytest.raises(mx.MXNetError, match="cv2.*PIL"):
        timg.imdecode(b"\x00\x01garbage")


@pytest.mark.parametrize("interp", [0, 1, 2, 3])
@pytest.mark.parametrize("size", [(20, 15), (80, 64)])
def test_imresize_numpy_and_ndarray(interp, size):
    img = _smooth(37, 53)
    a, b = (m.imresize(img, size[0], size[1], interp) for m, _ in PAIRS)
    assert isinstance(b, np.ndarray)
    np.testing.assert_array_equal(a, b)
    nd = timg.imresize(mx.nd.array(img, ctx=mx.cpu()), size[0], size[1],
                       interp)
    assert nd.context == mx.cpu() and nd.dtype == np.uint8
    np.testing.assert_array_equal(nd.asnumpy(), b)


def test_geometry_helpers():
    img = _smooth(40, 60)
    for args in (((60, 40), (80, 30)), ((20, 40), (30, 30)),
                 ((64, 48), (32, 32))):
        assert jimg.scale_down(*args) == timg.scale_down(*args)
    a, b = (m.resize_short(img, 24) for m, _ in PAIRS)
    np.testing.assert_array_equal(a, b)
    assert b.shape == (24, 36, 3)
    a, b = (m.fixed_crop(img, 3, 5, 20, 10, size=(16, 16)) for m, _ in PAIRS)
    np.testing.assert_array_equal(a, b)
    for fn in (lambda m: m.random_crop(img, (25, 20)),
               lambda m: m.center_crop(img, (25, 20)),
               lambda m: m.random_size_crop(img, (24, 24), 0.3, (0.75, 1.33)),
               lambda m: m.random_size_crop(img, (24, 24), 0.99, (3.0, 4.0))):
        (a, ra), (b, rb) = _both(fn)
        assert ra == rb
        np.testing.assert_array_equal(a, b)
    f = img.astype(np.float32)
    mean, std = np.array([1.0, 2.0, 3.0]), np.array([2.0, 4.0, 8.0])
    a, b = (m.color_normalize(f, mean, std) for m, _ in PAIRS)
    np.testing.assert_array_equal(a, b)


def _augmenters(mod):
    eigval = np.array([55.46, 4.794, 1.148])
    eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                       [-0.5808, -0.0045, -0.8140],
                       [-0.5836, -0.6948, 0.4203]])
    return {
        "resize": mod.ResizeAug(30),
        "force_resize": mod.ForceResizeAug((33, 21), 1),
        "random_crop": mod.RandomCropAug((24, 20)),
        "random_sized_crop": mod.RandomSizedCropAug((24, 24), 0.2,
                                                    (0.75, 1.33)),
        "center_crop": mod.CenterCropAug((24, 20), 0),
        "brightness": mod.BrightnessJitterAug(0.4),
        "contrast": mod.ContrastJitterAug(0.4),
        "saturation": mod.SaturationJitterAug(0.4),
        "hue": mod.HueJitterAug(0.3),
        "color_jitter": mod.ColorJitterAug(0.3, 0.3, 0.3),
        "lighting": mod.LightingAug(0.1, eigval, eigvec),
        "normalize": mod.ColorNormalizeAug(np.array([123.0, 117.0, 104.0]),
                                           np.array([58.0, 57.0, 57.5])),
        "gray": mod.RandomGrayAug(0.7),
        "flip": mod.HorizontalFlipAug(0.5),
        "cast": mod.CastAug(),
        "sequential": mod.SequentialAug([mod.ResizeAug(28),
                                         mod.HorizontalFlipAug(0.9),
                                         mod.CastAug()]),
        "random_order": mod.RandomOrderAug([mod.BrightnessJitterAug(0.2),
                                            mod.ContrastJitterAug(0.2),
                                            mod.SaturationJitterAug(0.2)]),
    }


AUG_NAMES = sorted(_augmenters(timg))


@pytest.mark.parametrize("name", AUG_NAMES)
def test_augmenter_numpy_bit_for_bit(name):
    img = _smooth(37, 53, seed=5)
    if name in ("brightness", "contrast", "saturation", "hue",
                "color_jitter", "lighting", "normalize", "gray",
                "random_order"):
        img = img.astype(np.float32)
    for seed in (1, 2, 3):
        a, b = _both(lambda m: _augmenters(m)[name](img), seed=seed)
        assert type(b) is np.ndarray
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)
    assert _augmenters(timg)[name].dumps() == _augmenters(jimg)[name].dumps()


@pytest.mark.parametrize("name", AUG_NAMES)
def test_augmenter_ndarray(name):
    img = _smooth(37, 53, seed=6).astype(np.float32)

    def run(m):
        pkg = jmx if m is jimg else mx
        x = pkg.nd.array(img, ctx=pkg.cpu())
        return _augmenters(m)[name](x)

    a, b = _both(run, seed=4)
    assert isinstance(b, mx.nd.NDArray) and b.context == mx.cpu()
    np.testing.assert_allclose(_np(b), _np(a), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kwargs", [
    dict(),
    dict(resize=40, rand_crop=True, rand_mirror=True, mean=True, std=True),
    dict(rand_crop=True, rand_resize=True, brightness=0.1, contrast=0.1,
         saturation=0.1, hue=0.1, pca_noise=0.1, rand_gray=0.2,
         mean=np.array([1.0, 2.0, 3.0]), std=np.array([4.0, 5.0, 6.0])),
])
def test_create_augmenter(kwargs):
    a, b = (m.CreateAugmenter((3, 24, 24), **kwargs) for m, _ in PAIRS)
    assert [x.dumps() for x in a] == [x.dumps() for x in b]
    img = _smooth(37, 53, seed=7)

    def chain(augs):
        x = img
        for aug in augs:
            x = aug(x)
        return x

    for seed in (0, 1):
        random.seed(seed)
        np.random.seed(seed)
        ra = chain(a)
        random.seed(seed)
        np.random.seed(seed)
        np.testing.assert_array_equal(chain(b), ra)


def test_per_thread_augmenter_rng():
    """seed_augmenter_rng installs a per-thread generator: draws in a thread
    depend on its seed alone, in both packages."""
    img = _smooth(37, 53, seed=8)
    results = {}

    def work(mod, key, seed):
        mod.image.seed_augmenter_rng(seed)
        augs = mod.CreateAugmenter((3, 24, 24), rand_crop=True,
                                   rand_resize=True, rand_mirror=True,
                                   pca_noise=0.1)
        x = img
        for aug in augs:
            x = aug(x)
        results[key] = x
        mod.image.seed_augmenter_rng(None)

    threads = [threading.Thread(target=work, args=(m, (i, s), s))
               for i, (m, _) in enumerate(PAIRS) for s in (11, 12, 13)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for s in (11, 12, 13):
        np.testing.assert_array_equal(results[(0, s)], results[(1, s)])
    assert not np.array_equal(results[(1, 11)], results[(1, 12)])


def _hide(monkeypatch, *names):
    if "cv2" in names:
        monkeypatch.setattr(codec, "_cv2", lambda: None)
    if "PIL" in names:
        monkeypatch.setattr(codec, "_pil", lambda: None)


def test_codec_choice_and_fallbacks(monkeypatch):
    assert codec.backend() == "cv2"
    assert codec.available()[:2] == ["cv2", "PIL"]
    img = _smooth(37, 53, seed=9)
    png = codec.encode(img, img_fmt=".png")
    jpg = codec.encode(img, quality=90)
    want_jpg = codec.decode(jpg)
    _hide(monkeypatch, "cv2")
    assert codec.backend() == "PIL"
    np.testing.assert_array_equal(codec.decode(png), img)
    np.testing.assert_array_equal(codec.decode(png, 0)[..., None].shape[:2],
                                  img.shape[:2])
    # PIL decodes with libjpeg too: within a level or two of cv2
    assert np.abs(codec.decode(jpg).astype(int) - want_jpg).max() <= 2
    np.testing.assert_array_equal(cv2.imdecode(np.frombuffer(
        codec.encode(img, img_fmt=".png"), np.uint8), 1), img)
    # without cv2 a resize raises, as the JAX package's does
    with pytest.raises(mx.MXNetError, match="cv2"):
        timg.imresize(img, 24, 30)
    with pytest.raises(mx.MXNetError, match="cv2"):
        codec.resize(img, 24, 30, 2)


def test_codec_without_any_codec(monkeypatch):
    _hide(monkeypatch, "cv2", "PIL")
    assert codec.available() == []
    with pytest.raises(mx.MXNetError, match="cv2.*PIL"):
        codec.backend()
    with pytest.raises(mx.MXNetError, match="cv2.*PIL"):
        codec.decode(_jpeg())
    with pytest.raises(mx.MXNetError, match="cv2.*PIL"):
        codec.encode(_smooth(8, 8))


def test_jpeg_fixtures_are_cv2_pixels():
    import os
    here = os.path.join(os.path.dirname(__file__), "data")
    for name in ("jpeg444", "jpeg420"):
        with open(os.path.join(here, name + ".jpg"), "rb") as f:
            buf = f.read()
        want = np.load(os.path.join(here, name + ".npy"))
        assert want.shape == (48, 64, 3)
        np.testing.assert_array_equal(codec.decode(buf), want)


def test_detection_waits_for_a2b():
    """The detection half arrived with the slice A2b: its names are the
    detection module's."""
    from mxnet_tpu_torch.image import detection
    assert timg.det is detection
    for name in ("ImageDetIter", "CreateDetAugmenter", "DetRandomCropAug"):
        assert getattr(timg, name) is getattr(detection, name)

"""Image loading, augmentation and iteration (ref: python/mxnet/image/image.py).

Counterpart of ``mxnet_tpu/image/image.py``.  Decode, encode and resize
go through ``image.codec`` (cv2, else PIL; resize in cv2), the augmenters
compute in numpy on the host, and a batch uploads to the card once, where
the executor copies it into its bound arrays.  The augmenter pipeline and ``ImageIter`` keep the
reference's API (python/mxnet/image/image.py:482-1160), and the
augmenters draw through ``_rand``/``_nprand`` exactly as the JAX
package's do, so the same seeds give the same batches.

The image arrays of this module live on the host (``cpu()``), as the
reference's ``mx.image`` works on CPU NDArrays and as the port's
iterators serve host batches: ``imdecode`` returns a host NDArray, an
NDArray augmenter's result stays on its input's context, and
``ImageIter`` serves host batches.

Design choices local to this module:
  * ``Augmenter.__init__`` both records kwargs for ``dumps()`` and
    installs them as attributes, so the dozen concrete augmenters are
    two-liners;
  * every builtin augmenter is type-preserving (numpy in -> numpy out),
    letting ImageIter run the whole per-image chain in numpy.
"""
from __future__ import annotations

import json
import os
import random
import threading

import numpy as np

from ..base import MXNetError
from ..context import cpu
from ..ndarray import NDArray, array as _array
from .. import recordio
from ..io import DataIter, DataBatch, DataDesc
from . import codec

__all__ = ["imdecode", "imread", "imresize", "scale_down", "resize_short",
           "fixed_crop", "random_crop", "center_crop", "color_normalize",
           "random_size_crop", "Augmenter", "SequentialAug", "RandomOrderAug",
           "ResizeAug", "ForceResizeAug", "RandomCropAug", "RandomSizedCropAug",
           "CenterCropAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "ColorNormalizeAug", "RandomGrayAug",
           "HorizontalFlipAug", "CastAug", "CreateAugmenter", "ImageIter"]

# NTSC/YIQ luma weights + transform pair, shared by the color jitters
_LUMA = np.array([[[0.299, 0.587, 0.114]]], np.float32)
_TO_YIQ = np.array([[0.299, 0.587, 0.114],
                    [0.596, -0.274, -0.321],
                    [0.211, -0.523, 0.311]], np.float32)
_FROM_YIQ = np.array([[1.0, 0.956, 0.621],
                      [1.0, -0.272, -0.647],
                      [1.0, -1.107, 1.705]], np.float32)


def nd_array(arr, dtype=None, ctx=None):
    """An NDArray of ``arr``, on the host unless ``ctx`` says otherwise."""
    return _array(arr, ctx=ctx or cpu(), dtype=dtype)


# -- augmenter RNG ----------------------------------------------------------
# Augmentation draws go through these accessors so a parallel decode worker
# can install a PER-RECORD deterministic RNG on its own thread
# (io.EnginePipelineIter seeds one per sample index): decode order across
# threads then cannot change the augmentation a given record receives.
# Without an installed RNG the process-global generators are used, matching
# the reference's single-threaded python path.
_aug_tls = threading.local()


def _rand():
    return getattr(_aug_tls, "rng", None) or random


def _nprand():
    return getattr(_aug_tls, "nprng", None) or np.random


def seed_augmenter_rng(seed):
    """Install (seed is not None) or clear (None) this thread's augmenter
    RNG.  Used by parallel decode pipelines for per-record determinism."""
    if seed is None:
        _aug_tls.rng = None
        _aug_tls.nprng = None
    else:
        _aug_tls.rng = random.Random(seed)
        _aug_tls.nprng = np.random.RandomState(seed & 0x7FFFFFFF)


def _augs_all_builtin(augs):
    """True when every augmenter (including those nested in Sequential/
    RandomOrder) is from this module — i.e. type-preserving, safe for the
    all-numpy fast path.  User-supplied augmenters keep the historical
    NDArray input contract."""
    for a in augs:
        if a.__class__.__module__ != __name__:
            return False
        if isinstance(a, (SequentialAug, RandomOrderAug)) \
                and not _augs_all_builtin(a.ts):
            return False
    return True


def _as_numpy(img):
    """(array, was_ndarray) — augmenter bodies compute in numpy."""
    if isinstance(img, NDArray):
        return img.asnumpy(), True
    return img, False


def _like(arr, was_nd, ctx=None):
    return nd_array(arr, ctx=ctx) if was_nd else arr


def _imdecode_np(buf, flag=1, to_rgb=True):
    """Decode to a HWC uint8 numpy array (the host path)."""
    if isinstance(buf, NDArray):
        buf = buf.asnumpy().astype(np.uint8)
    img = codec.decode(buf, flag)
    if to_rgb and img.ndim == 3:
        # cv2's COLOR_BGR2RGB: the three colour channels reversed, any
        # alpha dropped
        img = np.ascontiguousarray(img[:, :, 2::-1])
    if img.ndim == 2:
        img = img[:, :, None]
    return img


def imdecode(buf, flag=1, to_rgb=True, out=None):
    """Decode an image byte buffer to an NDArray, HWC uint8
    (ref: image.py:imdecode — RGB order by default, unlike raw cv2)."""
    return nd_array(_imdecode_np(buf, flag, to_rgb), dtype=np.uint8)


def imread(filename, flag=1, to_rgb=True):
    with open(filename, "rb") as f:
        return imdecode(f.read(), flag=flag, to_rgb=to_rgb)


def imresize(src, w, h, interp=2):
    """Type-preserving resize: numpy in -> numpy out (the host decode path
    runs the whole augmentation chain in numpy), NDArray in -> NDArray out
    on its context (public API)."""
    img, was_nd = _as_numpy(src)
    out = codec.resize(img, w, h, interp)
    if out.ndim == 2:
        out = out[:, :, None]
    return nd_array(out, dtype=img.dtype, ctx=src.context) if was_nd \
        else out


def scale_down(src_size, size):
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    h, w = src.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(src, new_w, new_h, interp=interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    out = src[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        out = imresize(out, size[0], size[1], interp=interp)
    return out


def _cropper(src, size, interp, centered):
    """Shared random/center crop: pick the origin, cut, resize."""
    h, w = src.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    if centered:
        x0, y0 = (w - new_w) // 2, (h - new_h) // 2
    else:
        x0 = _rand().randint(0, w - new_w)
        y0 = _rand().randint(0, h - new_h)
    out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_crop(src, size, interp=2):
    return _cropper(src, size, interp, centered=False)


def center_crop(src, size, interp=2):
    return _cropper(src, size, interp, centered=True)


def color_normalize(src, mean, std=None):
    if mean is not None:
        src = src - mean
    if std is not None:
        src = src / std
    return src


def random_size_crop(src, size, min_area, ratio, interp=2):
    h, w = src.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = _rand().uniform(min_area, 1.0) * area
        new_ratio = _rand().uniform(*ratio)
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if _rand().random() < 0.5:
            new_h, new_w = new_w, new_h
        if new_w <= w and new_h <= h:
            x0 = _rand().randint(0, w - new_w)
            y0 = _rand().randint(0, h - new_h)
            out = fixed_crop(src, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(src, size, interp)


class Augmenter:
    """Image augmenter base (ref: image.py:482).

    kwargs are installed as attributes AND recorded (JSON-safe) for
    `dumps()`, so concrete augmenters don't repeat the bookkeeping.
    """

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, k, v)
        self._kwargs = {
            k: (v.asnumpy() if isinstance(v, NDArray) else v).tolist()
            if isinstance(v, (NDArray, np.ndarray)) else v
            for k, v in kwargs.items()}

    def dumps(self):
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        for aug in self.ts:
            src = aug(src)
        return src


class RandomOrderAug(SequentialAug):
    def __call__(self, src):
        ts = list(self.ts)
        _rand().shuffle(ts)
        for t in ts:
            src = t(src)
        return src


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)

    def __call__(self, src):
        return resize_short(src, self.size, self.interp)


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)

    def __call__(self, src):
        return imresize(src, self.size[0], self.size[1], self.interp)


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)

    def __call__(self, src):
        return random_crop(src, self.size, self.interp)[0]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)

    def __call__(self, src):
        return random_size_crop(src, self.size, self.min_area, self.ratio,
                                self.interp)[0]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)

    def __call__(self, src):
        return center_crop(src, self.size, self.interp)[0]


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)

    def __call__(self, src):
        alpha = 1.0 + _rand().uniform(-self.brightness, self.brightness)
        return src * alpha


class ContrastJitterAug(Augmenter):
    def __init__(self, contrast):
        super().__init__(contrast=contrast)

    def __call__(self, src):
        alpha = 1.0 + _rand().uniform(-self.contrast, self.contrast)
        arr, _ = _as_numpy(src)
        gray = (arr * _LUMA).sum()
        gray = (3.0 * (1.0 - alpha) / arr.size) * gray
        return src * alpha + gray


class SaturationJitterAug(Augmenter):
    def __init__(self, saturation):
        super().__init__(saturation=saturation)

    def __call__(self, src):
        alpha = 1.0 + _rand().uniform(-self.saturation, self.saturation)
        arr, was_nd = _as_numpy(src)
        gray = (arr * _LUMA).sum(axis=2, keepdims=True) * (1.0 - alpha)
        return src * alpha + _like(gray, was_nd,
                                   src.context if was_nd else None)


class HueJitterAug(Augmenter):
    def __init__(self, hue):
        super().__init__(hue=hue)

    def __call__(self, src):
        alpha = _rand().uniform(-self.hue, self.hue)
        u, w = np.cos(alpha * np.pi), np.sin(alpha * np.pi)
        rot = np.array([[1.0, 0.0, 0.0], [0.0, u, -w], [0.0, w, u]],
                       np.float32)
        t = (_FROM_YIQ @ rot @ _TO_YIQ).T
        arr, was_nd = _as_numpy(src)
        return _like(np.dot(arr, t), was_nd, src.context if was_nd else None)


class ColorJitterAug(RandomOrderAug):
    def __init__(self, brightness, contrast, saturation):
        jitters = [cls(amount) for cls, amount in
                   ((BrightnessJitterAug, brightness),
                    (ContrastJitterAug, contrast),
                    (SaturationJitterAug, saturation)) if amount > 0]
        super().__init__(jitters)


class LightingAug(Augmenter):
    """PCA-based lighting jitter (AlexNet-style)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.eigval = eigval
        self.eigvec = eigvec

    def __call__(self, src):
        alpha = _nprand().normal(0, self.alphastd, size=(3,))
        rgb = np.dot(self.eigvec * alpha, self.eigval).astype(np.float32)
        return src + (nd_array(rgb, ctx=src.context)
                      if isinstance(src, NDArray) else rgb)


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        # keep numpy copies: the host decode path is all-numpy, the
        # NDArray path a copy on the image's context made at its first call
        # (cached: this runs once per image in the pipeline's loop)
        self.mean = mean.asnumpy() if isinstance(mean, NDArray) else mean
        self.std = std.asnumpy() if isinstance(std, NDArray) else std
        self._nd_mean = None
        self._nd_std = None

    def __call__(self, src):
        if isinstance(src, NDArray):
            if self._nd_mean is None and self.mean is not None:
                self._nd_mean = nd_array(self.mean, ctx=src.context)
            if self._nd_std is None and self.std is not None:
                self._nd_std = nd_array(self.std, ctx=src.context)
            return color_normalize(src, self._nd_mean, self._nd_std)
        return color_normalize(src.astype(np.float32, copy=False),
                               self.mean, self.std)


class RandomGrayAug(Augmenter):
    _gray = np.tile(np.array([[0.21], [0.72], [0.07]], np.float32), 3)

    def __init__(self, p):
        super().__init__(p=p)

    def __call__(self, src):
        if _rand().random() >= self.p:
            return src
        arr, was_nd = _as_numpy(src)
        return _like(np.dot(arr, self._gray), was_nd,
                     src.context if was_nd else None)


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)

    def __call__(self, src):
        if _rand().random() >= self.p:
            return src
        arr, was_nd = _as_numpy(src)
        out = np.ascontiguousarray(arr[:, ::-1])
        return _like(out, was_nd, src.context if was_nd else None)


class CastAug(Augmenter):
    def __init__(self, typ="float32"):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return src.astype(self.typ)


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, hue=0, pca_noise=0,
                    rand_gray=0, inter_method=2):
    """Build the standard augmenter list (ref: image.py:CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0,
                                                            4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if hue:
        auglist.append(HueJitterAug(hue))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if rand_gray > 0:
        auglist.append(RandomGrayAug(rand_gray))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None and std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


def _parse_imglist_file(path):
    """.lst file -> (key -> (label, relpath), ordered keys).  Format per
    line: index<TAB>label...<TAB>path."""
    table, order = {}, []
    with open(path) as fin:
        for line in fin:
            fields = line.strip().split("\t")
            if not fields or not fields[0]:
                continue
            key = int(fields[0])
            table[key] = (np.array(fields[1:-1], np.float32), fields[-1])
            order.append(key)
    return table, order


def _wrap_imglist(entries):
    """In-memory [(label, path), ...] -> same mapping shape, 1-based
    string keys (reference quirk kept for compatibility)."""
    table, order = {}, []
    for n, record in enumerate(entries, 1):
        label, path = record[0], record[1]  # extra fields are ignored
        if not isinstance(label, (list, np.ndarray)):
            label = [label]
        table[str(n)] = (np.array(label, np.float32), path)
        order.append(str(n))
    return table, order


class ImageIter(DataIter):
    """Image iterator over .rec files or .lst/image-folder lists with
    augmentation (ref: image.py:999)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root=None,
                 path_imgidx=None, shuffle=False, part_index=0, num_parts=1,
                 aug_list=None, imglist=None, data_name="data",
                 label_name="softmax_label", **kwargs):
        super().__init__()
        assert path_imgrec or path_imglist or (isinstance(imglist, list))
        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            if path_imgidx:
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, "r")
                self.imgidx = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, "r")
                self.imgidx = None
            self.seq = self.imgidx
        if path_imglist:
            self.imglist, self.seq = _parse_imglist_file(path_imglist)
        elif isinstance(imglist, list):
            self.imglist, self.seq = _wrap_imglist(imglist)

        self.path_root = path_root
        self.check_data_shape(data_shape)
        self.provide_data = [DataDesc(data_name, (batch_size,) + data_shape)]
        label_shape = (batch_size, label_width) if label_width > 1 \
            else (batch_size,)
        self.provide_label = [DataDesc(label_name, label_shape)]
        self.batch_size = batch_size
        self.data_shape = data_shape
        self.label_width = label_width
        self.shuffle = shuffle
        if self.seq is not None and num_parts > 1:
            n_per = len(self.seq) // num_parts
            self.seq = self.seq[part_index * n_per:(part_index + 1) * n_per]
        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list
        self._all_builtin_augs = _augs_all_builtin(self.auglist)
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            random.shuffle(self.seq)
        if self.imgrec is not None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            return label, self.read_image(fname)
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, h, w, c), np.float32)
        batch_label = np.zeros((batch_size,) + (
            (self.label_width,) if self.label_width > 1 else ()), np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                # builtin augmenters are type-preserving: all-numpy fast
                # path; user augmenters keep the NDArray input contract
                data = self.imdecode_np(s) if self._all_builtin_augs \
                    else self.imdecode(s)
                data = self.augmentation_transform(data)
                arr = data.asnumpy() if isinstance(data, NDArray) else data
                batch_data[i] = arr
                batch_label[i] = label
                i += 1
        except StopIteration:
            if not i:
                raise
        batch_data = batch_data.transpose(0, 3, 1, 2)  # HWC -> CHW
        return DataBatch([nd_array(batch_data)], [nd_array(batch_label)],
                         pad=batch_size - i)

    def check_data_shape(self, data_shape):
        if not len(data_shape) == 3:
            raise ValueError("data_shape should have length 3, with "
                             "dimensions CxHxW")
        if not data_shape[0] == 3 and not data_shape[0] == 1:
            raise ValueError("This iterator expects inputs to have 1 or 3 "
                             "channels.")

    def imdecode(self, s):
        return imdecode(s)

    def imdecode_np(self, s):
        """Numpy decode for the host batching path (augmenters are
        type-preserving, so the whole per-image chain stays in numpy).  A
        subclass overriding imdecode() is honored through the NDArray
        route."""
        if type(self).imdecode is not ImageIter.imdecode:
            data = self.imdecode(s)
            return data.asnumpy() if isinstance(data, NDArray) else data
        return _imdecode_np(s)

    def read_image(self, fname):
        from ..filesystem import open_uri
        path = os.path.join(self.path_root, fname) if self.path_root \
            else fname
        with open_uri(path, "rb") as fin:
            return fin.read()

    def augmentation_transform(self, data):
        for aug in self.auglist:
            data = aug(data)
        return data

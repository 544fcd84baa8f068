"""Object-detection data augmentation + ImageDetIter.

Counterpart of ``mxnet_tpu/image/detection.py``: the same augmenters and
iterator over the port's ``image.image``, computing in numpy on the host,
so that the same seeds give the JAX package's batches bit for bit.
Arrays handed in as NDArrays come back on their own context; batches are
host NDArrays, as ``ImageIter``'s are.

Behavior parity with the reference detection pipeline
(python/mxnet/image/detection.py:1-943 and the C++ defaults in
src/io/image_det_aug_default.cc), built on this package's numpy-first
augmenter chain: a detection label is a float array [N, W>=5] whose rows
are (class_id, xmin, ymin, xmax, ymax, ...extras) with coordinates
normalized to [0, 1]; augmenters take and return (image, label) pairs.
Randomness routes through the image module's thread-local RNG so the
engine pipeline's per-record seeding keeps detection augmentation
bit-deterministic across worker counts.
"""
from __future__ import annotations

import json
import logging
import math

import numpy as np

from ..io import DataBatch, DataDesc
from ..ndarray import NDArray
from .image import (Augmenter, CastAug, ColorJitterAug, ColorNormalizeAug,
                    ForceResizeAug, HueJitterAug, LightingAug,
                    RandomGrayAug, ResizeAug, ImageIter, fixed_crop, _rand,
                    nd_array)

__all__ = [
    "DetAugmenter", "DetBorrowAug", "DetRandomSelectAug",
    "DetHorizontalFlipAug", "DetRandomCropAug", "DetRandomPadAug",
    "CreateMultiRandCropAugmenter", "CreateDetAugmenter", "ImageDetIter",
]


# ---------------------------------------------------------------------------
# box geometry on [N, 5+] labels (columns: cls, x1, y1, x2, y2, ...)

def _box_areas(boxes):
    """Areas of the (x1,y1,x2,y2) columns; negatives clamp to zero."""
    w = np.maximum(0.0, boxes[:, 2] - boxes[:, 0])
    h = np.maximum(0.0, boxes[:, 3] - boxes[:, 1])
    return w * h


def _box_intersections(boxes, x1, y1, x2, y2):
    """Per-box intersection rectangles with a window; empty rows -> 0."""
    out = boxes.copy()
    out[:, 0] = np.maximum(boxes[:, 0], x1)
    out[:, 1] = np.maximum(boxes[:, 1], y1)
    out[:, 2] = np.minimum(boxes[:, 2], x2)
    out[:, 3] = np.minimum(boxes[:, 3], y2)
    empty = (out[:, 0] >= out[:, 2]) | (out[:, 1] >= out[:, 3])
    out[empty] = 0.0
    return out


def _as_pair(value, name):
    """Accept a (lo, hi) pair or a single number meaning (v, v)."""
    if isinstance(value, (tuple, list)):
        return tuple(value)
    logging.info("Using fixed %s: %s", name, value)
    return (value, value)


def _propose_h_w(ratio_range, min_area, max_area, width, height,
                 clamp_to_image):
    """One (h, w) proposal honoring the aspect/area constraints.

    Shared by crop (clamp_to_image=True: region inside the image) and pad
    (False: region containing the image).  Returns None when this draw
    can't satisfy the constraints.
    """
    ratio = _rand().uniform(*ratio_range)
    if ratio <= 0:
        return None
    h = int(round(math.sqrt(min_area / ratio)))
    max_h = int(round(math.sqrt(max_area / ratio)))
    if clamp_to_image:
        if round(max_h * ratio) > width:
            max_h = int((width + 0.4999999) / ratio)
        max_h = min(max_h, height)
        h = min(h, max_h)
    else:
        if round(h * ratio) < width:
            h = int((width + 0.499999) / ratio)
        h = max(h, height)
        h = min(h, max_h)
    if h < max_h:
        h = _rand().randint(h, max_h)
    w = int(round(h * ratio))
    if clamp_to_image:
        # nudge against rounding drift on the area bounds
        if w * h < min_area:
            h += 1
            w = int(round(h * ratio))
        if w * h > max_area:
            h -= 1
            w = int(round(h * ratio))
        if (w * h < min_area or w * h > max_area or w > width
                or h > height or w <= 0 or h <= 0):
            return None
    return h, w


# ---------------------------------------------------------------------------
# augmenters

class DetAugmenter:
    """Base detection augmenter: maps (image, label) to (image, label)."""

    def __init__(self, **kwargs):
        for k, v in kwargs.items():
            if isinstance(v, NDArray):
                v = v.asnumpy()
            if isinstance(v, np.ndarray):
                kwargs[k] = v.tolist()
        self._kwargs = kwargs

    def dumps(self):
        return json.dumps([type(self).__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Lift a label-preserving pixel Augmenter into the detection chain."""

    def __init__(self, augmenter):
        if not isinstance(augmenter, Augmenter):
            raise TypeError("Borrowing from invalid Augmenter")
        super().__init__(augmenter=augmenter.dumps())
        self.augmenter = augmenter

    def dumps(self):
        return [type(self).__name__.lower(), self.augmenter.dumps()]

    def __call__(self, src, label):
        return self.augmenter(src), label


class DetRandomSelectAug(DetAugmenter):
    """Apply one randomly chosen child augmenter, or none (skip_prob)."""

    def __init__(self, aug_list, skip_prob=0):
        super().__init__(skip_prob=skip_prob)
        if not isinstance(aug_list, (list, tuple)):
            aug_list = [aug_list]
        for aug in aug_list:
            if not isinstance(aug, DetAugmenter):
                raise ValueError("Allow DetAugmenter in list only")
        self.aug_list = list(aug_list)
        self.skip_prob = skip_prob if aug_list else 1

    def dumps(self):
        return [type(self).__name__.lower(),
                [a.dumps() for a in self.aug_list]]

    def __call__(self, src, label):
        if _rand().random() < self.skip_prob:
            return src, label
        chosen = self.aug_list[_rand().randrange(len(self.aug_list))]
        return chosen(src, label)


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror the image AND the x-coordinates of every box."""

    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src, label):
        if _rand().random() >= self.p:
            return src, label
        was_nd = isinstance(src, NDArray)
        arr = src.asnumpy() if was_nd else src
        flipped = np.ascontiguousarray(arr[:, ::-1])
        out = label.copy()
        out[:, 1] = 1.0 - label[:, 3]
        out[:, 3] = 1.0 - label[:, 1]
        return (nd_array(flipped, ctx=src.context) if was_nd
                else flipped), out


class DetRandomCropAug(DetAugmenter):
    """Constrained random crop: the window must cover every surviving
    object by at least min_object_covered; boxes clipped to the window
    keep only rows retaining min_eject_coverage of their area."""

    def __init__(self, min_object_covered=0.1,
                 aspect_ratio_range=(0.75, 1.33), area_range=(0.05, 1.0),
                 min_eject_coverage=0.3, max_attempts=50):
        aspect_ratio_range = _as_pair(aspect_ratio_range,
                                      "aspect ratio (DetRandomCropAug)")
        area_range = _as_pair(area_range, "area range (DetRandomCropAug)")
        super().__init__(min_object_covered=min_object_covered,
                         aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range,
                         min_eject_coverage=min_eject_coverage,
                         max_attempts=max_attempts)
        self.min_object_covered = min_object_covered
        self.min_eject_coverage = min_eject_coverage
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = area_range[1] > 0 and \
            area_range[0] <= area_range[1] and \
            0 < aspect_ratio_range[0] <= aspect_ratio_range[1]
        if not self.enabled:
            logging.warning("DetRandomCropAug disabled: invalid "
                            "area/aspect ranges %s %s",
                            area_range, aspect_ratio_range)

    def __call__(self, src, label):
        height, width = src.shape[0], src.shape[1]
        proposal = self._propose(label, height, width)
        if proposal is None:
            return src, label
        x, y, w, h, new_label = proposal
        return fixed_crop(src, x, y, w, h, None), new_label

    def _covers_objects(self, label, x, y, w, h, width, height):
        """Does the pixel window keep every (non-degenerate) object
        covered by at least min_object_covered?"""
        if w * h < 2:
            return False
        win = (x / width, y / height, (x + w) / width, (y + h) / height)
        boxes = label[:, 1:]
        areas = _box_areas(boxes)
        real = areas * width * height > 2
        if not real.any():
            return False
        inter = _box_intersections(boxes[real], *win)
        coverage = _box_areas(inter) / areas[real]
        coverage = coverage[coverage > 0]
        return coverage.size > 0 and \
            float(coverage.min()) > self.min_object_covered

    def _clip_labels(self, label, x, y, w, h, width, height):
        """Re-express boxes in window coordinates; eject tiny leftovers.
        None when no box survives (the proposal is then rejected)."""
        wx, wy = x / width, y / height
        ww, wh = w / width, h / height
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] - wx) / ww
        out[:, (2, 4)] = (out[:, (2, 4)] - wy) / wh
        out[:, 1:5] = np.clip(out[:, 1:5], 0.0, 1.0)
        coverage = _box_areas(out[:, 1:]) * ww * wh \
            / np.maximum(_box_areas(label[:, 1:]), 1e-12)
        keep = (out[:, 3] > out[:, 1]) & (out[:, 4] > out[:, 2]) \
            & (coverage > self.min_eject_coverage)
        if not keep.any():
            return None
        return out[keep]

    def _propose(self, label, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return None
        min_area = self.area_range[0] * height * width
        max_area = self.area_range[1] * height * width
        for _ in range(self.max_attempts):
            hw = _propose_h_w(self.aspect_ratio_range, min_area, max_area,
                              width, height, clamp_to_image=True)
            if hw is None:
                continue
            h, w = hw
            y = _rand().randint(0, max(0, height - h))
            x = _rand().randint(0, max(0, width - w))
            if self._covers_objects(label, x, y, w, h, width, height):
                new_label = self._clip_labels(label, x, y, w, h,
                                              width, height)
                if new_label is not None:
                    return x, y, w, h, new_label
        return None


class DetRandomPadAug(DetAugmenter):
    """Random expansion: embed the image in a larger canvas of pad_val
    pixels, shrinking the normalized boxes accordingly."""

    def __init__(self, aspect_ratio_range=(0.75, 1.33),
                 area_range=(1.0, 3.0), max_attempts=50,
                 pad_val=(128, 128, 128)):
        if not isinstance(pad_val, (list, tuple)):
            pad_val = (pad_val,)
        aspect_ratio_range = _as_pair(aspect_ratio_range,
                                      "aspect ratio (DetRandomPadAug)")
        area_range = _as_pair(area_range, "area range (DetRandomPadAug)")
        super().__init__(aspect_ratio_range=aspect_ratio_range,
                         area_range=area_range, max_attempts=max_attempts,
                         pad_val=pad_val)
        self.pad_val = pad_val
        self.aspect_ratio_range = aspect_ratio_range
        self.area_range = area_range
        self.max_attempts = max_attempts
        self.enabled = area_range[1] > 1.0 and \
            area_range[0] <= area_range[1] and \
            0 < aspect_ratio_range[0] <= aspect_ratio_range[1]
        if not self.enabled:
            logging.warning("DetRandomPadAug disabled: invalid "
                            "area/aspect ranges %s %s",
                            area_range, aspect_ratio_range)

    def __call__(self, src, label):
        height, width = src.shape[0], src.shape[1]
        proposal = self._propose(label, height, width)
        if proposal is None:
            return src, label
        x, y, w, h, new_label = proposal
        was_nd = isinstance(src, NDArray)
        arr = src.asnumpy() if was_nd else src
        canvas = np.empty((h, w) + arr.shape[2:], arr.dtype)
        canvas[...] = np.asarray(self.pad_val, arr.dtype)
        canvas[y:y + height, x:x + width] = arr
        return (nd_array(canvas, ctx=src.context) if was_nd
                else canvas), new_label

    def _shift_labels(self, label, x, y, w, h, height, width):
        out = label.copy()
        out[:, (1, 3)] = (out[:, (1, 3)] * width + x) / w
        out[:, (2, 4)] = (out[:, (2, 4)] * height + y) / h
        return out

    def _propose(self, label, height, width):
        if not self.enabled or height <= 0 or width <= 0:
            return None
        min_area = self.area_range[0] * height * width
        max_area = self.area_range[1] * height * width
        for _ in range(self.max_attempts):
            hw = _propose_h_w(self.aspect_ratio_range, min_area, max_area,
                              width, height, clamp_to_image=False)
            if hw is None:
                continue
            h, w = hw
            if h - height < 2 or w - width < 2:
                continue  # marginal padding is not helpful
            y = _rand().randint(0, max(0, h - height))
            x = _rand().randint(0, max(0, w - width))
            return x, y, w, h, self._shift_labels(label, x, y, w, h,
                                                  height, width)
        return None


# ---------------------------------------------------------------------------
# factory helpers

def _broadcast_params(params):
    """Zip scalar-or-list parameters to equal lengths."""
    lists = [p if isinstance(p, list) else [p] for p in params]
    n = max(len(p) for p in lists)
    return [p * n if len(p) == 1 else p for p in lists]


def CreateMultiRandCropAugmenter(min_object_covered=0.1,
                                 aspect_ratio_range=(0.75, 1.33),
                                 area_range=(0.05, 1.0),
                                 min_eject_coverage=0.3, max_attempts=50,
                                 skip_prob=0):
    """A DetRandomSelectAug over one crop augmenter per parameter set
    (pass lists to get multiple candidate constraint profiles)."""
    aligned = _broadcast_params([min_object_covered, aspect_ratio_range,
                                 area_range, min_eject_coverage,
                                 max_attempts])
    crops = [DetRandomCropAug(min_object_covered=moc,
                              aspect_ratio_range=arr, area_range=ar,
                              min_eject_coverage=mec, max_attempts=ma)
             for moc, arr, ar, mec, ma in zip(*aligned)]
    return DetRandomSelectAug(crops, skip_prob=skip_prob)


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_gray=0, rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0, pca_noise=0,
                       hue=0, inter_method=2, min_object_covered=0.1,
                       aspect_ratio_range=(0.75, 1.33),
                       area_range=(0.05, 3.0), min_eject_coverage=0.3,
                       max_attempts=50, pad_val=(127, 127, 127)):
    """Standard detection augmentation chain (ref: detection.py:484);
    geometry first (resize/crop/mirror/pad), then the forced resize to
    data_shape, then photometric jitter and normalization."""
    augs = []
    if resize > 0:
        augs.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    if rand_crop > 0:
        augs.append(CreateMultiRandCropAugmenter(
            min_object_covered, aspect_ratio_range, area_range,
            min_eject_coverage, max_attempts, skip_prob=1 - rand_crop))
    if rand_mirror > 0:
        augs.append(DetHorizontalFlipAug(0.5))
    if rand_pad > 0:
        augs.append(DetRandomSelectAug(
            [DetRandomPadAug(aspect_ratio_range,
                             (1.0, area_range[1]), max_attempts, pad_val)],
            skip_prob=1 - rand_pad))
    augs.append(DetBorrowAug(
        ForceResizeAug((data_shape[2], data_shape[1]), inter_method)))
    augs.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        augs.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if hue:
        augs.append(DetBorrowAug(HueJitterAug(hue)))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        augs.append(DetBorrowAug(LightingAug(pca_noise, eigval, eigvec)))
    if rand_gray > 0:
        augs.append(DetBorrowAug(RandomGrayAug(rand_gray)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    elif mean is not None:
        assert isinstance(mean, np.ndarray) and mean.shape[0] in (1, 3)
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    elif std is not None:
        assert isinstance(std, np.ndarray) and std.shape[0] in (1, 3)
    if mean is not None or std is not None:
        augs.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return augs


# ---------------------------------------------------------------------------
# iterator

class ImageDetIter(ImageIter):
    """ImageIter specialization for detection: variable-object labels.

    A raw record label is the im2rec detection layout
    ``[header_width, object_width, ...header..., (id, x1, y1, x2, y2,
    ...)*]``; batches carry a fixed [batch, max_objects, object_width]
    label padded with -1 rows (ref: detection.py:626 ImageDetIter).
    """

    def __init__(self, batch_size, data_shape, path_imgrec=None,
                 path_imglist=None, path_root=None, path_imgidx=None,
                 shuffle=False, part_index=0, num_parts=1, aug_list=None,
                 imglist=None, data_name="data", label_name="label",
                 **kwargs):
        super().__init__(batch_size=batch_size, data_shape=data_shape,
                         path_imgrec=path_imgrec,
                         path_imglist=path_imglist, path_root=path_root,
                         path_imgidx=path_imgidx, shuffle=shuffle,
                         part_index=part_index, num_parts=num_parts,
                         aug_list=[], imglist=imglist,
                         data_name=data_name, label_name=label_name)
        self.auglist = (CreateDetAugmenter(data_shape, **kwargs)
                        if aug_list is None else aug_list)
        self.label_shape = self._scan_label_shape()
        self.provide_label = [DataDesc(
            label_name, (self.batch_size,) + self.label_shape)]

    # -- labels --------------------------------------------------------------
    @staticmethod
    def _parse_label(label):
        """Flat im2rec detection label -> [N, object_width] valid rows."""
        if isinstance(label, NDArray):
            label = label.asnumpy()
        flat = np.asarray(label).ravel()
        if flat.size < 7:
            raise RuntimeError("Label shape is invalid: %s"
                               % (flat.shape,))
        header_width = int(flat[0])
        obj_width = int(flat[1])
        if (flat.size - header_width) % obj_width != 0:
            raise RuntimeError(
                "Label shape %s inconsistent with annotation width %d."
                % (flat.shape, obj_width))
        objects = flat[header_width:].reshape(-1, obj_width)
        good = (objects[:, 3] > objects[:, 1]) \
            & (objects[:, 4] > objects[:, 2])
        if not good.any():
            raise RuntimeError("Encounter sample with no valid label.")
        return objects[good]

    @staticmethod
    def _check_valid_label(label):
        if label.ndim != 2 or label.shape[1] < 5:
            raise RuntimeError(
                "Label with shape (1+, 5+) required, %s received."
                % (label,))
        good = (label[:, 0] >= 0) & (label[:, 3] > label[:, 1]) \
            & (label[:, 4] > label[:, 2])
        if not good.any():
            raise RuntimeError("Invalid label occurs.")

    def _scan_label_shape(self):
        """One pass over the source to size the padded label tensor."""
        max_objects, width = 0, 5
        self.reset()
        try:
            while True:
                raw, _ = self.next_sample()
                parsed = self._parse_label(raw)
                max_objects = max(max_objects, parsed.shape[0])
                width = parsed.shape[1]
        except StopIteration:
            pass
        self.reset()
        return (max_objects, width)

    # -- iteration -----------------------------------------------------------
    def augmentation_transform(self, data, label):
        for aug in self.auglist:
            data, label = aug(data, label)
        return data, label

    def next(self):
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, h, w, c), np.float32)
        batch_label = np.full((batch_size,) + self.label_shape, -1.0,
                              np.float32)
        i = 0
        try:
            while i < batch_size:
                raw, s = self.next_sample()
                try:
                    data = self.imdecode_np(s)
                    label = self._parse_label(raw)
                    data, label = self.augmentation_transform(data, label)
                    self._check_valid_label(label)
                except RuntimeError as e:
                    logging.debug("Invalid image, skipping: %s", e)
                    continue
                arr = data.asnumpy() if isinstance(data, NDArray) else data
                batch_data[i] = arr
                batch_label[i, :label.shape[0]] = label
                i += 1
        except StopIteration:
            if not i:
                raise
        batch_data = batch_data.transpose(0, 3, 1, 2)  # HWC -> CHW
        return DataBatch([nd_array(batch_data)], [nd_array(batch_label)],
                         pad=batch_size - i)

    # -- shape management ----------------------------------------------------
    def reshape(self, data_shape=None, label_shape=None):
        if data_shape is not None:
            self.check_data_shape(data_shape)
            self.data_shape = data_shape
            self.provide_data = [DataDesc(
                self.provide_data[0][0], (self.batch_size,) + data_shape)]
        if label_shape is not None:
            self.check_label_shape(label_shape)
            self.label_shape = label_shape
            self.provide_label = [DataDesc(
                self.provide_label[0][0],
                (self.batch_size,) + label_shape)]

    def check_label_shape(self, label_shape):
        if len(label_shape) != 2:
            raise ValueError("label_shape should have length 2")
        if label_shape[0] < self.label_shape[0]:
            raise ValueError(
                "Attempts to reduce label count from %d to %d, not "
                "allowed." % (self.label_shape[0], label_shape[0]))
        if label_shape[1] != self.label_shape[1]:
            raise ValueError(
                "label_shape object width inconsistent: %d vs %d."
                % (self.label_shape[1], label_shape[1]))

    def sync_label_shape(self, it, verbose=False):
        """Unify label shapes with another ImageDetIter (train/val pair)."""
        assert isinstance(it, ImageDetIter)
        shape = (max(self.label_shape[0], it.label_shape[0]),
                 self.label_shape[1])
        self.reshape(label_shape=shape)
        it.reshape(label_shape=shape)
        if verbose and shape != self.label_shape:
            logging.info("Resized label_shape to %s.", shape)
        return it

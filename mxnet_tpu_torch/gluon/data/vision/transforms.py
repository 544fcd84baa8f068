"""Vision transforms (ref: gluon.data.vision.transforms).

Counterpart of ``mxnet_tpu/gluon/data/vision/transforms.py``: composable
per-sample transforms for ``Dataset.transform_first``.  They run in the
input pipeline before the batch reaches the card, in numpy on the host
(per-sample work on the DataLoader's threads); a transform's NDArray
result is on its input's context (the host for a dataset's images).
"""
from __future__ import annotations

import random

import numpy as np

from ...block import Block
from ...nn import Sequential
from ....context import cpu
from ....ndarray import NDArray, array
from .... import image as image_mod

__all__ = ["Compose", "Cast", "ToTensor", "Normalize", "RandomResizedCrop",
           "CenterCrop", "Resize", "RandomFlipLeftRight",
           "RandomFlipTopBottom", "RandomBrightness", "RandomContrast",
           "RandomSaturation", "RandomHue", "RandomColorJitter",
           "RandomLighting"]


def _like(arr, x):
    """``arr`` as an NDArray on ``x``'s context (the host for numpy)."""
    return array(arr, ctx=x.context if isinstance(x, NDArray) else cpu())


class Compose(Sequential):
    """Sequentially compose transforms (ref: transforms.py:Compose)."""

    def __init__(self, transforms):
        super().__init__()
        for t in transforms:
            self.add(t)


class Cast(Block):
    def __init__(self, dtype="float32"):
        super().__init__()
        self._dtype = dtype

    def forward(self, x):
        return x.astype(self._dtype)


class ToTensor(Block):
    """HWC uint8 [0,255] -> CHW float32 [0,1] (ref: transforms.py:ToTensor)."""

    def forward(self, x):
        arr = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
        arr = arr.astype(np.float32) / 255.0
        if arr.ndim == 3:
            arr = arr.transpose(2, 0, 1)
        elif arr.ndim == 4:
            arr = arr.transpose(0, 3, 1, 2)
        return _like(arr, x)


class Normalize(Block):
    """Channel-wise normalize a CHW tensor (ref: transforms.py:Normalize)."""

    def __init__(self, mean, std):
        super().__init__()
        self._mean = np.asarray(mean, np.float32).reshape(-1, 1, 1)
        self._std = np.asarray(std, np.float32).reshape(-1, 1, 1)

    def forward(self, x):
        arr = x.asnumpy() if isinstance(x, NDArray) else np.asarray(x)
        return _like((arr - self._mean) / self._std, x)


class Resize(Block):
    def __init__(self, size, keep_ratio=False, interpolation=1):
        super().__init__()
        self._size = size
        self._keep = keep_ratio
        self._interpolation = interpolation

    def forward(self, x):
        if isinstance(self._size, int):
            if self._keep:
                return image_mod.resize_short(x, self._size,
                                              self._interpolation)
            size = (self._size, self._size)
        else:
            size = self._size
        return image_mod.imresize(x, size[0], size[1], self._interpolation)


class CenterCrop(Block):
    def __init__(self, size, interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._interpolation = interpolation

    def forward(self, x):
        return image_mod.center_crop(x, self._size, self._interpolation)[0]


class RandomResizedCrop(Block):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3.0 / 4.0, 4.0 / 3.0),
                 interpolation=1):
        super().__init__()
        self._size = (size, size) if isinstance(size, int) else size
        self._scale = scale
        self._ratio = ratio
        self._interpolation = interpolation

    def forward(self, x):
        return image_mod.random_size_crop(
            x, self._size, self._scale[0], self._ratio,
            self._interpolation)[0]


class RandomFlipLeftRight(Block):
    def forward(self, x):
        if random.random() < 0.5:
            arr = x.asnumpy() if isinstance(x, NDArray) else x
            x = _like(arr[:, ::-1].copy(), x)
        return x


class RandomFlipTopBottom(Block):
    def forward(self, x):
        if random.random() < 0.5:
            arr = x.asnumpy() if isinstance(x, NDArray) else x
            x = _like(arr[::-1].copy(), x)
        return x


class RandomBrightness(Block):
    def __init__(self, brightness):
        super().__init__()
        self._aug = image_mod.BrightnessJitterAug(brightness)

    def forward(self, x):
        return self._aug(x)


class RandomContrast(Block):
    def __init__(self, contrast):
        super().__init__()
        self._aug = image_mod.ContrastJitterAug(contrast)

    def forward(self, x):
        return self._aug(x)


class RandomSaturation(Block):
    def __init__(self, saturation):
        super().__init__()
        self._aug = image_mod.SaturationJitterAug(saturation)

    def forward(self, x):
        return self._aug(x)


class RandomHue(Block):
    def __init__(self, hue):
        super().__init__()
        self._aug = image_mod.HueJitterAug(hue)

    def forward(self, x):
        return self._aug(x)


class RandomColorJitter(Block):
    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0):
        super().__init__()
        self._aug = image_mod.ColorJitterAug(brightness, contrast, saturation)
        self._hue = image_mod.HueJitterAug(hue) if hue else None

    def forward(self, x):
        x = self._aug(x)
        if self._hue is not None:
            x = self._hue(x)
        return x


class RandomLighting(Block):
    def __init__(self, alpha):
        super().__init__()
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        self._aug = image_mod.LightingAug(alpha, eigval, eigvec)

    def forward(self, x):
        return self._aug(x)

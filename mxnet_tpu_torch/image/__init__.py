"""Image iterators and augmenters (ref: python/mxnet/image/).

Counterpart of ``mxnet_tpu/image/__init__.py``: ``image.py``'s decoding,
augmenters and ``ImageIter``, and ``codec`` (decode, encode and resize).
The detection half (``mx.image.det``, ``ImageDetIter`` and the detection
augmenters) waits for the slice A2b: its names raise ``MXNetError``
saying so.
"""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
from . import codec  # noqa: F401
from ..base import MXNetError as _MXNetError

_DETECTION = ("det", "detection", "DetAugmenter", "DetBorrowAug",
              "DetRandomSelectAug", "DetHorizontalFlipAug",
              "DetRandomCropAug", "DetRandomPadAug",
              "CreateMultiRandCropAugmenter", "CreateDetAugmenter",
              "ImageDetIter")


def __getattr__(name):
    if name in _DETECTION:
        raise _MXNetError("mx.image.%s (object detection) waits for the "
                          "slice A2b of the port" % name)
    raise AttributeError("module %r has no attribute %r" % (__name__, name))

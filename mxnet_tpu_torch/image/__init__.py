"""Image iterators and augmenters (ref: python/mxnet/image/).

Counterpart of ``mxnet_tpu/image/__init__.py``: ``image.py``'s decoding,
augmenters and ``ImageIter``, ``detection.py``'s detection augmenters and
``ImageDetIter`` (also as ``mx.image.det``), and ``codec`` (decode,
encode and resize).
"""
from .image import *  # noqa: F401,F403
from . import image  # noqa: F401
from .detection import *  # noqa: F401,F403
from . import detection  # noqa: F401
from . import detection as det  # noqa: F401  (mx.image.det alias)
from . import codec  # noqa: F401

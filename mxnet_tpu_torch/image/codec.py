"""Image coding for the host image pipeline: decode, encode and resize.

The port's counterpart of the JAX package's three cv2 calls:
``cv2.imdecode`` (``mxnet_tpu/image/image.py``, ``mxnet_tpu/recordio.py``),
``cv2.imencode`` (``recordio.py``) and ``cv2.resize`` (``image.py``).
Images are numpy arrays in cv2's conventions: HWC ``uint8`` in BGR order,
or HW for one channel.

- Decode and encode take cv2 where it imports, else PIL (the JAX
  package's own order).  A buffer that neither reads raises
  ``MXNetError`` naming cv2 and PIL; nothing is skipped.
- Resize is ``cv2.resize``; without cv2 it raises ``MXNetError``, as the
  JAX package's resize fails without cv2.

:func:`backend` names the codec that decode tries first.
"""
from __future__ import annotations

import functools
import importlib

import numpy as np

from ..base import MXNetError

CODECS = ("cv2", "PIL")


@functools.lru_cache(maxsize=None)
def _import(name):
    try:
        return importlib.import_module(name)
    except ImportError:
        return None


def _cv2():
    return _import("cv2")


def _pil():
    if _import("PIL") is None:
        return None
    return _import("PIL.Image")


def available():
    """The codecs that import here, in the order decode tries them."""
    have = {"cv2": _cv2() is not None, "PIL": _pil() is not None}
    return [c for c in CODECS if have[c]]


def backend():
    """The codec that decode and encode try first here."""
    have = available()
    if not have:
        raise MXNetError("no image codec here: neither cv2 nor PIL "
                         "imports")
    return have[0]


# ---------------------------------------------------------------------------
# Decode and encode
# ---------------------------------------------------------------------------

def _as_bytes(buf):
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return bytes(buf)
    return np.ascontiguousarray(buf, dtype=np.uint8).tobytes()


def _pil_decode(pil, data, flag):
    from io import BytesIO
    img = pil.open(BytesIO(data))
    if flag == 0:
        img = img.convert("L")
    elif flag > 0 and img.mode != "RGB":
        img = img.convert("RGB")
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] >= 3:  # RGB(A) -> BGR(A), cv2's order
        arr = np.ascontiguousarray(
            np.concatenate([arr[:, :, 2::-1], arr[:, :, 3:]], axis=2))
    return arr


def decode(buf, flag=1):
    """An encoded image as a numpy array in cv2's conventions: ``flag`` 1
    three-channel BGR, 0 one channel (HW), -1 as stored."""
    data = _as_bytes(buf)
    tried = []
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imdecode(np.frombuffer(data, dtype=np.uint8), flag)
        if img is not None:
            return img
        tried.append("cv2 could not read it")
    else:
        tried.append("cv2 does not import")
    pil = _pil()
    if pil is not None:
        try:
            return _pil_decode(pil, data, flag)
        except Exception as e:  # PIL raises several types on bad data
            tried.append("PIL could not read it (%s)" % e)
    else:
        tried.append("PIL does not import")
    raise MXNetError("no image codec reads these %d bytes: %s"
                     % (len(data), "; ".join(tried)))


def _pil_encode(pil, img, quality, img_fmt):
    from io import BytesIO
    arr = np.asarray(img)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = arr[:, :, 0]
    if arr.ndim == 3:
        arr = arr[:, :, ::-1]  # BGR -> RGB
    fmt = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG"}.get(
        img_fmt.lower(), "JPEG")
    bio = BytesIO()
    kwargs = {"quality": quality} if fmt == "JPEG" else {}
    pil.fromarray(np.ascontiguousarray(arr)).save(bio, format=fmt, **kwargs)
    return bio.getvalue()


def encode(img, quality=95, img_fmt=".jpg"):
    """Encode a numpy image (cv2's conventions) as ``img_fmt`` bytes."""
    cv2 = _cv2()
    if cv2 is not None:
        ok, buf = cv2.imencode(img_fmt, img,
                               [cv2.IMWRITE_JPEG_QUALITY, quality])
        if not ok:
            raise MXNetError("cv2 could not encode a %s image as %s"
                             % (np.asarray(img).shape, img_fmt))
        return buf.tobytes()
    pil = _pil()
    if pil is not None:
        return _pil_encode(pil, img, quality, img_fmt)
    raise MXNetError("no image codec encodes %s here: neither cv2 nor PIL "
                     "imports" % img_fmt)


def resize(img, w, h, interp=1):
    """``cv2.resize(img, (w, h), interpolation=interp)``."""
    cv2 = _cv2()
    if cv2 is None:
        raise MXNetError("resizing an image needs cv2, which does not "
                         "import here")
    return cv2.resize(img, (w, h), interpolation=interp)

"""Image coding for the host image pipeline: decode, encode and resize.

The port's counterpart of the JAX package's three cv2 calls:
``cv2.imdecode`` (``mxnet_tpu/image/image.py``, ``mxnet_tpu/recordio.py``),
``cv2.imencode`` (``recordio.py``) and ``cv2.resize`` (``image.py``).
Images are numpy arrays in cv2's conventions: HWC ``uint8`` in BGR order,
or HW for one channel.

- Decode and encode take cv2 where it imports, else PIL (the JAX
  package's own order), else nvJPEG from the CUDA toolkit
  (``csrc/jpeg_codec.cu``): JPEG decoded into device memory and encoded
  from it, ``quality`` and chroma subsampling as parameters, the pixels
  returned to the host, since the augmenters compute in numpy.  A buffer
  that no available codec reads raises ``MXNetError`` naming cv2, PIL and
  nvJPEG; nothing is skipped.
- Resize is ``cv2.resize`` where cv2 imports, else :func:`torch_resize`,
  cv2's nearest (``floor(dst * scale)``), bilinear and bicubic rules
  (half-pixel centres, edge replication, a = -0.75) computed with torch
  on the host; other interpolation codes raise ``MXNetError`` naming cv2.

:func:`backend` names the codec that decode tries first.  The nvJPEG
functions are public so that a run on the card can hold them to cv2's
pixels whatever codec the pipeline uses.
"""
from __future__ import annotations

import ctypes
import functools
import importlib
import threading

import numpy as np
import torch

from ..base import MXNetError

CODECS = ("cv2", "PIL", "nvJPEG")
# nvJPEG's chroma subsampling codes in csrc/jpeg_codec.cu
SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


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


def nvjpeg_available():
    """A card and the toolkit's nvJPEG header are present (the library is
    built at its first call)."""
    if not torch.cuda.is_available():
        return False
    import os
    from ..ops import _build
    try:
        nvcc = _build.nvcc_path()
    except MXNetError:
        return False
    root = os.path.dirname(os.path.dirname(nvcc))
    return os.path.exists(os.path.join(root, "include", "nvjpeg.h"))


def available():
    """The codecs that import or build here, in the order decode tries
    them."""
    have = {"cv2": _cv2() is not None, "PIL": _pil() is not None,
            "nvJPEG": nvjpeg_available()}
    return [c for c in CODECS if have[c]]


def backend():
    """The codec that decode and encode try first here."""
    have = available()
    if not have:
        raise MXNetError("no image codec here: cv2 and PIL do not import "
                         "and nvJPEG needs a CUDA device and the toolkit")
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
    if nvjpeg_available():
        try:
            return nvjpeg_decode(data, flag)
        except MXNetError as e:
            tried.append("nvJPEG could not read it (%s)" % e)
    else:
        tried.append("nvJPEG needs a CUDA device and the toolkit")
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
    if img_fmt.lower() in (".jpg", ".jpeg") and nvjpeg_available():
        return nvjpeg_encode(img, quality)
    raise MXNetError("no image codec encodes %s here: cv2 and PIL do not "
                     "import, and nvJPEG (JPEG only) needs a CUDA device "
                     "and the toolkit" % img_fmt)


# ---------------------------------------------------------------------------
# nvJPEG (csrc/jpeg_codec.cu)
# ---------------------------------------------------------------------------

_nvjpeg = {}
_nvjpeg_lock = threading.Lock()


def _nvjpeg_lib():
    with _nvjpeg_lock:
        lib = _nvjpeg.get("lib")
        if lib is None:
            from ..ops import _build
            lib = _build.load("jpeg_codec")
            vp, sz, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int
            ip = ctypes.POINTER(ctypes.c_int)
            lib.jpeg_last_error.restype = ctypes.c_char_p
            lib.jpeg_last_error.argtypes = []
            for fn, args in (
                    ("jpeg_info", [ctypes.c_char_p, sz, ip, ip, ip, ip]),
                    ("jpeg_decode", [i, ctypes.c_char_p, sz, i, i, i, vp]),
                    ("jpeg_decode_planes", [i, ctypes.c_char_p, sz, i, i,
                                            i, i, vp, vp, vp]),
                    ("jpeg_encode", [i, vp, i, i, i, i, i, vp, sz,
                                     ctypes.POINTER(sz)])):
                getattr(lib, fn).restype = ctypes.c_int
                getattr(lib, fn).argtypes = args
            _nvjpeg["lib"] = lib
        return lib


def _nvjpeg_check(lib, rc, what):
    if rc != 0:
        raise MXNetError("nvJPEG %s: %s (code %d)"
                         % (what, lib.jpeg_last_error().decode(), rc))


def _device(device):
    if device is None:
        return torch.cuda.current_device()
    return torch.device(device).index or 0


def nvjpeg_info(buf):
    """(components, width, height, subsampling code) of a JPEG stream."""
    lib = _nvjpeg_lib()
    data = _as_bytes(buf)
    out = [ctypes.c_int(0) for _ in range(4)]
    _nvjpeg_check(lib, lib.jpeg_info(data, len(data),
                                     *[ctypes.byref(v) for v in out]),
                  "reading the header")
    return tuple(v.value for v in out)


def nvjpeg_decode(buf, flag=1, device=None):
    """Decode a JPEG stream on the card; returns the host image in cv2's
    conventions (``flag`` as in :func:`decode`).  4:4:4, 4:2:2 and 4:2:0
    colour is upsampled and converted as libjpeg (and so cv2) does; other
    subsamplings take nvJPEG's own conversion.  A one-component stream
    decoded in colour is its luma in three channels, as in cv2."""
    lib = _nvjpeg_lib()
    data = _as_bytes(buf)
    comps, w, h, _ = nvjpeg_info(data)
    if comps not in (1, 3):
        raise MXNetError("the nvJPEG path decodes 1- and 3-component "
                         "JPEGs, not %d" % comps)
    gray = flag == 0 or comps == 1
    out = np.empty((h, w) if gray else (h, w, 3), np.uint8)
    _nvjpeg_check(lib, lib.jpeg_decode(_device(device), data, len(data),
                                       int(gray), w, h,
                                       out.ctypes.data),
                  "decode")
    if gray and flag > 0:
        out = np.repeat(out[:, :, None], 3, axis=2)
    return out


# nvJPEG's chroma subsampling codes -> (horizontal, vertical) factors of
# the subsamplings the libjpeg conversion takes
_FACTORS = {0: (1, 1), 1: (2, 1), 2: (2, 2)}


def nvjpeg_planes(buf, device=None):
    """(Y, Cb, Cr, (hs, vs)) of a 4:4:4, 4:2:2 or 4:2:0 JPEG stream as
    nvJPEG decodes them, before upsampling: the input of the decode's
    colour conversion kernel."""
    lib = _nvjpeg_lib()
    data = _as_bytes(buf)
    comps, w, h, css = nvjpeg_info(data)
    if comps != 3 or css not in _FACTORS:
        raise MXNetError("nvjpeg_planes takes 3-component 4:4:4, 4:2:2 or "
                         "4:2:0 streams (components %d, subsampling code %d)"
                         % (comps, css))
    hs, vs = _FACTORS[css]
    cw, ch = -(-w // hs), -(-h // vs)
    y = np.empty((h, w), np.uint8)
    cb, cr = (np.empty((ch, cw), np.uint8) for _ in range(2))
    _nvjpeg_check(lib, lib.jpeg_decode_planes(
        _device(device), data, len(data), w, h, cw, ch, y.ctypes.data,
        cb.ctypes.data, cr.ctypes.data), "decode")
    return y, cb, cr, (hs, vs)


def plain_ycc_to_bgr(y, cb, cr, factors):
    """The plain version of ``csrc/jpeg_codec.cu``'s ycc_to_bgr_kernel, in
    numpy: libjpeg's fancy upsampling of the chroma planes subsampled by
    ``factors`` (hs, vs) in {(1, 1), (2, 1), (2, 2)} (jdsample.c), then its
    fixed-point YCbCr -> BGR conversion (jdcolor.c)."""
    hs, vs = factors
    h, w = y.shape

    def up(c):
        c = c.astype(np.int64)
        ch, cw = c.shape
        if hs == 1:
            return c[:h, :w]
        x = np.arange(w)
        xi = x >> 1
        xn = np.where(x & 1, np.minimum(xi + 1, cw - 1),
                      np.maximum(xi - 1, 0))
        if vs == 1:
            rows = c[:h]
            return (3 * rows[:, xi] + rows[:, xn]
                    + np.where(x & 1, 2, 1)) >> 2
        r = np.arange(h)
        yi = r >> 1
        yn = np.where(r & 1, np.minimum(yi + 1, ch - 1),
                      np.maximum(yi - 1, 0))
        col = 3 * c[yi] + c[yn]
        return (3 * col[:, xi] + col[:, xn] + np.where(x & 1, 7, 8)) >> 4

    cb, cr = up(cb) - 128, up(cr) - 128
    luma = y.astype(np.int64)
    half = 1 << 15
    bgr = np.stack([luma + ((116130 * cb + half) >> 16),
                    luma + ((-22554 * cb + half - 46802 * cr) >> 16),
                    luma + ((91881 * cr + half) >> 16)], 2)
    return np.clip(bgr, 0, 255).astype(np.uint8)


def nvjpeg_encode(img, quality=95, subsampling="420", device=None):
    """Encode a host image (HWC BGR or HW) as JPEG on the card at
    ``quality`` with chroma ``subsampling`` ("444", "422" or "420", cv2's
    default); returns the bytes."""
    lib = _nvjpeg_lib()
    arr = np.ascontiguousarray(img, dtype=np.uint8)
    if arr.ndim == 3 and arr.shape[2] == 1:
        arr = np.ascontiguousarray(arr[:, :, 0])
    if arr.ndim not in (2, 3) or (arr.ndim == 3 and arr.shape[2] != 3):
        raise MXNetError("nvJPEG encodes HW or HWC 3-channel images, not %s"
                         % (arr.shape,))
    if subsampling not in SUBSAMPLING:
        raise MXNetError("subsampling %r is not one of %s"
                         % (subsampling, sorted(SUBSAMPLING)))
    h, w = arr.shape[:2]
    channels = 1 if arr.ndim == 2 else 3
    capacity = 2 * arr.size + 65536
    while True:
        out = np.empty(capacity, np.uint8)
        n = ctypes.c_size_t(0)
        rc = lib.jpeg_encode(_device(device), arr.ctypes.data, w, h,
                             channels, int(quality), SUBSAMPLING[subsampling],
                             out.ctypes.data, capacity, ctypes.byref(n))
        if rc != -2:
            break
        capacity = n.value
    _nvjpeg_check(lib, rc, "encode")
    return out[:n.value].tobytes()


# ---------------------------------------------------------------------------
# Resize
# ---------------------------------------------------------------------------

_CUBIC_A = -0.75


def _taps(n_src, n_dst, interp):
    """(indices [n_dst, k], weights [n_dst, k]) of one axis under cv2's
    rule ``interp`` (0 nearest, 1 bilinear, 2 bicubic)."""
    scale = n_src / n_dst
    d = torch.arange(n_dst, dtype=torch.float64)
    if interp == 0:
        idx = torch.clamp(torch.floor(d * scale).long(), max=n_src - 1)
        return idx[:, None], torch.ones(n_dst, 1, dtype=torch.float64)
    # cv2 computes the source position in single precision
    pos = ((d + 0.5) * scale - 0.5).float().double()
    s = torch.floor(pos)
    t = pos - s
    s = s.long()
    if interp == 1:
        low = s < 0
        high = s >= n_src - 1
        t = torch.where(low | high, torch.zeros_like(t), t)
        s = torch.where(low, torch.zeros_like(s), s)
        s = torch.where(high, torch.full_like(s, n_src - 1), s)
        idx = torch.stack([s, s + 1], 1)
        w = torch.stack([1 - t, t], 1)
    else:
        a = _CUBIC_A
        x = t
        w0 = ((a * (x + 1) - 5 * a) * (x + 1) + 8 * a) * (x + 1) - 4 * a
        w1 = ((a + 2) * x - (a + 3)) * x * x + 1
        w2 = ((a + 2) * (1 - x) - (a + 3)) * (1 - x) * (1 - x) + 1
        w = torch.stack([w0, w1, w2, 1 - w0 - w1 - w2], 1)
        idx = torch.stack([s - 1, s, s + 1, s + 2], 1)
    return idx.clamp(0, n_src - 1), w


def torch_resize(img, w, h, interp=1):
    """``cv2.resize(img, (w, h), interpolation=interp)`` computed with torch
    on the host: cv2's nearest, bilinear and bicubic rules in float64,
    rounded half up and saturated for integer images.  Within a gray level
    of cv2 for bilinear and two for bicubic (cv2 rounds its coefficients
    to 11 bits); nearest is exact.  Like cv2, a one-channel result is HW."""
    if interp not in (0, 1, 2):
        raise MXNetError(
            "interpolation %r needs cv2, which does not import here; "
            "without it resize takes 0 (nearest), 1 (bilinear) or 2 "
            "(bicubic)" % (interp,))
    arr = np.asarray(img)
    squeeze = arr.ndim == 2 or arr.shape[2] == 1
    x = torch.from_numpy(np.ascontiguousarray(
        arr.reshape(arr.shape[0], arr.shape[1], -1))).double()
    for axis, (n_src, n_dst) in enumerate(((arr.shape[0], h),
                                           (arr.shape[1], w))):
        idx, wt = _taps(n_src, n_dst, interp)
        taps = x.index_select(axis, idx.reshape(-1))
        shape = (n_dst, idx.shape[1]) + tuple(x.shape[1:]) if axis == 0 \
            else (x.shape[0], n_dst, idx.shape[1], x.shape[2])
        taps = taps.reshape(shape)
        wshape = (n_dst, idx.shape[1], 1, 1) if axis == 0 \
            else (1, n_dst, idx.shape[1], 1)
        x = (taps * wt.reshape(wshape)).sum(axis + 1)
    if np.issubdtype(arr.dtype, np.integer):
        info = np.iinfo(arr.dtype)
        x = torch.floor(x + 0.5).clamp(info.min, info.max)
    out = x.numpy().astype(arr.dtype)
    return out[:, :, 0] if squeeze else out


def resize(img, w, h, interp=1):
    """``cv2.resize`` where cv2 imports, else :func:`torch_resize`."""
    cv2 = _cv2()
    if cv2 is not None:
        return cv2.resize(img, (w, h), interpolation=interp)
    return torch_resize(img, w, h, interp)

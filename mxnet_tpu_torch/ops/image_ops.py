"""Image operators: the ``_image_*`` family.

Counterpart of ``mxnet_tpu/ops/image_ops.py`` (ref: src/operator/image/
image_random.cc: to_tensor, normalize, the deterministic and random
flips, brightness/contrast/saturation/hue jitter, color jitter, PCA
lighting).  Each op is a torch function on the tensor's device.  The
random ones draw their factors from the port's generator of that device
(``random.generator``, seeded by ``mx.random.seed``) and carry
``needs_rng``; the bits differ from JAX's, the distributions are the JAX
package's: one factor (or coin, or permutation) per call, uniform on
``[min_factor, max_factor)``, and the lighting's three normal draws.

Layouts follow the reference: images are HWC (or NHWC batched),
``to_tensor`` turns them into CHW float32 in [0, 1], and ``normalize``
takes CHW (or NCHW).  The hue rotation of an integer image computes in
float32 (the JAX package casts its matrix to the image's integer type).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from .. import random as _random
from ..base import str_to_attr
from .registry import pFloat, register

# Rec. 601 luma weights: the reference's grayscale blend
_R, _G, _B = 0.299, 0.587, 0.114
# PCA lighting: ImageNet's eigenvalues and eigenvectors (the AlexNet
# paper's constants, as the reference's adjust_lighting documents them)
_EIGVAL = (55.46, 4.794, 1.148)
_EIGVEC = ((-0.5675, 0.7192, 0.4009),
           (-0.5808, -0.0045, -0.8140),
           (-0.5836, -0.6948, 0.4203))


def pFloatTuple(v):
    v = str_to_attr(v)
    if isinstance(v, (int, float)):
        return (float(v),)
    return tuple(float(x) for x in v)


def _generator(t):
    return _random.generator(t.device)


@functools.lru_cache(maxsize=256)
def _const(values, device, dtype=torch.float32):
    """The tensor (float32 unless ``dtype`` says) of the nested tuple
    ``values`` on ``device``, made once: its host-to-device copy cannot run
    inside a CUDA graph capture of a step that holds the op.  Callers never
    write it."""
    return torch.tensor(values, dtype=dtype, device=device)


def _uniform(data, lo, hi):
    """One f32 draw on ``[lo, hi)`` on ``data``'s device (none on meta
    tensors, where shape inference runs)."""
    out = torch.empty((), dtype=torch.float32, device=data.device)
    if data.device.type == "meta" or lo == hi:
        return out.fill_(lo) if data.device.type != "meta" else out
    return out.uniform_(lo, hi, generator=_generator(data))


def _coin(data):
    """A fair coin on ``data``'s device (a 0-dim bool tensor)."""
    if data.device.type == "meta":
        return torch.empty((), dtype=torch.bool, device=data.device)
    return torch.rand((), device=data.device,
                      generator=_generator(data)) < 0.5


def _to_tensor(data):
    """HWC [0, 255] -> CHW float32 [0, 1] (ref: _image_to_tensor)."""
    x = data.to(torch.float32) / 255.0
    if data.ndim == 3:
        return x.permute(2, 0, 1)
    return x.permute(0, 3, 1, 2)


register("_image_to_tensor", _to_tensor, num_inputs=1, input_names=["data"],
         doc="Convert an HWC uint8/float image to CHW float32 in [0,1].")


def _normalize(data, mean=(0.0,), std=(1.0,)):
    """(CHW - mean) / std, per channel (ref: _image_normalize)."""
    shape = (-1, 1, 1) if data.ndim == 3 else (1, -1, 1, 1)
    mean = _const(tuple(mean), data.device)
    std = _const(tuple(std), data.device)
    return (data - mean.reshape(shape)) / std.reshape(shape)


register("_image_normalize", _normalize, num_inputs=1, input_names=["data"],
         params={"mean": (pFloatTuple, (0.0,)), "std": (pFloatTuple, (1.0,))},
         doc="Normalize a CHW image with per-channel mean/std.")


def _flip_lr(data):
    return torch.flip(data, dims=(-2,))  # HWC / NHWC: the width axis


def _flip_tb(data):
    return torch.flip(data, dims=(-3,))  # HWC / NHWC: the height axis


register("_image_flip_left_right", _flip_lr, num_inputs=1,
         input_names=["data"])
register("_image_flip_top_bottom", _flip_tb, num_inputs=1,
         input_names=["data"])


def _random_flip_lr(data):
    return torch.where(_coin(data), _flip_lr(data), data)


def _random_flip_tb(data):
    return torch.where(_coin(data), _flip_tb(data), data)


register("_image_random_flip_left_right", _random_flip_lr, num_inputs=1,
         input_names=["data"], needs_rng=True)
register("_image_random_flip_top_bottom", _random_flip_tb, num_inputs=1,
         input_names=["data"], needs_rng=True)

_FACTORS = {"min_factor": (pFloat, 0.0), "max_factor": (pFloat, 0.0)}


def _brightness(data, alpha):
    return data * alpha


def _random_brightness(data, min_factor=0.0, max_factor=0.0):
    return _brightness(data, _uniform(data, min_factor, max_factor))


register("_image_random_brightness", _random_brightness, num_inputs=1,
         input_names=["data"], needs_rng=True, params=dict(_FACTORS))


def _gray(data):
    """Luma of an HWC/NHWC image, broadcastable back over channels."""
    r, g, b = data[..., 0], data[..., 1], data[..., 2]
    return (_R * r + _G * g + _B * b)[..., None]


def _contrast(data, alpha):
    return data * alpha + _gray(data).mean() * (1.0 - alpha)


def _saturation(data, alpha):
    return data * alpha + _gray(data) * (1.0 - alpha)


def _random_contrast(data, min_factor=0.0, max_factor=0.0):
    return _contrast(data, _uniform(data, min_factor, max_factor))


def _random_saturation(data, min_factor=0.0, max_factor=0.0):
    return _saturation(data, _uniform(data, min_factor, max_factor))


register("_image_random_contrast", _random_contrast, num_inputs=1,
         input_names=["data"], needs_rng=True, params=dict(_FACTORS))
register("_image_random_saturation", _random_saturation, num_inputs=1,
         input_names=["data"], needs_rng=True, params=dict(_FACTORS))

_HUE_BASE = ((0.299, 0.587, 0.114),) * 3
_HUE_COS = ((0.701, -0.587, -0.114),
            (-0.299, 0.413, -0.114),
            (-0.299, -0.587, 0.886))
_HUE_SIN = ((0.168, -0.331, 0.5),   # NTSC I/Q mixing terms
            (0.328, 0.035, -0.5),
            (-0.497, 0.296, 0.201))


def _hue_rotate(data, alpha):
    """Rotate the hue by ``alpha`` turns through the YIQ approximation the
    reference uses (image_random-inl.h RandomHue), folded into one
    RGB -> RGB matrix."""
    dev = data.device
    t = _const(_HUE_BASE, dev) + torch.cos(alpha * np.pi) \
        * _const(_HUE_COS, dev) + torch.sin(alpha * np.pi) \
        * _const(_HUE_SIN, dev)
    x = data if data.is_floating_point() else data.to(torch.float32)
    return torch.einsum("...c,dc->...d", x, t.to(x.dtype))


def _random_hue(data, min_factor=0.0, max_factor=0.0):
    return _hue_rotate(data, _uniform(data, min_factor, max_factor))


register("_image_random_hue", _random_hue, num_inputs=1,
         input_names=["data"], needs_rng=True, params=dict(_FACTORS))

# the JAX package's fixed set of orders, one drawn per call
_JITTER_ORDERS = ((0, 1, 2, 3), (3, 2, 1, 0), (1, 3, 0, 2), (2, 0, 3, 1))


def _random_color_jitter(data, brightness=0.0, contrast=0.0,
                         saturation=0.0, hue=0.0):
    """Brightness, contrast, saturation and hue jitter in one of four
    orders, drawn per call (the reference shuffles the order per call).
    The four factors are drawn once; every order is computed and the drawn
    one selected on the device, so the op reads nothing back to the host
    and a step that holds it can be captured as a CUDA graph (the JAX
    package's ``lax.switch``)."""
    alphas = (_uniform(data, 1 - brightness, 1 + brightness),
              _uniform(data, 1 - contrast, 1 + contrast),
              _uniform(data, 1 - saturation, 1 + saturation),
              _uniform(data, -hue, hue))
    fns = (_brightness, _contrast, _saturation, _hue_rotate)
    pick = torch.empty((), dtype=torch.int64, device=data.device)
    if data.device.type != "meta":
        pick.random_(len(_JITTER_ORDERS), generator=_generator(data))
    out = None
    for k, order in enumerate(_JITTER_ORDERS):
        x = data
        for i in order:
            x = fns[i](x, alphas[i])
        out = x if out is None else torch.where(pick == k, x, out)
    return out


register("_image_random_color_jitter", _random_color_jitter, num_inputs=1,
         input_names=["data"], needs_rng=True,
         params={"brightness": (pFloat, 0.0), "contrast": (pFloat, 0.0),
                 "saturation": (pFloat, 0.0), "hue": (pFloat, 0.0)})


def _lighting(data, alpha):
    """``data`` plus the PCA lighting offset of the three weights
    ``alpha`` (a float32 tensor on ``data``'s device)."""
    vec = _const(_EIGVEC, data.device)
    val = _const(_EIGVAL, data.device)
    return data + (vec @ (alpha * val)).to(data.dtype)


def _adjust_lighting(data, alpha=(0.0, 0.0, 0.0)):
    """Add PCA-based lighting noise (ref: _image_adjust_lighting)."""
    return _lighting(data, _const(tuple(alpha), data.device))


register("_image_adjust_lighting", _adjust_lighting, num_inputs=1,
         input_names=["data"],
         params={"alpha": (pFloatTuple, (0.0, 0.0, 0.0))})


def _random_lighting(data, alpha_std=0.05):
    alpha = torch.empty(3, dtype=torch.float32, device=data.device)
    if data.device.type != "meta":
        alpha.normal_(0.0, 1.0, generator=_generator(data))
    return _lighting(data, alpha * alpha_std)


register("_image_random_lighting", _random_lighting, num_inputs=1,
         input_names=["data"], needs_rng=True,
         params={"alpha_std": (pFloat, 0.05)})

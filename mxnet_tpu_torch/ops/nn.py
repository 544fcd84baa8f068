"""Neural-network operators (the serving and training slices).

Counterpart of part of ``mxnet_tpu/ops/nn.py``: ``log_softmax``,
``softmax``, ``SoftmaxActivation``, ``_PReLU``, ``FullyConnected`` (with
its two-way shape rule and ``flatten=False``), ``LeakyReLU`` (with the
exact-erf ``gelu``),
``LayerNorm``, ``InstanceNorm``, ``L2Normalization``, ``LRN``,
``Dropout``, ``Embedding``, the conv-net ops ``Convolution``,
``Deconvolution``, ``Activation``, ``Pooling``, ``BatchNorm`` and
``SoftmaxOutput``, the losses ``softmax_cross_entropy`` and
``MakeLoss``, the regression heads and ``SVMOutput``, the sequence ops
and ``UpSampling``.  Products and convolutions are plain ``torch``
calls: the JAX package leaves them to XLA, and the port leaves them to
cuBLAS and cuDNN.  Where the JAX package has a Pallas kernel, the port's
op is a ``torch.autograd.Function`` around the hand-written kernel of
``kernels.py``: BatchNorm's training statistics and their backward pair
(``bn_channel_sums``), and the max/avg pooling input gradients.  Outside
the reference's own eligibility for those kernels, torch autograd
differentiates the plain forward, as XLA's autodiff does there.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError, dtype_name
from .. import random as _random
from . import kernels as _kernels
from .registry import (pAny, pBool, pDtype, pFloat, pInt, pShape, pStr,
                       register)


def _log_softmax(x, axis=-1, temperature=None):
    if temperature:
        x = x / temperature
    return torch.log_softmax(x, dim=int(axis))


register("log_softmax", _log_softmax, num_inputs=1,
         params={"axis": (pAny, -1), "temperature": (pAny, None)})


def _softmax(x, axis=-1, temperature=None):
    if temperature is not None and temperature != 1.0:
        x = x / temperature
    return torch.softmax(x, dim=int(axis))


register("softmax", _softmax, num_inputs=1,
         params={"axis": (pAny, -1), "temperature": (pAny, None)})


def _softmax_activation(x, mode="instance"):
    if mode == "channel":
        return torch.softmax(x, dim=1)
    return torch.softmax(x.reshape(x.shape[0], -1), dim=-1).reshape(x.shape)


register("SoftmaxActivation", _softmax_activation, num_inputs=1,
         params={"mode": (pStr, "instance")})


def _prelu(x, gamma):
    g = gamma.reshape((1, -1) + (1,) * (x.ndim - 2)) if x.ndim > 1 else gamma
    return torch.where(x > 0, x, g * x)


register("_PReLU", _prelu, num_inputs=2)


def _dropout(data, p=0.5, mode="training", axes=None, _train=False):
    """Inverted dropout: in training (or ``mode='always'``) keep each
    element (or each slice along the axes not in ``axes``) with
    probability 1 - p and scale by 1 / (1 - p).  The mask is drawn from the
    device's generator (``mx.random.seed``), so it differs from the JAX
    package's bits."""
    if (not _train and mode != "always") or p <= 0.0:
        return data
    shape = data.shape
    if axes:
        shape = tuple(1 if i in axes else n for i, n in enumerate(shape))
    keep = 1.0 - p
    mask = torch.rand(shape, device=data.device,
                      generator=_random.generator(data.device)) < keep
    return data * (mask.to(data.dtype) / keep)


register("Dropout", _dropout, num_inputs=1, takes_train_flag=True,
         needs_rng=True,
         params={"p": (pFloat, 0.5), "mode": (pStr, "training"),
                 "axes": (pShape, None)})


def _leaky_relu(x, act_type="leaky", slope=0.25, lower_bound=0.125,
                upper_bound=0.334):
    if act_type in ("leaky", "rrelu"):  # rrelu uses mean slope at inference
        s = slope if act_type == "leaky" else (lower_bound + upper_bound) / 2.0
        return torch.where(x > 0, x, s * x)
    if act_type == "elu":
        return torch.where(x > 0, x, slope * torch.expm1(x))
    if act_type == "selu":
        alpha, scale = 1.6732632423543772, 1.0507009873554805
        return scale * torch.where(x > 0, x, alpha * torch.expm1(x))
    if act_type == "gelu":  # exact erf form (transformer FFN activation)
        return 0.5 * x * (1.0 + torch.erf(x * (1.0 / math.sqrt(2.0))))
    raise MXNetError("unknown LeakyReLU act_type %s" % act_type)


register("LeakyReLU", _leaky_relu, num_inputs=1,
         params={"act_type": (pStr, "leaky"), "slope": (pFloat, 0.25),
                 "lower_bound": (pFloat, 0.125),
                 "upper_bound": (pFloat, 0.334)})


# set inside ``row_independent_products()``
_ROW_PRODUCTS = contextvars.ContextVar("row_products", default=False)


@contextlib.contextmanager
def row_independent_products():
    """Inside the block, ``FullyConnected`` on host tensors computes each
    row's product on its own: one (1, K) x (K, N) product a row, batched
    by ``torch.bmm``.  The host BLAS's product of a few rows may give one
    row other bits than the others for the same input row (at 4 rows,
    row 0 differs from rows 1-3 in the last bit), so a row's bits would
    depend on its place in the batch.  A step that promises each row the
    bits it gets alone (the continuous batcher's slots) runs here.  On the
    card cuBLAS gives every row the same bits at these shapes, and the
    product stays one GEMM."""
    token = _ROW_PRODUCTS.set(True)
    try:
        yield
    finally:
        _ROW_PRODUCTS.reset(token)


def _fully_connected(data, weight, *rest, num_hidden=1, no_bias=False,
                     flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten or data.ndim == 2 \
        else data
    if _ROW_PRODUCTS.get() and x.device.type == "cpu":
        rows = x.reshape(-1, 1, x.shape[-1])
        wt = weight.t()
        out = torch.bmm(rows, wt.expand(rows.shape[0], *wt.shape)) \
            .reshape(*x.shape[:-1], wt.shape[1])
    else:
        out = torch.matmul(x, weight.t())
    if not no_bias:
        out = out + rest[0]
    return out


def _fc_infer_shape(in_shapes, attrs, out_shapes=None):
    num_hidden = int(attrs["num_hidden"])
    no_bias = attrs.get("no_bias", False)
    flatten = attrs.get("flatten", True)
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    filled = list(in_shapes)
    # backward inference: heal unknown (0) leading data dims from a known
    # output shape (the reference's pass is bidirectional)
    out = out_shapes[0] if out_shapes else None
    if out is not None and any(int(d) == 0 for d in dshape):
        if flatten or len(dshape) == 2:
            if int(dshape[0]) == 0 and int(out[0]) != 0:
                dshape = (int(out[0]),) + tuple(dshape[1:])
        elif len(out) == len(dshape):
            dshape = tuple(int(o) if int(d) == 0 and int(o) != 0 else int(d)
                           for d, o in zip(dshape[:-1], out[:-1])) \
                + (dshape[-1],)
        filled[0] = dshape
    if flatten or len(dshape) == 2:
        in_dim = math.prod(int(d) for d in dshape[1:])
        unknown = any(int(d) == 0 for d in dshape[1:])
    else:
        in_dim = int(dshape[-1])
        unknown = in_dim == 0  # middle dims don't affect the weight shape
    if not unknown:
        filled[1] = (num_hidden, in_dim)
    if not no_bias:
        filled[2] = (num_hidden,)
    oshape = (dshape[0], num_hidden) if (flatten or len(dshape) == 2) \
        else tuple(dshape[:-1]) + (num_hidden,)
    return filled, [oshape]


register("FullyConnected", _fully_connected,
         input_names=("data", "weight", "bias"),
         infer_shape=_fc_infer_shape, bidirectional_infer=True,
         params={"num_hidden": (pInt, 1), "no_bias": (pBool, False),
                 "flatten": (pBool, True)})


def _layer_norm(data, gamma, beta, axis=-1, eps=1e-5, output_mean_var=False):
    mean = torch.mean(data, dim=axis, keepdim=True)
    var = torch.mean(torch.square(data - mean), dim=axis, keepdim=True)
    out = (data - mean) * torch.rsqrt(var + eps)
    bshape = [1] * data.ndim
    bshape[axis] = data.shape[axis]
    out = out * gamma.reshape(bshape) + beta.reshape(bshape)
    if output_mean_var:
        return out, mean.squeeze(axis), var.squeeze(axis)
    return out


def _ln_infer_shape(in_shapes, attrs):
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, None
    axis = int(attrs.get("axis", -1))
    c = dshape[axis]
    filled = [dshape, (c,), (c,)]
    if attrs.get("output_mean_var"):
        red = tuple(s for i, s in enumerate(dshape)
                    if i != (axis % len(dshape)))
        return filled, [dshape, red, red]
    return filled, [dshape]


register("LayerNorm", _layer_norm, input_names=("data", "gamma", "beta"),
         infer_shape=_ln_infer_shape,
         num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1,
         params={"axis": (pInt, -1), "eps": (pFloat, 1e-5),
                 "output_mean_var": (pBool, False)})


def _embedding(data, weight, input_dim=1, output_dim=1, dtype="float32",
               sparse_grad=False):
    return torch.nn.functional.embedding(data.to(torch.int64), weight)


def _embedding_infer_shape(in_shapes, attrs):
    dshape = in_shapes[0]
    filled = list(in_shapes)
    filled[1] = (int(attrs["input_dim"]), int(attrs["output_dim"]))
    if dshape is None:
        return filled, [None]
    return filled, [tuple(dshape) + (int(attrs["output_dim"]),)]


register("Embedding", _embedding, input_names=("data", "weight"),
         infer_shape=_embedding_infer_shape,
         params={"input_dim": (pInt, 1), "output_dim": (pInt, 1),
                 "dtype": (pDtype, "float32"), "sparse_grad": (pBool, False)})


# ---------------------------------------------------------------------------
# Activation
# ---------------------------------------------------------------------------


def _relu(x):
    # jnp.maximum(x, 0), whose gradient at x == 0 is 0.5; torch.maximum
    # splits a tie the same way (torch.relu would give 0 there)
    return torch.maximum(x, torch.zeros((), dtype=x.dtype, device=x.device))


_ACTS = {
    "relu": _relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softrelu": F.softplus,
    "softsign": F.softsign,
}


def _activation(x, act_type="relu"):
    return _ACTS[act_type](x)


register("Activation", _activation, num_inputs=1,
         params={"act_type": (pStr, "relu")})


# ---------------------------------------------------------------------------
# Convolution (cuDNN; the JAX package leaves it to XLA)
# ---------------------------------------------------------------------------

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _convolution(data, weight, *rest, kernel=(1, 1), stride=None,
                 dilate=None, pad=None, num_filter=1, num_group=1,
                 no_bias=False, workspace=1024, cudnn_tune=None,
                 cudnn_off=False, layout=None, _train=False):
    nd = len(kernel)
    return _CONV[nd](data, weight, None if no_bias else rest[0],
                     stride=tuple(stride or (1,) * nd),
                     padding=tuple(pad or (0,) * nd),
                     dilation=tuple(dilate or (1,) * nd),
                     groups=int(num_group))


def _conv_out_dim(d, k, s, p, dil):
    return (d + 2 * p - (dil * (k - 1) + 1)) // s + 1


def _conv_infer_shape(in_shapes, attrs):
    kernel = attrs["kernel"]
    nd = len(kernel)
    stride = attrs.get("stride") or (1,) * nd
    dilate = attrs.get("dilate") or (1,) * nd
    pad = attrs.get("pad") or (0,) * nd
    num_filter = int(attrs["num_filter"])
    num_group = int(attrs.get("num_group", 1))
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    filled = list(in_shapes)
    filled[1] = (num_filter, dshape[1] // num_group) + tuple(kernel)
    if not attrs.get("no_bias", False):
        filled[2] = (num_filter,)
    spatial = tuple(_conv_out_dim(dshape[2 + i], kernel[i], stride[i],
                                  pad[i], dilate[i]) for i in range(nd))
    return filled, [(dshape[0], num_filter) + spatial]


register("Convolution", _convolution, input_names=("data", "weight", "bias"),
         infer_shape=_conv_infer_shape, takes_train_flag=True,
         aliases=("Convolution_v1",),
         params={"kernel": (pShape, (1, 1)), "stride": (pShape, None),
                 "dilate": (pShape, None), "pad": (pShape, None),
                 "num_filter": (pInt, 1), "num_group": (pInt, 1),
                 "no_bias": (pBool, False), "workspace": (pInt, 1024),
                 "cudnn_tune": (pStr, None), "cudnn_off": (pBool, False),
                 "layout": (pStr, None)})


# ---------------------------------------------------------------------------
# Deconvolution: the transposed convolution (cuDNN), with the reference's
# crop semantics out = (in - 1) * s + ke - 2 * pad + adj, ke the dilated
# kernel extent, and ``target_shape`` overriding pad and adj
# ---------------------------------------------------------------------------

_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


def _deconv_pad_adj(in_spatial, ke, stride, pad, adj, target_shape):
    """Effective (pad, adj) per spatial dim.  target_shape overrides both
    with a centered crop (ref: deconvolution-inl.h InferPad — total =
    s(i-1)+ke-t, pad=(total+1)/2, adj=total%2)."""
    if not target_shape:
        return tuple(pad), (tuple(adj) if adj else (0,) * len(ke))
    pads, adjs = [], []
    for t, i, s, k in zip(target_shape, in_spatial, stride, ke):
        total = s * (int(i) - 1) + k - int(t)
        if total < 0:
            raise MXNetError("Deconvolution: target_shape %s exceeds the "
                             "full output size" % (tuple(target_shape),))
        adjs.append(total % 2)
        pads.append((total + 1) // 2)
    return tuple(pads), tuple(adjs)


def _deconvolution(data, weight, *rest, kernel=(1, 1), stride=None,
                   dilate=None, pad=None, adj=None, target_shape=None,
                   num_filter=1, num_group=1, no_bias=True, workspace=1024,
                   cudnn_tune=None, cudnn_off=False, layout=None):
    nd = len(kernel)
    stride = tuple(stride or (1,) * nd)
    dilate = tuple(dilate or (1,) * nd)
    ke = [(k - 1) * d + 1 for k, d in zip(kernel, dilate)]
    pad, adj = _deconv_pad_adj(data.shape[2:], ke, stride,
                               tuple(pad or (0,) * nd), adj, target_shape)
    # the weight is (C_in, num_filter / g, k...), torch's layout for a
    # transposed convolution
    return _CONV_T[nd](data, weight, None if no_bias else rest[0],
                       stride=stride, padding=pad, output_padding=adj,
                       groups=int(num_group), dilation=dilate)


def _deconv_infer_shape(in_shapes, attrs):
    kernel = attrs["kernel"]
    nd = len(kernel)
    stride = attrs.get("stride") or (1,) * nd
    dilate = attrs.get("dilate") or (1,) * nd
    pad = attrs.get("pad") or (0,) * nd
    num_filter = int(attrs["num_filter"])
    num_group = int(attrs.get("num_group", 1))
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    filled = list(in_shapes)
    filled[1] = (dshape[1], num_filter // num_group) + tuple(kernel)
    if not attrs.get("no_bias", True):
        filled[2] = (num_filter,)
    ke = [(kernel[i] - 1) * dilate[i] + 1 for i in range(nd)]
    pad_eff, adj_eff = _deconv_pad_adj(dshape[2:], ke, stride, pad,
                                       attrs.get("adj"),
                                       attrs.get("target_shape"))
    spatial = tuple(stride[i] * (dshape[2 + i] - 1) + ke[i]
                    - 2 * pad_eff[i] + adj_eff[i] for i in range(nd))
    return filled, [(dshape[0], num_filter) + spatial]


register("Deconvolution", _deconvolution,
         input_names=("data", "weight", "bias"),
         infer_shape=_deconv_infer_shape,
         params={"kernel": (pShape, (1, 1)), "stride": (pShape, None),
                 "dilate": (pShape, None), "pad": (pShape, None),
                 "adj": (pShape, None), "target_shape": (pShape, None),
                 "num_filter": (pInt, 1), "num_group": (pInt, 1),
                 "no_bias": (pBool, True), "workspace": (pInt, 1024),
                 "cudnn_tune": (pStr, None), "cudnn_off": (pBool, False),
                 "layout": (pStr, None)})


# ---------------------------------------------------------------------------
# Pooling.  The forward pads explicitly with the reference's (lo, hi) pads
# (``pooling_convention="full"`` widens only the right pad, which is not
# torch's ceil_mode) and pools with padding 0.
# ---------------------------------------------------------------------------


def _pool_spatial_pads(spatial, kernel, stride, pad, convention):
    """Per-axis (lo, hi) spatial padding honoring the 'full' ceil mode
    (widen the right pad so ceil division is covered)."""
    if convention != "full":
        return tuple((p, p) for p in pad)
    pads = []
    for d, k, s, p in zip(spatial, kernel, stride, pad):
        out_full = int(np.ceil((d + 2 * p - k) / s)) + 1
        needed = (out_full - 1) * s + k - d - p
        pads.append((p, max(needed, p)))
    return tuple(pads)


def _pool_out_dim(d, k, s, p, convention):
    span = d + 2 * p - k
    return (int(np.ceil(span / s)) if convention == "full"
            else span // s) + 1


@functools.lru_cache(maxsize=256)
def _pool_window_counts(spatial, kernel, stride, pads, out_shape, device):
    """(OH, ...) float32 map of valid (non-padded) elements per window,
    at least 1 — the count_include_pad=False divisor.  Built once per
    geometry and device: its host-to-device copy cannot run inside a
    CUDA graph capture, and a step reads the same map every time.
    Callers never write it."""
    cnt = None
    for d, k, s, (lo, _), o in zip(spatial, kernel, stride, pads, out_shape):
        start = np.arange(o) * s - lo
        axis = np.clip(start + k, 0, d) - np.clip(start, 0, d)
        cnt = axis if cnt is None else np.multiply.outer(cnt, axis)
    return torch.from_numpy(np.maximum(cnt, 1).astype(np.float32)).to(device)


def _pool_forward(x, pool_type, kernel, stride, pads, count_include_pad):
    nd = len(kernel)
    flat = [p for lo_hi in reversed(pads) for p in lo_hi]  # F.pad order
    if pool_type == "max":
        fill = float("-inf") if x.is_floating_point() \
            else torch.iinfo(x.dtype).min
        xp = F.pad(x, flat, value=fill)
        return (F.max_pool1d, F.max_pool2d, F.max_pool3d)[nd - 1](
            xp, kernel, stride)
    xp = F.pad(x, flat)
    if nd == 1:  # avg_pool1d has no divisor_override
        total = F.avg_pool2d(xp.unsqueeze(-2), (1,) + kernel, (1,) + stride,
                             divisor_override=1).squeeze(-2)
    else:
        total = (F.avg_pool2d, F.avg_pool3d)[nd - 2](
            xp, kernel, stride, divisor_override=1)
    if pool_type == "sum":
        return total
    if count_include_pad:
        n = float(math.prod(kernel))
        if total.dtype in (torch.float32, torch.float64):
            # a device scalar: the card multiplies by the reciprocal of a
            # host scalar, which is not the host's (IEEE) division
            n = torch.full((), n, dtype=total.dtype, device=total.device)
        return (total / n).to(x.dtype)
    cnt = _pool_window_counts(tuple(x.shape[2:]), kernel, stride, pads,
                              tuple(total.shape[2:]), x.device)
    return (total / cnt).to(x.dtype)


def _make_pool_divisor(pool_type, count_include_pad, x_shape, kernel,
                       stride, pads, out_shape, device,
                       dtype=torch.float32):
    """The (OH, OW) map each pooling cotangent is multiplied by, in
    ``dtype`` (float32, or float64 for float64 data)."""
    if pool_type == "sum":
        return torch.ones(out_shape, dtype=dtype, device=device)
    if count_include_pad:
        return torch.full(out_shape, 1.0 / float(math.prod(kernel)),
                          dtype=dtype, device=device)
    return 1.0 / _pool_window_counts(tuple(x_shape[2:]), kernel, stride,
                                     pads, out_shape, device).to(dtype)


# The backward of every step reads the same map: built once per geometry
# and device, so a step launches no fill for it.  Callers never write it.
_pool_divisor = functools.lru_cache(maxsize=256)(_make_pool_divisor)


class _PoolFn(torch.autograd.Function):
    """2-D pooling whose input gradient is the hand-written kernel
    (``max_pool_backward`` recomputes the argmax from the saved input;
    ``avg_pool_backward`` never reads it)."""

    @staticmethod
    def forward(ctx, x, pool_type, kernel, stride, pads, count_include_pad):
        out = _pool_forward(x, pool_type, kernel, stride, pads,
                            count_include_pad)
        ctx.cfg = (pool_type, kernel, stride, pads, count_include_pad)
        ctx.x_meta = (tuple(x.shape), x.dtype)
        if pool_type == "max":
            ctx.save_for_backward(x)
        return out

    @staticmethod
    def backward(ctx, dy):
        pool_type, kernel, stride, pads, count_include_pad = ctx.cfg
        x_shape, x_dtype = ctx.x_meta
        if pool_type == "max":
            (x,) = ctx.saved_tensors
            dx = _kernels.max_pool_backward(x, dy.to(x_dtype), kernel,
                                            stride, pads)
        else:
            div = _pool_divisor(pool_type, count_include_pad, x_shape,
                                kernel, stride, pads, tuple(dy.shape[2:]),
                                dy.device, _kernels._acc_dtype(x_dtype))
            dx = _kernels.avg_pool_backward(dy.to(x_dtype), div, x_shape,
                                            kernel, stride, pads, x_dtype)
        return dx, None, None, None, None, None


def _pooling(data, pool_type="max", kernel=(1, 1), stride=None, pad=None,
             global_pool=False, pooling_convention="valid", cudnn_off=False,
             count_include_pad=True):
    if global_pool:
        kernel = tuple(data.shape[2:])
        stride = (1,) * len(kernel)
        pad = (0,) * len(kernel)
    kernel = tuple(int(k) for k in kernel)
    nd = len(kernel)
    stride = tuple(stride or (1,) * nd)
    pad = tuple(pad or (0,) * nd)
    if pool_type not in ("max", "avg", "sum"):
        raise MXNetError("unknown pool_type %s" % pool_type)
    pads = _pool_spatial_pads(tuple(data.shape[2:]), kernel, stride, pad,
                              str(pooling_convention))
    # the reference's kernel eligibility (ops/nn.py:531-535)
    if data.ndim == 4 and nd == 2 and data.is_floating_point() \
            and math.prod(kernel) <= _kernels.MAX_POOL_TAPS:
        return _PoolFn.apply(data, pool_type, kernel, stride, pads,
                             bool(count_include_pad))
    return _pool_forward(data, pool_type, kernel, stride, pads,
                         bool(count_include_pad))


def _pool_infer_shape(in_shapes, attrs):
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    kernel = attrs["kernel"]
    nd = len(kernel)
    if attrs.get("global_pool", False):
        return in_shapes, [tuple(dshape[:2]) + (1,) * (len(dshape) - 2)]
    stride = attrs.get("stride") or (1,) * nd
    pad = attrs.get("pad") or (0,) * nd
    conv = attrs.get("pooling_convention", "valid")
    return in_shapes, [tuple(dshape[:2]) + tuple(
        _pool_out_dim(dshape[2 + i], kernel[i], stride[i], pad[i], conv)
        for i in range(nd))]


register("Pooling", _pooling, num_inputs=1, infer_shape=_pool_infer_shape,
         aliases=("Pooling_v1",),
         params={"pool_type": (pStr, "max"), "kernel": (pShape, (1, 1)),
                 "stride": (pShape, None), "pad": (pShape, None),
                 "global_pool": (pBool, False),
                 "pooling_convention": (pStr, "valid"),
                 "cudnn_off": (pBool, False),
                 "count_include_pad": (pBool, True)})


# ---------------------------------------------------------------------------
# BatchNorm.  Inputs data, gamma, beta; aux moving_mean, moving_var.  The
# impl returns (out[, mean, var], new_moving_mean, new_moving_var); the
# last two are state outputs the executor writes back into the aux arrays.
# ---------------------------------------------------------------------------


def _bn_affine(x, g, b, mean, inv, bshape):
    """y = x*A + B with per-channel A = g*inv, B = b - mean*g*inv, in f32,
    cast to x's dtype (the reference's scale/shift form)."""
    g32 = g.float()
    a = (g32 * inv).reshape(bshape)
    shift = (b.float() - mean * g32 * inv).reshape(bshape)
    return (x.float() * a + shift).to(x.dtype)


class _BNTrainFn(torch.autograd.Function):
    """Training-mode BatchNorm over NCHW with the reference's hand-written
    backward (``_bn_train_core``): one-pass f32 statistics
    ``E[x^2] - E[x]^2`` from one ``bn_channel_sums`` call, and a backward
    that takes ``(sum dy, sum dy*x)`` from one more, including the
    cotangents of the returned batch mean and variance."""

    @staticmethod
    def forward(ctx, x, g, b, eps):
        n, c, h, w = x.shape
        count = n * h * w
        s1, s2 = _kernels.bn_channel_sums(x)
        mean = s1 / count
        var = torch.clamp_min(s2 / count - mean * mean, 0.0)
        inv = torch.rsqrt(var + eps)
        ctx.save_for_backward(x, g, mean, inv)
        return _bn_affine(x, g, b, mean, inv, (1, c, 1, 1)), mean, var

    @staticmethod
    def backward(ctx, dy, dmean, dvar):
        x, g, mean, inv = ctx.saved_tensors
        n, c, h, w = x.shape
        count = n * h * w
        bshape = (1, c, 1, 1)
        # one fused pass: sum dy*(x - mean) = sum dy*x - mean*sum dy
        sum_dy, sum_dy_x = _kernels.bn_channel_sums(dy.to(x.dtype), x)
        sum_dy_xc = sum_dy_x - mean * sum_dy
        xc = x.float() - mean.reshape(bshape)
        g32 = g.float()
        dx = (g32 * inv).reshape(bshape) * (
            dy.float() - (sum_dy / count).reshape(bshape)
            - xc * (inv * inv * sum_dy_xc / count).reshape(bshape))
        dx = dx + (dmean / count).reshape(bshape) \
            + xc * (2.0 * dvar / count).reshape(bshape)
        return (dx.to(x.dtype), (sum_dy_xc * inv).to(g.dtype),
                sum_dy.to(g.dtype), None)


def _bn_train_plain(x, g, b, ax, eps):
    """Training-mode BatchNorm outside the kernel's NCHW domain, in plain
    torch ops that autograd differentiates."""
    red = tuple(i for i in range(x.ndim) if i != ax)
    bshape = tuple(-1 if i == ax else 1 for i in range(x.ndim))
    x32 = x.float()
    mean = x32.mean(dim=red)
    var = torch.clamp_min((x32 * x32).mean(dim=red) - mean * mean, 0.0)
    inv = torch.rsqrt(var + eps)
    return _bn_affine(x, g, b, mean, inv, bshape), mean, var


def _inv_std(var, eps):
    """Inference BatchNorm's ``1 / sqrt(var + eps)`` in f32, rounded the
    same on every device.  int8 serving rounds what BatchNorm feeds it,
    so one ulp here flips int8 steps between card and host.  The card's
    ``torch.rsqrt`` is within 2 ulp, and the host's f32 ``torch.sqrt``
    misrounds some values; the f64 square root rounded to f32 is the
    correctly rounded f32 one, and the reciprocal an IEEE division."""
    return torch.sqrt((var + eps).double()).float().reciprocal()


def _batch_norm(data, gamma, beta, moving_mean, moving_var, eps=1e-3,
                momentum=0.9, fix_gamma=True, use_global_stats=False,
                output_mean_var=False, axis=1, cudnn_off=False, _train=False):
    ax = int(axis) % data.ndim
    bshape = tuple(data.shape[ax] if i == ax else 1 for i in range(data.ndim))
    g = torch.ones_like(gamma) if fix_gamma else gamma
    if _train and not use_global_stats:
        # the reference's kernel eligibility (ops/nn.py:679-682)
        if data.ndim == 4 and ax == 1 and data.is_floating_point():
            out, mean, var = _BNTrainFn.apply(data, g, beta, float(eps))
        else:
            out, mean, var = _bn_train_plain(data, g, beta, ax, float(eps))
        with torch.no_grad():  # the moving statistics take no gradient
            new_mm = moving_mean * momentum \
                + mean.to(moving_mean.dtype) * (1 - momentum)
            new_mv = moving_var * momentum \
                + var.to(moving_var.dtype) * (1 - momentum)
    else:
        mean, var = moving_mean.float(), moving_var.float()
        new_mm, new_mv = moving_mean, moving_var
        inv = _inv_std(var, eps)
        out = (data.float() - mean.reshape(bshape)) * inv.reshape(bshape)
        out = (out.to(data.dtype) * g.reshape(bshape)
               + beta.reshape(bshape)).to(data.dtype)
    if output_mean_var:
        return (out, mean.to(data.dtype), var.to(data.dtype), new_mm,
                new_mv)
    return out, new_mm, new_mv


def _bn_infer_type(in_dtypes, attrs):
    """gamma/beta/moving stats stay float32 when data is half-width."""
    d = in_dtypes[0]
    if d is None:
        return in_dtypes, None
    pt = "float32" if dtype_name(d) in ("float16", "bfloat16") else d
    filled = [d, pt, pt, pt, pt][:len(in_dtypes)]
    n_out = 3 if attrs.get("output_mean_var") else 1
    return filled, [d] * n_out


def _bn_infer_shape(in_shapes, attrs):
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    ax = int(attrs.get("axis", 1)) % len(dshape)
    c = (dshape[ax],)
    filled = [dshape] + [c, c, c, c]
    if attrs.get("output_mean_var"):
        return filled, [dshape, c, c, c, c]
    return filled, [dshape, c, c]


register("BatchNorm", _batch_norm,
         input_names=("data", "gamma", "beta"),
         aux_names=("moving_mean", "moving_var"),
         num_outputs=lambda attrs: 3 if attrs.get("output_mean_var") else 1,
         mutate_map=(3, 4), takes_train_flag=True,
         infer_shape=_bn_infer_shape, infer_type=_bn_infer_type,
         aliases=("BatchNorm_v1",),
         params={"eps": (pFloat, 1e-3), "momentum": (pFloat, 0.9),
                 "fix_gamma": (pBool, True),
                 "use_global_stats": (pBool, False),
                 "output_mean_var": (pBool, False), "axis": (pInt, 1),
                 "cudnn_off": (pBool, False)})


def _instance_norm(data, gamma, beta, eps=1e-3):
    axes = tuple(range(2, data.ndim))
    mean = torch.mean(data, dim=axes, keepdim=True)
    var = torch.var(data, dim=axes, keepdim=True, correction=0)
    bshape = (1, -1) + (1,) * (data.ndim - 2)
    out = (data - mean) * torch.rsqrt(var + eps)
    return out * gamma.reshape(bshape) + beta.reshape(bshape)


def _in_infer_shape(in_shapes, attrs):
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    return [dshape, (dshape[1],), (dshape[1],)], [dshape]


register("InstanceNorm", _instance_norm,
         input_names=("data", "gamma", "beta"),
         infer_shape=_in_infer_shape, params={"eps": (pFloat, 1e-3)})


def _l2_normalization(data, eps=1e-10, mode="instance"):
    if mode == "instance":
        n = torch.sqrt(torch.sum(torch.square(
            data.reshape(data.shape[0], -1)), dim=1) + eps)
        return data / n.reshape((-1,) + (1,) * (data.ndim - 1))
    # "channel", and "spatial" as the reference computes it: over axis 1
    return data / torch.sqrt(torch.sum(torch.square(data), dim=1,
                                       keepdim=True) + eps)


register("L2Normalization", _l2_normalization, num_inputs=1,
         params={"eps": (pFloat, 1e-10), "mode": (pStr, "instance")})


def _lrn(data, alpha=1e-4, beta=0.75, knorm=2.0, nsize=5):
    """Local response normalization across channels: data / (knorm +
    alpha * the sum of squares over the nsize channels around each)."""
    sq = torch.square(data)
    half = int(nsize) // 2
    padded = F.pad(sq, (0, 0, 0, 0, half, half))
    window = torch.zeros_like(sq)
    for i in range(int(nsize)):
        window = window + padded[:, i:i + sq.shape[1]]
    return data / torch.pow(knorm + alpha * window, beta)


register("LRN", _lrn, num_inputs=1,
         params={"alpha": (pFloat, 1e-4), "beta": (pFloat, 0.75),
                 "knorm": (pFloat, 2.0), "nsize": (pInt, 5)})


# ---------------------------------------------------------------------------
# SoftmaxOutput: the loss head.  Its backward ignores the head gradient and
# is (softmax - onehot) * grad_scale with the reference's ignore_label and
# normalization (ref: softmax_output-inl.h).
# ---------------------------------------------------------------------------


def _softmax_fwd(data, multi_output, preserve_shape):
    if multi_output:
        return torch.softmax(data, dim=1)
    if preserve_shape:
        return torch.softmax(data, dim=-1)
    return torch.softmax(data.reshape(data.shape[0], -1),
                         dim=-1).reshape(data.shape)


def _one_hot(lab, k, axis, dtype):
    """One-hot along ``axis``; labels outside [0, k) give a zero row (as
    ``jax.nn.one_hot`` does), so an ignored -1 label is safe."""
    classes = torch.arange(k, device=lab.device)
    shape = [1] * (lab.ndim + 1)
    shape[axis] = k
    return (lab.unsqueeze(axis) == classes.reshape(shape)).to(dtype)


def _softmax_output_grad(out, label, grad_scale, ignore_label, use_ignore,
                         normalization, multi_output):
    lab = label.to(torch.int64)
    if multi_output:  # data (n, k, x...), label (n, x...)
        grad = out - _one_hot(lab, out.shape[1], 1, out.dtype)
        expand = (slice(None), None)
    else:
        onehot = _one_hot(lab, out.shape[-1], lab.ndim, out.dtype)
        grad = out - onehot.reshape(out.shape)
        expand = (Ellipsis,) + (None,) * (grad.ndim - lab.ndim)
    valid = torch.ones(lab.shape, dtype=out.dtype, device=out.device)
    if use_ignore:
        valid = (label != ignore_label).to(out.dtype)
        grad = grad * valid[expand]
    if normalization == "batch":
        grad = grad / out.shape[0]
    elif normalization == "valid":
        grad = grad / torch.clamp_min(valid.sum(), 1.0)
    return grad * grad_scale


class _SoftmaxOutputFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, data, label, cfg):
        out = _softmax_fwd(data, cfg[4], cfg[5])
        ctx.save_for_backward(out, label)
        ctx.cfg = cfg
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, label = ctx.saved_tensors
        grad = _softmax_output_grad(out, label, *ctx.cfg[:5])
        return grad.to(out.dtype), None, None


def _softmax_output(data, label, grad_scale=1.0, ignore_label=-1.0,
                    multi_output=False, use_ignore=False,
                    preserve_shape=False, normalization="null",
                    out_grad=False, smooth_alpha=0.0):
    cfg = (float(grad_scale), float(ignore_label), bool(use_ignore),
           str(normalization), bool(multi_output), bool(preserve_shape))
    return _SoftmaxOutputFn.apply(data, label, cfg)


def _softmax_output_infer_shape(in_shapes, attrs):
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    filled = list(in_shapes)
    if attrs.get("multi_output", False):
        filled[1] = (dshape[0],) + tuple(dshape[2:])
    elif attrs.get("preserve_shape", False):
        # one label a position, as the backward reads them (MXNet 1.0's
        # label shape, data.shape[:-1]; the JAX package's (batch,) cannot
        # bind per-token labels)
        filled[1] = tuple(dshape[:-1])
    else:
        filled[1] = (dshape[0],)
    return filled, [dshape]


register("SoftmaxOutput", _softmax_output, input_names=("data", "label"),
         infer_shape=_softmax_output_infer_shape, aliases=("Softmax",),
         params={"grad_scale": (pFloat, 1.0), "ignore_label": (pFloat, -1.0),
                 "multi_output": (pBool, False), "use_ignore": (pBool, False),
                 "preserve_shape": (pBool, False),
                 "normalization": (pStr, "null"), "out_grad": (pBool, False),
                 "smooth_alpha": (pFloat, 0.0)})


def _softmax_cross_entropy(data, label):
    """Summed cross-entropy of softmax(data) at integer labels (ref:
    loss_binary_op.cc softmax_cross_entropy: 2-D data, 1-D label, a (1,)
    output; its backward is autograd's softmax minus one-hot)."""
    logp = torch.log_softmax(data.float(), dim=-1)
    idx = label.detach().to(torch.int64)
    picked = torch.gather(logp, -1, idx[:, None])
    return (-torch.sum(picked)).reshape(1).to(data.dtype)


def _sce_infer_shape(in_shapes, attrs):
    d, _ = in_shapes
    filled = list(in_shapes)
    if d is not None and in_shapes[1] is None:
        filled[1] = (d[0],)
    return filled, [(1,)]


register("softmax_cross_entropy", _softmax_cross_entropy,
         input_names=("data", "label"), infer_shape=_sce_infer_shape)


class _MakeLossFn(torch.autograd.Function):
    """Identity forward; the backward ignores the head gradient and gives
    ``grad_scale`` everywhere (ref: make_loss-inl.h)."""

    @staticmethod
    def forward(ctx, data, grad_scale):
        ctx.grad_scale = grad_scale
        return data.view_as(data)

    @staticmethod
    def backward(ctx, _head_grad):
        return torch.full_like(_head_grad, ctx.grad_scale), None


register("MakeLoss", lambda data, grad_scale=1.0, valid_thresh=0.0,
         normalization="null": _MakeLossFn.apply(data, float(grad_scale)),
         num_inputs=1,
         params={"grad_scale": (pFloat, 1.0), "valid_thresh": (pFloat, 0.0),
                 "normalization": (pStr, "null")})


# ---------------------------------------------------------------------------
# Regression heads, SVMOutput (ref: regression_output-inl.h, svm_output)
# ---------------------------------------------------------------------------

_REG_LINKS = {"linear": lambda x: x, "mae": lambda x: x,
              "logistic": torch.sigmoid}


class _RegressionFn(torch.autograd.Function):
    """The reference's regression heads: the link function forward; a
    backward that ignores the head gradient and gives ``(out - label)``
    (``sign(out - label)`` for MAE) times ``grad_scale / num_output``,
    and the label no gradient."""

    @staticmethod
    def forward(ctx, data, label, kind, grad_scale):
        out = _REG_LINKS[kind](data)
        ctx.save_for_backward(out, label)
        ctx.kind, ctx.grad_scale = kind, grad_scale
        return out

    @staticmethod
    def backward(ctx, _head_grad):
        out, label = ctx.saved_tensors
        num_output = int(np.prod(out.shape[1:])) if out.ndim > 1 else 1
        diff = out - label.reshape(out.shape).to(out.dtype)
        if ctx.kind == "mae":
            diff = torch.sign(diff)
        grad = diff * (ctx.grad_scale / num_output)
        return grad.to(out.dtype), torch.zeros_like(label), None, None


def _reg_infer_shape(in_shapes, attrs):
    """The label takes the data's shape (the JAX package's rule, which
    leaves a given label shape alone)."""
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    filled = list(in_shapes)
    if filled[1] is None:
        filled[1] = dshape
    return filled, [dshape]


for _name, _kind in (("LinearRegressionOutput", "linear"),
                     ("MAERegressionOutput", "mae"),
                     ("LogisticRegressionOutput", "logistic")):
    register(_name,
             (lambda kind: lambda data, label, grad_scale=1.0:
              _RegressionFn.apply(data, label, kind, float(grad_scale)))(
                  _kind),
             input_names=("data", "label"), infer_shape=_reg_infer_shape,
             params={"grad_scale": (pFloat, 1.0)})


def _svm_output(data, label, margin=1.0, regularization_coefficient=1.0,
                use_linear=False):
    """Identity forward whose gradient is the head gradient: the JAX
    package's ``SVMOutput`` (the reference MXNet's backward is the hinge
    loss's gradient; ROADMAP R9)."""
    return data.clone()


register("SVMOutput", _svm_output, input_names=("data", "label"),
         infer_shape=_softmax_output_infer_shape,
         params={"margin": (pFloat, 1.0),
                 "regularization_coefficient": (pFloat, 1.0),
                 "use_linear": (pBool, False)})


# ---------------------------------------------------------------------------
# Sequence ops (ref: sequence_last/mask/reverse-inl.h); TNC, or the batch
# first with axis=1 for SequenceLast and SequenceMask
# ---------------------------------------------------------------------------

def _lengths(rest):
    return rest[0].detach().to(torch.int64)


def _seq_last(data, *rest, use_sequence_length=False, axis=0):
    axis = int(axis)
    if not use_sequence_length:
        return data.select(axis, data.shape[axis] - 1)
    idx = _lengths(rest) - 1
    if axis == 0:
        return data[idx, torch.arange(data.shape[1], device=data.device)]
    return data[torch.arange(data.shape[0], device=data.device), idx]


register("SequenceLast", _seq_last, input_names=("data", "sequence_length"),
         params={"use_sequence_length": (pBool, False), "axis": (pInt, 0)})


def _seq_mask(data, *rest, use_sequence_length=False, value=0.0, axis=0):
    if not use_sequence_length:
        return data
    seqlen = _lengths(rest)
    t = torch.arange(data.shape[int(axis)], device=data.device)
    if int(axis) == 0:
        mask = t[:, None] < seqlen[None, :]
    else:
        mask = t[None, :] < seqlen[:, None]
    mask = mask.reshape(mask.shape + (1,) * (data.ndim - 2))
    return torch.where(mask, data, torch.full((), value, dtype=data.dtype,
                                               device=data.device))


register("SequenceMask", _seq_mask, input_names=("data", "sequence_length"),
         params={"use_sequence_length": (pBool, False),
                 "value": (pFloat, 0.0), "axis": (pInt, 0)})


def _seq_reverse(data, *rest, use_sequence_length=False, axis=0):
    """Reverse the first ``sequence_length`` steps of each sequence along
    axis 0 (the JAX package reverses along axis 0 whatever ``axis``
    says)."""
    if not use_sequence_length:
        return torch.flip(data, (0,))
    seqlen = _lengths(rest)
    t = torch.arange(data.shape[0], device=data.device)[:, None]
    rev = torch.where(t < seqlen[None, :], seqlen[None, :] - 1 - t, t)
    rev = rev.reshape(rev.shape + (1,) * (data.ndim - 2)).expand(data.shape)
    return torch.gather(data, 0, rev)


register("SequenceReverse", _seq_reverse,
         input_names=("data", "sequence_length"),
         params={"use_sequence_length": (pBool, False), "axis": (pInt, 0)})


# ---------------------------------------------------------------------------
# UpSampling (ref: upsampling-inl.h)
# ---------------------------------------------------------------------------

def _upsampling(*args, scale=1, sample_type="nearest", num_args=1,
                num_filter=0, multi_input_mode="concat", workspace=512):
    """Nearest: each pixel repeated ``scale`` times along H and W.
    Bilinear: a half-pixel-centre bilinear resize.  Both read the first
    input only, as the JAX package's do (the reference concatenates or
    sums several nearest inputs and deconvolves with a weight input in
    bilinear mode; ROADMAP R10)."""
    data = args[0]
    scale = int(scale)
    if sample_type == "nearest":
        return data.repeat_interleave(scale, 2).repeat_interleave(scale, 3)
    return F.interpolate(data, scale_factor=scale, mode="bilinear",
                         align_corners=False)


register("UpSampling", _upsampling, num_inputs=None,
         key_var_num_args="num_args",
         params={"scale": (pInt, 1), "sample_type": (pStr, "nearest"),
                 "num_args": (pInt, 1), "num_filter": (pInt, 0),
                 "multi_input_mode": (pStr, "concat"),
                 "workspace": (pInt, 512)})

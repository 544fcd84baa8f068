"""Neural-network operators (the slice the symbol-graph LM server runs).

Counterpart of part of ``mxnet_tpu/ops/nn.py``: ``FullyConnected`` (with
its two-way shape rule and ``flatten=False``), ``LeakyReLU`` (with the
exact-erf ``gelu``), ``LayerNorm`` and ``Embedding``.  The products are
plain ``torch.matmul``: the JAX package leaves them to XLA, and the port
leaves them to cuBLAS.
"""
from __future__ import annotations

import math

import torch

from ..base import MXNetError
from .registry import pBool, pDtype, pFloat, pInt, pStr, register


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


def _fully_connected(data, weight, *rest, num_hidden=1, no_bias=False,
                     flatten=True):
    x = data.reshape(data.shape[0], -1) if flatten or data.ndim == 2 \
        else data
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

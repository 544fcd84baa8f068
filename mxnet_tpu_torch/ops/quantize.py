"""int8 inference: per-channel weight quantization, the quantized
convolution and fully-connected ops, and the graph rewrite onto them.

Counterpart of ``mxnet_tpu/ops/quantize.py``.  The rewrite is a
topo-order node map giving a NEW Symbol whose int8 weights and f32
per-channel scales bind like any other parameters, so the plan cache,
serving buckets and ``warmup()``'s zero-rebuild check apply unchanged.

The quantized ops multiply int8 operands with int32 accumulation, then
rescale in f32 in the JAX package's order.  The product:

- **on the card**: ``torch._int_mm``, cuBLAS's int8 GEMM.  The JAX
  package leaves this product to XLA (no Pallas kernel), so the port
  leaves it to the library.  The convolution runs it over an int8
  im2col.  ``_int_mm`` needs more than 16 rows and K and N multiples of
  8: rows, K and N are padded with zeros and the result sliced, which is
  exact.  A failure raises; the card never falls back to a plain version.
- **on the host** (and as the tests' reference): the plain version, the
  exact integer product computed in f64 (|sums| stay far below 2**53)
  and cast to int32, bit for bit what the route gives.

Scales: weights symmetric per output channel, ``max|w| / 127``
(:func:`quantize_weight`); activations per tensor, either calibrated
offline (:func:`calibrate`, pinned as ``act_scale``) or dynamic,
``max|x| / 127`` per ROW, so a row's grid never depends on the rows
co-batched or padded beside it.  Rounding is ``torch.round``, half to
even like ``jnp.round``.

Entry points: ``Predictor(..., quantize="int8")``, ``ServedModel(...,
quantize="int8")`` and the ``MXNET_TPU_QUANTIZE`` default.
"""
from __future__ import annotations

import json

import numpy as np
import torch
import torch.nn.functional as F

from ..base import MXNetError
from .nn import _conv_out_dim
from .registry import get_op, pBool, pFloat, pInt, register

_QUANT_MODES = ("int8",)


# ---------------------------------------------------------------------------
# Quantization math
# ---------------------------------------------------------------------------

def quantize_weight(w, axis=0):
    """Symmetric per-channel int8 quantization of a weight array along
    ``axis`` (the output-channel axis of Convolution/FullyConnected).
    Returns numpy ``(q_int8, scales_f32)`` with ``w ~= q * scales``."""
    w = np.asarray(w, dtype=np.float32)
    red = tuple(i for i in range(w.ndim) if i != axis)
    amax = np.max(np.abs(w), axis=red) if red else np.abs(w)
    scales = (np.maximum(amax, 1e-12) / 127.0).astype(np.float32)
    bshape = tuple(-1 if i == axis else 1 for i in range(w.ndim))
    q = np.clip(np.rint(w / scales.reshape(bshape)), -127, 127)
    return q.astype(np.int8), scales


def quantize_act(x, act_scale):
    """(x_int8, scale): the calibrated static scale when ``act_scale >
    0``, else a dynamic per-row range (max over every axis but the
    batch)."""
    x = x.to(torch.float32)

    def const(v):
        # a device scalar: dividing by a host scalar may multiply by its
        # reciprocal on the card, which is not the JAX package's division
        return torch.full((), v, dtype=torch.float32, device=x.device)

    if act_scale and act_scale > 0.0:
        s = const(act_scale)
    else:
        red = tuple(range(1, x.ndim))
        s = torch.clamp(torch.amax(torch.abs(x), dim=red, keepdim=True),
                        min=1e-12) / const(127.0)
    xq = torch.clamp(torch.round(x / s), -127.0, 127.0).to(torch.int8)
    return xq, s


# ---------------------------------------------------------------------------
# The int8 products: the cuBLAS route on the card, the plain version
# ---------------------------------------------------------------------------

_INT_MM_MIN_ROWS = 17   # _int_mm: more than 16 rows


def _ceil(n, m):
    return -(-n // m) * m


def _padded_weight(w2d, kp):
    """(N, K) int8 weight rows zero-padded to (N8, kp)."""
    n, k = w2d.shape
    npad = _ceil(n, 8)
    if (npad, kp) == (n, k):
        return w2d.contiguous()
    out = w2d.new_zeros((npad, kp))
    out[:n, :k] = w2d
    return out


def _int_mm(a_pad, w_pad):
    """cuBLAS int8 GEMM ``a_pad @ w_pad.T`` (int32) of padded operands."""
    try:
        return torch._int_mm(a_pad, w_pad.t())
    except RuntimeError as exc:
        raise MXNetError("int8 GEMM (torch._int_mm) failed on %s for "
                         "(%d x %d) @ (%d x %d): %s"
                         % (a_pad.device, a_pad.shape[0], a_pad.shape[1],
                            w_pad.shape[1], w_pad.shape[0], exc)) from exc


def _padded_rows(m, k):
    return max(_INT_MM_MIN_ROWS, _ceil(m, 8)), _ceil(k, 8)


def int8_matmul(a, w):
    """``a @ w.T`` of int8 ``a`` (M, K) and ``w`` (N, K) as exact int32:
    cuBLAS on a CUDA tensor, the plain version on a host tensor."""
    if a.device.type != "cuda":
        return plain_int8_matmul(a, w)
    return padded_matmul(a, w, _int_mm)


def padded_matmul(a, w, gemm):
    """``a @ w.T`` through ``gemm`` on operands zero-padded to its
    limits (rows, K and N), the result sliced back."""
    m, k = a.shape
    mp, kp = _padded_rows(m, k)
    if (mp, kp) != (m, k):
        padded = a.new_zeros((mp, kp))
        padded[:m, :k] = a
        a = padded
    return gemm(a.contiguous(), _padded_weight(w, kp))[:m, :w.shape[0]]


def plain_int8_matmul(a, w):
    """The plain version of :func:`int8_matmul`: exact in f64."""
    return torch.matmul(a.to(torch.float64),
                        w.to(torch.float64).t()).to(torch.int32)


def _conv_geometry(x_shape, kernel, stride, pad, dilate):
    nd = len(kernel)
    stride = tuple(stride or (1,) * nd)
    pad = tuple(pad or (0,) * nd)
    dilate = tuple(dilate or (1,) * nd)
    out = tuple(_conv_out_dim(x_shape[2 + i], kernel[i], stride[i], pad[i],
                              dilate[i]) for i in range(nd))
    return stride, pad, dilate, out


def _im2col_view(xq, kernel, stride, pad, dilate, out):
    """[N, *out, C, *kernel] strided view of the zero-padded int8 input:
    entry (n, o, c, t) is the tap ``t`` of output pixel ``o``."""
    nd = len(kernel)
    x = F.pad(xq, [p for q in reversed(pad) for p in (q, q)]).contiguous()
    st = x.stride()
    view = x.as_strided(
        tuple(x.shape[:2]) + tuple(kernel) + tuple(out),
        (st[0], st[1]) + tuple(d * st[2 + i] for i, d in enumerate(dilate))
        + tuple(s * st[2 + i] for i, s in enumerate(stride)))
    return view.permute((0,) + tuple(range(2 + nd, 2 + 2 * nd)) + (1,)
                        + tuple(range(2, 2 + nd)))


def int8_conv(xq, wq, stride=None, pad=None, dilate=None, num_group=1):
    """Convolution of int8 ``xq`` (N, C, *S) and ``wq`` (F, C/g, *k) as
    exact int32 (N, F, *out): on the card one cuBLAS int8 GEMM per group
    over an int8 im2col, on the host the plain version."""
    if xq.device.type != "cuda":
        return plain_int8_conv(xq, wq, stride, pad, dilate, num_group)
    return im2col_conv(xq, wq, stride, pad, dilate, num_group, _int_mm)


def im2col_conv(xq, wq, stride, pad, dilate, num_group, gemm):
    """The convolution as ``gemm`` (padded ``a @ w.T``, int32) over an
    int8 im2col written straight into the zero-padded GEMM operand, one
    GEMM per group."""
    kernel = tuple(wq.shape[2:])
    nd = len(kernel)
    stride, pad, dilate, out = _conv_geometry(xq.shape, kernel, stride, pad,
                                              dilate)
    g = int(num_group)
    n, c = xq.shape[:2]
    cg, fg = c // g, wq.shape[0] // g
    m = n * int(np.prod(out))
    k = cg * int(np.prod(kernel))
    mp, kp = _padded_rows(m, k)
    cols = _im2col_view(xq, kernel, stride, pad, dilate, out)
    res = []
    for gi in range(g):
        a = xq.new_zeros((mp, kp)) if (mp, kp) != (m, k) \
            else xq.new_empty((m, k))
        a[:m, :k].unflatten(0, (n,) + out).unflatten(
            -1, (cg,) + kernel).copy_(
            cols[(slice(None),) * (1 + nd) + (slice(gi * cg,
                                                    (gi + 1) * cg),)])
        w2d = wq[gi * fg:(gi + 1) * fg].reshape(fg, k)
        acc = gemm(a, _padded_weight(w2d, kp))[:m, :fg]
        res.append(acc.reshape((n,) + out + (fg,)))
    acc = res[0] if g == 1 else torch.cat(res, dim=-1)
    return acc.permute((0, 1 + nd) + tuple(range(1, 1 + nd))).contiguous()


_CONV_F = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def plain_int8_conv(xq, wq, stride=None, pad=None, dilate=None,
                    num_group=1):
    """The plain version of :func:`int8_conv`: exact in f64."""
    kernel = tuple(wq.shape[2:])
    stride, pad, dilate, _ = _conv_geometry(xq.shape, kernel, stride, pad,
                                            dilate)
    return _CONV_F[len(kernel)](
        xq.to(torch.float64), wq.to(torch.float64), stride=stride,
        padding=pad, dilation=dilate, groups=int(num_group)).to(torch.int32)


# ---------------------------------------------------------------------------
# Quantized ops (int8 operands, int32 accumulation, f32 rescale)
# ---------------------------------------------------------------------------

def _quantized_convolution(data, weight, scale, *rest, kernel=(1, 1),
                           stride=None, dilate=None, pad=None, num_filter=1,
                           num_group=1, no_bias=False, workspace=1024,
                           cudnn_tune=None, cudnn_off=False, layout=None,
                           act_scale=0.0):
    nd = len(kernel)
    xq, sx = quantize_act(data, act_scale)
    out = int8_conv(xq, weight.to(torch.int8), stride, pad, dilate,
                    num_group)
    # sx is a scalar (calibrated) or (N, 1, ..., 1) (dynamic per-row);
    # either broadcasts against the per-channel weight scales
    rescale = sx * scale.to(torch.float32).reshape((1, -1) + (1,) * nd)
    y = out.to(torch.float32) * rescale
    if not no_bias:
        y = y + rest[0].to(torch.float32).reshape((1, -1) + (1,) * nd)
    return y.to(data.dtype)


def _qconv_infer_shape(in_shapes, attrs):
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
    filled[2] = (num_filter,)
    if not attrs.get("no_bias", False):
        filled[3] = (num_filter,)
    spatial = tuple(_conv_out_dim(dshape[2 + i], kernel[i], stride[i],
                                  pad[i], dilate[i]) for i in range(nd))
    return filled, [(dshape[0], num_filter) + spatial]


def _quantized_fully_connected(data, weight, scale, *rest, num_hidden=1,
                               no_bias=False, flatten=True, act_scale=0.0):
    x = data.reshape(data.shape[0], -1) if flatten or data.ndim == 2 \
        else data
    xq, sx = quantize_act(x, act_scale)
    lead = xq.shape[:-1]
    out = int8_matmul(xq.reshape(-1, xq.shape[-1]),
                      weight.to(torch.int8)).reshape(lead + (-1,))
    y = out.to(torch.float32) * (sx * scale.to(torch.float32))
    if not no_bias:
        y = y + rest[0].to(torch.float32)
    return y.to(data.dtype)


def _qfc_infer_shape(in_shapes, attrs):
    num_hidden = int(attrs["num_hidden"])
    flatten = attrs.get("flatten", True)
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, [None]
    filled = list(in_shapes)
    if flatten or len(dshape) == 2:
        in_dim = int(np.prod(dshape[1:]))
        oshape = (dshape[0], num_hidden)
    else:
        in_dim = int(dshape[-1])
        oshape = tuple(dshape[:-1]) + (num_hidden,)
    filled[1] = (num_hidden, in_dim)
    filled[2] = (num_hidden,)
    if not attrs.get("no_bias", False):
        filled[3] = (num_hidden,)
    return filled, [oshape]


def _q_infer_type(in_dtypes, attrs):
    d = in_dtypes[0]
    if d is None:
        return in_dtypes, None
    filled = [d, np.int8, np.float32, np.float32][:len(in_dtypes)]
    return filled, [d]


register("_contrib_quantized_conv", _quantized_convolution,
         input_names=("data", "weight", "scale", "bias"),
         infer_shape=_qconv_infer_shape, infer_type=_q_infer_type,
         params=dict(get_op("Convolution").params,
                     act_scale=(pFloat, 0.0)))

register("_contrib_quantized_fc", _quantized_fully_connected,
         input_names=("data", "weight", "scale", "bias"),
         infer_shape=_qfc_infer_shape, infer_type=_q_infer_type,
         params={"num_hidden": (pInt, 1), "no_bias": (pBool, False),
                 "flatten": (pBool, True), "act_scale": (pFloat, 0.0)})

_QUANT_OF = {"Convolution": "_contrib_quantized_conv",
             "FullyConnected": "_contrib_quantized_fc"}


# ---------------------------------------------------------------------------
# Graph rewrite
# ---------------------------------------------------------------------------

def _quantizable(node, arg_params):
    """A Convolution/FullyConnected whose weight input is a variable with
    a known (checkpointed) value.  Deconvolution and weight-producing
    subgraphs stay float."""
    if node.is_var or node.op_name not in _QUANT_OF:
        return False
    if len(node.inputs) < 2:
        return False
    wsrc, _ = node.inputs[1]
    return wsrc.is_var and wsrc.name in arg_params


def _host(v):
    return v.asnumpy() if hasattr(v, "asnumpy") else np.asarray(v)


def quantize_symbol(symbol, arg_params, aux_params=None, mode="int8",
                    calibration=None, skip=()):
    """Rewrite ``symbol`` for int8 inference: every quantizable
    Convolution/FullyConnected becomes its ``_contrib_quantized_*`` twin
    reading an int8 weight and an f32 per-channel scale (new variables
    ``<weight>_int8`` / ``<weight>_scale``, made where the float weight
    lives), with ``act_scale`` pinned from ``calibration`` (a
    :class:`CalibrationTable` or {node_name: scale}) or 0 for dynamic
    ranging.  ``skip`` names layers to keep float.

    Returns ``(qsym, qarg_params, qaux_params)``."""
    if mode not in _QUANT_MODES:
        raise MXNetError("unsupported quantize mode %r (supported: %s)"
                         % (mode, _QUANT_MODES))
    from ..context import cpu
    from ..ndarray import NDArray, array as nd_array
    from ..symbol.symbol import Symbol, _Node
    calibration = dict(calibration or {})
    skip = set(skip)
    qargs = dict(arg_params)
    mapped = {}
    qvars = {}        # weight name -> (wq_node, sc_node): tied weights
    replaced = set()  # are quantized once and shared
    for node in symbol._topo():
        if node.is_var:
            mapped[node] = node
            continue
        inputs = [(mapped[src], idx) for src, idx in node.inputs]
        if _quantizable(node, arg_params) and node.name not in skip:
            wsrc, _ = node.inputs[1]
            if wsrc.name not in qvars:
                w = arg_params[wsrc.name]
                ctx = w.context if isinstance(w, NDArray) else cpu()
                q, scales = quantize_weight(_host(w))
                wq_node = _Node(None, wsrc.name + "_int8",
                                {"__dtype__": "int8"})
                sc_node = _Node(None, wsrc.name + "_scale",
                                {"__dtype__": "float32"})
                qvars[wsrc.name] = (wq_node, sc_node)
                qargs[wq_node.name] = nd_array(q, ctx=ctx, dtype=np.int8)
                qargs[sc_node.name] = nd_array(scales, ctx=ctx,
                                               dtype=np.float32)
                replaced.add(wsrc.name)
            wq_node, sc_node = qvars[wsrc.name]
            attrs = dict(node.attrs)
            act = float(calibration.get(node.name, 0.0))
            if act > 0.0:
                attrs["act_scale"] = repr(act)
            new_inputs = [inputs[0], (wq_node, 0), (sc_node, 0)]
            new_inputs.extend(inputs[2:])  # the bias rides along
            mapped[node] = _Node(_QUANT_OF[node.op_name], node.name,
                                 attrs, new_inputs)
        elif all(mapped[src] is src for src, _ in node.inputs):
            mapped[node] = node  # untouched subgraph: share the nodes
        else:
            mapped[node] = _Node(node.op_name, node.name,
                                 dict(node.attrs), inputs)
    qsym = Symbol([(mapped[n], i) for n, i in symbol._entries])
    # drop a replaced float weight only when nothing in the rewritten
    # graph still reads it; one tied into a float consumer keeps its
    # copy, with its checkpoint shape stamped on the (shared) var node
    still_used = {n.name: n for n in qsym._topo() if n.is_var}
    for name in replaced:
        if name not in still_used:
            qargs.pop(name, None)
        elif "__shape__" not in still_used[name].attrs:
            still_used[name].attrs["__shape__"] = str(
                tuple(int(d) for d in _host(arg_params[name]).shape))
            symbol._shash = None
    return qsym, qargs, dict(aux_params or {})


# ---------------------------------------------------------------------------
# Offline activation calibration
# ---------------------------------------------------------------------------

class CalibrationTable(dict):
    """{node_name: act_scale} with a serializable layout description."""

    def describe(self):
        return {"slots": ["max_abs_act/%s" % k for k in sorted(self)],
                "scales": {k: float(v) for k, v in sorted(self.items())}}

    def dumps(self):
        return json.dumps(self.describe())

    @classmethod
    def loads(cls, s):
        return cls(json.loads(s)["scales"])


def calibrate(symbol, arg_params, aux_params, input_shapes, batches,
              ctx=None):
    """Offline activation-range calibration for :func:`quantize_symbol`:
    run the FLOAT graph over ``batches`` (an iterable of {input_name:
    host array}) and record each quantizable layer's input ``max|x|``.

    One forward per batch, its quantizable layers' inputs reduced on the
    device through ``Executor.set_monitor_callback`` and fetched as one
    small vector.  Returns a :class:`CalibrationTable` of per-layer
    ``act_scale`` (running max / 127).  ``ctx`` defaults to the current
    context."""
    from ..context import current_context
    from ..ndarray import NDArray, array as nd_array
    ctx = ctx or current_context()
    exe = symbol.simple_bind(ctx, grad_req="null",
                             **{k: tuple(v) for k, v in
                                input_shapes.items()})

    def nd(v):
        return v if isinstance(v, NDArray) else nd_array(v, ctx=ctx)
    exe.copy_params_from({k: nd(v) for k, v in arg_params.items()},
                         {k: nd(v) for k, v in (aux_params or {}).items()},
                         allow_extra_params=True)
    qnames = []
    for node in symbol._topo():
        if _quantizable(node, arg_params) and node.name not in qnames:
            qnames.append(node.name)
    if not qnames:
        return CalibrationTable()
    taps = {"%s_%s" % (n, "data"): i for i, n in enumerate(qnames)}
    seen = {}

    def collect(name, arr):
        i = taps.get(name)
        if i is not None:
            m = torch.amax(torch.abs(arr.tensor.to(torch.float32)))
            seen[i] = m if i not in seen else torch.maximum(seen[i], m)

    exe.set_monitor_callback(collect, monitor_all=True)
    running = None
    for batch in batches:
        seen.clear()
        exe.forward(is_train=False, **{k: v for k, v in batch.items()
                                       if k in exe.arg_dict})
        vec = torch.stack([seen[i] for i in range(len(qnames))]) \
            .cpu().numpy()
        running = vec if running is None else np.maximum(running, vec)
    exe.set_monitor_callback(None)
    if running is None:
        raise MXNetError(
            "calibrate() saw no batches: pass a non-empty iterable of "
            "{input_name: array} dicts (a generator can only be "
            "consumed once)")
    return CalibrationTable({name: float(m) / 127.0
                             for name, m in zip(qnames, running)})

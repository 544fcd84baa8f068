"""Fused RNN operator: vanilla RNN / LSTM / GRU, multi-layer, bidirectional.

Counterpart of ``mxnet_tpu/ops/rnn_op.py``.  The JAX package steps each
layer and direction with a ``lax.scan``; the port hands each layer to
torch's fused recurrent call (``torch._VF.lstm``, ``gru``, ``rnn_tanh``,
``rnn_relu``): cuDNN's RNN kernels on the card, as the reference MXNet
runs its ``RNN`` op (``cudnn_rnn-inl.h``), and torch's own on the host.
torch defines the cells as the JAX package does: LSTM gates i, f, g, o;
GRU gates r, z, n with ``n = tanh(x_n + r * (W_hn h + b_hn))``.

Weight layout: the reference/cuDNN flat vector of the JAX package — per
layer, per direction W [G*H, in] and R [G*H, H] for all layers first,
then the biases bW [G*H] and bR [G*H] in the same order.  Each layer's
call gets views into it; they are not cuDNN's packed layout, so on the
card cuDNN copies them into a buffer of its own at every call (torch
warns about it once).

One call per layer, so that the dropout between layers (``p``, applied
only in training, never after the last layer) draws its mask from the
port's generator (``mx.random.seed``) as the ``Dropout`` op does; torch's
own ``dropout`` argument would use torch's global generator.  As in the
JAX package, ``lstm_state_clip_min``/``_max`` clip each layer's final
cell state only, and ``lstm_state_clip_nan`` is accepted and ignored.
"""
from __future__ import annotations

import torch

from .. import random as _random
from .registry import pBool, pFloat, pInt, pStr, register


def _gates(mode):
    return {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}[mode]


def rnn_param_size(num_layers, input_size, state_size, bidirectional, mode):
    g = _gates(mode)
    dirs = 2 if bidirectional else 1
    size = 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else state_size * dirs
        size += dirs * g * state_size * (in_sz + state_size)  # W + R
    size += num_layers * dirs * 2 * g * state_size  # biases
    return size


def _unpack_params(params, num_layers, input_size, state_size,
                   bidirectional, mode):
    """Views of the flat parameter vector: [W, R, bW, bR] per (layer,
    direction), in layer-major order."""
    g = _gates(mode)
    dirs = 2 if bidirectional else 1
    h = state_size
    ws, off = [], 0
    for layer in range(num_layers):
        in_sz = input_size if layer == 0 else h * dirs
        for _ in range(dirs):
            w = params[off:off + g * h * in_sz].reshape(g * h, in_sz)
            off += g * h * in_sz
            r = params[off:off + g * h * h].reshape(g * h, h)
            off += g * h * h
            ws.append([w, r, None, None])
    for i in range(num_layers * dirs):
        ws[i][2] = params[off:off + g * h]
        off += g * h
        ws[i][3] = params[off:off + g * h]
        off += g * h
    return ws


def _rnn_impl(data, parameters, state, *maybe_cell, state_size=0,
              num_layers=1, bidirectional=False, mode="lstm", p=0.0,
              state_outputs=False, lstm_state_clip_min=None,
              lstm_state_clip_max=None, lstm_state_clip_nan=False,
              _train=False):
    has_cell = mode == "lstm"
    L = int(num_layers)
    dirs = 2 if bidirectional else 1
    ws = _unpack_params(parameters, L, data.shape[2], int(state_size),
                        bidirectional, mode)
    fused = getattr(torch._VF, mode)
    # cuDNN differentiates only a forward run in its training mode; the
    # call's own dropout stays 0 (the masks below are the port's)
    fused_train = torch.is_grad_enabled()
    x = data
    hys, cys = [], []
    for layer in range(L):
        lo, hi = layer * dirs, (layer + 1) * dirs
        flat = [t for i in range(lo, hi) for t in ws[i]]
        if has_cell:
            x, hy, cy = fused(x, (state[lo:hi], maybe_cell[0][lo:hi]), flat,
                              True, 1, 0.0, fused_train, bidirectional, False)
            if lstm_state_clip_min is not None:
                cy = torch.clamp(cy, lstm_state_clip_min, lstm_state_clip_max)
            cys.append(cy)
        else:
            x, hy = fused(x, state[lo:hi], flat, True, 1, 0.0, fused_train,
                          bidirectional, False)
        hys.append(hy)
        if p > 0 and _train and layer != L - 1:
            keep = torch.rand(x.shape, device=x.device,
                              generator=_random.generator(x.device)) < 1.0 - p
            x = torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    hy = torch.cat(hys)
    if has_cell:
        return x, hy, torch.cat(cys)
    return x, hy


def _rnn_num_outputs(attrs):
    # visible outputs: output [+ hy [+ cy]] when state_outputs
    if attrs.get("state_outputs") in (True, "True", "true", 1, "1"):
        return 3 if attrs.get("mode", "lstm") == "lstm" else 2
    return 1


def _rnn_infer_shape(in_shapes, attrs):
    dshape = in_shapes[0]
    if dshape is None:
        return in_shapes, None
    T, N, input_size = dshape
    h = int(attrs["state_size"])
    L = int(attrs["num_layers"])
    bid = bool(attrs.get("bidirectional", False))
    mode = attrs.get("mode", "lstm")
    dirs = 2 if bid else 1
    filled = list(in_shapes)
    filled[1] = (rnn_param_size(L, input_size, h, bid, mode),)
    filled[2] = (L * dirs, N, h)
    if mode == "lstm" and len(filled) > 3:
        filled[3] = (L * dirs, N, h)
    out = [(T, N, h * dirs), (L * dirs, N, h)]
    if mode == "lstm":
        out.append((L * dirs, N, h))
    return filled, out


register("RNN", _rnn_impl,
         input_names=("data", "parameters", "state", "state_cell"),
         num_inputs=lambda attrs: 4 if attrs.get("mode", "lstm") == "lstm"
         else 3,
         num_outputs=_rnn_num_outputs,
         infer_shape=_rnn_infer_shape,
         takes_train_flag=True, needs_rng=True,
         params={
             "state_size": (pInt, 0), "num_layers": (pInt, 1),
             "bidirectional": (pBool, False), "mode": (pStr, "lstm"),
             "p": (pFloat, 0.0), "state_outputs": (pBool, False),
             "lstm_state_clip_min": (pFloat, None),
             "lstm_state_clip_max": (pFloat, None),
             "lstm_state_clip_nan": (pBool, False),
         })

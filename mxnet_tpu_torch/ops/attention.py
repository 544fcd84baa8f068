"""Native attention operators (the transformer fast path).

Counterpart of ``mxnet_tpu/ops/attention.py``.  Two graph ops route the
whole softmax(QK^T)V contraction through the flash-attention kernel
(``ops/kernels.py``):

- ``scaled_dot_product_attention``: pre-split heads, q/k/v as
  [batch, seq, heads, head_dim]; causal and padding masks.
- ``multi_head_attention``: the q/k/v/out projections around the same
  core, so one graph node carries a whole attention block.
"""
from __future__ import annotations

import torch

from . import kernels as _k
from .registry import pBool, pFloat, pInt, register


def _sdpa(query, key, value, *rest, causal=False, scale=0.0,
          use_lengths=False):
    kv_lens = rest[0] if use_lengths else None
    return _k.attention(query, key, value, causal=causal,
                        scale=(scale if scale else None), kv_lens=kv_lens)


def _sdpa_infer_shape(in_shapes, attrs, out_shapes=None):
    filled = list(in_shapes)
    q, k, v = filled[0], filled[1], filled[2]
    # k and v always share a shape — heal one from the other
    if k is None and v is not None:
        filled[1] = k = v
    if v is None and k is not None:
        filled[2] = v = k
    batch = None
    for s in (q, k):
        if s is not None and len(s) == 4 and int(s[0]) != 0:
            batch = int(s[0])
    if attrs.get("use_lengths") and len(filled) > 3 and filled[3] is None \
            and batch is not None:
        filled[3] = (batch,)
    if q is None:
        return filled, [None]
    return filled, [tuple(q)]


def _sdpa_infer_type(in_dtypes, attrs):
    filled = list(in_dtypes)
    d = next((t for t in filled[:3] if t is not None), None)
    if d is None:
        return filled, None
    for i in range(3):
        if filled[i] is None:
            filled[i] = d
    # kv_length keeps its own dtype (an index vector, never coerced to
    # the activation dtype)
    return filled, [d]


register("scaled_dot_product_attention", _sdpa,
         input_names=("query", "key", "value", "kv_length"),
         num_inputs=lambda attrs: 3 + bool(attrs.get("use_lengths")),
         infer_shape=_sdpa_infer_shape, bidirectional_infer=True,
         infer_type=_sdpa_infer_type,
         params={"causal": (pBool, False), "scale": (pFloat, 0.0),
                 "use_lengths": (pBool, False)})


def _mha(query, key, value, q_weight, q_bias, k_weight, k_bias, v_weight,
         v_bias, out_weight, out_bias, *rest, num_heads=1, num_hidden=0,
         causal=False, scale=0.0, use_lengths=False):
    b, sq = query.shape[0], query.shape[1]
    sk = key.shape[1]
    h = int(num_heads)
    # MXNet weight convention (num_hidden, in_dim): project via x @ W^T
    q = (torch.matmul(query, q_weight.t()) + q_bias).reshape(b, sq, h, -1)
    k = (torch.matmul(key, k_weight.t()) + k_bias).reshape(b, sk, h, -1)
    v = (torch.matmul(value, v_weight.t()) + v_bias).reshape(b, sk, h, -1)
    kv_lens = rest[0] if use_lengths else None
    o = _k.attention(q, k, v, causal=causal,
                     scale=(scale if scale else None), kv_lens=kv_lens)
    return torch.matmul(o.reshape(b, sq, -1), out_weight.t()) + out_bias


def _mha_infer_shape(in_shapes, attrs, out_shapes=None):
    heads = int(attrs.get("num_heads", 1))
    units = int(attrs.get("num_hidden", 0))
    filled = list(in_shapes)
    q, k, v = filled[0], filled[1], filled[2]
    # heal query from a known output (backward inference, like FC)
    out = out_shapes[0] if out_shapes else None
    if q is None and out is not None:
        filled[0] = q = tuple(out)
    embed = int(q[-1]) if q is not None and int(q[-1]) != 0 else 0
    if not units:
        units = embed  # default projection width = query embed dim
    if units:
        if units % heads:
            raise ValueError(
                "multi_head_attention: num_hidden %d not divisible by "
                "num_heads %d" % (units, heads))
        ek = int(k[-1]) if k is not None and int(k[-1]) != 0 else embed
        ev = int(v[-1]) if v is not None and int(v[-1]) != 0 else embed
        if embed:
            filled[3] = (units, embed)         # q_weight
            filled[9] = (embed, units)         # out_weight
            filled[10] = (embed,)              # out_bias
        if ek:
            filled[5] = (units, ek)            # k_weight
        if ev:
            filled[7] = (units, ev)            # v_weight
        filled[4] = (units,)                   # q_bias
        filled[6] = (units,)                   # k_bias
        filled[8] = (units,)                   # v_bias
    if attrs.get("use_lengths") and len(filled) > 11 and filled[11] is None \
            and q is not None and int(q[0]) != 0:
        filled[11] = (int(q[0]),)
    if q is None:
        return filled, [None]
    return filled, [tuple(q)]


def _mha_infer_type(in_dtypes, attrs):
    filled = list(in_dtypes)
    d = next((t for t in filled[:11] if t is not None), None)
    if d is None:
        return filled, None
    for i in range(11):
        if filled[i] is None:
            filled[i] = d
    return filled, [d]


register("multi_head_attention", _mha,
         input_names=("query", "key", "value", "query_weight", "query_bias",
                      "key_weight", "key_bias", "value_weight", "value_bias",
                      "out_weight", "out_bias", "kv_length"),
         num_inputs=lambda attrs: 11 + bool(attrs.get("use_lengths")),
         infer_shape=_mha_infer_shape, bidirectional_infer=True,
         infer_type=_mha_infer_type,
         params={"num_heads": (pInt, 1), "num_hidden": (pInt, 0),
                 "causal": (pBool, False), "scale": (pFloat, 0.0),
                 "use_lengths": (pBool, False)})

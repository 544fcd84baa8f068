"""Core tensor operators (the slice the symbol-graph LM server runs).

Counterpart of part of ``mxnet_tpu/ops/tensor.py``: ``elemwise_add``
with the reference's equal-shape rule, ``broadcast_add``,
``expand_dims`` and ``Flatten``.  Op names and attrs follow the reference registry so a
graph's JSON stays the same in both packages.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from .registry import pInt, register


def _elemwise_add(lhs, rhs):
    if lhs.shape != rhs.shape:
        # the reference's elemwise_* ops REQUIRE equal shapes
        # (elemwise_binary_op.h); broadcasting is broadcast_add's job
        raise MXNetError(
            "elemwise op needs equal shapes, got %s and %s — use the "
            "broadcast_* variant" % (tuple(lhs.shape), tuple(rhs.shape)))
    return lhs + rhs


register("elemwise_add", _elemwise_add, num_inputs=2)
register("broadcast_add", lambda lhs, rhs: lhs + rhs, num_inputs=2)
register("expand_dims", lambda x, axis=0: torch.unsqueeze(x, int(axis)),
         num_inputs=1, params={"axis": (pInt, 0)})
register("Flatten", lambda x: x.reshape(x.shape[0], -1), num_inputs=1,
         aliases=("flatten",))

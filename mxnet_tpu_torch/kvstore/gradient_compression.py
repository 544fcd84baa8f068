"""2-bit gradient compression with an error-feedback residual.

Counterpart of ``mxnet_tpu/kvstore/gradient_compression.py`` (ref:
src/kvstore/gradient_compression.{h,cc,cu}): a value at or above
+threshold quantizes to +threshold, at or below -threshold to
-threshold, else to 0, and the quantization error accumulates into a
residual that is added before the next quantization.  The wire format
is the JAX package's byte for byte: a uint8 stream of 4 codes a byte
(code 1 is +threshold, 2 is -threshold, 0 is no update), the first value
in the low two bits, padded up to ``ceil(n / 4)`` bytes with code 0.

The quantizer and dequantizers are torch ops on the tensor's own device:
the JAX package writes them in ``jnp`` (they are not Pallas kernels), so
the port writes them as torch ops too.
"""
from __future__ import annotations

import torch


def packed_nbytes(n):
    """Wire bytes for n 2-bit values: 4 codes per byte, padded up."""
    return (int(n) + 3) // 4


def _pack2(codes):
    """Flat codes in {0, 1, 2}, any length -> uint8 with 4 codes a byte
    (``packed_nbytes(len)`` of them); the pad lanes get code 0."""
    q = codes.reshape(-1).to(torch.uint8)
    pad = (-q.numel()) % 4
    if pad:
        q = torch.cat([q, q.new_zeros(pad)])
    q = q.reshape(-1, 4)
    return q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)


def _unpack2(packed):
    """uint8 [..., m] -> codes [..., 4 m] in stream order."""
    b = packed
    return torch.stack([b & 3, (b >> 2) & 3, (b >> 4) & 3, (b >> 6) & 3],
                       dim=-1).reshape(*b.shape[:-1], -1)


def quantize_flat(flat, residual, threshold):
    """``(packed uint8 [ceil(n/4)], new residual)`` of ``flat + residual``
    (any length, any float dtype); the residual ``flat + residual -
    dequantized`` keeps the input's dtype and shape."""
    g = flat.reshape(-1) + residual.reshape(-1)
    plus, minus = g >= threshold, g <= -threshold
    code = plus.to(torch.uint8) | (minus.to(torch.uint8) << 1)
    # +t, -t or 0 in the gradient's dtype, exactly (t * 1 - t * 0)
    deq = plus.to(g.dtype) * threshold - minus.to(g.dtype) * threshold
    return _pack2(code), (g - deq).reshape(flat.shape)


def dequantize_flat(packed, n, threshold):
    """packed uint8 [ceil(n/4)] -> float32 [n] of {-t, 0, +t}."""
    codes = _unpack2(packed)[:n]
    return torch.where(codes == 1, threshold,
                       torch.where(codes == 2, -threshold, 0.0)) \
        .to(torch.float32)


def dequantize_sum_flat(packed_rows, n, threshold):
    """packed_rows [w, ceil(n/4)] uint8 -> float32 [n]: the sum over w of
    the dequantized rows, as ``threshold`` times the integer count of
    (+1, -1) codes (bit for bit the sum of the dequantized rows)."""
    codes = _unpack2(packed_rows)[:, :n]
    signed = torch.where(codes == 1, 1,
                         torch.where(codes == 2, -1, 0)).to(torch.int32)
    return threshold * signed.sum(dim=0).to(torch.float32)


class GradientCompression:
    """The store's 2-bit quantizer, with one residual per key (the key
    names the parameter and, for a multi-context push, the context)."""

    def __init__(self, threshold=0.5):
        self.threshold = float(threshold)
        self._residuals = {}

    def get_params(self):
        return {"type": "2bit", "threshold": self.threshold}

    def quantize(self, key, grad):
        """Packed uint8 codes of ``grad`` (a tensor) plus this key's
        residual, which takes the new quantization error."""
        res = self._residuals.get(key)
        if res is None:
            res = torch.zeros_like(grad)
        codes, self._residuals[key] = quantize_flat(grad, res,
                                                    self.threshold)
        return codes

    def dequantize(self, codes, shape, dtype=torch.float32):
        n = int(torch.Size(shape).numel())
        return dequantize_flat(codes, n, self.threshold) \
            .reshape(shape).to(dtype)

    def dequantize_sum(self, gathered, shape, dtype=torch.float32):
        """The dequantized sum of every participant's codes; ``gathered``
        is [participants, packed bytes] uint8, one row each."""
        n = int(torch.Size(shape).numel())
        return dequantize_sum_flat(gathered, n, self.threshold) \
            .reshape(shape).to(dtype)

"""Bucketed gradient collectives, optionally 2-bit compressed.

Counterpart of ``mxnet_tpu/parallel/comm.py``.  The JAX package shards
the gradient list into buckets in reverse-autodiff order and emits ONE
collective per bucket inside the step, so each bucket's reduction can
ride the interconnect while earlier layers still differentiate.  Two
wire formats per bucket:

- ``psum``: plain all-reduce in the gradient's dtype;
- ``2bit`` (``MXNET_TPU_GRAD_COMPRESS=2bit``): the reference's 2-bit
  error-feedback quantizer run per position — quantize(gradient +
  residual) with ``kvstore.gradient_compression.quantize_flat``, whose
  codes are the JAX package's byte for byte, then an all-gather of the
  packed uint8 codes (16x fewer wire bytes than f32), then
  ``dequantize_sum_flat`` of every position's codes.  The residual is one
  flat f32 vector per bucket per position.

The knobs are the JAX package's, read from the same variables
(``MXNET_TPU_COMM_BUCKET_MB``, ``MXNET_TPU_GRAD_COMPRESS``,
``MXNET_TPU_GRAD_COMPRESS_THRESHOLD``), and ``partition_buckets``,
``CommPlan`` and ``reshard_residuals`` give the JAX package's outputs.

Ordering: the JAX package chains bucket k's result into bucket k+1's
input with ``lax.optimization_barrier`` so XLA can neither combine nor
reorder the collectives.  The port runs eagerly, so nothing can combine
them: ``reduce_buckets`` issues one collective a bucket (counted by
``collectives.watch``), in plan order, on the stream, after the
backward has produced every gradient.  It keeps the structure (one
reduction a bucket, reverse declaration order) but does not overlap a
bucket's reduction with the rest of the backward.

Used by ``parallel/train.py`` (``ShardedTrainStep``'s overlap path).
"""
from __future__ import annotations

import logging
import os
from collections import namedtuple

import numpy as np
import torch

from ..kvstore.gradient_compression import (dequantize_sum_flat,
                                            packed_nbytes, quantize_flat)
from . import collectives
from .mesh import current_mesh

_logger = logging.getLogger("mxnet_tpu")

DEFAULT_BUCKET_MB = 4.0
_BUCKET_ENV = "MXNET_TPU_COMM_BUCKET_MB"
BUCKET_ENV = _BUCKET_ENV
_COMPRESS_ENV = "MXNET_TPU_GRAD_COMPRESS"
_THRESHOLD_ENV = "MXNET_TPU_GRAD_COMPRESS_THRESHOLD"
_warned = set()


def _warn_once(key, msg, *args):
    if key not in _warned:
        _warned.add(key)
        _logger.warning(msg, *args)


_BUCKET_OFF = object()  # explicit 0/off: force monolithic, beats compress


def bucket_mb():
    """The ``MXNET_TPU_COMM_BUCKET_MB`` knob: None = unset (overlap off
    unless compression requests the default bucketing), the
    ``_BUCKET_OFF`` sentinel for an explicit ``0``/``off`` (force the
    monolithic step even when ``MXNET_TPU_GRAD_COMPRESS`` is set — the
    single-knob kill switch), a positive float = bucket size in MB.
    Malformed values warn once and read as unset."""
    raw = os.environ.get(_BUCKET_ENV, "").strip().lower()
    if raw == "":
        return None
    if raw in ("0", "off", "false"):
        return _BUCKET_OFF
    try:
        mb = float(raw)
    except ValueError:
        _warn_once(("bucket", raw), "ignoring malformed %s=%r (want a "
                   "size in MB)", _BUCKET_ENV, raw)
        return None
    return mb if mb > 0 else _BUCKET_OFF


def compress_mode():
    """``MXNET_TPU_GRAD_COMPRESS``: '2bit' or None.  Any other value
    warns once and runs uncompressed."""
    raw = os.environ.get(_COMPRESS_ENV, "").strip().lower()
    if raw in ("", "0", "off", "false", "none"):
        return None
    if raw != "2bit":
        _warn_once(("compress", raw), "ignoring unsupported %s=%r (only "
                   "'2bit' is implemented)", _COMPRESS_ENV, raw)
        return None
    return "2bit"


def compress_threshold():
    raw = os.environ.get(_THRESHOLD_ENV, "").strip()
    if not raw:
        return 0.5
    try:
        return float(raw)
    except ValueError:
        _warn_once(("threshold", raw), "ignoring malformed %s=%r; using "
                   "0.5", _THRESHOLD_ENV, raw)
        return 0.5


CommConfig = namedtuple("CommConfig", ["bucket_bytes", "compress",
                                       "threshold"])


def comm_config():
    """The resolved comm configuration, or None when overlap is off.
    Setting ``MXNET_TPU_GRAD_COMPRESS`` alone implies overlap with the
    default bucket size — the compressed wire format only exists on the
    bucketed path.  An EXPLICIT ``MXNET_TPU_COMM_BUCKET_MB=0``/``off``
    forces the monolithic step even when compression is requested (the
    debugging kill switch)."""
    mb = bucket_mb()
    if mb is _BUCKET_OFF:
        return None
    compress = compress_mode()
    if mb is None and compress is None:
        return None
    if mb is None:
        mb = DEFAULT_BUCKET_MB
    return CommConfig(bucket_bytes=int(mb * 1024 * 1024), compress=compress,
                      threshold=compress_threshold() if compress else 0.0)


def comm_signature():
    """The comm component of a step's cache key: ``()`` when overlap is
    off, else (bucket bytes, wire format, threshold)."""
    cfg = comm_config()
    if cfg is None:
        return ()
    return (cfg.bucket_bytes, cfg.compress or "psum", cfg.threshold)


def _np_dtype(dtype):
    """numpy's dtype of a torch dtype, a numpy dtype or a name; bfloat16,
    which numpy lacks, as a 2-byte stand-in (only a dtype's size and
    identity matter here)."""
    if dtype in (torch.bfloat16, "bfloat16"):
        return np.dtype("V2")
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


# -- bucket partitioning ------------------------------------------------------

def partition_buckets(shapes, dtypes, bucket_bytes):
    """Partition gradient indices ``0..n-1`` into buckets in REVERSE
    order (reverse autodiff: the LAST parameter's gradient is the first
    the backward pass finishes).

    Returns a list of index lists forming an exact cover of
    ``reversed(range(n))``.  A bucket closes when adding the next
    gradient would exceed ``bucket_bytes`` (every bucket holds at least
    one gradient, so oversized tensors get a bucket of their own) or
    when the dtype changes — buckets concatenate into one flat wire
    buffer, and a mixed-dtype concat would silently promote."""
    buckets = []
    cur, cur_bytes, cur_dtype = [], 0, None
    for i in reversed(range(len(shapes))):
        dt = _np_dtype(dtypes[i])
        nbytes = int(np.prod(shapes[i], dtype=np.int64)) * dt.itemsize
        if cur and (cur_dtype != dt or cur_bytes + nbytes > bucket_bytes):
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nbytes
        cur_dtype = dt
    if cur:
        buckets.append(cur)
    return buckets


class CommPlan:
    """Static description of the bucketed reduction for one gradient
    list: which indices form each bucket, flat element counts, per-step
    wire accounting, and the residual shapes compression carries.
    ``dtypes`` are torch or numpy dtypes, kept as given."""

    __slots__ = ("buckets", "bucket_elems", "bucket_dtypes", "compress",
                 "threshold", "scale", "wire_bytes", "grad_bytes",
                 "grad_f32_bytes", "shapes", "dtypes")

    def __init__(self, shapes, dtypes, cfg, scale=1.0):
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.dtypes = list(dtypes)
        self.compress = cfg.compress
        self.threshold = float(cfg.threshold)
        self.scale = float(scale)
        self.buckets = partition_buckets(self.shapes, self.dtypes,
                                         cfg.bucket_bytes)
        self.bucket_elems = [
            sum(int(np.prod(self.shapes[i], dtype=np.int64)) for i in b)
            for b in self.buckets]
        self.bucket_dtypes = [self.dtypes[b[0]] for b in self.buckets]
        # wire accounting (per worker per step): what each participant
        # contributes to the collective.  grad_bytes is the uncompressed
        # payload in storage dtype; grad_f32_bytes the f32 equivalent.
        self.grad_bytes = sum(
            n * _np_dtype(dt).itemsize
            for n, dt in zip(self.bucket_elems, self.bucket_dtypes))
        self.grad_f32_bytes = 4 * sum(self.bucket_elems)
        if self.compress:
            self.wire_bytes = sum(packed_nbytes(n)
                                  for n in self.bucket_elems)
        else:
            self.wire_bytes = self.grad_bytes

    @property
    def n_buckets(self):
        return len(self.buckets)

    def residual_shapes(self):
        """Flat per-position residual vector shapes, one per bucket (empty
        when not compressing — plain psum carries no feedback state)."""
        if not self.compress:
            return []
        return [(n,) for n in self.bucket_elems]


def reduce_buckets(grads, axis_name, plan, residuals=None, mesh=None):
    """The bucketed reduction over ``axis_name`` of ``mesh`` (default: the
    current mesh).  ``grads`` holds one gradient list per mesh position
    (flat position order): each position's partial gradients;
    ``residuals`` one list of flat f32 error-feedback vectors (one per
    bucket) per position when ``plan.compress``.

    Returns ``(reduced_grads, new_residuals)``, both one list per
    position: every reduced gradient is the sum over the axis times
    ``plan.scale``, in its original shape and dtype.  One collective a
    bucket, in plan order (reverse declaration)."""
    mesh = mesh or current_mesh()
    n_pos = len(grads)
    out = [[None] * len(g) for g in grads]
    new_residuals = [[] for _ in range(n_pos)]
    for bi, idxs in enumerate(plan.buckets):
        flats = []
        for g in grads:
            parts = [g[i].reshape(-1) for i in idxs]
            flats.append(parts[0] if len(parts) == 1 else torch.cat(parts))
        if plan.compress:
            packed = []
            for p, flat in enumerate(flats):
                flat = flat.to(torch.float32)
                if plan.scale != 1.0:
                    flat = flat * plan.scale
                carry = flat + residuals[p][bi]
                codes, new_res = quantize_flat(
                    carry, torch.zeros_like(carry), plan.threshold)
                packed.append(codes)
                new_residuals[p].append(new_res)
            reduced = [dequantize_sum_flat(rows, plan.bucket_elems[bi],
                                           plan.threshold)
                       for rows in collectives.all_gather(packed, mesh,
                                                          axis_name)]
        else:
            reduced = collectives.psum(flats, mesh, axis_name)
            if plan.scale != 1.0:
                reduced = [r * plan.scale for r in reduced]
        for p in range(n_pos):
            offset = 0
            for i in idxs:
                n = int(np.prod(plan.shapes[i], dtype=np.int64))
                seg = reduced[p][offset:offset + n]
                out[p][i] = seg.reshape(plan.shapes[i]).to(
                    grads[p][i].dtype)
                offset += n
    return out, new_residuals


# -- elastic resume: residual resharding --------------------------------------

def reshard_residuals(buckets, new_dp):
    """Re-factorize checkpointed error-feedback residuals onto a new dp
    width (elastic resume: surviving-worker count != original).

    Each bucket rides as ``(dp, n)`` — one flat f32 error vector per
    shard.  When workers merge (``old_dp`` divisible by ``new_dp``) the
    pending quantization error is conserved by SUM-merging each group
    of ``old_dp // new_dp`` old shards into the new shard that takes
    over their data.  A width the old one does not divide (including
    growing the mesh) has no information-preserving mapping — the caller
    drops the residuals with a warning.

    Returns ``(new_buckets, None)`` or ``(None, reason)``."""
    out = []
    for j, bucket in enumerate(buckets):
        arr = np.asarray(bucket, np.float32)
        if arr.ndim != 2:
            return None, ("bucket %d has rank %d, expected (dp, n)"
                          % (j, arr.ndim))
        old_dp = arr.shape[0]
        if old_dp == new_dp:
            out.append(arr)
            continue
        if new_dp <= 0 or old_dp % new_dp:
            return None, ("dp axis %d is not divisible by the new "
                          "factorization %d" % (old_dp, new_dp))
        out.append(arr.reshape(new_dp, old_dp // new_dp,
                               arr.shape[1]).sum(axis=1))
    return out, None

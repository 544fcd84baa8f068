"""Gluon utilities (ref: python/mxnet/gluon/utils.py).

Counterpart of ``mxnet_tpu/gluon/utils.py``: batch splitting across
contexts, global-norm clipping, repr indentation and ``check_sha1``.
``download`` raises, as the JAX package's does: neither package fetches
files; place them locally.
"""
from __future__ import annotations

import hashlib
import math

from ..base import MXNetError
from ..ndarray import NDArray, array


def _slice_bounds(size, num_slice):
    """[(start, stop)] per slice; the LAST slice absorbs the remainder."""
    step = size // num_slice
    bounds = [(i * step, (i + 1) * step) for i in range(num_slice)]
    return bounds[:-1] + [((num_slice - 1) * step, size)]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """Split an NDArray into num_slice chunks along batch_axis."""
    size = data.shape[batch_axis]
    if size < num_slice:
        raise ValueError(
            "Too many slices for data with shape %s. Arguments are "
            "num_slice=%d and batch_axis=%d."
            % (data.shape, num_slice, batch_axis))
    if even_split and size % num_slice:
        raise ValueError(
            "data with shape %s cannot be evenly split into %d slices "
            "along axis %d. Use a batch size that's multiple of %d or set "
            "even_split=False to allow uneven partitioning of data."
            % (data.shape, num_slice, batch_axis, num_slice))
    lead = (slice(None),) * batch_axis
    return [data[lead + (slice(lo, hi),)]
            for lo, hi in _slice_bounds(size, num_slice)]


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """split_data, then place one slice per context."""
    if not isinstance(data, NDArray):
        data = array(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    return [piece.as_in_context(ctx)
            for piece, ctx in zip(
                split_data(data, len(ctx_list), batch_axis, even_split),
                ctx_list)]


def clip_global_norm(arrays, max_norm):
    """Rescale arrays in place so their joint 2-norm is <= max_norm;
    returns the pre-clip norm."""
    assert len(arrays) > 0
    live = [a for a in arrays if a is not None]
    total = math.sqrt(sum(float(a.norm().asscalar()) ** 2 for a in live))
    ratio = max_norm / (total + 1e-8)
    if ratio < 1.0:
        for a in live:
            a *= ratio
    return total


def _indent(text, spaces):
    """Indent every line but the first (block repr nesting)."""
    head, sep, rest = text.partition("\n")
    if not sep:
        return text
    pad = " " * spaces
    return head + "\n" + "\n".join(pad + line for line in rest.split("\n"))


def check_sha1(filename, sha1_hash):
    """Whether the SHA-1 digest of the file equals ``sha1_hash``."""
    digest = hashlib.sha1()
    with open(filename, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None):
    """Raises ``MXNetError``: nothing is fetched over the network."""
    raise MXNetError("network access is not available in this environment; "
                     "place files locally instead")

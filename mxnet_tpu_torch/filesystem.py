"""Pluggable URI streams.

Counterpart of ``mxnet_tpu/filesystem.py``.  Parity target: dmlc-core's
``dmlc::Stream::Create`` URI dispatch: the reference reads ``.rec`` files
from ``s3://bucket/...`` and ``hdfs://namenode/...`` when built with
USE_S3/USE_HDFS.  Here the dispatch is a scheme registry: local paths (no
scheme, or ``file://``) open directly; any other scheme routes to a
registered opener, so an S3/GCS/HDFS backend is one ``register_scheme``
call with whatever client library the deployment uses (boto3, fsspec,
pyarrow.fs, ...); no client is bundled.

    import fsspec
    from mxnet_tpu_torch import filesystem
    filesystem.register_scheme("s3", lambda path, mode:
                               fsspec.open("s3://" + path, mode).open())

Consumers: ``recordio.MXRecordIO`` (and the indexed variant),
``image.ImageIter.read_image``, ``nd.save``/``nd.load`` and
``Symbol.save``/``sym.load`` (so checkpoints and Gluon's parameter files
too).
"""
from __future__ import annotations

import re

from .base import MXNetError

_SCHEMES = {}

_URI_RE = re.compile(r"^([a-zA-Z][a-zA-Z0-9+.\-]*)://(.*)$")


def split_uri(uri):
    """(scheme, path); scheme is '' for plain local paths.  Windows
    drive letters (one char) are not schemes."""
    m = _URI_RE.match(str(uri))
    if m and len(m.group(1)) > 1:
        return m.group(1).lower(), m.group(2)
    return "", str(uri)


def is_remote(uri):
    scheme, _ = split_uri(uri)
    return scheme not in ("", "file")


def register_scheme(scheme, opener):
    """Register `opener(path, mode) -> file-like` for `scheme://path`
    URIs.  mode is 'rb'/'wb'/'r'/'w'.  Returns any previously
    registered opener (None otherwise) so callers can restore it."""
    scheme = scheme.lower()
    prev = _SCHEMES.get(scheme)
    _SCHEMES[scheme] = opener
    return prev


def unregister_scheme(scheme):
    _SCHEMES.pop(scheme.lower(), None)


def open_uri(uri, mode="rb"):
    """Open a local path or a registered-scheme URI as a file object."""
    scheme, path = split_uri(uri)
    if scheme in ("", "file"):
        return open(path, mode)
    opener = _SCHEMES.get(scheme)
    if opener is None:
        raise MXNetError(
            "no stream backend registered for %r URIs (got %r); call "
            "mxnet_tpu_torch.filesystem.register_scheme(%r, opener) with your "
            "client library — e.g. fsspec: register_scheme(%r, lambda "
            "path, mode: fsspec.open(%r + path, mode).open())"
            % (scheme, uri, scheme, scheme, scheme + "://"))
    return opener(path, mode)

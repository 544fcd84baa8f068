"""Experimental contrib namespace (ref: python/mxnet/contrib/__init__.py).

Op-level contrib lives in mx.nd.contrib / mx.sym.contrib; this package
holds the non-op extras (the TensorBoard bridge), as the JAX package's
``mxnet_tpu/contrib/`` does.
"""
from __future__ import annotations

from . import tensorboard  # noqa: F401

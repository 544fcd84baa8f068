"""Pretrained-weight store (ref: gluon/model_zoo/model_store.py).

Counterpart of ``mxnet_tpu/gluon/model_zoo/model_store.py``.  The
reference downloads SHA1-pinned ``.params`` files; this package, like the
JAX one, has no network access, so the store resolves names in a local
directory only (``MXNET_TPU_MODEL_DIR``, default ``~/.mxnet/models``):
the same file format (``Block.load_params``; a file saved by either
package loads in both) and the same API.
"""
from __future__ import annotations

import os

__all__ = ["get_model_file", "load_pretrained", "purge"]

_model_sha1 = {}


def get_model_file(name, root=None):
    root = root or os.environ.get(
        "MXNET_TPU_MODEL_DIR",
        os.path.join(os.path.expanduser("~"), ".mxnet", "models"))
    file_path = os.path.join(root, "%s.params" % name)
    if os.path.exists(file_path):
        return file_path
    raise FileNotFoundError(
        "pretrained model file %s not found; this environment has no "
        "network egress — place the .params file there manually" % file_path)


def load_pretrained(net, name, ctx=None, root=None):
    net.load_params(get_model_file(name, root), ctx=ctx)
    return net


def purge(root=None):
    root = root or os.path.join(os.path.expanduser("~"), ".mxnet", "models")
    if os.path.isdir(root):
        for f in os.listdir(root):
            if f.endswith(".params"):
                os.remove(os.path.join(root, f))

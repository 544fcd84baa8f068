"""mx.nd.linalg: the imperative linear-algebra ops (ref:
python/mxnet/ndarray/linalg.py; ops of src/operator/tensor/la_op.h).

Counterpart of ``mxnet_tpu/ndarray/linalg.py``: every registered op named
``_linalg_<name>`` is ``mx.nd.linalg.<name>``."""
from __future__ import annotations

from . import _make_op_func as _maker
from ._prefix_ns import make_getattr, populate

populate(globals(), "_linalg_", _maker)
__getattr__ = make_getattr(__name__, globals(), "_linalg_", _maker)

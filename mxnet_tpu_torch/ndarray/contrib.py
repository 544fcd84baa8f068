"""mx.nd.contrib: the imperative contrib ops (ref:
python/mxnet/ndarray/contrib.py; ops of src/operator/contrib/).

Counterpart of ``mxnet_tpu/ndarray/contrib.py``: every registered op named
``_contrib_<name>`` is ``mx.nd.contrib.<name>``."""
from __future__ import annotations

from . import _make_op_func as _maker
from ._prefix_ns import make_getattr, populate

populate(globals(), "_contrib_", _maker)
__getattr__ = make_getattr(__name__, globals(), "_contrib_", _maker)

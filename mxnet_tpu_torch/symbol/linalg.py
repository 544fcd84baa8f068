"""mx.sym.linalg: the symbolic linear-algebra ops (ref:
python/mxnet/symbol/linalg.py).

Counterpart of ``mxnet_tpu/symbol/linalg.py``: every registered op named
``_linalg_<name>`` is ``mx.sym.linalg.<name>``."""
from __future__ import annotations

from . import _make_sym_func as _maker
from ..ndarray._prefix_ns import make_getattr, populate

populate(globals(), "_linalg_", _maker)
__getattr__ = make_getattr(__name__, globals(), "_linalg_", _maker)

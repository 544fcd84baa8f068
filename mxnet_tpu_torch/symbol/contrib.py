"""mx.sym.contrib: the symbolic contrib ops (ref:
python/mxnet/symbol/contrib.py).

Counterpart of ``mxnet_tpu/symbol/contrib.py``: every registered op named
``_contrib_<name>`` is ``mx.sym.contrib.<name>``."""
from __future__ import annotations

from . import _make_sym_func as _maker
from ..ndarray._prefix_ns import make_getattr, populate

populate(globals(), "_contrib_", _maker)
__getattr__ = make_getattr(__name__, globals(), "_contrib_", _maker)

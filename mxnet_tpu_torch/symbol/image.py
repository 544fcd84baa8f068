"""mx.sym.image: the symbolic image ops (ref: python/mxnet/symbol/image.py).

Counterpart of ``mxnet_tpu/symbol/image.py``: every registered op named
``_image_<name>`` is ``mx.sym.image.<name>``."""

from ..ops import registry as _registry
from . import _make_sym_func

for _name, _op in list(_registry.op_registry().items()):
    if _name.startswith("_image_"):
        _fn = _make_sym_func(_name, _op)
        _fn.__name__ = _name[len("_image_"):]
        globals()[_fn.__name__] = _fn

"""mx.nd.image: the imperative image ops (ref: python/mxnet/ndarray/image.py;
ops of src/operator/image/image_random-inl.h).

Counterpart of ``mxnet_tpu/ndarray/image.py``: every registered op named
``_image_<name>`` is ``mx.nd.image.<name>``."""

from ..ops import registry as _registry
from . import _make_op_func

for _name, _op in list(_registry.op_registry().items()):
    if _name.startswith("_image_"):
        _fn = _make_op_func(_name, _op)
        _fn.__name__ = _name[len("_image_"):]
        globals()[_fn.__name__] = _fn

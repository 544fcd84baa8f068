"""mx.nd namespace: NDArray, its constructors, the ``.params`` format, and
one imperative function per registered op (``mx.nd.FullyConnected(x, w,
b, num_hidden=4)``, ``mx.nd.random_uniform(...)``), generated from the
registry as the JAX package's ``ndarray/__init__.py`` generates them;
``mx.nd.random`` holds the samplers."""
from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry
from .ndarray import (  # noqa: F401
    NDArray, _invoke, arange, array, concatenate, empty, from_dlpack,
    from_numpy, full, invoke, load, loads, moveaxis, ones, save,
    to_dlpack_for_read, to_dlpack_for_write, waitall, zeros,
)


def _make_op_func(canonical, op):
    def fn(*args, **kwargs):
        out = kwargs.pop("out", None)
        kwargs.pop("name", None)
        inputs, scalar_pos = [], []
        for a in args:
            if isinstance(a, NDArray):
                inputs.append(a)
            elif isinstance(a, (list, tuple)) and a \
                    and isinstance(a[0], NDArray):
                inputs.extend(a)
            else:
                scalar_pos.append(a)
        nd_kwargs = {k: v for k, v in kwargs.items()
                     if isinstance(v, NDArray)}
        attrs = {k: v for k, v in kwargs.items()
                 if not isinstance(v, NDArray)}
        if nd_kwargs:
            for n in tuple(op.input_names or ()) + op.aux_names:
                if n in nd_kwargs:
                    inputs.append(nd_kwargs.pop(n))
            inputs.extend(nd_kwargs.values())
        # non-NDArray positional args fill the declared attrs in order
        # (nd.clip(x, a_min, a_max))
        free = [k for k in op.params if k not in attrs]
        attrs.update(zip(free, scalar_pos))
        return _invoke(canonical, inputs, attrs, out=out)

    fn.__name__ = canonical
    fn.__doc__ = op.doc or ("%s (generated from the op registry)"
                            % canonical)
    return fn


from . import sparse  # noqa: E402  (ref: ndarray/sparse.py)


def cast_storage(data, stype="default"):
    """Storage-aware cast (ref: cast_storage op): the dense-to-sparse
    direction gives a sparse array (the registered op of the same name
    serves symbol graphs, where it is the identity)."""
    return sparse.cast_storage(data, stype)


_mod = _sys.modules[__name__]
for _name, _op in list(_registry.op_registry().items()):
    if _name.replace("_", "a").isidentifier() and not hasattr(_mod, _name):
        setattr(_mod, _name, _make_op_func(_name, _op))

onehot_encode = one_hot  # noqa: F821  the generated op function, as in the reference

from . import random  # noqa: F401,E402  (ref: ndarray/random.py)
from . import linalg  # noqa: F401,E402  (ref: ndarray/linalg.py)
from . import contrib  # noqa: F401,E402  (ref: ndarray/contrib.py)
from . import image  # noqa: F401,E402  (ref: ndarray/image.py)

"""mx.sym namespace: Symbol plus one composition function per registered
op (``mx.sym.FullyConnected(data, num_hidden=4, name="fc")``);
``mx.sym.random`` holds the samplers."""
from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry
from .symbol import (  # noqa: F401
    AttrScope, Group, NameManager, Symbol, Variable, _create, arange, load,
    load_json, ones, var, zeros,
)


def _make_sym_func(name, op):
    def fn(*args, **kwargs):
        node_name = kwargs.pop("name", None)
        attr_extra = kwargs.pop("attr", None)
        inputs = [a for a in args if isinstance(a, Symbol)]
        named = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
        for n in tuple(op.input_names or ()) + op.aux_names:
            if n in named:
                inputs.append(named.pop(n))
        inputs.extend(named.values())
        out = _create(name, inputs, attrs, name=node_name)
        if attr_extra:
            out._set_attr(**attr_extra)
        return out

    fn.__name__ = name
    fn.__doc__ = op.doc or ("%s (generated symbol op)" % name)
    return fn


_mod = _sys.modules[__name__]
for _name, _op in list(_registry.op_registry().items()):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_sym_func(_name, _op))

from . import random  # noqa: F401,E402  (ref: symbol/random.py)
from . import linalg  # noqa: F401,E402  (ref: symbol/linalg.py)
from . import contrib  # noqa: F401,E402  (ref: symbol/contrib.py)
from . import image  # noqa: F401,E402  (ref: symbol/image.py)

"""mx.sym namespace: Symbol plus one composition function per registered
op (``mx.sym.FullyConnected(data, num_hidden=4, name="fc")``)."""
from __future__ import annotations

import sys as _sys

from ..ops import registry as _registry
from .symbol import (  # noqa: F401
    Group, NameManager, Symbol, Variable, _create, load, load_json, var,
)


def _make_sym_func(name, op):
    def fn(*args, **kwargs):
        node_name = kwargs.pop("name", None)
        inputs = [a for a in args if isinstance(a, Symbol)]
        named = {k: v for k, v in kwargs.items() if isinstance(v, Symbol)}
        attrs = {k: v for k, v in kwargs.items() if not isinstance(v, Symbol)}
        for n in tuple(op.input_names or ()) + op.aux_names:
            if n in named:
                inputs.append(named.pop(n))
        inputs.extend(named.values())
        return _create(name, inputs, attrs, name=node_name)

    fn.__name__ = name
    fn.__doc__ = op.doc or ("%s (generated symbol op)" % name)
    return fn


_mod = _sys.modules[__name__]
for _name, _op in list(_registry.op_registry().items()):
    if not hasattr(_mod, _name):
        setattr(_mod, _name, _make_sym_func(_name, _op))

"""Parameters from numpy: how weights made elsewhere enter the port.

``params_from_numpy`` takes a {name: numpy array} dict — the JAX
package's parameters as ``asnumpy()`` gives them, or weights generated
from a seed — with or without the ``arg:``/``aux:`` prefixes of a
``.params`` file, and returns the port's ``(arg_params, aux_params)``.
"""
from __future__ import annotations

from .context import current_context
from .ndarray import array


def params_from_numpy(arrays, ctx=None):
    """{name: np.ndarray} -> (arg_params, aux_params) of NDArrays on
    ``ctx`` (default: the current context).  ``aux:``-prefixed names are
    auxiliary states; ``arg:``-prefixed and bare names are arguments."""
    ctx = ctx or current_context()
    arg_params, aux_params = {}, {}
    for name, value in arrays.items():
        table = arg_params
        if name.startswith("aux:"):
            table, name = aux_params, name[4:]
        elif name.startswith("arg:"):
            name = name[4:]
        table[name] = array(value, ctx=ctx)
    return arg_params, aux_params

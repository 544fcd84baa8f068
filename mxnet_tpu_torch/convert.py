"""Parameters from numpy: how weights made elsewhere enter the port.

``params_from_numpy`` takes a {name: numpy array} dict — the JAX
package's parameters as ``asnumpy()`` gives them, or weights generated
from a seed — with or without the ``arg:``/``aux:`` prefixes of a
``.params`` file, and returns the port's ``(arg_params, aux_params)``.
``set_gluon_params`` writes such a dict, or a ``.params`` file saved by
either package, into a Gluon net's Parameters.
"""
from __future__ import annotations

from .base import MXNetError
from .context import cpu, current_context
from .ndarray import NDArray, array, load


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


def set_gluon_params(net, source, ctx=None):
    """Set every Parameter of Gluon ``net`` from ``source``: a {name:
    numpy array or NDArray} dict or the path of a ``.params`` file.
    Names may be full (``collect_params()`` keys), carry the
    ``arg:``/``aux:`` prefixes of an export, or lack the net's prefix (a
    ``save_params`` file).  Parameters not yet initialized are placed on
    ``ctx`` (default: the current context) with the loaded shape, so no
    forward is needed first.  Every Parameter must be covered."""
    if isinstance(source, str):
        source = load(source)
    params = net.collect_params()
    seen = set()
    for name, value in source.items():
        if name.startswith(("arg:", "aux:")):
            name = name[4:]
        if name not in params.keys():
            name = net.prefix + name
        if name not in params.keys():
            raise MXNetError("set_gluon_params: %r names no Parameter of %s"
                             % (name, net.name))
        if not isinstance(value, NDArray):
            value = array(value, ctx=cpu())
        params[name]._load_init(value, ctx)
        seen.add(name)
    missing = sorted(set(params.keys()) - seen)
    if missing:
        raise MXNetError("set_gluon_params: no value for %s" % missing)

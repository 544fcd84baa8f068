"""Prefix-based op namespaces.

Counterpart of ``mxnet_tpu/ndarray/_prefix_ns.py``.  The reference
code-generates ``ndarray.linalg.gemm`` from the C-registry op
``_linalg_gemm`` (and likewise ``contrib.*``) in
python/mxnet/ndarray/register.py ``_init_op_module``; here every op of the
port's registry named ``<prefix><name>`` is ``<name>`` in the namespace
module.
"""
from __future__ import annotations

from ..ops import registry as _registry


def populate(mod_dict, prefix, maker):
    """Fill a module dict with ops whose registered name starts with
    ``prefix``."""
    for name, op in _registry.op_registry().items():
        if not name.startswith(prefix):
            continue
        short = name[len(prefix):]
        if not short.isidentifier() or short in mod_dict:
            continue
        fn = maker(name, op)
        fn.__name__ = short
        mod_dict[short] = fn


def make_getattr(module_name, mod_dict, prefix, maker):
    """A module ``__getattr__`` through which ops registered later appear
    in the namespace."""
    def _getattr(name):
        tbl = _registry.op_registry()
        canonical = prefix + name
        if canonical in tbl:
            fn = maker(canonical, tbl[canonical])
            fn.__name__ = name
            mod_dict[name] = fn
            return fn
        raise AttributeError("module %r has no attribute %r"
                             % (module_name, name))
    return _getattr

"""Parameters from numpy: how weights made elsewhere enter the port.

``params_from_numpy`` takes a {name: numpy array} dict — the JAX
package's parameters as ``asnumpy()`` gives them, or weights generated
from a seed — with or without the ``arg:``/``aux:`` prefixes of a
``.params`` file, and returns the port's ``(arg_params, aux_params)``.
``set_gluon_params`` writes such a dict, or a ``.params`` file saved by
either package, into a Gluon net's Parameters.  ``set_parallel_state``
carries a JAX ``ShardedTrainStep``'s parameters and momentum, or a JAX
``MoELayer``'s weights, as numpy arrays into the port's step or layer;
``set_mesh_module_state`` a JAX ``ShardedModule``'s or
``PipelineModule``'s parameters, optimizer state and moving statistics
into the port's module on its mesh; ``set_fused_step_state`` a JAX
``Module``'s fused train step (one context or data-parallel): its
masters, optimizer states, moving statistics and 2-bit residuals.
``sparse_from_numpy`` carries a JAX ``RowSparseNDArray`` or
``CSRNDArray`` across as its numpy ``data``/``indices``/``indptr``.
"""
from __future__ import annotations

import numpy as np
import torch

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


def sparse_from_numpy(stype, shape, data, indices, indptr=None, ctx=None):
    """The port's sparse array from a sparse array's numpy components (a
    JAX ``RowSparseNDArray``'s ``data.asnumpy()`` and
    ``indices.asnumpy()``, a ``CSRNDArray``'s also ``indptr``), kept as
    they are (no re-sorting), on ``ctx`` (default: the current context)."""
    from .ndarray.sparse import CSRNDArray, RowSparseNDArray
    ctx = ctx or current_context()
    data = array(np.asarray(data), ctx=ctx)
    indices = array(np.asarray(indices, np.int64), ctx=ctx, dtype=np.int64)
    if stype == "row_sparse":
        return RowSparseNDArray(data, indices, shape)
    if stype == "csr":
        return CSRNDArray(data, indices, array(np.asarray(indptr, np.int64),
                                               ctx=ctx, dtype=np.int64),
                          shape)
    raise MXNetError("sparse_from_numpy: unknown storage type %r" % stype)


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


def set_parallel_state(target, arrays, momentum=None, mesh=None):
    """Write numpy arrays into an ``mx.parallel`` object.

    - ``target`` a ``ShardedTrainStep``: ``arrays`` (and ``momentum``)
      are {name: array} of its parameters (as ``np.asarray(jax_step.
      params[name])`` and ``momentum_buf`` give them); each is sharded by
      the step's ``param_sharding`` over its mesh.  ``mesh`` must be the
      step's own if given.
    - ``target`` a ``MoELayer``: ``arrays`` holds ``gate_w``, ``w1`` and
      ``w2``; they are placed on ``mesh``'s first position (default: the
      layer's current device).
    Every name the target holds must be covered."""
    from .parallel import MoELayer, ShardedTrainStep, shard
    from .parallel.mesh import host_tensor
    if isinstance(target, ShardedTrainStep):
        if mesh is not None and mesh is not target.mesh:
            raise MXNetError("set_parallel_state: a ShardedTrainStep keeps "
                             "its own mesh")
        for table, values in ((target.params, arrays),
                              (target.momentum_buf, momentum)):
            if values is None:
                continue
            if set(values) != set(table):
                raise MXNetError("set_parallel_state: names %s, the step "
                                 "holds %s" % (sorted(values), sorted(table)))
            for name, value in values.items():
                if tuple(value.shape) != table[name].shape:
                    raise MXNetError("set_parallel_state: %s has shape %s, "
                                     "the step's %s" % (name, value.shape,
                                                        table[name].shape))
                table[name] = shard(value, target.param_sharding[name])
        return target
    if isinstance(target, MoELayer):
        names = ("gate_w", "w1", "w2")
        if set(arrays) != set(names):
            raise MXNetError("set_parallel_state: a MoELayer takes %s, got %s"
                             % (names, sorted(arrays)))
        dev = mesh.torch_devices[0] if mesh is not None \
            else target.gate_w.device
        for name in names:
            setattr(target, name, host_tensor(arrays[name]).to(dev))
        return target
    raise MXNetError("set_parallel_state: %r is neither a ShardedTrainStep "
                     "nor a MoELayer" % (target,))


def set_mesh_module_state(target, params, momentum=None, aux=None):
    """Write numpy arrays into a bound, initialized ``mx.mod``
    ``ShardedModule`` or ``PipelineModule``; each array is sharded as the
    module shards that name on its mesh.

    - ``ShardedModule``: ``params`` {name: array} of every parameter
      (``np.asarray(jax_mod._masters[name])``), ``aux`` {name: array} of
      the moving statistics (``_dev_aux``), ``momentum`` {name: state}
      of the optimizer's states, an array or a tuple of arrays as
      ``create_state`` makes them (``_states``; the module's optimizer
      must be initialized).
    - ``PipelineModule``: ``params`` and ``momentum`` keyed as the
      module keys them (``"body:<name>"`` with the stages stacked on dim
      0, ``"stem:<name>"``, ``"head:<name>"``: ``jax_mod._params`` and
      ``_mom``).
    Every name the module holds must be covered."""
    from .module.fused_step import _map_state
    from .module.pipeline_module import PipelineModule
    from .module.sharded import ShardedModule
    from .parallel import ShardedArray, shard
    if not (target.binded and target.params_initialized):
        raise MXNetError("set_mesh_module_state: bind and init_params "
                         "first")

    def covered(values, table, what):
        if set(values) != set(table):
            raise MXNetError("set_mesh_module_state: %s names %s, the "
                             "module holds %s" % (what, sorted(values),
                                                  sorted(table)))

    if isinstance(target, PipelineModule):
        covered(params, target._params, "params")
        for name, value in params.items():
            target._params[name] = shard(value,
                                         target._param_sharding[name])
        if momentum is not None:
            if target._mom is None:
                raise MXNetError("set_mesh_module_state: init_optimizer "
                                 "first")
            covered(momentum, target._mom, "momentum")
            for name, value in momentum.items():
                target._mom[name] = shard(value,
                                          target._param_sharding[name])
        return target
    if not isinstance(target, ShardedModule):
        raise MXNetError("set_mesh_module_state: %r is neither a "
                         "ShardedModule nor a PipelineModule" % (target,))
    covered(params, target._param_names + target._fixed_param_names,
            "params")
    covered(aux or {}, target._aux_names, "aux")
    target.init_params(
        initializer=None,
        arg_params=params_from_numpy(params, cpu())[0],
        aux_params=params_from_numpy(aux or {}, cpu())[0], force_init=True)
    if target.optimizer_initialized:
        for name in target._param_names:
            dev = target._dev_params[name]
            target._masters[name] = ShardedArray(
                [s.float() for s in dev.shards], dev.sharding, dev.shape) \
                if target._mixed[name] else dev
    if momentum is not None:
        if not target.optimizer_initialized:
            raise MXNetError("set_mesh_module_state: init_optimizer first")
        covered(momentum, target._param_names, "momentum")
        for name, state in momentum.items():
            sharding = target._param_sharding[name]
            target._states[name] = _map_state(
                lambda a, s=sharding: shard(a, s), state)
    return target


def set_fused_step_state(module, source):
    """Write the state of ``source``'s fused train step (a JAX package
    ``Module`` whose fused step has run, one context or data-parallel)
    into ``module``'s (a port ``Module`` whose ``init_optimizer`` engaged
    the fused step): the step's ``_masters``, ``states``, ``_gaux`` and
    ``_residuals``, read as numpy.  The parameters go to the masters,
    every context's replica (cast to its storage) and the host copies,
    the moving statistics to every context and the host copies."""
    from .module.fused_step import _map_state
    from .optimizer import state_leaves
    fs = module._fused_step
    step = source._fused_step
    if fs is None or step is None:
        raise MXNetError("set_fused_step_state: both modules need a fused "
                         "step (init_optimizer under its gating; the "
                         "source's must have run)")
    names = list(step.param_names)
    params = {n: np.asarray(m) for n, m in zip(names, step._masters)}
    states = {n: _map_state(np.asarray, st)
              for n, st in zip(names, step.states)}
    aux = {n: np.asarray(a) for n, a in zip(step.prog.aux_names, step._gaux)}
    residuals = [np.asarray(r) for r in step._residuals]
    shared = fs.shared
    if set(params) != set(shared.masters):
        raise MXNetError("set_fused_step_state: the source trains %s, the "
                         "step %s" % (sorted(params),
                                      sorted(shared.masters)))
    if [r.shape for r in residuals] != [r.shape for r in fs._residuals]:
        raise MXNetError("set_fused_step_state: residuals of shapes %s for "
                         "the step's %s" % ([r.shape for r in residuals],
                                            [r.shape for r in fs._residuals]))

    def host(value):
        return torch.from_numpy(np.array(value, copy=True))

    with torch.no_grad():
        for name, value in params.items():
            t = host(value)
            if shared.mixed[name]:
                shared.masters[name].copy_(t)
                t = shared.masters[name]
            for exe in fs.execs:
                exe.arg_dict[name].tensor.copy_(t)
            module._arg_params[name].tensor.copy_(t)
        for name, st in states.items():
            for dst, src in zip(state_leaves(shared.states[name]),
                                state_leaves(st)):
                dst.copy_(host(src))
        for name, value in aux.items():
            for exe in fs.execs:
                exe.aux_dict[name].tensor.copy_(host(value))
            module._aux_params[name].tensor.copy_(host(value))
        for r, value in zip(fs._residuals, residuals):
            for k, s in enumerate(r.shards):
                s.copy_(host(value)[k:k + 1])
    for s in shared.steps:
        s._note_seen()
    return module

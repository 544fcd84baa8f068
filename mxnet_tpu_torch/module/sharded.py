"""ShardedModule: the Module API over a device mesh.

Counterpart of ``mxnet_tpu/module/sharded.py``, with its constructor,
partition rules, errors and messages.  The user hands the module a mesh
and, optionally, per-parameter partition specs.  Partition resolution per
parameter, first match wins:

1. the ``param_partition={name: PartitionSpec}`` constructor argument;
2. a ``__shard__`` attr on the variable (``mx.sym.var(name,
   __shard__="tp,None")``);
3. the default rule (``parallel.mesh.shard_params_rule``): 2-D and conv
   weights split over tp when divisible, everything else replicated.

Parameters, their optimizer states and the moving statistics live on the
mesh as ``parallel.ShardedArray``s.  Batch inputs shard over dp on dim
0; ``sequence_axis=1`` also shards that dim over sp.

The JAX package compiles the step into one SPMD program and GSPMD splits
every op over the mesh.  The port has no sharding propagation, so it
computes once per dp group, on the group's first position: the position
with that dp coordinate and index 0 on every other axis.  A step:

- the group's copy of each parameter is the parameter's shards
  ``all_gather``ed (counted in ``parallel.collectives``);
- its rows are the batch's dp shard, gathered over sp first;
- ``_spmd.GroupProgram`` runs forward and backward over every group in
  lockstep, so BatchNorm and ``SoftmaxOutput`` see the global batch;
- each gradient is psum'd over dp, in position order;
- each position slices its block of the gradient and runs
  ``optimizer.fused_update`` on its shard of the master and state.
  The JAX step updates the global arrays; shard by shard is exact,
  since every optimizer's ``fused_update`` is elementwise.

So tp and sp shard storage and the update, and dp splits compute.  A
graph with an op that cannot run on one group's rows (``_spmd``'s
tables) runs over the global batch on the mesh's first position
instead, as ``ShardedTrainStep`` does outside its primitives: still the
JAX package's math.  ``dp_mode`` reads ``"split"`` or ``"global"``,
and ``dp_mode_reason`` names the op that forced ``"global"``.
``collectives`` holds the last step's collectives by kind.
"""
from __future__ import annotations

import logging

import torch

from ..base import MXNetError, dtype_name, torch_dtype
from ..context import cpu
from ..initializer import Uniform, InitDesc
from ..ndarray import NDArray, zeros as nd_zeros
from .. import optimizer as opt
from .. import random as _random
from ..optimizer import _is_low_precision, apply_update
from ..parallel import collectives
from ..parallel.mesh import (Mesh, MeshSpec, NamedSharding, P, ShardedArray,
                             _as_tensor, create_mesh, shard,
                             shard_params_rule)
from .base_module import BaseModule, _check_input_names
from .fused_step import _map_state
from .module import _descs
from ._spmd import GroupProgram


def _parse_shard_attr(text):
    """'tp,None' / '(dp, tp)' / 'None' -> PartitionSpec."""
    cleaned = text.strip().strip("()")
    parts = []
    for tok in cleaned.split(","):
        tok = tok.strip().strip("'\"")
        if not tok:
            continue
        parts.append(None if tok.lower() in ("none", "") else tok)
    return P(*parts)


def _as_mesh(mesh):
    if mesh is None:
        from ..parallel.mesh import current_mesh
        return current_mesh()
    if isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, MeshSpec):
        return create_mesh(mesh)
    if isinstance(mesh, dict):
        return create_mesh(**mesh)
    raise MXNetError("mesh must be a Mesh, MeshSpec, or axis dict; "
                     "got %r" % (mesh,))


def gather(mesh, arr, positions):
    """The global value of ``arr`` (a ``ShardedArray``) at each of
    ``positions``: its shards all-gathered along every axis that splits
    it (one counted collective an axis); a replicated array's own
    shards."""
    blocks = list(arr.shards)
    spec = arr.sharding.spec
    for d in range(len(arr.shape)):
        for axis in reversed(spec.axes(d)):
            stacked = collectives.all_gather(blocks, mesh, axis)
            joined = {}
            for t in stacked:
                if id(t) not in joined:
                    joined[id(t)] = torch.cat(t.unbind(0), dim=d)
            blocks = [joined[id(t)] for t in stacked]
    return [blocks[p] for p in positions]


class ShardedModule(BaseModule):
    """BaseModule over a mesh: one dp-split step a batch."""

    def __init__(self, symbol, mesh=None, data_names=("data",),
                 label_names=("softmax_label",), logger=logging,
                 param_partition=None, sequence_axis=None,
                 fixed_param_names=None):
        super().__init__(logger=logger)
        self._symbol = symbol
        self.mesh = _as_mesh(mesh)
        self._param_partition = dict(param_partition or {})
        self._sequence_axis = sequence_axis
        self._data_names = list(data_names or [])
        self._label_names = list(label_names or [])
        self._fixed_param_names = list(fixed_param_names or [])
        self._output_names = symbol.list_outputs()
        self._aux_names = symbol.list_auxiliary_states()
        inputs = set(self._data_names) | set(self._label_names)
        self._param_names = [a for a in symbol.list_arguments()
                             if a not in inputs
                             and a not in self._fixed_param_names]
        _check_input_names(symbol, self._data_names, "data", True)
        _check_input_names(symbol, self._label_names, "label", False)
        self._dp_mode = self._dp_mode_reason = None
        self.collectives = None
        self._reset_bind()

    def _reset_bind(self):
        """Pristine unbound state: everything keyed to one bind's shapes
        and shardings (also run by bind(force_rebind=True), so a rebind
        never trains through a stale plan)."""
        self._host_args = None
        self._host_aux = None
        self._optimizer = None
        self._step = None
        self._fwd = None
        self._outputs = []
        self.optimizer_initialized = False
        self.params_initialized = False

    # -- introspection -------------------------------------------------------
    @property
    def data_names(self):
        return self._data_names

    @property
    def output_names(self):
        return self._output_names

    @property
    def data_shapes(self):
        assert self.binded
        return self._data_shapes

    @property
    def label_shapes(self):
        assert self.binded
        return self._label_shapes

    @property
    def output_shapes(self):
        assert self.binded
        return self._output_shapes

    @property
    def dp_mode(self):
        """``"split"``: each dp group computes its own rows, the
        batch-reducing ops reduce across the groups; ``"global"``: the
        graph runs over the global batch on the first position (None
        before bind)."""
        return self._dp_mode

    @property
    def dp_mode_reason(self):
        """The op that forced ``"global"`` (None in ``"split"``)."""
        return self._dp_mode_reason

    # -- binding -------------------------------------------------------------
    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        if self.binded and not force_rebind:
            self.logger.warning("Already bound, ignoring bind()")
            return
        if inputs_need_grad or shared_module is not None:
            raise MXNetError("ShardedModule does not support inputs_need_"
                             "grad or shared_module")
        preserved = None
        if self.binded:
            # force_rebind: drop everything built for the old shapes, but
            # carry the trained parameters across (their shapes do not
            # depend on the batch; Module.bind keeps them too)
            if self.params_initialized:
                preserved = self.get_params()
            self._reset_bind()
        self.for_training = for_training
        self.binded = True

        self._data_shapes = _descs(data_shapes)
        self._label_shapes = _descs(label_shapes) or None

        from ..executor import _Program
        known = {d.name: tuple(d.shape) for d in self._data_shapes}
        if self._label_shapes:
            known.update((l.name, tuple(l.shape))
                         for l in self._label_shapes)
        self._prog = prog = _Program(self._symbol, known)
        arg_shapes, out_shapes, aux_shapes = \
            self._symbol.infer_shape(**known)
        arg_types, _, aux_types = self._symbol.infer_type()
        self._output_shapes = list(zip(self._output_names,
                                       [tuple(s) for s in out_shapes]))

        names = self._symbol.list_arguments()
        self._arg_shape = {n: tuple(s) for n, s in zip(names, arg_shapes)}
        self._arg_type = {n: dtype_name(t) for n, t in zip(names, arg_types)}
        self._aux_shape = {n: tuple(s)
                           for n, s in zip(self._aux_names, aux_shapes)}
        self._aux_type = {n: dtype_name(t) for n, t in zip(
            self._aux_names, aux_types or [None] * len(self._aux_names))}

        # partition spec per parameter: ctor dict > __shard__ attr > rule
        attr_dict = self._symbol.attr_dict()
        self._pspec = {}
        for n in self._param_names + self._fixed_param_names:
            if n in self._param_partition:
                spec = self._param_partition[n]
                if not isinstance(spec, P):
                    spec = P(*spec) if isinstance(spec, (tuple, list)) \
                        else _parse_shard_attr(str(spec))
            elif "__shard__" in (attr_dict.get(n) or {}):
                spec = _parse_shard_attr(attr_dict[n]["__shard__"])
            else:
                spec = shard_params_rule(
                    self.mesh, n, self._arg_shape[n]).spec
            self._pspec[n] = spec
        self._param_sharding = {
            n: NamedSharding(self.mesh, s) for n, s in self._pspec.items()}
        self._repl = NamedSharding(self.mesh, P())

        def batch_spec(shape):
            parts = [("dp",)]
            if self._sequence_axis is not None and \
                    len(shape) > self._sequence_axis:
                while len(parts) < self._sequence_axis:
                    parts.append(None)
                parts.append(("sp",))
            return NamedSharding(self.mesh, P(*parts))

        descs = self._data_shapes + (self._label_shapes or [])
        self._batch_sharding = {d.name: batch_spec(d.shape) for d in descs}
        self._full_batch = int(self._data_shapes[0].shape[0])
        batch_set = set(self._data_names) | set(self._label_names)
        self._batch_arg_names = [n for n in prog.arg_names
                                 if n in batch_set]
        self._plan_groups(known)

        if preserved is not None:
            # re-place the carried masters under the NEW shardings
            self.init_params(initializer=None, arg_params=preserved[0],
                             aux_params=preserved[1], force_init=True)

    def _plan_groups(self, known):
        """Decide ``dp_mode``: the groups' first positions and the
        lockstep plan, or the first position alone."""
        mesh = self.mesh
        dp = mesh.shape.get("dp", 1)
        firsts = [int(p) for p in mesh.groups("dp")[0]]
        self._split, reason = None, None
        if dp > 1 and self._full_batch % dp == 0:
            group_mesh = create_mesh(
                MeshSpec(dp=dp), devices=[mesh.devices.flat[p]
                                          for p in firsts])
            split = GroupProgram(self._symbol, known,
                                 set(self._batch_arg_names), dp, group_mesh)
            reason = split.reason
            if reason is None:
                self._split = split
        if reason is None:
            self._dp_mode = "split"
            self._groups = firsts if self._split is not None else firsts[:1]
        else:
            self._dp_mode, self._groups = "global", firsts[:1]
            self.logger.warning(
                "ShardedModule: %s acts across the rows of the batch, so "
                "the graph cannot run per dp group; it runs over the "
                "global batch on the mesh's first position (dp_mode "
                "'global')", reason)
        self._dp_mode_reason = reason

    def _check_divisibility(self):
        """Clear errors beat a shape error deep in a step."""
        dp = self.mesh.shape.get("dp", 1)
        if self._full_batch % dp:
            raise MXNetError(
                "batch %d does not divide over dp=%d"
                % (self._full_batch, dp))
        sp = self.mesh.shape.get("sp", 1)
        if self._sequence_axis is not None and sp > 1:
            for d in self._data_shapes:
                if len(d.shape) > self._sequence_axis and \
                        d.shape[self._sequence_axis] % sp:
                    raise MXNetError(
                        "sequence dim %d of %s does not divide over sp=%d"
                        % (d.shape[self._sequence_axis], d.name, sp))

    # -- parameters ----------------------------------------------------------
    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        if self.params_initialized and not force_init:
            return
        assert self.binded, "call bind before init_params"
        self._check_divisibility()
        attrs = self._symbol.attr_dict()
        batch_names = set(self._data_names) | set(self._label_names)

        def fill(name, shape, dtype, provided):
            host = nd_zeros(shape, cpu(), dtype=dtype)
            if provided and name in provided:
                provided[name].copyto(host)
            elif provided is not None and not allow_missing:
                raise RuntimeError("%s is not presented" % name)
            elif initializer is not None:
                initializer(InitDesc(name, attrs.get(name, None)), host)
            return host

        self._host_args = {
            n: fill(n, self._arg_shape[n], self._arg_type[n], arg_params)
            for n in self._symbol.list_arguments() if n not in batch_names}
        self._host_aux = {
            n: fill(n, self._aux_shape[n], self._aux_type[n], aux_params)
            for n in self._aux_names}

        # placement: params by their partition, aux replicated
        self._dev_params = {
            n: shard(self._host_args[n], self._param_sharding[n])
            for n in self._param_names}
        self._dev_fixed = {
            n: shard(self._host_args[n],
                     self._param_sharding.get(n, self._repl))
            for n in self._fixed_param_names}
        self._dev_aux = {n: shard(self._host_aux[n], self._repl)
                         for n in self._aux_names}
        self.params_initialized = True

    def get_params(self):
        assert self.binded and self.params_initialized

        def host(v):
            return NDArray(v.global_tensor(torch.device("cpu"))
                           .detach().clone())
        args = {n: host(v) for n, v in self._dev_params.items()}
        args.update((n, host(v)) for n, v in self._dev_fixed.items())
        auxs = {n: host(v) for n, v in self._dev_aux.items()}
        return args, auxs

    def init_params_from(self, arg_params, aux_params):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, force_init=True)

    # -- optimizer + step ----------------------------------------------------
    def init_optimizer(self, kvstore=None, optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        """kvstore is accepted for API parity and ignored: gradient
        aggregation is the step's psum over dp."""
        assert self.binded and self.params_initialized
        if self.optimizer_initialized and not force_init:
            return
        if isinstance(optimizer, str):
            optimizer_params = dict(optimizer_params)
            optimizer_params.setdefault("rescale_grad",
                                        1.0 / self._full_batch)
            optimizer = opt.create(
                optimizer, sym=self._symbol,
                param_idx2name=dict(enumerate(self._param_names)),
                **optimizer_params)
        if not optimizer._fused_ok():
            raise MXNetError(
                "%s lacks fused_update; ShardedModule needs a fused-capable "
                "optimizer" % type(optimizer).__name__)
        self._optimizer = optimizer

        # f32 masters for half-width params under multi_precision, sharded
        # exactly like their parameter
        mp = bool(getattr(optimizer, "multi_precision", False))
        names = self._param_names
        self._store_dtypes = {n: torch_dtype(self._arg_type[n])
                              for n in names}
        self._mixed = {n: mp and _is_low_precision(self._arg_type[n])
                       for n in names}
        self._masters = {
            n: (ShardedArray([s.float() for s in self._dev_params[n].shards],
                             self._param_sharding[n],
                             self._dev_params[n].shape)
                if self._mixed[n] else self._dev_params[n])
            for n in names}

        def init_state(n):
            master = self._masters[n].global_tensor(torch.device("cpu"))
            st = optimizer.create_state(names.index(n),
                                        NDArray(master.detach().clone()))
            return _map_state(lambda a: shard(a, self._param_sharding[n]),
                              st)

        self._states = {n: init_state(n) for n in names}
        self._step = self._train_step
        self._build_fwd()
        self.optimizer_initialized = True

    def _build_fwd(self):
        """The eval-mode step; optimizer-independent, so forward() can
        build it lazily after a rebind with no optimizer."""
        self._fwd = self._eval_step

    def _per_step_scalars(self):
        optimizer = self._optimizer
        out = []
        for i, _ in enumerate(self._param_names):
            optimizer._update_count(i)
            out.append((optimizer._get_lr(i) * 1.0,
                        optimizer._get_wd(i) * 1.0,
                        tuple(optimizer.fused_scalars(i))))
        return out

    def _group_batches(self, data_batch):
        """Each group's rows of every batch input, on the group's device:
        the dp shard, gathered over sp where the input is split there (in
        ``"global"`` mode the whole batch on the first position)."""
        mesh, groups = self.mesh, self._groups
        vals = dict(zip(self._data_names, data_batch.data))
        if self._label_names and data_batch.label:
            vals.update(zip(self._label_names, data_batch.label))
        out = [{} for _ in groups]
        sp = mesh.shape.get("sp", 1)
        for n in self._batch_arg_names:
            x = _as_tensor(vals[n]).to(torch_dtype(self._arg_type[n]))
            sharding = self._batch_sharding[n]
            if self._split is None:
                rows = [x.to(mesh.torch_devices[groups[0]])]
            elif sp > 1 and "sp" in sharding.spec:
                blocks = shard(x, sharding).shards
                stacked = collectives.all_gather(blocks, mesh, "sp")
                dim = self._sequence_axis
                rows = [torch.cat(stacked[p].unbind(0), dim=dim)
                        for p in groups]
            else:
                dp_rows = NamedSharding(mesh, P("dp"))
                rows = [x[dp_rows.slices(x.shape, p)].to(
                    mesh.torch_devices[p]) for p in groups]
            for table, t in zip(out, rows):
                table[n] = t
        return out

    def _run(self, data_batch, train):
        """Forward every group (recorded by autograd when training).
        Returns (each group's outputs, new aux values, {(name, group):
        leaf})."""
        mesh, groups = self.mesh, self._groups
        devices = [mesh.torch_devices[p] for p in groups]
        batches = self._group_batches(data_batch)
        source = self._masters if train else self._dev_params
        with torch.no_grad():
            copies = {n: gather(mesh, source[n], groups)
                      for n in self._param_names}
            fixed = {n: gather(mesh, self._dev_fixed[n], groups)
                     for n in self._fixed_param_names}
        leaves, values = {}, []
        for gi, p in enumerate(groups):
            v = dict(batches[gi])
            for n in self._param_names:
                t = copies[n][gi]
                if train:
                    t = leaves[(n, gi)] = t.detach().requires_grad_(True)
                    if self._mixed[n]:
                        t = t.to(self._store_dtypes[n])
                v[n] = t
            v.update((n, fixed[n][gi]) for n in self._fixed_param_names)
            v.update((n, self._dev_aux[n].shards[p])
                     for n in self._aux_names)
            values.append(v)
        with torch.enable_grad() if train else torch.no_grad():
            if self._split is None:
                outs, new_aux = self._prog.evaluate(values[0], train=train,
                                                    device=devices[0])
                outs = [outs]
            else:
                outs, new_aux = self._split.evaluate(values, train, devices)
        return outs, new_aux, leaves

    def _merge_outputs(self, outs):
        """The global outputs on the first position: each group's rows,
        concatenated (an output without rows: group 0's)."""
        dev = self.mesh.torch_devices[self._groups[0]]
        rows = self._split.batched_outputs if self._split is not None \
            else [True] * len(outs[0])
        self._outputs = [
            NDArray(torch.cat([g[i].detach().to(dev) for g in outs])
                    if b and len(outs) > 1 else outs[0][i].detach())
            for i, b in enumerate(rows)]

    def _train_step(self, data_batch):
        mesh, groups = self.mesh, self._groups
        names = self._param_names
        scalars = self._per_step_scalars()
        outs, new_aux, leaves = self._run(data_batch, train=True)
        rows = self._split.batched_outputs if self._split is not None \
            else [True] * len(outs[0])
        ys = [o for gi, g in enumerate(outs) for o, b in zip(g, rows)
              if o.requires_grad and (b or gi == 0)]
        order = [(n, gi) for n in names for gi in range(len(groups))]
        grads = torch.autograd.grad(
            ys, [leaves[k] for k in order], [torch.ones_like(y) for y in ys],
            allow_unused=True) if ys else [None] * len(order)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(order, grads)}
        dp_of = [mesh.coords(p)["dp"] for p in range(mesh.size)] \
            if len(groups) > 1 else [0] * mesh.size
        optimizer = self._optimizer
        with torch.no_grad():
            for j, n in enumerate(names):
                per_group = [grads[(n, gi)] for gi in range(len(groups))]
                blocks = [per_group[dp_of[p]] for p in range(mesh.size)]
                if len(groups) > 1:
                    blocks = collectives.psum(blocks, mesh, "dp")
                master, sharding = self._masters[n], self._param_sharding[n]
                lr, wd, ex = scalars[j]
                for p in range(mesh.size):
                    w = master.shards[p]
                    g = blocks[p][sharding.slices(master.shape, p)]
                    apply_update(
                        optimizer, w, g.to(w.device, w.dtype),
                        _map_state(lambda s, p=p: s.shards[p],
                                   self._states[n]), lr, wd, ex,
                        key=_random.generator(w.device)
                        if optimizer.fused_needs_rng else None)
                self._dev_params[n] = ShardedArray(
                    [s.to(self._store_dtypes[n]) for s in master.shards],
                    sharding, master.shape) if self._mixed[n] else master
            for n, value in new_aux.items():
                for s in self._dev_aux[n].shards:
                    s.copy_(value)
        self._merge_outputs(outs)

    def _eval_step(self, data_batch):
        outs, _, _ = self._run(data_batch, train=False)
        self._merge_outputs(outs)

    # -- computation ---------------------------------------------------------
    def forward_backward(self, data_batch):
        assert self.optimizer_initialized, \
            "init_optimizer before training (the step is fused)"
        with collectives.watch() as record:
            self._step(data_batch)
        self.collectives = record.counts

    def update(self):
        pass  # the fused step already applied the optimizer

    def forward(self, data_batch, is_train=None):
        if is_train:
            raise MXNetError(
                "ShardedModule trains through forward_backward (one fused "
                "program); forward(is_train=True) alone has no step to "
                "attach to")
        assert self.binded and self.params_initialized
        if self._fwd is None:
            self._build_fwd()
        self._fwd(data_batch)

    def backward(self, out_grads=None):
        raise MXNetError("ShardedModule fuses backward into "
                         "forward_backward")

    def get_outputs(self, merge_multi_context=True):
        return list(self._outputs)

    def get_input_grads(self, merge_multi_context=True):
        raise MXNetError("inputs_need_grad is not supported")

    def update_metric(self, eval_metric, labels):
        eval_metric.update(labels, self._outputs)

    def install_monitor(self, mon):
        raise MXNetError("monitors need per-op values; use Module on one "
                         "device for monitoring")

    def save_checkpoint(self, prefix, epoch):
        from ..model import save_checkpoint
        arg_params, aux_params = self.get_params()
        save_checkpoint(prefix, epoch, self._symbol, arg_params, aux_params)

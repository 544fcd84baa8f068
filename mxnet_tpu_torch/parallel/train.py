"""Sharded training step: loss + gradients + SGD-momentum over a mesh.

Counterpart of ``mxnet_tpu/parallel/train.py``.  The JAX package
compiles the whole step into one XLA program over the mesh: the batch
is laid out by ``batch_spec``, the parameters by their shardings, and
GSPMD inserts the gradient reductions.  The port keeps its semantics in
two paths:

- **Monolithic, any mesh.**  The global parameters are assembled from
  their shards on the mesh's first position, ``loss_fn(params, batch)``
  runs once over the global batch under torch autograd, and each
  gradient is sliced back into its parameter's shards, where the
  update runs: ``g = grad + wd*p; m = momentum*m + g; p -= lr*m``, the
  momentum sharded like its parameter.  Parallelism inside ``loss_fn``
  comes from the primitives' own specs (``ring_attention(...,
  batch_axis="dp")``, ``pipeline_stages``, ``moe_ffn``): they split
  their global inputs over the positions, run there with their
  collectives, and assemble global outputs.  Operations outside them run
  on the first position's device.
- **Overlap** (``MXNET_TPU_COMM_BUCKET_MB`` / ``MXNET_TPU_GRAD_COMPRESS``,
  ``parallel/comm.py``), only where ``_overlap_viable`` allows it: dp >
  1, every other axis 1, parameters replicated.  ``loss_fn`` runs per dp
  position on its batch shard (so it must not call the mesh primitives),
  the gradients reduce through ``comm.reduce_buckets`` with ``scale =
  1/dp``, one collective a bucket, optionally 2-bit compressed with the
  error-feedback residual ``(dp,) + residual_shape`` beside the
  momentum, and the loss is ``pmean``'d.  The overlap contract assumes
  ``loss_fn`` returns a MEAN over batch examples.

The port compiles no program, so ``lower()`` has no counterpart; the
step's record of collectives (``step.collectives``, counts by kind of
the last call) is what a caller inspects instead of compiled HLO.
"""
from __future__ import annotations

import logging

import torch
import torch.utils.checkpoint

from ..base import MXNetError
from . import collectives
from . import comm as _comm
from ..serving.continuous import tree_map
from .mesh import NamedSharding, P, ShardedArray, block, host_tensor, \
    shard, shard_params_rule, split

_logger = logging.getLogger("mxnet_tpu")


def _overlap_viable(mesh, param_sharding):
    """None when the bucketed-overlap path applies, else the reason it
    cannot."""
    sizes = dict(mesh.shape)
    if sizes.get("dp", 1) <= 1:
        return "no data-parallel axis (dp<=1): no gradient collective " \
               "to overlap"
    if any(v > 1 for k, v in sizes.items() if k != "dp"):
        return "model-parallel axes present (%s): gradient flow is not " \
               "a plain dp psum" % ({k: v for k, v in sizes.items()
                                     if k != "dp" and v > 1},)
    if any(tuple(s.spec) != () for s in param_sharding.values()):
        return "sharded parameters: their gradients are not replicated " \
               "dp partial sums"
    return None


def _batch_tensor(value, device):
    if hasattr(value, "tensor"):  # an NDArray
        value = value.tensor
    if not isinstance(value, torch.Tensor):
        value = host_tensor(value)
    return value.to(device)


def _spec_tree(batch_spec, batch):
    """``batch_spec`` as a tree shaped like ``batch`` (one sharding for a
    whole tree is every leaf's)."""
    if isinstance(batch_spec, NamedSharding):
        return tree_map(lambda _: batch_spec, batch)
    return batch_spec


class ShardedTrainStep:
    """loss_fn(params, batch) as a sharded SGD-momentum step.

    params: dict name -> tensor, numpy array or ``ShardedArray``.  The
    optimizer state (momentum) shards identically to its parameter.
    ``remat`` recomputes ``loss_fn``'s activations in the backward
    (``torch.utils.checkpoint``); ``donate`` updates the shards in place,
    else every step makes new shard tensors (arrays a caller kept from
    ``step.params`` then keep their values).
    """

    def __init__(self, loss_fn, params, mesh, lr=0.01, momentum=0.9, wd=0.0,
                 param_sharding=None, batch_spec=None, donate=True,
                 remat=False):
        self.mesh = mesh
        self.lr, self.momentum, self.wd = lr, momentum, wd
        self.donate = donate
        if param_sharding is None:
            param_sharding = {
                name: shard_params_rule(mesh, name, tuple(p.shape))
                for name, p in params.items()}
        self.param_sharding = param_sharding
        if batch_spec is None:
            batch_spec = NamedSharding(mesh, P("dp"))
        self.batch_spec = batch_spec
        self.params = {name: shard(p, param_sharding[name])
                       for name, p in params.items()}
        self.momentum_buf = {
            name: shard(torch.zeros(p.shape, dtype=p.dtype),
                        param_sharding[name])
            for name, p in self.params.items()}
        if remat:
            inner = loss_fn

            def loss_fn(params, batch):
                return torch.utils.checkpoint.checkpoint(
                    inner, params, batch, use_reentrant=False)
        self._loss_fn = loss_fn
        self.collectives = None  # the last call's counts by kind

        # -- overlapped gradient collectives (resolved at construction) --
        self.comm_plan = None
        self.overlap_off_reason = None
        cfg = _comm.comm_config()
        if cfg is not None:
            self.overlap_off_reason = _overlap_viable(mesh, param_sharding)
            if self.overlap_off_reason is not None:
                _logger.warning(
                    "gradient-collective overlap requested but "
                    "unavailable for this step (%s); using the monolithic "
                    "GSPMD reduction", self.overlap_off_reason)
            else:
                # reverse declaration order stands in for reverse
                # autodiff order on an opaque loss_fn: later-declared
                # params sit deeper in the model by convention
                self._grad_order = list(params)
                dp = int(mesh.shape["dp"])
                self.comm_plan = _comm.CommPlan(
                    [self.params[n].shape for n in self._grad_order],
                    [self.params[n].dtype for n in self._grad_order],
                    cfg, scale=1.0 / dp)
        self.residuals = []
        if self.comm_plan is not None and self.comm_plan.compress:
            dp = int(mesh.shape["dp"])
            res_sh = NamedSharding(mesh, P("dp"))
            self.residuals = [
                shard(torch.zeros((dp,) + s, dtype=torch.float32), res_sh)
                for s in self.comm_plan.residual_shapes()]

    def __call__(self, batch):
        with collectives.watch() as record:
            if self.comm_plan is None:
                loss = self._monolithic(batch)
            else:
                loss = self._overlap(batch)
        self.collectives = record.counts
        if self.comm_plan is not None:
            from ..observability.instrument import note_comm_overlapped
            note_comm_overlapped(self.comm_plan)
        return loss

    def lower(self, batch_struct=None):
        """The JAX package returns the lowered XLA step here; the port
        compiles no program."""
        raise MXNetError(
            "ShardedTrainStep.lower: the port compiles no XLA program; "
            "inspect step.collectives (the last step's collectives by "
            "kind) instead")

    def _monolithic(self, batch):
        dev = self.mesh.torch_devices[0]
        specs = _spec_tree(self.batch_spec, batch)
        tree_map(lambda v, s: s.shard_shape(tuple(v.shape)), batch, specs)
        names = list(self.params)
        with torch.enable_grad():
            gp = {k: self.params[k].global_tensor(dev).detach()
                  .requires_grad_(True) for k in names}
            gb = tree_map(lambda v: _batch_tensor(v, dev), batch)
            loss = self._loss_fn(gp, gb)
            grads = torch.autograd.grad(loss, [gp[k] for k in names],
                                        allow_unused=True)
        with torch.no_grad():
            for k, g in zip(names, grads):
                if g is None:
                    g = torch.zeros_like(gp[k])
                self._update(k, split(g, self.param_sharding[k]))
        return loss.detach()

    def _overlap(self, batch):
        mesh, plan = self.mesh, self.comm_plan
        specs = _spec_tree(self.batch_spec, batch)
        gb = tree_map(lambda v: _batch_tensor(v, mesh.torch_devices[0]),
                      batch)
        losses, glists = [], []
        for p in range(mesh.size):
            batch_p = tree_map(lambda v, s: block(v, s, p), gb, specs)
            with torch.enable_grad():
                params_p = {k: v.shards[p].detach().requires_grad_(True)
                            for k, v in self.params.items()}
                loss = self._loss_fn(params_p, batch_p)
                grads = torch.autograd.grad(
                    loss, [params_p[k] for k in self._grad_order],
                    allow_unused=True)
            losses.append(loss.detach())
            glists.append([torch.zeros_like(params_p[k]) if g is None else g
                           for k, g in zip(self._grad_order, grads)])
        with torch.no_grad():
            res_in = [[r.shards[p][0] for r in self.residuals]
                      for p in range(mesh.size)]
            red, new_res = _comm.reduce_buckets(glists, "dp", plan, res_in,
                                                mesh=mesh)
            for i, r in enumerate(self.residuals):
                for p in range(mesh.size):
                    r.shards[p].copy_(new_res[p][i][None])
            for i, k in enumerate(self._grad_order):
                self._update(k, [red[p][i] for p in range(mesh.size)])
            loss = collectives.pmean(losses, mesh, "dp")[0]
        return loss

    def _update(self, name, grads):
        """SGD-momentum on every shard of ``name`` from its gradient
        blocks (one per position): in place when donating, else into new
        ``ShardedArray``s."""
        lr, mom, wd = self.lr, self.momentum, self.wd
        param, buf = self.params[name], self.momentum_buf[name]
        new_params, new_moms = [], []
        for p, g in enumerate(grads):
            w, v = param.shards[p], buf.shards[p]
            g = g.to(w.device) + wd * w
            m = mom * v + g
            new = w - lr * m
            if self.donate:
                v.copy_(m)
                w.copy_(new)
            new_params.append(new)
            new_moms.append(m)
        if not self.donate:
            self.params[name] = ShardedArray(new_params, param.sharding,
                                             param.shape)
            self.momentum_buf[name] = ShardedArray(new_moms, buf.sharding,
                                                   buf.shape)

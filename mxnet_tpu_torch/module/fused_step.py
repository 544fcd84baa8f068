"""The fused train step: forward, backward and the optimizer update of a
batch as one unit; on the card, one CUDA graph replay.

Counterpart of ``mxnet_tpu/module/fused_step.py``.  The JAX package
jits forward, backward and every parameter's update into one XLA program
a batch.  Here the same step function (the executor's plan run under
torch autograd, ``torch.autograd.grad`` of its outputs, the BatchNorm
moving statistics written back, then each optimizer's ``fused_update``)
runs eagerly on the host, and on the card is captured once into a
``torch.cuda.CUDAGraph`` and replayed for every later batch: one launch
from the host a step in place of thousands.

- **State.** Under ``multi_precision`` a float16/bfloat16 parameter gets
  an f32 master; the forward reads the half-width storage, the gradient
  is cast to f32 once, the master and its f32 optimizer state update,
  and the storage receives the master cast back (``mixed``,
  ``master_dtypes``).  Other parameters update their storage directly.
- **Static buffers.** The graph reads and writes fixed tensors: the
  bound data, label, parameter and aux arrays (a batch is copied into
  them), the masters and states, and ``_scalars`` (each parameter's lr,
  wd and ``fused_scalars`` extras, packed on the host and copied in
  before every step, so a learning-rate schedule takes effect at the
  next replay).  Outputs handed to ``get_outputs`` are copies.
- **Capture.** The first batch runs eagerly on the capture stream (a
  real step: every batch is trained exactly once), which builds the
  kernels, fills the caches and allocates the per-stream BatchNorm
  counters (``ops/kernels.py``) before capture; the second batch is
  captured and then replayed; later batches replay.  A capture that
  fails raises ``MXNetError``.  The kernels' launch counts and the
  collectives (``parallel.collectives``) are taken from the capture and
  counted again at every replay.
- **Writes from outside.** ``set_params`` copies into the bound tensors
  (torch bumps their version counters): the step re-derives a master
  from its storage unless the storage still equals the master cast, so
  the epoch-end ``set_params`` of ``fit`` keeps the f32 masters.  A
  ``reshape`` rebuilds the executor: the step carries its masters,
  states and residuals to it and captures anew.
- **Shared state (bucketing).** A module bound with ``shared_module=``
  gets a step of its own, built with ``share=`` the sharer's step: its
  own executor, ``_scalars``, stream and graph, over the sharer's
  ``_SharedState`` — the same master and optimizer-state tensors (by
  parameter name), one record of the storage seen after the last step of
  any sharer (an eager step bumps the shared storage's version counters;
  that is no write from outside), and one ``ran`` flag.  Every graph
  reads and writes the same tensors; each keeps its own memory pool, and
  its outputs are copied out after each replay.  ``transfer_to_updater``,
  ``export_states`` and ``load_states`` act once on the shared state,
  and ``retire`` leaves the fused path in every sharer.

**Data parallelism.**  Over several contexts under a collective store
(``'tpu_ici'``) with equal batch slices, the JAX package shards the
batch over a dp mesh inside the one program and GSPMD inserts the
gradient all-reduce.  Here each context is a dp position, by its place
in the list, so ``[cpu(0), cpu(1)]`` and ``[gpu(0)] * 2`` both fuse.
Each position computes its own executor's rows, and
``module/_spmd.py``'s ``GroupProgram`` runs the positions in lockstep:
BatchNorm's channel sums and ``SoftmaxOutput``'s counts are psum'd over
them, which is the global-batch math the JAX package gets.  Each
gradient is psum'd over the positions (``parallel.collectives``), one
update runs on the first position's masters and states, and every
executor's replica receives the result.  A graph with an op that cannot
run on one position's rows runs over the global batch on the first
position instead (``dp_mode`` ``"global"``, ``dp_mode_reason`` the op),
as ``ShardedModule`` does.  Under ``MXNET_TPU_COMM_BUCKET_MB`` /
``MXNET_TPU_GRAD_COMPRESS`` (``parallel/comm.py``) each position runs
its forward and backward alone and ``comm.reduce_buckets`` reduces one
collective a bucket, 2-bit with a residual a position, where
``_overlap_gate`` allows it (``overlap_off_reason`` says why not).
Positions on one card are one CUDA graph; across cards the step runs
eagerly (a graph cannot span devices).  ``collectives`` holds the last
step's collectives by kind.  The optimizer's index of a parameter is
its first context's (``i * n``, the index the Module names it by): the
JAX package's step reads index ``i``, the name of another parameter
when ``n > 1``.

Otherwise ``refusal`` keeps the JAX package's gating: a store that
updates, a store on one context, several contexts without a collective
store or with unequal slices, a monitor, ``grad_req='add'`` or
``inputs_need_grad`` take the general path; on the card so does a graph
holding a ``Custom`` node (its host round trip cannot be captured).  A
step with a bucketed reduction reports its plan's wire bytes
(``instrument.note_comm_overlapped``).

**Health and memory.**  Under ``MXNET_TPU_HEALTH=1`` (resolved when the
step is built, so a health-on step captures a graph of its own) the step
computes the packed health vector inside itself, inside the CUDA graph on
the card: the outputs' finiteness, the gradient and parameter norms, the
group maxima, the attention taps and the exact update ratio
``|Δw|/|w|`` from a copy of the masters taken before the update.  After
each step the vector is copied into a pinned host buffer behind an event
(``last_health``); ``take_health`` waits for that event only when the fit
loop reads it, after the next batch's ``prepare``.  The step's gradients
and pre-update masters stay reachable (``health_inputs``) for a plain
recomputation.  Each build opens a memprof program record: at the first
step on the host, and on the card at the eager warm-up step that precedes
each capture, whose record gets the capture's time and, under
``MXNET_TPU_MEMPROF=1``, the warm-up step's peak and the graph pool's
bytes.  A device out-of-memory in a step writes the memory post-mortem
(``observability/memprof``) before it propagates.  The program cache
waits for a later runtime-services slice.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from ..base import MXNetError
from .. import executor_cache
from ..ndarray import NDArray
from ..observability import health as _health
from ..observability import instrument as _instrument
from ..observability import memprof as _memprof
from ..ops import kernels as _kernels
from .. import optimizer as _opt
from .. import random as _random
from ..parallel import collectives
from ..parallel import comm as _comm

# eager steps on the capture stream before the graph is captured
WARMUP_STEPS = 1

# the health vector's slots that the exact update ratio reads and fills
_PARAM_NORM = _health.HealthLayout.HEAD.index("param_norm")
_RATIO = _health.HealthLayout.HEAD.index("update_ratio")

# reserved key for the compression residuals inside the fused_v2 states
# dict (the JAX package's); older loaders skip it (not a parameter name)
_RESIDUAL_KEY = "__comm_residuals__"


def _map_state(fn, state):
    if isinstance(state, tuple):
        return tuple(_map_state(fn, s) for s in state)
    return None if state is None else fn(state)


class _SharedState:
    """What every module sharing one fused step trains, by parameter
    name: the masters (an f32 copy, or the first context's storage), the
    optimizer states, the Updater index, the storage (tensor, version)
    seen after the last step of any sharer, and the error-feedback
    residuals of the 2-bit reduction (one ``ShardedArray`` a bucket)."""

    def __init__(self):
        self.masters = {}
        self.states = {}
        self.mixed = {}
        self.index = {}
        self.seen = {}
        self.steps = []
        self.residuals = []
        self.ran = False


class FusedTrainStep:
    @staticmethod
    def refusal(module):
        """Why the fused step cannot serve ``module`` (None when it can):
        the JAX package's gating (``FusedTrainStep.supports``), with a
        module's contexts as dp positions by their place in the list
        (the JAX package also refuses contexts that share a device)."""
        group = module._exec_group
        n = len(module._context)
        if group is None or len(group.execs) != n:
            return "the executor group does not match the contexts"
        if module._update_on_kvstore:
            return "the store updates the weights"
        kv = module._kvstore
        if n == 1 and kv is not None:
            return "one context with a store"
        if n > 1:
            if kv is None or not any(t in kv.type for t in ("tpu", "ici")):
                return "several contexts without a collective store"
            if len({s.stop - s.start for s in group.slices}) != 1:
                return "unequal batch slices"
        opt = module._optimizer
        if opt is None or not opt._fused_ok():
            return "optimizer %s has no fused update of its own" \
                % type(opt).__name__
        for exe in group.execs:
            if exe._monitor_callback is not None:
                return "monitor installed"
            if any(req == "add" for req in exe._grad_req.values()):
                return "grad_req 'add'"
        if module.inputs_need_grad:
            return "inputs_need_grad"
        exe = group.execs[0]
        if exe._device.type == "cuda":
            for k, step in enumerate(exe._prog.steps):
                if step[0].name == "Custom":
                    # the user's Python runs on host copies: a CUDA graph
                    # cannot capture the round trip
                    return "Custom op (node %s) runs its Python on the " \
                           "host" % exe._prog.taps[k][0]
        draws = opt.fused_needs_rng or any(
            step[0].needs_rng for step in exe._prog.steps)
        if exe._device.type == "cuda" and draws and not hasattr(
                torch.cuda.CUDAGraph, "register_generator_state"):
            return ("the step draws random numbers and this torch cannot "
                    "register a generator with a CUDA graph")
        return None

    @staticmethod
    def supports(module):
        """The JAX package's gating as a flag: whether ``refusal`` is
        None.  ``Module`` consults both, so patching this to return False
        keeps a module on the general path, as in the JAX package."""
        return FusedTrainStep.refusal(module) is None

    def join_refusal(self, module):
        """Why ``module`` cannot share this step's state (None when it
        can): each of its trained parameters that this state trains must
        be bound to the very tensor this state trains."""
        exe = module._exec_group.execs[0]
        for name in exe._grad_names:
            have = self.shared.seen.get(name)
            if have is not None and have[0] is not exe.arg_dict[name].tensor:
                return "parameter %s is bound to a tensor of its own" % name
        return None

    def __init__(self, module, share=None):
        self.module = module
        group = module._exec_group
        self.execs = list(group.execs)
        self.n_dev = len(self.execs)
        exe = self.execs[0]
        self.exe = exe
        self.opt = opt = module._optimizer
        self.devices = [e._device for e in self.execs]
        self.device = exe._device
        self.param_names = list(exe._grad_names)
        # the optimizer's index of a parameter: its first context's slot
        idx_of = {n: i for i, n in enumerate(group.param_names)}
        self.param_idx = [idx_of.get(n, i) * self.n_dev
                          for i, n in enumerate(self.param_names)]
        storage = [exe.arg_dict[n].tensor for n in self.param_names]
        self.param_dtypes = [t.dtype for t in storage]
        mp = bool(opt.multi_precision)
        self.mixed = [mp and _opt._is_low_precision(dt)
                      for dt in self.param_dtypes]
        self.master_dtypes = [torch.float32 if m else dt
                              for m, dt in zip(self.mixed, self.param_dtypes)]
        # a reshape rebuild (share is self) or a new sharer: the shared f32
        # masters and states are authoritative, and a parameter without a
        # master updates this executor's storage
        shared = share.shared if share is not None else _SharedState()
        self.shared = shared
        if self not in shared.steps:
            shared.steps.append(self)
        for j, (name, t) in enumerate(zip(self.param_names, storage)):
            if name not in shared.states:
                shared.mixed[name] = self.mixed[j]
                shared.index[name] = self.param_idx[j]
                shared.masters[name] = t.detach().float().clone() \
                    if self.mixed[j] else t
                shared.states[name] = self._init_state(j)
            elif not self.mixed[j]:
                shared.masters[name] = t
        n = len(self.param_names)
        self._n_extra = int(opt.fused_n_scalars)
        self._scalars = torch.zeros((n, 2 + self._n_extra),
                                    dtype=torch.float32, device=self.device)
        self._lr = [self._scalars[j, 0] for j in range(n)]
        self._wd = [self._scalars[j, 1] for j in range(n)]
        self._ex = [tuple(self._scalars[j, 2 + k]
                          for k in range(self._n_extra)) for j in range(n)]
        self._key = _random.generator(self.device) \
            if opt.fused_needs_rng else None
        self._bound = self._bound_tensors()
        # a sharer's record stands (a write since its last step is still
        # to be honoured); a reshape rebuild starts from its new storage
        for n in self.param_names:
            if share is self or n not in shared.seen:
                t = exe.arg_dict[n].tensor
                shared.seen[n] = (t, t._version)
        # data parallelism and the bucketed reduction
        self.dp_mode = self.dp_mode_reason = None
        self._mesh = self._split = self._global = None
        self._comm_plan = None
        self.overlap_off_reason = None
        self.collectives = None
        if self.n_dev > 1:
            self._plan_dp()
        cfg = _comm.comm_config()
        if cfg is not None and self.n_dev == 1:
            # nothing to overlap: there is no gradient collective
            self.overlap_off_reason = "single-device"
        elif cfg is not None:
            reason = self._overlap_gate()
            if reason is None:
                self._comm_plan = _comm.CommPlan(
                    [tuple(t.shape) for t in storage], self.param_dtypes,
                    cfg)
            else:
                self.overlap_off_reason = reason
                module.logger.warning(
                    "gradient-collective overlap requested but "
                    "unavailable for this program (%s); using the "
                    "monolithic reduction", reason)
        self._init_residuals()
        # the CUDA graph and what it captured: one graph when every
        # position is on one card
        self._graphable = self.device.type == "cuda" \
            and len(set(self.devices)) == 1
        self._traced = False
        self.graph = None
        self.captures = 0
        self.replays = 0
        self.graph_launches = {}
        self.graph_collectives = {}
        self.capture_seconds = None
        self._outs = None
        self._eager_on_card = 0
        self._stream = torch.cuda.Stream(self.device) \
            if self._graphable else None
        # health sentinel, resolved here: the step's own slot map, the
        # vector of the last step (device), its pinned host copy and event
        self._health_on = _health.enabled()
        self.health_layout = _health.HealthLayout(
            len(exe._prog.out_slots), self.param_names,
            tap_names=_health.attention_tap_names(exe._symbol._topo())) \
            if self._health_on else None
        self._hvec = None
        self.last_health = None
        self.health_inputs = None
        self._health_host = self._health_event = None
        # memprof: this build's program record and its capture probe
        self._memprof_label = "fused@%s" % exe._symbol.structural_hash()[:10]
        self._probe = None

    @property
    def ran(self):
        """Whether any step sharing this state has run."""
        return self.shared.ran

    @ran.setter
    def ran(self, value):
        self.shared.ran = bool(value)

    @property
    def _masters(self):
        return [self.shared.masters[n] for n in self.param_names]

    @property
    def states(self):
        return [self.shared.states[n] for n in self.param_names]

    @property
    def _residuals(self):
        """The 2-bit error-feedback residuals: one ``ShardedArray`` a
        bucket, (dp, elements) over the positions (``np.asarray`` gives
        the global value); empty unless compressing."""
        return self.shared.residuals

    def _init_state(self, j):
        """create_state-shaped optimizer state in the master dtype."""
        st = self.opt.create_state(
            self.param_idx[j],
            NDArray(self.shared.masters[self.param_names[j]]))
        return _opt.state_tensors(st)

    def _bound_tensors(self):
        return [a.tensor for e in self.execs for table in (e.arg_dict,
                                                           e.aux_dict)
                for a in table.values()]

    def _note_seen(self):
        """Record the (tensor, version counter) of each parameter's
        storage in the shared state."""
        for n in self.param_names:
            t = self.exe.arg_dict[n].tensor
            self.shared.seen[n] = (t, t._version)

    # -- data-parallel planning -----------------------------------------------
    def _batch_axes(self):
        """{bound batch input: its batch axis} of the data and labels."""
        group = self.module._exec_group
        axes = dict(zip(group.data_names, group.data_layouts))
        if group.label_shapes:
            axes.update(zip(group.label_names, group.label_layouts))
        return {n: a for n, a in axes.items() if n in self.exe.arg_dict}

    def _plan_dp(self):
        """The positions' mesh and ``dp_mode``: the lockstep plan over
        the positions, or the global batch on the first."""
        from ..executor import _Program
        from ..parallel.mesh import MeshSpec, create_mesh
        from ._spmd import GroupProgram
        module, n = self.module, self.n_dev
        self._mesh = create_mesh(MeshSpec(dp=n), devices=module._context)
        known = {d.name: tuple(d.shape) for d in module._data_shapes}
        if module._label_shapes:
            known.update((d.name, tuple(d.shape))
                         for d in module._label_shapes)
        axes = self._batch_axes()
        off = sorted(k for k, a in axes.items() if a != 0)
        if off:
            reason = "the batch axis of %s is %d, not 0" % (off[0],
                                                            axes[off[0]])
        else:
            split = GroupProgram(self.exe._symbol, known, set(axes), n,
                                 self._mesh)
            reason = split.reason
        if reason is None:
            self._split, self.dp_mode = split, "split"
        else:
            self.dp_mode = "global"
            self._global = _Program(self.exe._symbol, known)
            module.logger.warning(
                "fused data-parallel step: %s acts across the rows of the "
                "batch, so the graph cannot run per dp position; it runs "
                "over the global batch on the first position (dp_mode "
                "'global')", reason)
        self.dp_mode_reason = reason

    def _overlap_gate(self):
        """Why the bucketed reduction cannot serve this program (None when
        it can): each position then evaluates the graph alone, which must
        be the global math up to the order of the sums.

        - auxiliary state (BatchNorm moving statistics) is updated from
          batch statistics, which a position's rows alone would change;
        - in-graph rng (dropout) would draw per position;
        - a loss head that divides by the batch (``SoftmaxOutput``
          ``normalization='batch'``/``'valid'``) would divide by a
          position's rows, and the sum would come out dp times too large;
        - every output must be batch-major, so that the positions'
          outputs are the rows of the global ones."""
        exe = self.exe
        if exe._prog.aux_names:
            return "auxiliary state (batch statistics need global-batch " \
                   "semantics)"
        if any(step[0].needs_rng for step in exe._prog.steps):
            return "in-graph rng"
        for node in exe._symbol._topo():
            if node.attrs.get("normalization") in ("batch", "valid"):
                return "batch-normalized loss gradient (%s " \
                       "normalization=%r divides by the per-shard " \
                       "batch)" % (node.op_name,
                                   node.attrs["normalization"])
        shapes = {n: tuple(a.shape) for n, a in exe.arg_dict.items()}
        try:
            _, outs, _ = exe._symbol.infer_shape(**shapes)
        except Exception as e:  # noqa: BLE001 -- the JAX package's reason
            return "output shape probe failed (%s)" % (e,)
        local_b = min(sl.stop - sl.start
                      for sl in self.module._exec_group.slices)
        if not all(len(o) >= 1 and int(o[0]) == local_b for o in outs):
            return "non-batch-major outputs"
        return None

    def _init_residuals(self):
        """One zeroed (dp, elements) f32 residual a bucket under 2-bit
        compression; a carried set of the same layout stands."""
        from ..parallel.mesh import NamedSharding, P, shard
        plan = self._comm_plan
        if plan is None or not plan.compress:
            self.shared.residuals = []
            return
        want = [(self.n_dev,) + s for s in plan.residual_shapes()]
        if [r.shape for r in self.shared.residuals] == want:
            return
        sharding = NamedSharding(self._mesh, P("dp"))
        self.shared.residuals = [
            shard(torch.zeros(s, dtype=torch.float32), sharding)
            for s in want]

    # -- the step ------------------------------------------------------------
    def _leaves(self):
        """Each position's {name: tensor} of its executor's bound arrays,
        the trained parameters replaced by autograd leaves over the same
        storage, and those leaves."""
        values, leaves = [], []
        for exe in self.execs:
            v = {n: a.tensor for n, a in exe.arg_dict.items()}
            v.update((n, a.tensor) for n, a in exe.aux_dict.items())
            lv = [v[n].detach().requires_grad_(True)
                  for n in self.param_names]
            v.update(zip(self.param_names, lv))
            values.append(v)
            leaves.append(lv)
        return values, leaves

    @staticmethod
    def _grads(ys, leaves):
        ys = [y for y in ys if y.requires_grad]
        if not ys:
            return [None] * len(leaves)
        return list(torch.autograd.grad(
            ys, leaves, [torch.ones_like(y) for y in ys],
            allow_unused=True))

    def _write_aux(self, new_aux):
        with torch.no_grad():
            for name, value in new_aux.items():
                for exe in self.execs:
                    dst = exe.aux_dict[name].tensor
                    if value is not dst:
                        dst.copy_(value)

    def _psum(self, per_position, leaves):
        """Each parameter's gradient summed over the positions (one
        all-reduce a parameter), on the first position."""
        out = []
        for j, gs in enumerate(zip(*per_position)):
            gs = [torch.zeros_like(lv[j]) if g is None else g
                  for g, lv in zip(gs, leaves)]
            out.append(collectives.psum(gs, self._mesh, "dp")[0])
        return out

    def _compute(self):
        """Forward, backward and update over the bound tensors; returns
        each position's outputs.  The body of the eager step and of the
        graph."""
        values, leaves = self._leaves()
        taps = None
        if self.n_dev == 1:
            with torch.enable_grad(), self._tap_frame() as taps:
                outs, new_aux = self.exe._prog.evaluate(
                    values[0], train=True, device=self.device)
            grads = self._grads(outs, leaves[0])
            outs = [outs]
        elif self._comm_plan is not None:
            outs, grads = self._overlap_step(values, leaves)
            new_aux = {}
        elif self._split is not None:
            with torch.enable_grad():
                outs, new_aux = self._split.evaluate(values, True,
                                                     self.devices)
            rows = self._split.batched_outputs
            # a batchless output is one value: its head gradient once
            ys = [o for k, g in enumerate(outs) for o, b in zip(g, rows)
                  if b or k == 0]
            flat = self._grads(ys, [t for lv in leaves for t in lv])
            p = len(self.param_names)
            grads = self._psum([flat[k * p:(k + 1) * p]
                                for k in range(self.n_dev)], leaves)
        else:
            with self._tap_frame() as taps:
                outs, new_aux, grads = self._global_step(values, leaves[0])
        self._write_aux(new_aux)
        old = self._copy_masters() if self._health_on else None
        self._update(grads)
        if self._health_on:
            self._pack_health(outs, grads, old, taps)
        return [[o.detach() for o in g] for g in outs]

    def _tap_frame(self):
        """The attention taps' frame of a health-on step (the positions of
        the split and bucketed paths each run the graph alone, so their
        tap slots hold -1)."""
        return _health.collect_taps() if self._health_on \
            else contextlib.nullcontext()

    def _copy_masters(self):
        """A copy of every master before the update (the exact update
        ratio's baseline)."""
        with torch.no_grad():
            return list(torch._foreach_mul(self._masters, 1.0))

    def _pack_health(self, outs, grads, old, taps):
        """The step's packed health vector (``_hvec``, on the first
        position's device): ``pack_summary`` over the global outputs, the
        pre-update masters and the gradients, with the exact update ratio
        ``|Δw|/|w|``."""
        f32 = torch.float32
        with torch.no_grad():
            grads = [torch.zeros_like(w) if g is None else g
                     for g, w in zip(grads, old)]
            new = self._masters
            if all(w.dtype == f32 for w in old):
                diffs = torch._foreach_sub(new, old)
            else:
                diffs = [a.float() - b.float() for a, b in zip(new, old)]
            upd = torch.linalg.vector_norm(torch.stack(list(
                torch._foreach_norm(list(diffs), 2, dtype=f32))))
            if self.n_dev == 1:
                flat = outs[0]
            else:
                # the positions' rows of each output, joined
                flat = [torch.cat([g[i].reshape(-1).to(self.device)
                                   for g in outs])
                        for i in range(len(outs[0]))]
            hvec = _health.pack_summary(
                self.health_layout, [o.detach() for o in flat], old, grads,
                taps=taps)
            # the ratio's denominator is the vector's own param norm
            hvec[_RATIO] = upd / torch.clamp(hvec[_PARAM_NORM], min=1e-12)
        self._hvec = hvec
        self.health_inputs = (grads, old)

    def _publish_health(self):
        """Hand the last step's vector to the host: a non-blocking copy
        into the pinned buffer and an event on the card (no wait here)."""
        hvec = self._hvec
        if hvec.device.type != "cuda":
            self.last_health = hvec
            return
        if self._health_host is None:
            self._health_host = torch.empty(hvec.shape, dtype=hvec.dtype,
                                            pin_memory=True)
            self._health_event = torch.cuda.Event()
        self._health_host.copy_(hvec, non_blocking=True)
        self._health_event.record(torch.cuda.current_stream(self.device))
        self.last_health = self._health_host

    def take_health(self):
        """The last step's health vector as a numpy array (None when the
        sentinel is off or it was taken already): waits for the copy's
        event, the step's only synchronization with the host."""
        vec = self.last_health
        if vec is None:
            return None
        self.last_health = None
        if vec is self._health_host:
            self._health_event.synchronize()
        return vec.detach().to("cpu").numpy().copy()

    def _global_step(self, values, leaves):
        """The graph over the global batch on the first position: the
        positions' rows joined, each position's rows of the outputs."""
        group = self.module._exec_group
        dev, axes = self.device, self._batch_axes()
        joined = dict(values[0])
        for name, axis in axes.items():
            joined[name] = torch.cat([v[name].to(dev) for v in values],
                                     dim=max(axis, 0))
        with torch.enable_grad():
            outs, new_aux = self._global.evaluate(joined, train=True,
                                                  device=dev)
        grads = self._grads(outs, leaves)
        per = []
        for sl, d in zip(group.slices, self.devices):
            mine = []
            for o, axis in zip(outs, group.output_layouts):
                if axis >= 0 and o.dim() > axis \
                        and o.shape[axis] == group.batch_size:
                    o = o.narrow(axis, sl.start, sl.stop - sl.start)
                mine.append(o.to(d))
            per.append(mine)
        return per, new_aux, grads

    def _overlap_step(self, values, leaves):
        """Each position's forward and backward alone, then one
        collective a bucket (``comm.reduce_buckets``), 2-bit with each
        position's residuals when compressing."""
        outs, glists = [], []
        for k, exe in enumerate(self.execs):
            with torch.enable_grad():
                o, _ = exe._prog.evaluate(values[k], train=True,
                                          device=self.devices[k])
            g = self._grads(o, leaves[k])
            glists.append([torch.zeros_like(t) if x is None else x
                           for x, t in zip(g, leaves[k])])
            outs.append(o)
        res = self._residuals
        res_in = [[r.shards[k][0] for r in res] for k in range(self.n_dev)]
        with torch.no_grad():
            red, new_res = _comm.reduce_buckets(
                glists, "dp", self._comm_plan, res_in, mesh=self._mesh)
            for k in range(self.n_dev):
                for r, t in zip(res, new_res[k]):
                    r.shards[k][0].copy_(t)
        return outs, red[0]

    def _update(self, grads):
        """One optimizer step of every master from its gradient, written
        back into every executor's storage that is not the master."""
        masters, states = self._masters, self.states
        with torch.no_grad():
            for j, g in enumerate(grads):
                w = masters[j]
                if g is None:  # the outputs do not depend on it
                    g = torch.zeros_like(w)
                elif self.mixed[j]:
                    g = g.float()  # the one f32 cast on the gradient path
                _opt.apply_update(self.opt, w, g, states[j], self._lr[j],
                                  self._wd[j], self._ex[j], key=self._key)
                name = self.param_names[j]
                for k, exe in enumerate(self.execs):
                    if k or self.mixed[j]:
                        exe.arg_dict[name].tensor.copy_(w)

    def _per_step_scalars(self):
        """Advance the optimizer's counts once for this batch and pack
        each parameter's lr, wd and extras."""
        opt = self.opt
        rows = []
        for i in self.param_idx:
            opt._update_count(i)
            rows.append((opt._get_lr(i), opt._get_wd(i))
                        + tuple(opt.fused_scalars(i)))
        packed = torch.from_numpy(np.asarray(rows, np.float32).reshape(
            self._scalars.shape))
        if self.device.type == "cuda":
            # the host allocator keeps a pinned block until the copy that
            # reads it has run, so the next step cannot overwrite it early
            self._scalars.copy_(packed.pin_memory(), non_blocking=True)
        else:
            self._scalars.copy_(packed)

    def _load(self, data_batch):
        """Copy each position's rows of the batch into its executor's
        bound input tensors, cast to their dtypes: the graph reads those
        tensors, so they are never rebound."""
        module = self.module
        group = module._exec_group
        pairs = list(zip([d.name for d in module._data_shapes],
                         data_batch.data))
        if module._label_shapes and data_batch.label:
            pairs += list(zip([d.name for d in module._label_shapes],
                              data_batch.label))
        axes = self._batch_axes()
        with torch.no_grad():
            for name, arr in pairs:
                if name not in self.exe.arg_dict:
                    continue
                src = arr.tensor if isinstance(arr, NDArray) \
                    else torch.as_tensor(np.asarray(arr))
                axis = axes.get(name, -1)
                for exe, sl in zip(self.execs, group.slices):
                    part = src if axis < 0 or self.n_dev == 1 \
                        else src.narrow(axis, sl.start, sl.stop - sl.start)
                    exe.arg_dict[name].tensor.copy_(part)

    def _refresh(self):
        """Honour writes into the bound tensors since the last step.  A new
        tensor object (a rebind) means a new capture, and a parameter
        without a master updates the new tensor from then on.  A parameter
        with one, rebound or written in place, re-derives its master unless
        its storage still equals the master cast."""
        if any(a is not b for a, b in zip(self._bound_tensors(),
                                          self._bound)):
            self._bound = self._bound_tensors()
            self.graph, self._outs = None, None
            self._eager_on_card = 0
        shared = self.shared
        for j, n in enumerate(self.param_names):
            was, version = shared.seen[n]
            t = self.exe.arg_dict[n].tensor
            if t is not was:
                if t.shape != was.shape or t.dtype != was.dtype:
                    raise MXNetError(
                        "parameter %s was rebound to a %s %s tensor; the "
                        "fused step trains it as %s %s" % (
                            n, t.dtype, tuple(t.shape), was.dtype,
                            tuple(was.shape)))
                if not self.mixed[j]:
                    shared.masters[n] = t.detach()
            elif t._version == version:
                continue
            if self.mixed[j]:
                master = shared.masters[n]
                with torch.no_grad():
                    if not torch.equal(t, master.to(t.dtype)):
                        master.copy_(t)

    def run(self, data_batch):
        module = self.module
        if module._exec_group.execs[0] is not self.exe:
            # a reshape rebuilt the executors: keep the shared masters,
            # optimizer states and residuals (same symbol, same parameter
            # list)
            self.__init__(module, share=self)
        first = not self._traced
        if first:
            # the step's first run builds it (the JAX package traces its
            # step program here)
            self._traced = True
            executor_cache.note_trace("fused_step")
        self.ran = True
        self._refresh()
        self._load(data_batch)
        self._per_step_scalars()
        for exe in self.execs:
            exe._recorded = None
        with _memprof.oom_guard("fused_step" if self.n_dev == 1
                                else "fused_step_dp"), \
                collectives.watch() as record:
            if not self._graphable:
                rec = _memprof.note_build("fused_step", self._memprof_label) \
                    if first else None
                with _memprof.first_run(rec, self.device,
                                        self._arguments) as run_outs:
                    outs = self._compute()
                    run_outs.extend(o for g in outs for o in g)
            elif self.graph is None and self._eager_on_card < WARMUP_STEPS:
                if self._eager_on_card == 0:
                    # a capture sequence starts: one record for it
                    self._probe = _memprof.CaptureProbe(
                        _memprof.note_build("fused_step",
                                            self._memprof_label),
                        self.device)
                with self._probe.warmup():
                    outs = self._eager_on_stream()
                self._eager_on_card += 1
            else:
                if self.graph is None:
                    self._capture()
                self.graph.replay()
                self.replays += 1
                _kernels.add_launch_counts(self.graph_launches)
                collectives.add_counts(self.graph_collectives)
                outs = [[o.clone() for o in g] for g in self._outs]
            if self._health_on:
                self._publish_health()
        self.collectives = record.counts
        if self._comm_plan is not None:
            # the plan's wire bytes, on the host (no launch, no sync)
            _instrument.note_comm_overlapped(self._comm_plan)
        for exe, mine in zip(self.execs, outs):
            exe.outputs = [NDArray(o) for o in mine]
        self._note_seen()

    def _eager_on_stream(self):
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            outs = self._compute()
        cur.wait_stream(self._stream)
        for g in outs:
            for o in g:
                o.record_stream(cur)
        return outs

    def _arguments(self):
        """What a step reads and keeps: the bound tensors, the masters
        that are not the storage, and the optimizer states."""
        out = list(self._bound_tensors())
        out += [self.shared.masters[n] for j, n in
                enumerate(self.param_names) if self.mixed[j]]
        for st in self.states:
            out += _opt.state_leaves(st)
        return out

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        if hasattr(graph, "register_generator_state"):
            # replays then draw fresh numbers from the port's generator
            graph.register_generator_state(_random.generator(self.device))
        if self._probe is None:
            self._probe = _memprof.CaptureProbe(
                _memprof.note_build("fused_step", self._memprof_label),
                self.device)
        probe, self._probe = self._probe, None
        t0 = time.perf_counter()
        try:
            # thread_local: an input pipeline's workers go on uploading the
            # next batches on their own threads (pinned allocations, event
            # waits on a side stream) while this step is captured; in the
            # global mode any such call invalidates the capture
            with probe.capture(self._arguments,
                               lambda: [o for g in outs for o in g]), \
                    _kernels.captured_launches() as launches, \
                    collectives.captured() as issued, \
                    torch.cuda.device(self.device), \
                    torch.cuda.graph(graph, stream=self._stream,
                                     capture_error_mode="thread_local"):
                outs = self._compute()
        except Exception as exc:
            raise MXNetError("capturing the fused train step as a CUDA "
                             "graph failed: %s" % exc) from exc
        self.capture_seconds = time.perf_counter() - t0
        self.graph_launches = launches
        self.graph_collectives = issued
        self.graph, self._outs = graph, outs
        self.captures += 1

    # -- handing state over --------------------------------------------------
    def retire(self, updater):
        """Leave the fused path in every module sharing this state, the
        state handed to ``updater`` (None drops it)."""
        self.transfer_to_updater(updater)
        for step in self.shared.steps:
            if step.module._fused_step is step:
                step.module._fused_step = None
        self.shared.steps = []

    def sync_masters(self, arg_params, aux_params):
        """Copy the step's state into the host master dicts bit for bit,
        in each parameter's storage dtype (the JAX package's): the
        replicas are equal, so no mean over the contexts rounds them."""
        shared, exe = self.shared, self.exe
        with torch.no_grad():
            for name, nd in arg_params.items():
                src = shared.masters.get(name)
                if src is not None and shared.mixed[name]:
                    # the storage's value: the master cast as the step casts
                    src = src.to(exe.arg_dict[name].tensor.dtype)
                elif src is None and name in exe.arg_dict:
                    src = exe.arg_dict[name].tensor  # a fixed parameter
                if src is not None:
                    nd.tensor.copy_(src)
            for name, nd in aux_params.items():
                if name in exe.aux_dict:
                    nd.tensor.copy_(exe.aux_dict[name].tensor)

    def transfer_to_updater(self, updater):
        """Seed a local Updater's per-index state from the shared tensors,
        so that retiring the fused path keeps the optimizer state (and the
        f32 masters under multi_precision): over several contexts one slot
        a context (``index + k``), each with its own copy on the
        context's device."""
        if updater is None:
            return
        if self._residuals:
            self.module.logger.warning(
                "retiring the fused step drops the 2-bit compression "
                "error-feedback residuals; the general path reduces "
                "uncompressed gradients")
        shared = self.shared
        for name, idx in shared.index.items():
            for k, dev in enumerate(self.devices):
                own = (lambda t: t) if k == 0 \
                    else (lambda t, d=dev: t.to(d, copy=True))
                st = _map_state(lambda t: NDArray(own(t)),
                                shared.states[name])
                if shared.mixed[name]:
                    st = self.opt.fused_wrap_mp_state(
                        st, NDArray(own(shared.masters[name])))
                updater.states[idx + k] = st
                updater.states_synced[idx + k] = True

    def export_states(self):
        """The ``fused_v2`` layout: {name: {"state": numpy tree[,
        "master": f32 numpy]}}, the JAX package's byte for byte, and the
        residuals under ``__comm_residuals__`` (the comm signature and
        one (dp, elements) array a bucket)."""
        def host(t):  # a copy: the live tensors go on training
            t = t.detach()
            return (t.float() if t.dtype == torch.bfloat16 else t
                    ).to("cpu", copy=True).numpy()
        shared = self.shared
        out = {}
        for name in shared.index:
            entry = {"state": _map_state(host, shared.states[name])}
            if shared.mixed[name]:
                entry["master"] = host(shared.masters[name])
            out[name] = entry
        if self._residuals:
            out[_RESIDUAL_KEY] = {
                "signature": _comm.comm_signature(),
                "buckets": [np.asarray(r) for r in self._residuals]}
        return out

    def _load_residuals(self, comm_st):
        """Restore checkpointed residuals: bit for bit when the layout
        matches, sum-merged over dp when a larger dp this one divides
        wrote them, else dropped with a warning (a residual under another
        quantization layout would add noise, not correction)."""
        logger = self.module.logger
        res = self._residuals
        want = [tuple(r.shape) for r in res]
        saved_sig = comm_st.get("signature")
        cur_sig = _comm.comm_signature()
        buckets = None
        if saved_sig is not None and tuple(saved_sig) != tuple(cur_sig):
            logger.warning(
                "checkpointed compression residuals were written under "
                "comm signature %s but the current configuration is %s; "
                "dropping them (error feedback restarts from zero)",
                tuple(saved_sig), tuple(cur_sig))
        else:
            buckets = [np.asarray(b, np.float32)
                       for b in comm_st.get("buckets", [])]
            if [b.shape for b in buckets] != want:
                resharded, reason = (None, "bucket count changed") \
                    if len(buckets) != len(want) \
                    else _comm.reshard_residuals(buckets, self.n_dev)
                if resharded is not None \
                        and [r.shape for r in resharded] == want:
                    logger.info(
                        "elastic resume: sum-merged compression residuals "
                        "from dp=%d onto dp=%d (pending quantization error "
                        "conserved)", buckets[0].shape[0], self.n_dev)
                    buckets = resharded
                else:
                    logger.warning(
                        "checkpointed compression residuals do not match "
                        "the current bucket layout (%s vs %s%s); dropping "
                        "them (error feedback restarts from zero)",
                        [tuple(b.shape) for b in buckets], want,
                        "; " + reason if reason else "")
                    buckets = None
        with torch.no_grad():
            for j, r in enumerate(res):
                for k, s in enumerate(r.shards):
                    if buckets is None:
                        s.zero_()
                    else:
                        s.copy_(torch.from_numpy(buckets[j][k:k + 1]))

    def load_states(self, states):
        """Restore ``fused_v2`` (or ``fused_v1``: a bare momentum array per
        name) states in place; a restored master is authoritative, and
        residuals follow ``_load_residuals``."""
        shared = self.shared
        comm_st = states.get(_RESIDUAL_KEY)
        if comm_st is not None and self._residuals:
            self._load_residuals(comm_st)
        with torch.no_grad():
            for name, v in states.items():
                if name not in shared.states:
                    continue
                if isinstance(v, dict):
                    st = v["state"]
                    if shared.mixed[name] and v.get("master") is not None:
                        shared.masters[name].copy_(
                            torch.from_numpy(np.asarray(v["master"])))
                else:
                    st = v
                cur = _opt.state_leaves(shared.states[name])
                new = _opt.state_leaves(st)
                if len(cur) != len(new) or any(
                        tuple(a.shape) != tuple(np.shape(b))
                        for a, b in zip(cur, new)):
                    continue
                for dst, src in zip(cur, new):
                    dst.copy_(torch.from_numpy(np.asarray(src)))
        for step in shared.steps:
            step._note_seen()

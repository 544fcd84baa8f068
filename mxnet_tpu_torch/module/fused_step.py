"""The fused train step: forward, backward and the optimizer update of a
batch as one unit, on one device; on the card, one CUDA graph replay.

Counterpart of ``mxnet_tpu/module/fused_step.py`` for one device.  The
JAX package jits forward, backward and every parameter's update into one
XLA program a batch.  Here the same step function (the executor's plan
run under torch autograd, ``torch.autograd.grad`` of its outputs, the
BatchNorm moving statistics written back, then each optimizer's
``fused_update``) runs eagerly on the host, and on the card is captured
once into a ``torch.cuda.CUDAGraph`` and replayed for every later batch:
one launch from the host a step in place of ~2,000.

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
  fails raises ``MXNetError``.  The kernels' launch counts are taken
  from the capture and added again at every replay.
- **Writes from outside.** ``set_params`` copies into the bound tensors
  (torch bumps their version counters): the step re-derives a master
  from its storage unless the storage still equals the master cast, so
  the epoch-end ``set_params`` of ``fit`` keeps the f32 masters.  A
  ``reshape`` rebuilds the executor: the step carries its masters and
  states to it and captures anew.
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

It serves one context without a store.  ``refusal`` keeps the JAX
package's gating for the rest: a store that updates, a store on one
context, several contexts without a collective store, on one device or
with unequal slices take the general path.  On distinct cards under a
collective store the JAX package fuses the data-parallel step; that path
waits for the next multi-device slice (A3b), as do the overlapped
collectives, the health sentinel, the memory profiler and the program
cache.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..base import MXNetError
from ..ndarray import NDArray
from ..ops import kernels as _kernels
from .. import optimizer as _opt
from .. import random as _random

# eager steps on the capture stream before the graph is captured
WARMUP_STEPS = 1


def _map_state(fn, state):
    if isinstance(state, tuple):
        return tuple(_map_state(fn, s) for s in state)
    return None if state is None else fn(state)


class _SharedState:
    """What every module sharing one fused step trains, by parameter
    name: the masters (an f32 copy, or the storage itself), the optimizer
    states, the Updater index, and the storage (tensor, version) seen
    after the last step of any sharer."""

    def __init__(self):
        self.masters = {}
        self.states = {}
        self.mixed = {}
        self.index = {}
        self.seen = {}
        self.steps = []
        self.ran = False


class FusedTrainStep:
    @staticmethod
    def refusal(module):
        """Why the fused step cannot serve ``module`` (None when it can):
        the JAX package's gating (``FusedTrainStep.supports``)."""
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
            if len({c.torch_device() for c in module._context}) != n:
                return "several contexts on one device"
            if len({s.stop - s.start for s in group.slices}) != 1:
                return "unequal batch slices"
            # distinct cards under a collective store: the JAX package
            # fuses the data-parallel step (BatchNorm over the whole batch)
            return "the fused dp step waits for A3b2b"
        opt = module._optimizer
        if opt is None or not opt._fused_ok():
            return "optimizer %s has no fused update of its own" \
                % type(opt).__name__
        exe = group.execs[0]
        if exe._monitor_callback is not None:
            return "monitor installed"
        if any(req == "add" for req in exe._grad_req.values()):
            return "grad_req 'add'"
        if module.inputs_need_grad:
            return "inputs_need_grad"
        draws = opt.fused_needs_rng or any(
            step[0].needs_rng for step in exe._prog.steps)
        if exe._device.type == "cuda" and draws and not hasattr(
                torch.cuda.CUDAGraph, "register_generator_state"):
            return ("the step draws random numbers and this torch cannot "
                    "register a generator with a CUDA graph")
        return None

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
        exe = module._exec_group.execs[0]
        self.exe = exe
        self.opt = opt = module._optimizer
        self.device = exe._device
        self.param_names = list(exe._grad_names)
        idx_of = {n: i for i, n in enumerate(module._exec_group.param_names)}
        self.param_idx = [idx_of.get(n, i)
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
        # the CUDA graph and what it captured
        self.graph = None
        self.captures = 0
        self.replays = 0
        self.graph_launches = {}
        self.capture_seconds = None
        self._outs = None
        self._eager_on_card = 0
        self._stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None

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

    def _init_state(self, j):
        """create_state-shaped optimizer state in the master dtype."""
        st = self.opt.create_state(
            self.param_idx[j],
            NDArray(self.shared.masters[self.param_names[j]]))
        return _opt.state_tensors(st)

    def _bound_tensors(self):
        exe = self.exe
        return [a.tensor for a in exe.arg_dict.values()] + \
            [a.tensor for a in exe.aux_dict.values()]

    def _note_seen(self):
        """Record the (tensor, version counter) of each parameter's
        storage in the shared state."""
        for n in self.param_names:
            t = self.exe.arg_dict[n].tensor
            self.shared.seen[n] = (t, t._version)

    # -- the step ------------------------------------------------------------
    def _compute(self):
        """Forward, backward and update over the bound tensors; returns
        the outputs.  The body of the eager step and of the graph."""
        exe, opt = self.exe, self.opt
        values = {n: a.tensor for n, a in exe.arg_dict.items()}
        values.update((n, a.tensor) for n, a in exe.aux_dict.items())
        leaves = [values[n].detach().requires_grad_(True)
                  for n in self.param_names]
        values.update(zip(self.param_names, leaves))
        with torch.enable_grad():
            outs, new_aux = exe._prog.evaluate(values, train=True,
                                               device=self.device)
        ys = [o for o in outs if o.requires_grad]
        grads = torch.autograd.grad(
            ys, leaves, [torch.ones_like(y) for y in ys],
            allow_unused=True) if ys else [None] * len(leaves)
        masters, states = self._masters, self.states
        with torch.no_grad():
            for name, value in new_aux.items():
                dst = exe.aux_dict[name].tensor
                if value is not dst:
                    dst.copy_(value)
            for j, g in enumerate(grads):
                w = masters[j]
                if g is None:  # the outputs do not depend on it
                    g = torch.zeros_like(w)
                elif self.mixed[j]:
                    g = g.float()  # the one f32 cast on the gradient path
                _opt.apply_update(opt, w, g, states[j], self._lr[j],
                                  self._wd[j], self._ex[j], key=self._key)
                if self.mixed[j]:
                    exe.arg_dict[self.param_names[j]].tensor.copy_(w)
        return [o.detach() for o in outs]

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
        """Copy the batch into the bound input tensors, cast to their
        dtypes: the graph reads those tensors, so they are never
        rebound."""
        exe, module = self.exe, self.module
        pairs = list(zip([d.name for d in module._data_shapes],
                         data_batch.data))
        if module._label_shapes and data_batch.label:
            pairs += list(zip([d.name for d in module._label_shapes],
                              data_batch.label))
        with torch.no_grad():
            for name, arr in pairs:
                if name in exe.arg_dict:
                    src = arr.tensor if isinstance(arr, NDArray) \
                        else torch.as_tensor(np.asarray(arr))
                    exe.arg_dict[name].tensor.copy_(src)

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
            # a reshape rebuilt the executor: keep the shared masters and
            # optimizer state (same symbol, same parameter list)
            self.__init__(module, share=self)
        self.ran = True
        self._refresh()
        self._load(data_batch)
        self._per_step_scalars()
        exe = self.exe
        exe._recorded = None
        if self.device.type != "cuda":
            exe.outputs = [NDArray(o) for o in self._compute()]
        elif self.graph is None and self._eager_on_card < WARMUP_STEPS:
            exe.outputs = [NDArray(o) for o in self._eager_on_stream()]
            self._eager_on_card += 1
        else:
            if self.graph is None:
                self._capture()
            self.graph.replay()
            self.replays += 1
            _kernels.add_launch_counts(self.graph_launches)
            exe.outputs = [NDArray(o.clone()) for o in self._outs]
        self._note_seen()

    def _eager_on_stream(self):
        cur = torch.cuda.current_stream(self.device)
        self._stream.wait_stream(cur)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            outs = self._compute()
        cur.wait_stream(self._stream)
        for o in outs:
            o.record_stream(cur)
        return outs

    def _capture(self):
        graph = torch.cuda.CUDAGraph()
        if hasattr(graph, "register_generator_state"):
            # replays then draw fresh numbers from the port's generator
            graph.register_generator_state(_random.generator(self.device))
        t0 = time.perf_counter()
        try:
            # thread_local: an input pipeline's workers go on uploading the
            # next batches on their own threads (pinned allocations, event
            # waits on a side stream) while this step is captured; in the
            # global mode any such call invalidates the capture
            with _kernels.captured_launches() as launches, \
                    torch.cuda.device(self.device), \
                    torch.cuda.graph(graph, stream=self._stream,
                                     capture_error_mode="thread_local"):
                outs = self._compute()
        except Exception as exc:
            raise MXNetError("capturing the fused train step as a CUDA "
                             "graph failed: %s" % exc) from exc
        self.capture_seconds = time.perf_counter() - t0
        self.graph_launches = launches
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

    def transfer_to_updater(self, updater):
        """Seed a local Updater's per-index state from the shared tensors,
        so that retiring the fused path keeps the optimizer state (and the
        f32 masters under multi_precision)."""
        if updater is None:
            return
        shared = self.shared
        for name, idx in shared.index.items():
            st = _map_state(NDArray, shared.states[name])
            if shared.mixed[name]:
                st = self.opt.fused_wrap_mp_state(
                    st, NDArray(shared.masters[name]))
            updater.states[idx] = st
            updater.states_synced[idx] = True

    def export_states(self):
        """The ``fused_v2`` layout: {name: {"state": numpy tree[,
        "master": f32 numpy]}}, the JAX package's byte for byte."""
        def host(t):
            t = t.detach()
            return (t.float() if t.dtype == torch.bfloat16 else t
                    ).cpu().numpy()
        shared = self.shared
        out = {}
        for name in shared.index:
            entry = {"state": _map_state(host, shared.states[name])}
            if shared.mixed[name]:
                entry["master"] = host(shared.masters[name])
            out[name] = entry
        return out

    def load_states(self, states):
        """Restore ``fused_v2`` (or ``fused_v1``: a bare momentum array per
        name) states in place; a restored master is authoritative."""
        shared = self.shared
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

"""Continuous batching for stateful/recurrent decode: iteration-level
scheduling over one fixed-shape bound step.

Counterpart of ``mxnet_tpu/serving/continuous.py``.  A decode request is
a sequence of steps with recurrent state between them, and sequences end
at different times, so they cannot ride the request-level batcher:

- ONE bound step at a fixed batch shape of ``slot_count`` rows
  (``MXNET_TPU_SERVING_SLOT_COUNT``, default 8), bound through
  ``simple_bind`` like a bucket predictor: its plan is built once and
  serves every iteration whichever streams hold which slots.
- Per-slot recurrent state stays ON THE DEVICE between iterations: each
  state input is fed the previous iteration's matching output, gated by
  the slot occupancy mask through a row-wise ``torch.where``, so a slot
  that a stream left or just joined starts from exact zeros.  A select,
  never a multiply: a departed stream's Inf/NaN cannot reach the next
  occupant (``0 * Inf`` is NaN; the select drops the row), and a kept
  row passes through bit for bit.
- Streams JOIN a free slot and LEAVE at EOS without a shape change:
  only host-side input rows and the mask change.

Every iteration of every stream runs in the same ``slot_count``-row
step, its state row either exact zeros (a join) or the bits of its own
previous iteration, so a stream decodes bit for bit as it does alone
through a batcher of the same slot count.

The default ``ctx`` is the current context, ``gpu(0)`` unless the caller
enters another (the JAX package's default is ``cpu()``).

::

    cb = serving.ContinuousBatcher(
        step_sym, arg_params,
        input_shapes={"data": (feat,)},
        state_shapes={"state_h": (hidden,), "state_c": (hidden,)},
        state_pairs=[("state_h", 1), ("state_c", 2)],  # output index
        slot_count=8)
    cb.warmup()
    s = cb.submit({"data": seq})      # seq: (T, feat), one frame a step
    cb.drain()                        # or step() under your own loop
    outs = s.outputs()                # [(T, ...) per non-state output]
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import threads as _threads
from ..base import MXNetError
from ..context import current_context
from ..ndarray import NDArray, array as nd_array
from . import metrics

ENV_SLOT_COUNT = "MXNET_TPU_SERVING_SLOT_COUNT"
DEFAULT_SLOT_COUNT = 8


def default_slot_count():
    try:
        n = int(os.environ.get(ENV_SLOT_COUNT, str(DEFAULT_SLOT_COUNT)))
    except ValueError:
        return DEFAULT_SLOT_COUNT
    return max(1, n)


# -- pytree carry ------------------------------------------------------------
#
# The per-slot carry is a pytree (nested dict/list/tuple) of device
# tensors whose leaves are each (slot_count,) + anything.


def tree_map(fn, tree, *rest):
    """Map ``fn`` over matching leaves of pytrees (dict/list/tuple
    nesting; anything else is a leaf).  Structures must match."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    return fn(tree, *rest)


def tree_leaves(tree):
    """Leaves of a pytree in deterministic (sorted-key) order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def select_carry(mask, carried, zeros):
    """Row-wise occupancy select over a carry pytree of tensors: each
    leaf row is the carried value where the slot's mask is nonzero and
    exact zeros where it is 0.  A ``torch.where``, never a multiply.
    ``carried is None`` (before the first iteration) selects the zero
    tree wholesale."""
    if carried is None:
        return zeros

    def pick(c, z):
        keep = (mask != 0).reshape((-1,) + (1,) * (c.ndim - 1))
        return torch.where(keep, c, z)

    return tree_map(pick, carried, zeros)


class SlotScheduler:
    """Slot/occupancy machinery shared by :class:`ContinuousBatcher` and
    the paged-KV :class:`~mxnet_tpu_torch.serving.decode.
    PagedTransformerDecoder`: a FIFO of waiting streams, a fixed array of
    slots, admission into free slots, and the drain/close lifecycle.
    Subclasses implement :meth:`step` and the hooks."""

    def _init_slots(self, slot_count, name):
        self.name = str(name)
        self.slot_count = int(slot_count) if slot_count \
            else default_slot_count()
        if self.slot_count < 1:
            raise MXNetError("slot_count must be >= 1")
        self._lock = _threads.package_lock(
            "%s._lock" % type(self).__name__)
        self._slots = [None] * self.slot_count
        self._waiting = []
        self._closed = False
        self.iterations = 0

    # hooks ---------------------------------------------------------------
    def _on_admit_locked(self, slot, stream):
        """Per-join bookkeeping under the lock (e.g. mask reset)."""

    def _on_reject_locked(self, stream):
        """Undo submit-side acquisitions when a closed scheduler refuses
        the stream (e.g. release retained prefix pages)."""

    def _on_close_locked(self, doomed):
        """Bookkeeping under the lock while closing."""

    def _close_error(self, stream):
        return MXNetError("%s closed with the stream unfinished"
                          % type(self).__name__)

    def step(self):
        raise NotImplementedError

    # shared machinery ----------------------------------------------------
    def _enqueue(self, stream):
        """Closed-check and append under one lock acquisition: a submit
        racing close() is either refused here or failed by close, never
        appended after the drain."""
        with self._lock:
            if self._closed:
                self._on_reject_locked(stream)
                raise MXNetError("%s is closed" % type(self).__name__)
            self._waiting.append(stream)

    def _admit_locked(self):
        """Seat waiting streams in free slots; returns the joins."""
        joins = 0
        for slot in range(self.slot_count):
            if self._slots[slot] is not None or not self._waiting:
                continue
            stream = self._waiting.pop(0)
            stream.slot = slot
            self._slots[slot] = stream
            self._on_admit_locked(slot, stream)
            joins += 1
        return joins

    def active_streams(self):
        with self._lock:
            return sum(1 for s in self._slots if s is not None)

    def pending(self):
        """Streams not yet finished (active + waiting)."""
        with self._lock:
            return (sum(1 for s in self._slots if s is not None)
                    + len(self._waiting))

    def drain(self, max_iterations=None):
        """Run :meth:`step` until every submitted stream finished.
        Returns the number of iterations run."""
        n = 0
        while self.pending():
            if max_iterations is not None and n >= max_iterations:
                raise MXNetError(
                    "drain exceeded max_iterations=%d with %d stream(s) "
                    "unfinished" % (max_iterations, self.pending()))
            self.step()
            n += 1
        return n

    def close(self):
        """Refuse new streams and fail the unfinished ones."""
        with self._lock:
            self._closed = True
            doomed = [s for s in self._slots if s is not None]
            doomed += self._waiting
            self._slots = [None] * self.slot_count
            self._waiting = []
            self._on_close_locked(doomed)
        for stream in doomed:
            stream._finish(self._close_error(stream))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _Stream:
    """Completion state shared by both decode tiers' stream handles."""

    def _init_done(self):
        self._done = False
        self._cond = _threads.package_condition(
            "%s._cond" % type(self).__name__)
        self.error = None

    @property
    def done(self):
        return self._done

    def _finish(self, error=None):
        # first finish wins: a close() racing a step() marks the stream
        # with its typed error, which a later EOS must not overwrite
        with self._cond:
            if self._done:
                return
            self.error = error
            self._done = True
            self._cond.notify_all()

    def wait(self, timeout=None):
        """Block until the stream finished (EOS or error)."""
        with self._cond:
            if not self._cond.wait_for(lambda: self._done, timeout):
                raise MXNetError("stream did not finish within %ss"
                                 % timeout)
        if self.error is not None:
            raise self.error
        return self


class DecodeStream(_Stream):
    """One logical stream: its input frames, collected outputs and
    completion state.  Created by :meth:`ContinuousBatcher.submit`."""

    def __init__(self, inputs, length, eos_fn=None):
        self.inputs = inputs        # {name: (T,) + feature}
        self.length = length
        self.eos_fn = eos_fn        # optional (step_outputs_row) -> bool
        self.slot = None
        self.pos = 0                # next frame to feed
        self._collected = []        # per step: list of per-output rows
        self._init_done()

    def outputs(self):
        """One ``(steps,) + feature`` array per collected (non-state)
        output, stacked in step order."""
        if self.error is not None:
            raise self.error
        if not self._collected:
            return []
        n_outs = len(self._collected[0])
        return [np.stack([step[i] for step in self._collected])
                for i in range(n_outs)]

    @property
    def steps_decoded(self):
        return len(self._collected)


class ContinuousBatcher(SlotScheduler):
    """Slot-based iteration-level scheduler over one bound step (the
    module docstring has the model)."""

    def __init__(self, symbol, arg_params, input_shapes, state_shapes,
                 state_pairs, slot_count=None, aux_params=None, ctx=None,
                 collect_outputs=None, name="decode"):
        """``symbol``: the step graph, data inputs + state inputs ->
        outputs, where ``state_pairs`` maps each state input name to the
        output index holding its next value.  ``input_shapes`` /
        ``state_shapes``: per-row feature shapes (no batch dim).
        ``collect_outputs``: output indices returned to streams (default:
        every output no state claims)."""
        self._init_slots(slot_count, name)
        self.input_shapes = {k: tuple(int(d) for d in v)
                             for k, v in input_shapes.items()}
        self.state_shapes = {k: tuple(int(d) for d in v)
                             for k, v in state_shapes.items()}
        overlap = set(self.input_shapes) & set(self.state_shapes)
        if overlap:
            raise MXNetError("names %s are both data inputs and states"
                             % sorted(overlap))
        self.state_pairs = [(str(n), int(i)) for n, i in state_pairs]
        unknown = [n for n, _ in self.state_pairs
                   if n not in self.state_shapes]
        if unknown:
            raise MXNetError("state_pairs name(s) %s missing from "
                             "state_shapes" % unknown)
        self._ctx = ctx if ctx is not None else current_context()
        device = self._ctx.torch_device()
        bind_shapes = {k: (self.slot_count,) + v
                       for k, v in self.input_shapes.items()}
        bind_shapes.update({k: (self.slot_count,) + v
                            for k, v in self.state_shapes.items()})
        self._exe = symbol.simple_bind(self._ctx, grad_req="null",
                                       **bind_shapes)

        def nd(v):
            return v if isinstance(v, NDArray) else nd_array(v,
                                                             ctx=self._ctx)
        self._exe.copy_params_from(
            {k: nd(v) for k, v in arg_params.items()},
            {k: nd(v) for k, v in (aux_params or {}).items()},
            allow_extra_params=True)
        self.output_names = list(symbol.list_outputs())
        n_outs = len(self.output_names)
        bad = [i for _, i in self.state_pairs if not 0 <= i < n_outs]
        if bad:
            raise MXNetError("state output index(es) %s out of range "
                             "(%d outputs)" % (bad, n_outs))
        state_outs = {i for _, i in self.state_pairs}
        if collect_outputs is None:
            collect_outputs = [i for i in range(n_outs)
                               if i not in state_outs]
        self.collect_outputs = [int(i) for i in collect_outputs]
        # the previous iteration's state outputs on the device ({state
        # name: tensor}; None before the first iteration = zeros)
        self._carry = None
        # occupancy mask (slot_count,) f32: 1 = carry the slot's state
        # into the next iteration, 0 = start it from exact zeros
        self._mask = np.zeros((self.slot_count,), dtype=np.float32)
        self._zero_inputs = {
            k: np.zeros((self.slot_count,) + v, dtype=np.float32)
            for k, v in self.input_shapes.items()}
        self._zero_states = {
            k: torch.zeros((self.slot_count,) + v, dtype=torch.float32,
                           device=device)
            for k, v in self.state_shapes.items()}
        self._device = device

    # -- scheduling -----------------------------------------------------------

    def submit(self, inputs, eos_fn=None):
        """Queue one stream.  ``inputs``: {name: (T,)+feature}, frame t
        fed at the stream's t-th iteration (a bare array serves a
        single-input step).  ``eos_fn(row_outputs)`` may end the stream
        early; by default it leaves after its last frame.  Returns the
        :class:`DecodeStream`."""
        names = sorted(self.input_shapes)
        if not isinstance(inputs, dict):
            if len(names) != 1:
                raise MXNetError("step has inputs %s; pass a "
                                 "{name: array} dict" % names)
            inputs = {names[0]: inputs}
        arrays, length = {}, None
        for name in names:
            if name not in inputs:
                raise MXNetError("missing input %r" % name)
            arr = np.asarray(inputs[name], dtype=np.float32)
            feature = self.input_shapes[name]
            if arr.shape[1:] != feature or arr.ndim != len(feature) + 1 \
                    or arr.shape[0] == 0:
                raise MXNetError(
                    "input %r expects shape (steps,)+%s, got %s"
                    % (name, feature, arr.shape))
            if length is None:
                length = arr.shape[0]
            elif arr.shape[0] != length:
                raise MXNetError("inputs disagree on steps: %d vs %d"
                                 % (length, arr.shape[0]))
            arrays[name] = arr
        stream = DecodeStream(arrays, length, eos_fn=eos_fn)
        self._enqueue(stream)
        return stream

    def _on_admit_locked(self, slot, stream):
        # the joined slot's carry is dropped at the next select: the
        # stream starts from exact-zero state
        self._mask[slot] = 0.0

    # -- the iteration --------------------------------------------------------

    def _forward(self, feeds, mask_host):
        """One run of the bound step: data frames plus the gated carried
        state.  Returns the executor's outputs (device NDArrays)."""
        mask = torch.from_numpy(mask_host).to(self._device)
        feeds.update({k: NDArray(v) for k, v in select_carry(
            mask, self._carry, self._zero_states).items()})
        outs = self._exe.forward(is_train=False, **feeds)
        self._carry = {name: outs[idx].tensor
                       for name, idx in self.state_pairs}
        return outs

    def step(self):
        """One decode iteration over every occupied slot: seat waiting
        streams, feed each active stream's next frame (inactive slots
        feed zeros), run the fixed-shape step, carry state on the device,
        collect output rows, retire EOS streams.  Returns the number of
        active slots (0 = nothing ran)."""
        with self._lock:
            joins = self._admit_locked()
            active = [(slot, s) for slot, s in enumerate(self._slots)
                      if s is not None]
            if not active:
                return 0
            feeds = {k: buf.copy() for k, buf in self._zero_inputs.items()}
            for slot, stream in active:
                for name, arr in stream.inputs.items():
                    feeds[name][slot] = arr[stream.pos]
            mask_host = self._mask.copy()
        outs = self._forward(feeds, mask_host)
        host = [outs[i].asnumpy() for i in self.collect_outputs]
        self.iterations += 1
        # collect under the lock (no user code), then run eos_fn outside
        # it: a callback that touches the batcher must not deadlock, and
        # one that raises must not strand co-batched streams
        with self._lock:
            collected = []
            for slot, stream in active:
                rows = [h[slot].copy() for h in host]
                stream._collected.append(rows)
                stream.pos += 1
                collected.append((slot, stream, rows))
        decisions = []
        for slot, stream, rows in collected:
            eos = stream.pos >= stream.length
            error = None
            if not eos and stream.eos_fn is not None:
                try:
                    eos = bool(stream.eos_fn(rows))
                except Exception as exc:  # a bad callback fails ITS
                    eos, error = True, exc  # stream, not the batcher
            decisions.append((slot, stream, eos, error))
        leaves = 0
        with self._lock:
            for slot, stream, eos, _ in decisions:
                if eos:
                    self._slots[slot] = None
                    self._mask[slot] = 0.0
                    leaves += 1
                else:
                    self._mask[slot] = 1.0
        for _, stream, eos, error in decisions:
            if eos:
                stream._finish(error)
        metrics.record_decode_step(len(active), joins, leaves)
        return len(active)

    # -- warmup ---------------------------------------------------------------

    def warmup(self, verify=True):
        """Run one idle iteration (all-zero frames, the occupancy select
        applied) before traffic and, with ``verify``, a second that must
        build no plan, the ``Server.warmup`` contract.  Returns
        {"traces": n, "slot_count": S}."""
        from .. import executor_cache
        if self.pending():
            raise MXNetError("warmup must run before streams are "
                             "submitted")
        with executor_cache.watch_traces() as w:
            self._warm_iteration()
        traces = w.total()
        if verify:
            with executor_cache.watch_traces() as w2:
                self._warm_iteration()
            if w2.total():
                raise MXNetError(
                    "continuous-batcher warmup verification failed: %d "
                    "plan builds on the second iteration (delta: %s)"
                    % (w2.total(), w2.delta()))
        # a fresh start for the first real iteration (no slot active)
        self._carry = None
        self.iterations = 0
        return {"traces": traces, "slot_count": self.slot_count}

    def _warm_iteration(self):
        # the select runs on the zero tree itself, as it will in traffic
        self._carry = dict(self._zero_states)
        self._forward(dict(self._zero_inputs), self._mask.copy())

    # -- lifecycle ------------------------------------------------------------

    def _on_close_locked(self, doomed):
        self._mask[:] = 0.0

    def _close_error(self, stream):
        return MXNetError(
            "ContinuousBatcher closed with the stream unfinished "
            "(%d/%d steps decoded)" % (stream.steps_decoded,
                                       stream.length))

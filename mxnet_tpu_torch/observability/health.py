"""Training health sentinel: an in-step numerics summary and anomaly rules.

Counterpart of ``mxnet_tpu/observability/health.py``.  It answers "which
step produced the first NaN?" without re-running under a debugger and
without the per-tensor host syncs of the ``Monitor`` tap pass.

- **One packed vector a step, computed inside the step.**  With
  ``MXNET_TPU_HEALTH=1`` the executor's training run and the fused train
  step append a small reduction over tensors they already hold: the
  output-finiteness bitmask, the global gradient norm, the per-group
  max|g|, the parameter norm and the update/parameter ratio, packed into
  one float32 vector (``pack_summary``: ``torch._foreach_norm`` over the
  gradient and parameter lists and one ``amax`` a group).  On the card
  the fused step computes it inside its CUDA graph, so the sentinel adds
  no host launch and one small device-to-host copy a step.
- **The health flag keys the plan cache and the capture.**  Turning the
  sentinel on costs one new plan (and one new capture of a fused step);
  turning it off reuses the old ones, and with the flag off nothing that
  runs changes.
- **Host-side rules.**  ``HealthMonitor`` consumes the vector each step
  with rolling-window rules (non-finite loss/grad, grad-norm spike over a
  running EMA, loss plateau/explosion), emits telemetry counters and
  trace instants, feeds the flight recorder, invokes registered
  callbacks, and applies each rule's action from
  ``MXNET_TPU_HEALTH_RULES`` (warn / raise ``TrainingDivergedError`` /
  dump).

Layout, rules, actions and the multi-executor ``combine`` are the JAX
package's, slot for slot.
"""
from __future__ import annotations

import contextlib
import logging
import math
import os
import threading
from collections import OrderedDict, deque

from ..base import MXNetError
from . import flight_recorder as _flight
from . import telemetry as _telemetry
from . import tracing as _tracing

_ENV = "MXNET_TPU_HEALTH"
_RULES_ENV = "MXNET_TPU_HEALTH_RULES"

# outputs beyond this many share the last bitmask bit's fate implicitly
# (24 bits keep the mask exactly representable in float32)
MASK_OUTPUTS = 24

# at most this many per-param-group max|g| slots (contiguous groups over
# the ordered grad-name list; the layout records which names each covers)
MAX_GRAD_GROUPS = 8

# at most this many per-attention-node max|logit| tap slots
MAX_TAPS = 8

RULES = ("nonfinite", "grad_spike", "loss_plateau", "loss_explosion")
ACTIONS = ("off", "warn", "dump", "raise")

# loss_plateau defaults off: the loss proxy is mean(output[0]), which is
# constant for probability outputs (softmax rows sum to 1)
DEFAULT_ACTIONS = {"nonfinite": "raise", "grad_spike": "warn",
                   "loss_explosion": "warn", "loss_plateau": "off"}

_log = logging.getLogger("mxnet_tpu_torch.observability.health")


def enabled():
    """The sentinel is opt-in: ``MXNET_TPU_HEALTH=1``, read per call.  It
    is resolved at bind time into the plan-cache key (and at a fused
    step's construction), so flipping it mid-run affects the next bind."""
    return os.environ.get(_ENV, "0") == "1"


def rule_actions(spec=None):
    """Per-rule action map: defaults overridden by ``spec`` (or the
    ``MXNET_TPU_HEALTH_RULES`` env), format ``rule=action[,...]`` with
    action in off/warn/dump/raise.  Unknown rules or actions are ignored
    with a warning."""
    actions = dict(DEFAULT_ACTIONS)
    if spec is None:
        spec = os.environ.get(_RULES_ENV, "")
    for item in str(spec).split(","):
        item = item.strip()
        if not item:
            continue
        rule, _, action = item.replace(":", "=").partition("=")
        rule, action = rule.strip(), action.strip()
        if rule not in RULES or action not in ACTIONS:
            _log.warning("ignoring malformed %s entry %r (rules: %s, "
                         "actions: %s)", _RULES_ENV, item, RULES, ACTIONS)
            continue
        actions[rule] = action
    return actions


# -- attention-logit taps ----------------------------------------------------
#
# The attention ops call ``note_tap(value)`` while their forward runs.
# The executor opens a thread-local frame (``collect_taps``) around a
# health-on training run; taps land in the frame in execution order,
# which is the plan's topological order: the order
# ``attention_tap_names`` derives the slot names from before the run.
# Without an open frame the ops compute no tap at all (``collecting``).

_tap_tls = threading.local()


def collecting():
    """Whether a tap frame is open on this thread (the attention ops
    compute their bound only then)."""
    return bool(getattr(_tap_tls, "frames", None))


def note_tap(value):
    """Record one tap scalar into the innermost open frame (a no-op when
    no frame is open)."""
    frames = getattr(_tap_tls, "frames", None)
    if frames:
        frames[-1].append(value)


@contextlib.contextmanager
def collect_taps():
    """Open a tap frame around a run; yields the list the run's
    ``note_tap`` calls append to (scalar tensors, topological order)."""
    frames = getattr(_tap_tls, "frames", None)
    if frames is None:
        frames = _tap_tls.frames = []
    frame = []
    frames.append(frame)
    try:
        yield frame
    finally:
        frames.pop()


def attention_tap_names(order):
    """Static scan of a graph's topological node order for the attention
    ops that ``note_tap``: their node names in execution order, capped at
    :data:`MAX_TAPS`."""
    names = []
    for node in order:
        if getattr(node, "is_var", False):
            continue
        if getattr(node, "op_name", None) in (
                "multi_head_attention", "scaled_dot_product_attention"):
            names.append(node.name)
    return tuple(names[:MAX_TAPS])


class TrainingDivergedError(MXNetError):
    """A health rule with action ``raise`` fired.  Carries the first bad
    step (``.step``), the rule (``.rule``) and the flight-dump path
    (``.dump_path``, None when no dump could be written)."""

    def __init__(self, message, step=None, rule=None, dump_path=None):
        super().__init__(message)
        self.step = step
        self.rule = rule
        self.dump_path = dump_path


class HealthLayout:
    """Slot map of one packed health vector.

    Fixed head: ``finite_mask`` (bit i set = output i all-finite),
    ``out_mean`` (mean of output 0, the loss proxy), ``grad_norm``
    (global l2), ``param_norm`` (l2 over the trained parameters),
    ``update_ratio`` (|Δw|/|w|; exact on the fused-step path, -1 when the
    run did not compute it); then one ``max_abs_grad/…`` slot per
    contiguous parameter group, then one ``max_abs_attn_logit/…`` slot
    per attention tap (-1 when the run could not collect it)."""

    HEAD = ("finite_mask", "out_mean", "grad_norm", "param_norm",
            "update_ratio")

    def __init__(self, n_outputs, grad_names, max_groups=MAX_GRAD_GROUPS,
                 tap_names=()):
        self.n_outputs = max(0, min(int(n_outputs), MASK_OUTPUTS))
        self.full_mask = float((1 << self.n_outputs) - 1)
        grad_names = list(grad_names or ())
        n_groups = min(len(grad_names), max_groups)
        self.groups = []  # (label, start, stop) over the grad-name order
        for g in range(n_groups):
            start = g * len(grad_names) // n_groups
            stop = (g + 1) * len(grad_names) // n_groups
            names = grad_names[start:stop]
            label = names[0] if len(names) == 1 \
                else "%s[+%d]" % (names[0], len(names) - 1)
            self.groups.append((label, start, stop))
        self.tap_names = list(tap_names or ())[:MAX_TAPS]
        self.slots = (list(self.HEAD)
                      + ["max_abs_grad/%s" % label
                         for label, _, _ in self.groups]
                      + ["max_abs_attn_logit/%s" % name
                         for name in self.tap_names])

    @property
    def width(self):
        return len(self.slots)

    def unpack(self, vector):
        """{slot: float} from one packed vector, plus the derived
        ``all_finite`` flag (1.0 when every masked output was finite)."""
        vals = [float(v) for v in list(vector)]
        if len(vals) != self.width:
            raise ValueError("health vector width %d does not match "
                             "layout width %d" % (len(vals), self.width))
        out = OrderedDict(zip(self.slots, vals))
        out["all_finite"] = float(out["finite_mask"] == self.full_mask)
        return out

    def describe(self):
        """Serializable layout description (lands in flight dumps)."""
        return {"slots": list(self.slots),
                "n_outputs": self.n_outputs,
                "groups": [{"label": label, "start": start, "stop": stop}
                           for label, start, stop in self.groups],
                "taps": list(self.tap_names)}


def _l2(norms):
    """The l2 norm of a list of per-tensor l2 norms (0 when empty)."""
    import torch
    if not norms:
        return None
    return torch.linalg.vector_norm(torch.stack(norms))


def pack_summary(layout, outputs, param_vals, grad_vals, update_ratio=None,
                 taps=None):
    """The in-step reduction: one float32 vector matching ``layout``, on
    the device of the tensors it reads.

    Torch ops over tensors the step already holds, with no host sync, so
    it can run inside a captured CUDA graph: ``torch._foreach_norm`` gives
    each gradient's and parameter's l2 norm and each gradient's max|g| in
    f32, and one ``amax`` a group takes the group maximum.
    ``param_vals``/``grad_vals`` are ordered like the layout's gradient
    names; ``update_ratio`` is a scalar tensor when the caller (the fused
    train step) knows the applied update, else the slot holds -1 and the
    host estimates it from the optimizer's step scale.  ``taps``: the
    attention-logit scalars in the layout's ``tap_names`` order; a run
    that could not collect them passes None and the slots hold -1."""
    import torch
    f32 = torch.float32
    ref = outputs[0] if outputs else (grad_vals[0] if grad_vals
                                      else param_vals[0])
    dev = ref.device

    def scalar(v):
        return torch.full((), float(v), dtype=f32, device=dev)

    bits = []
    for i, o in enumerate(outputs[:layout.n_outputs]):
        ok = torch.isfinite(o).all()
        bits.append(torch.where(ok, scalar(1 << i), scalar(0.0)))
    mask = torch.stack(bits).sum() if bits else scalar(0.0)
    out_mean = outputs[0].to(f32).mean() if outputs else scalar(0.0)
    grad_vals = list(grad_vals)
    grad_norm = _l2(list(torch._foreach_norm(grad_vals, 2, dtype=f32))) \
        if grad_vals else None
    param_norm = _l2(list(torch._foreach_norm(list(param_vals), 2,
                                              dtype=f32))) \
        if param_vals else None
    ratio = scalar(-1.0) if update_ratio is None \
        else update_ratio.to(f32).reshape(())
    head = [mask, out_mean,
            grad_norm if grad_norm is not None else scalar(0.0),
            param_norm if param_norm is not None else scalar(0.0), ratio]
    group_max = []
    if layout.groups:
        maxes = torch.stack(list(torch._foreach_norm(
            grad_vals, float("inf"), dtype=f32)))
        group_max = [maxes[start:stop].amax()
                     for _, start, stop in layout.groups]
    tap_list = list(taps) if taps is not None else []
    tap_vals = [tap_list[i].to(f32).reshape(()) if i < len(tap_list)
                else scalar(-1.0) for i in range(len(layout.tap_names))]
    return torch.stack(head + group_max + tap_vals)


def combine(vectors, layout):
    """Merge per-executor health vectors (the multi-context general path)
    into one: bitmask AND, mean of loss proxies, l2-combined grad norm,
    the replicated param norm of executor 0, max of ratios and group
    maxima.  Host-side numpy over a handful of scalars."""
    import numpy as np
    arr = np.stack([np.asarray(v, dtype=np.float64) for v in vectors])
    out = np.array(arr[0])
    mask = ~np.int64(0)
    for v in arr[:, 0]:
        mask &= np.int64(v) if math.isfinite(v) else np.int64(0)
    out[0] = float(mask)
    out[1] = float(arr[:, 1].mean())
    out[2] = float(np.sqrt((arr[:, 2] ** 2).sum()))
    out[3] = float(arr[0, 3])
    out[4] = float(arr[:, 4].max())
    if arr.shape[1] > 5:
        out[5:] = arr[:, 5:].max(axis=0)
    return out.astype(np.float32)


class HealthMonitor:
    """Host-side per-step rule engine over the packed health summaries.

    ``observe(step, summary)`` takes either the unpacked {slot: value}
    dict or a raw vector plus its layout, evaluates the enabled rules,
    mirrors the scalars into telemetry gauges, and fires anomalies: each
    lands in ``self.anomalies``, increments ``health.anomalies.<rule>``,
    drops a ``health_anomaly:<rule>`` trace instant, is noted in the
    flight recorder and handed to every registered callback; then the
    rule's action runs (``warn`` logs, ``dump`` writes a flight dump,
    ``raise`` dumps and raises :class:`TrainingDivergedError` naming the
    step)."""

    def __init__(self, actions=None, ema_alpha=0.2, spike_factor=10.0,
                 warmup_steps=5, explode_factor=1e3, plateau_window=100,
                 plateau_rtol=1e-6, logger=None, recorder=None):
        self.actions = rule_actions() if actions is None \
            else dict(DEFAULT_ACTIONS, **actions)
        self.ema_alpha = float(ema_alpha)
        self.spike_factor = float(spike_factor)
        self.warmup_steps = int(warmup_steps)
        self.explode_factor = float(explode_factor)
        self.plateau_rtol = float(plateau_rtol)
        self.logger = logger or _log
        self.recorder = recorder
        self.callbacks = []
        self.anomalies = []
        self._grad_ema = None
        self._loss_ema = None
        self._loss_hist = deque(maxlen=max(2, int(plateau_window)))
        self._plateau_fired = False
        self._n = 0
        self._eps = 1e-12

    @property
    def first_anomaly(self):
        return self.anomalies[0] if self.anomalies else None

    def add_callback(self, fn):
        """fn(anomaly_dict) on every fired anomaly, before the action."""
        self.callbacks.append(fn)

    def _recorder(self):
        return self.recorder if self.recorder is not None \
            else _flight.get_recorder()

    def observe(self, step, summary, layout=None, loss=None):
        """Evaluate the rules for one step.  Returns the fired anomaly
        records (possibly none); raises :class:`TrainingDivergedError`
        when a fired rule's action is ``raise`` (after recording and
        dumping)."""
        if layout is not None and not isinstance(summary, dict):
            summary = layout.unpack(summary)
        self._n += 1
        gn = float(summary.get("grad_norm", float("nan")))
        loss_v = float(loss) if loss is not None \
            else float(summary.get("out_mean", float("nan")))
        fired = []

        def on(rule):
            return self.actions.get(rule, "off") != "off"

        if on("nonfinite"):
            bad = summary.get("all_finite", 1.0) < 1.0 \
                or not math.isfinite(gn) or not math.isfinite(loss_v)
            if bad:
                fired.append(self._anomaly(
                    "nonfinite", step, value=gn,
                    message="non-finite loss/grad at step %d "
                            "(finite_mask=%s grad_norm=%s loss=%s)"
                            % (step, summary.get("finite_mask"), gn,
                               loss_v)))
        if on("grad_spike") and math.isfinite(gn) \
                and self._grad_ema is not None \
                and self._n > self.warmup_steps:
            threshold = self.spike_factor * max(self._grad_ema, self._eps)
            if gn > threshold:
                fired.append(self._anomaly(
                    "grad_spike", step, value=gn, threshold=threshold,
                    message="grad-norm spike at step %d: %.4g > %.1f x "
                            "EMA %.4g" % (step, gn, self.spike_factor,
                                          self._grad_ema)))
        if on("loss_explosion") and math.isfinite(loss_v) \
                and self._loss_ema is not None \
                and self._n > self.warmup_steps:
            scale = max(abs(self._loss_ema), self._eps)
            if abs(loss_v) > self.explode_factor * scale:
                fired.append(self._anomaly(
                    "loss_explosion", step, value=loss_v,
                    threshold=self.explode_factor * scale,
                    message="loss explosion at step %d: |%.4g| > %.1f x "
                            "EMA %.4g" % (step, loss_v,
                                          self.explode_factor,
                                          self._loss_ema)))
        if on("loss_plateau") and math.isfinite(loss_v):
            self._loss_hist.append(loss_v)
            if len(self._loss_hist) == self._loss_hist.maxlen \
                    and not self._plateau_fired:
                lo, hi = min(self._loss_hist), max(self._loss_hist)
                scale = max(abs(sum(self._loss_hist)
                                / len(self._loss_hist)), self._eps)
                if (hi - lo) <= self.plateau_rtol * scale:
                    self._plateau_fired = True
                    fired.append(self._anomaly(
                        "loss_plateau", step, value=loss_v,
                        threshold=self.plateau_rtol * scale,
                        message="loss plateau at step %d: spread %.4g "
                                "over the last %d steps"
                                % (step, hi - lo, len(self._loss_hist))))

        # the EMAs update after the checks, so that a spike is judged
        # against history and not against itself
        if math.isfinite(gn):
            self._grad_ema = gn if self._grad_ema is None else (
                self.ema_alpha * gn
                + (1.0 - self.ema_alpha) * self._grad_ema)
        if math.isfinite(loss_v):
            self._loss_ema = loss_v if self._loss_ema is None else (
                self.ema_alpha * loss_v
                + (1.0 - self.ema_alpha) * self._loss_ema)

        _telemetry.counter("health.steps",
                           help="steps observed by the health "
                                "sentinel").inc()
        _telemetry.gauge("health.grad_norm",
                         help="global grad l2 (last step)").set(gn)
        _telemetry.gauge("health.param_norm",
                         help="param l2 (last step)").set(
            float(summary.get("param_norm", float("nan"))))
        _telemetry.gauge("health.update_ratio",
                         help="update/param ratio (last step)").set(
            float(summary.get("update_ratio", -1.0)))
        _telemetry.gauge("health.loss",
                         help="loss proxy (last step)").set(loss_v)

        # note every fired anomaly first, so that the single dump below
        # holds them all; rules are checked most severe first, so the
        # first raise-action record names the exception and the dump
        raise_rec = None
        dump_recs = []
        for rec in fired:
            self._fire(rec, summary)
            action = self.actions.get(rec["rule"], "warn")
            if action == "raise":
                if raise_rec is None:
                    raise_rec = rec
            elif action == "dump":
                dump_recs.append(rec)
            elif action == "warn":
                self.logger.warning("health anomaly: %s", rec["message"])
        path = None
        if raise_rec is not None or dump_recs:
            # one dump per observed step, even when several rules fire
            name_rec = raise_rec or dump_recs[0]
            path = self._recorder().dump(
                reason="anomaly_" + name_rec["rule"])
        for rec in dump_recs:
            self.logger.warning("health anomaly: %s (flight dump: %s)",
                                rec["message"], path)
        if raise_rec is not None:
            self.logger.error("training diverged: %s (flight dump: %s)",
                              raise_rec["message"], path)
            raise TrainingDivergedError(
                "training diverged at step %d: %s (flight dump: %s)"
                % (raise_rec["step"], raise_rec["message"], path),
                step=raise_rec["step"], rule=raise_rec["rule"],
                dump_path=path)
        return fired

    def _anomaly(self, rule, step, value=None, threshold=None,
                 message=""):
        return {"rule": rule, "step": int(step), "value": value,
                "threshold": threshold, "message": message}

    def _fire(self, rec, summary):
        """Record and emit one anomaly (telemetry, trace instant, black
        box, callbacks); the caller runs the rule's action."""
        self.anomalies.append(rec)
        _telemetry.counter("health.anomalies." + rec["rule"],
                           help="fired %s anomalies"
                                % rec["rule"]).inc()
        _tracing.emit_instant("health_anomaly:" + rec["rule"],
                              category="health",
                              args={"step": rec["step"],
                                    "value": rec["value"]})
        self._recorder().note_anomaly(dict(rec, summary=dict(summary)))
        for cb in self.callbacks:
            try:
                cb(rec)
            except Exception:
                self.logger.exception("health callback failed for %s",
                                      rec["rule"])

"""Learning-rate schedulers.

Counterpart of ``mxnet_tpu/lr_scheduler.py``, pure Python and the same
arithmetic: ``FactorScheduler``, ``MultiFactorScheduler`` and
``PolyScheduler`` of the reference MXNet, and a ``CosineScheduler``.
The decay count is computed in closed form from the update number and
the stateful rate is caught up to it.  The optimizer seeds ``base_lr``
from its ``learning_rate`` and asks for the rate once per update count
(``Optimizer._get_lr``), on the host: the fused train step hands the
result to the device as data, so a change takes effect at the next step.
"""
from __future__ import annotations

import logging
from math import cos, pi

_log = logging.getLogger(__name__)


class LRScheduler:
    """Maps the optimizer's update count to a learning rate.

    ``base_lr`` is the scheduler's current rate; the optimizer seeds it
    from ``learning_rate`` at construction.
    """

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr

    def __call__(self, num_update):
        """Return the rate to use for update number ``num_update``."""
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """Multiply the rate by ``factor`` every ``step`` updates, never going
    below ``stop_factor_lr``."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("FactorScheduler: step must be >= 1")
        if factor > 1.0:
            raise ValueError(
                "FactorScheduler: factor > 1 would grow the rate; use <= 1")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr
        self.count = 0  # update count at the last applied decay

    def __call__(self, num_update):
        # decays owed by now: one per full `step` window behind num_update
        owed = max(0, -(-num_update // self.step) - 1) * self.step
        while self.count < owed:
            self.count += self.step
            decayed = self.base_lr * self.factor
            if decayed < self.stop_factor_lr:
                self.base_lr = self.stop_factor_lr
                _log.info("Update[%d]: learning rate hit its floor %0.5e "
                          "and stays there", num_update, self.base_lr)
            else:
                self.base_lr = decayed
                _log.info("Update[%d]: learning rate -> %0.5e",
                          num_update, self.base_lr)
        return self.base_lr


class MultiFactorScheduler(LRScheduler):
    """Multiply the rate by ``factor`` once after each milestone in the
    increasing list ``step``."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError(
                "MultiFactorScheduler: step must be a non-empty list")
        for prev, nxt in zip(step, step[1:]):
            if nxt <= prev:
                raise ValueError(
                    "MultiFactorScheduler: milestones must strictly increase")
        if step[0] < 1:
            raise ValueError("MultiFactorScheduler: milestones must be >= 1")
        if factor > 1.0:
            raise ValueError(
                "MultiFactorScheduler: factor > 1 would grow the rate")
        self.step = step
        self.cur_step_ind = 0  # index of the next milestone not yet passed
        self.factor = factor
        self.count = 0

    def __call__(self, num_update):
        while (self.cur_step_ind < len(self.step)
               and num_update > self.step[self.cur_step_ind]):
            self.count = self.step[self.cur_step_ind]
            self.cur_step_ind += 1
            self.base_lr *= self.factor
            _log.info("Update[%d]: learning rate -> %0.5e",
                      num_update, self.base_lr)
        return self.base_lr


class PolyScheduler(LRScheduler):
    """Polynomial decay from ``base_lr`` to zero over ``max_update``
    updates: lr(t) = base * (1 - t/T)^pwr."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr)
        if not isinstance(max_update, int) or max_update < 1:
            raise ValueError(
                "PolyScheduler: max_update must be a positive int")
        self.base_lr_orig = base_lr
        self.max_update = max_update
        self.power = pwr

    def __call__(self, num_update):
        if num_update <= self.max_update:
            frac = 1.0 - num_update / self.max_update
            self.base_lr = self.base_lr_orig * frac ** self.power
        return self.base_lr


class CosineScheduler(LRScheduler):
    """Cosine decay from ``base_lr`` to ``final_lr`` over ``max_update``
    updates, with an optional linear warmup phase."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0, warmup_steps=0,
                 warmup_begin_lr=0.0):
        super().__init__(base_lr)
        self.max_update = max_update
        self.final_lr = final_lr
        self.warmup_steps = warmup_steps
        self.warmup_begin_lr = warmup_begin_lr
        self.base_lr_orig = base_lr

    def __call__(self, num_update):
        if num_update < self.warmup_steps:
            span = self.base_lr_orig - self.warmup_begin_lr
            return self.warmup_begin_lr + \
                span * num_update / max(self.warmup_steps, 1)
        if num_update > self.max_update:
            return self.final_lr
        progress = (num_update - self.warmup_steps) / \
            max(self.max_update - self.warmup_steps, 1)
        return self.final_lr + \
            (self.base_lr_orig - self.final_lr) * (1 + cos(pi * progress)) / 2

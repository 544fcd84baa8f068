"""BaseModule: the high-level train/score interface.

Counterpart of ``mxnet_tpu/module/base_module.py``: ``fit`` binds,
initializes the parameters and the optimizer, then runs epochs
``begin_epoch`` to ``num_epoch - 1`` of ``forward_backward`` ->
``update`` -> ``update_metric`` with the batch-end callbacks, syncing the
trained values into the module's parameter dicts before the epoch-end
callbacks (a checkpoint); a ``monitor`` is installed right after
``bind`` (so the fused step turns it down) and ticks around each batch; the next batch is fetched during the step
and handed to ``prepare`` (a BucketingModule binds its bucket ahead).
``score``, ``iter_predict`` and ``predict`` run predict-mode forwards
over an iterator; ``save_params`` / ``load_params`` use the ``.params``
format with ``arg:``/``aux:`` names.  Each training step decomposes
into ``observability.instrument.StepTracker``'s five components
(data_wait / fwd_bwd_dispatch / update / metric / sync): nested profiler
spans and registry histograms, one flag check each when both sinks are
off.

Under ``MXNET_TPU_HEALTH=1`` the loop runs the health sentinel: after the
next batch's ``prepare`` it takes the step's packed vector
(``_capture_health``), records the step in the flight recorder with the
latest device-memory sample, then lets ``HealthMonitor.observe`` judge it
(record first, judge second: a raising rule's dump already holds the
offending step).  A ``TrainingDivergedError`` propagates after its dump;
any other exception leaving ``fit`` goes through the OOM black box
(always) and, with the sentinel on, the flight recorder's exception dump.
The elastic checkpoint hooks wait for a later runtime-services slice.
"""
from __future__ import annotations

import logging
import math
import time

import torch

from .. import metric as metric_mod
from ..context import cpu
from ..initializer import Uniform
from ..io import DataIter
from ..log import module_logger as _module_logger
from ..observability import flight_recorder as _flight
from ..observability import health as _health
from ..observability import instrument as _instrument
from ..observability import memprof as _memprof


class BatchEndParam:
    """The object handed to batch-end callbacks (Speedometer et al.)."""

    def __init__(self, epoch, nbatch, eval_metric, locals=None):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


def _as_list(obj):
    return obj if isinstance(obj, (list, tuple)) else [obj]


def _trim_pad(outputs, pad):
    """Drop the iterator's pad rows from each output array."""
    if not pad:
        return list(outputs)
    return [out[:out.shape[0] - pad] for out in outputs]


_PARAM_SUFFIXES = ("_weight", "_bias", "_gamma", "_beta")


def _check_input_names(symbol, names, typename, throw):
    """Warn or raise when a declared data/label name is not an argument
    of the symbol."""
    args = symbol.list_arguments()
    for name in names:
        if name in args:
            continue
        likely_inputs = [a for a in args if not a.endswith(_PARAM_SUFFIXES)]
        msg = ("the Module was created with %s_names=%s, but %r is not an "
               "argument of the symbol. Inputs the symbol does declare: %s"
               % (typename, list(names), name, ", ".join(likely_inputs)))
        if throw:
            raise ValueError(msg)
        logging.getLogger(__name__).warning(msg)


def _each_callback(callbacks, arg):
    """Invoke one callback or a list of them with a single argument."""
    if callbacks is None:
        return
    if not isinstance(callbacks, (list, tuple)):
        callbacks = [callbacks]
    for cb in callbacks:
        cb(arg)


class BaseModule:
    """Abstract train/predict driver over a bound computation."""

    def __init__(self, logger=logging):
        # the bare ``logging`` default goes under the package root, so the
        # flight recorder's one handler sees every module record
        self.logger = _module_logger("module") if logger is logging \
            else logger
        self.binded = False
        self.for_training = False
        self.inputs_need_grad = False
        self.params_initialized = False
        self.optimizer_initialized = False
        self._symbol = None

    # -- abstract surface (ref: BaseModule; each raises until a subclass
    #    defines it) --------------------------------------------------------
    @property
    def symbol(self):
        return self._symbol

    @property
    def data_names(self):
        raise NotImplementedError()

    @property
    def output_names(self):
        raise NotImplementedError()

    @property
    def data_shapes(self):
        raise NotImplementedError()

    @property
    def label_shapes(self):
        raise NotImplementedError()

    @property
    def output_shapes(self):
        raise NotImplementedError()

    def get_params(self):
        raise NotImplementedError()

    def init_params(self, initializer=Uniform(0.01), arg_params=None,
                    aux_params=None, allow_missing=False, force_init=False,
                    allow_extra=False):
        raise NotImplementedError()

    def install_monitor(self, mon):
        raise NotImplementedError()

    def forward(self, data_batch, is_train=None):
        raise NotImplementedError()

    def backward(self, out_grads=None):
        raise NotImplementedError()

    def get_outputs(self, merge_multi_context=True):
        raise NotImplementedError()

    def get_input_grads(self, merge_multi_context=True):
        raise NotImplementedError()

    def update(self):
        raise NotImplementedError()

    def update_metric(self, eval_metric, labels):
        raise NotImplementedError()

    def bind(self, data_shapes, label_shapes=None, for_training=True,
             inputs_need_grad=False, force_rebind=False, shared_module=None,
             grad_req="write"):
        raise NotImplementedError()

    def init_optimizer(self, kvstore="local", optimizer="sgd",
                       optimizer_params=(("learning_rate", 0.01),),
                       force_init=False):
        raise NotImplementedError()

    def _ready(self, optimizer=False, grads=False):
        """The delegation precondition: bound and initialized."""
        if not (self.binded and self.params_initialized):
            raise AssertionError("needs bind() and init_params()")
        if optimizer and not self.optimizer_initialized:
            raise AssertionError("needs init_optimizer()")
        if grads and not self.inputs_need_grad:
            raise AssertionError("needs bind(inputs_need_grad=True)")

    def forward_backward(self, data_batch):
        self.forward(data_batch, is_train=True)
        self.backward()

    def set_params(self, arg_params, aux_params, allow_missing=False,
                   force_init=True, allow_extra=False):
        self.init_params(initializer=None, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init, allow_extra=allow_extra)

    def get_states(self, merge_multi_context=True):
        self._ready()
        if merge_multi_context:
            raise AssertionError("no states to merge")
        return []

    def set_states(self, states=None, value=None):
        self._ready()
        if states or value:
            raise AssertionError("this module has no states")

    def prepare(self, data_batch):
        """Get ready for ``data_batch`` before its step (a no-op here)."""

    def score(self, eval_data, eval_metric, num_batch=None,
              batch_end_callback=None, score_end_callback=None, reset=True,
              epoch=0):
        """Evaluate on a data iterator; returns name/value pairs."""
        if not (self.binded and self.params_initialized):
            raise AssertionError("score() needs bind() and init_params()")
        if reset:
            eval_data.reset()
        eval_metric = metric_mod.create(eval_metric)
        eval_metric.reset()
        seen = 0
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                break
            self.forward(batch, is_train=False)
            self.update_metric(eval_metric, batch.label)
            _each_callback(batch_end_callback, BatchEndParam(
                epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                locals=locals()))
            seen += 1
        _each_callback(score_end_callback, BatchEndParam(
            epoch=epoch, nbatch=seen, eval_metric=eval_metric,
            locals=locals()))
        return eval_metric.get_name_value()

    def iter_predict(self, eval_data, num_batch=None, reset=True):
        """Generator over (outputs, nbatch, batch) for each batch."""
        if not (self.binded and self.params_initialized):
            raise AssertionError("iter_predict() needs bind() and "
                                 "init_params()")
        if reset:
            eval_data.reset()
        for nbatch, batch in enumerate(eval_data):
            if num_batch is not None and nbatch == num_batch:
                return
            self.forward(batch, is_train=False)
            yield _trim_pad(self.get_outputs(), batch.pad), nbatch, batch

    def predict(self, eval_data, num_batch=None, merge_batches=True,
                reset=True, always_output_list=False):
        """Run inference over an iterator and collect the outputs."""
        per_batch = [
            [o.copyto(o.context) for o in outs]
            for outs, _, _ in self.iter_predict(eval_data, num_batch, reset)]
        if not per_batch or not merge_batches:
            return per_batch
        widths = {len(outs) for outs in per_batch}
        if len(widths) != 1:
            raise AssertionError(
                "cannot merge: batches produced differing output counts %s "
                "(bucketing?); pass merge_batches=False" % sorted(widths))
        from ..ndarray import NDArray
        merged = [NDArray(torch.cat([outs[i].tensor for outs in per_batch]))
                  for i in range(widths.pop())]
        if len(merged) == 1 and not always_output_list:
            return merged[0]
        return merged

    def fit(self, train_data, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None, kvstore="local",
            optimizer="sgd", optimizer_params=(("learning_rate", 0.01),),
            eval_end_callback=None, eval_batch_end_callback=None,
            initializer=Uniform(0.01), arg_params=None, aux_params=None,
            allow_missing=False, force_rebind=False, force_init=False,
            begin_epoch=0, num_epoch=None, validation_metric=None,
            monitor=None):
        """Bind, initialize, and train epochs ``begin_epoch`` to
        ``num_epoch - 1``.

        ``train_data``/``eval_data`` may be any ``DataIter`` (an
        ``io_pipeline.PipelineDataIter`` too) or a raw
        ``io_pipeline.Pipeline``, which is adapted here and closed when
        fit returns."""
        if num_epoch is None:
            raise AssertionError("fit() needs num_epoch")
        owned_iters = []
        try:
            # adapt inside the try: if the second adaptation or the fit
            # raises, the first adapter's running workers are still torn
            # down.  The eval adapter skips the warm start: score(reset=
            # True) would discard the armed epoch unconsumed.
            train_data = self._adapt_data(train_data, owned_iters)
            eval_data = self._adapt_data(eval_data, owned_iters,
                                         warm_start=False)
            self._fit_impl(
                train_data, eval_data, eval_metric, epoch_end_callback,
                batch_end_callback, kvstore, optimizer, optimizer_params,
                eval_end_callback, eval_batch_end_callback, initializer,
                arg_params, aux_params, allow_missing, force_rebind,
                force_init, begin_epoch, num_epoch, validation_metric,
                monitor)
        finally:
            for it in owned_iters:
                it.close()

    @staticmethod
    def _adapt_data(data, owned_iters, warm_start=True):
        """A raw Pipeline is adapted here and registered in
        ``owned_iters`` for fit's teardown; an iterator passes through and
        belongs to the caller."""
        if data is not None and not isinstance(data, DataIter) \
                and hasattr(data, "as_dataiter"):
            it = data.as_dataiter(warm_start=warm_start)
            owned_iters.append(it)
            return it
        return data

    def _fit_impl(self, train_data, eval_data, eval_metric,
                  epoch_end_callback, batch_end_callback, kvstore,
                  optimizer, optimizer_params, eval_end_callback,
                  eval_batch_end_callback, initializer, arg_params,
                  aux_params, allow_missing, force_rebind, force_init,
                  begin_epoch, num_epoch, validation_metric, monitor):
        self.bind(data_shapes=train_data.provide_data,
                  label_shapes=train_data.provide_label,
                  for_training=True, force_rebind=force_rebind)
        if monitor is not None:
            self.install_monitor(monitor)
        self.init_params(initializer=initializer, arg_params=arg_params,
                         aux_params=aux_params, allow_missing=allow_missing,
                         force_init=force_init)
        self.init_optimizer(kvstore=kvstore, optimizer=optimizer,
                            optimizer_params=optimizer_params)
        validation_metric = metric_mod.create(
            validation_metric if validation_metric is not None
            else eval_metric)
        eval_metric = metric_mod.create(eval_metric)
        try:
            for epoch in range(begin_epoch, num_epoch):
                self._run_epoch(epoch, train_data, eval_metric,
                                batch_end_callback, monitor)
                # the trained values into the module's parameter dicts, so
                # that the callbacks and the next epoch see the same tensors
                arg_now, aux_now = self.get_params()
                self.set_params(arg_now, aux_now)
                if epoch_end_callback is not None:
                    for cb in _as_list(epoch_end_callback):
                        cb(epoch, self.symbol, arg_now, aux_now)
                if eval_data:
                    for name, val in self.score(
                            eval_data, validation_metric,
                            score_end_callback=eval_end_callback,
                            batch_end_callback=eval_batch_end_callback,
                            epoch=epoch):
                        self.logger.info("Epoch[%d] Validation-%s=%f",
                                         epoch, name, val)
                train_data.reset()
        except _health.TrainingDivergedError:
            raise  # its flight dump is written already
        except Exception as exc:
            # the OOM black box, always: an out-of-memory may surface at
            # any sync point of the step, and this frame sees them all
            oomed = _memprof.maybe_record_oom("fit", exc) is not None \
                or (_memprof.is_oom(exc)
                    and _flight.get_recorder().has_dumped("oom"))
            if _health.enabled():
                _flight.note_exception(exc)
                # a second dump at a fixed MXNET_TPU_FLIGHT_PATH would
                # overwrite the OOM post-mortem
                if not oomed:
                    _flight.dump_once(reason="fit_exception")
            raise

    def _run_epoch(self, epoch, train_data, eval_metric, batch_end_callback,
                   monitor):
        """One pass over ``train_data``: each step's components timed by
        the tracker, the next batch fetched and prepared during the step,
        and under the sentinel the step's health vector taken after that
        prepare, recorded, then judged."""
        tic = time.time()
        eval_metric.reset()
        tracker = _instrument.StepTracker(epoch=epoch)
        health_mon = self._ensure_health_monitor() \
            if _health.enabled() else None
        it = iter(train_data)
        with tracker.component("data_wait"):
            batch = next(it, None)
        nbatch = 0
        while batch is not None:
            if monitor is not None:
                with tracker.component("sync"):
                    monitor.tic()
            with tracker.component("fwd_bwd_dispatch"):
                self.forward_backward(batch)
            with tracker.component("update"):
                self.update()
            with tracker.component("data_wait"):
                upcoming = next(it, None)
            if upcoming is not None:
                # the next batch's transfer while the step executes
                with tracker.component("sync"):
                    self.prepare(upcoming)
            pending_health = None
            if health_mon is not None:
                # after the next batch's prepare: reading the vector waits
                # for the step, which must not hold up the data
                with tracker.component("sync"):
                    pending_health = self._capture_health()
            with tracker.component("metric"):
                self.update_metric(eval_metric, batch.label)
            if monitor is not None:
                with tracker.component("sync"):
                    monitor.toc_print()
            with tracker.component("sync"):
                _each_callback(batch_end_callback, BatchEndParam(
                    epoch=epoch, nbatch=nbatch, eval_metric=eval_metric,
                    locals=locals()))
            timings = tracker.step_end(nbatch)
            if pending_health is not None:
                # record first, judge second
                step, summary = pending_health
                _flight.record_step(
                    step, epoch=epoch, batch=nbatch, health=summary,
                    timings=timings, mem=_instrument.last_memory_sample())
                health_mon.observe(step, summary)
            batch = upcoming
            nbatch += 1
        for name, val in eval_metric.get_name_value():
            self.logger.info("Epoch[%d] Train-%s=%f", epoch, name, val)
        self.logger.info("Epoch[%d] Time cost=%.3f", epoch,
                         time.time() - tic)

    # -- health sentinel -----------------------------------------------------
    def _take_health_vector(self):
        """``(numpy vector, layout)`` of this step, or None: subclasses
        with executors override it."""
        return None

    def _ensure_health_monitor(self):
        """One rolling-rule monitor per module, shared across epochs."""
        mon = getattr(self, "_health_mon", None)
        if mon is None:
            mon = self._health_mon = _health.HealthMonitor(
                logger=self.logger)
        return mon

    def _capture_health(self):
        """Take and unpack this step's health vector: ``(global step,
        summary)`` or None.  Stashes the summary for a
        ``Monitor(stats='health')`` and, where the run did not compute the
        update ratio (the general path), estimates it from the
        optimizer's step scale."""
        step = getattr(self, "_health_step", 0)
        self._health_step = step + 1
        taken = self._take_health_vector()
        if taken is None:
            return None
        vec, layout = taken
        summary = layout.unpack(vec)
        opt = getattr(self, "_optimizer", None)
        if summary.get("update_ratio", -1.0) < 0 and opt is not None:
            gn = summary.get("grad_norm", float("nan"))
            pn = summary.get("param_norm", 0.0)
            if pn > 0 and math.isfinite(gn):
                summary["update_ratio"] = \
                    opt.health_update_scale() * gn / pn
        self._last_health_summary = (step, summary)
        return step, summary

    def _install_health_monitor(self, mon):
        """Bind a ``Monitor(stats='health')`` to this module: it reads the
        summaries the fit loop stashes here, taps nothing and leaves the
        fused step in place."""
        mon.install_module(self)
        if not getattr(self, "_health_mon_announced", False):
            self._health_mon_announced = True
            if _health.enabled():
                self.logger.info(
                    "monitor(stats='health') installed: per-step "
                    "stats come from the in-step health sentinel;"
                    " the fused train step stays active")
            else:
                self.logger.warning(
                    "monitor(stats='health') installed but "
                    "MXNET_TPU_HEALTH is not 1: the sentinel is off "
                    "and the monitor will report nothing")

    # -- parameter files -----------------------------------------------------
    def save_params(self, fname):
        from ..ndarray import save
        arg_params, aux_params = self.get_params()
        blob = {"arg:" + k: v.as_in_context(cpu())
                for k, v in arg_params.items()}
        blob.update({"aux:" + k: v.as_in_context(cpu())
                     for k, v in aux_params.items()})
        save(fname, blob)

    def load_params(self, fname):
        from ..ndarray import load
        split = {"arg": {}, "aux": {}}
        for key, value in load(fname).items():
            kind, _, name = key.partition(":")
            if kind not in split or not name:
                raise ValueError("%s is not a Module param file (bad key %r)"
                                 % (fname, key))
            split[kind][name] = value
        self.set_params(split["arg"], split["aux"])

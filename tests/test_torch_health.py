"""The port's health sentinel and flight recorder against the JAX
package's, on the CPU.

``observability/health.py`` and ``observability/flight_recorder.py`` of
both packages: the slot layout and ``combine``, ``pack_summary`` on the
same arrays, ``HealthMonitor`` on the same scripted summaries, and a
small MLP trained under ``MXNET_TPU_HEALTH=1`` through ``Module.fit`` on
the fused path and on the general path over two host contexts, with its
weights carried from the JAX package's initialisation through
``params_from_numpy``: the per-step summaries, the divergence step of a
NaN batch and the flight dumps.  Then the flag's cost in plans, the
health monitor, ``Optimizer.health_update_scale`` and the serving hooks.

Inputs come from numpy seeds.  Tolerances are stated where they are used.
"""
import importlib.util
import json
import logging
import os

import numpy as np
import pytest
import torch

import mxnet_tpu as mj
from mxnet_tpu.observability import flight_recorder as flight_j
from mxnet_tpu.observability import health as health_j
from mxnet_tpu.observability import reqtrace as reqtrace_j
from mxnet_tpu.observability import telemetry as tel_j

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor_cache as ec_t
from mxnet_tpu_torch.convert import params_from_numpy
from mxnet_tpu_torch.observability import flight_recorder as flight_t
from mxnet_tpu_torch.observability import health as health_t
from mxnet_tpu_torch.observability import telemetry as tel_t

ENVS = ("MXNET_TPU_HEALTH", "MXNET_TPU_HEALTH_RULES", "MXNET_TPU_FLIGHT_PATH",
        "MXNET_TPU_FLIGHT_STEPS", "MXNET_TPU_MEMPROF")


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    """Health off unless a test opts in; fresh registries and recorders in
    both packages, and no request traces in the JAX package's (a dump
    holding some gains a ``fleet`` section the port's has not yet)."""
    for name in ENVS:
        monkeypatch.delenv(name, raising=False)

    def reset():
        for tel, flight in ((tel_j, flight_j), (tel_t, flight_t)):
            tel.reset()
            flight.reset()
        reqtrace_j.reset()
    reset()
    yield
    reset()


def _load_traceview():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "traceview.py")
    spec = importlib.util.spec_from_file_location("_tv_torch_health", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- layout, packing and combine ---------------------------------------------

@pytest.mark.parametrize("n_out,names,taps,groups", [
    (1, ["w"], (), 8),
    (2, ["a", "b", "c"], (), 2),
    (3, ["w%d" % i for i in range(13)], ("att0", "att1"), 8),
    (30, ["w%d" % i for i in range(5)], tuple("t%d" % i for i in range(10)),
     8),
])
def test_layout_slots_and_describe_match(n_out, names, taps, groups):
    lj = health_j.HealthLayout(n_out, names, max_groups=groups,
                               tap_names=taps)
    lt = health_t.HealthLayout(n_out, names, max_groups=groups,
                               tap_names=taps)
    assert lt.slots == lj.slots and lt.width == lj.width
    assert lt.describe() == lj.describe()
    assert lt.full_mask == lj.full_mask
    vec = np.random.RandomState(len(names)).rand(lt.width)
    assert lt.unpack(vec) == lj.unpack(vec)


def test_combine_matches():
    """combine of the same vectors: within 1e-7 (both in float32)."""
    layout_j = health_j.HealthLayout(2, ["a", "b"], tap_names=("t",))
    layout_t = health_t.HealthLayout(2, ["a", "b"], tap_names=("t",))
    r = np.random.RandomState(3)
    vecs = [np.concatenate([[3.0], r.rand(layout_t.width - 1)])
            for _ in range(3)]
    vecs[1][0] = 1.0  # one cleared bit
    vecs[2][4] = -1.0
    want = health_j.combine(vecs, layout_j)
    got = health_t.combine(vecs, layout_t)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=0)
    assert got[0] == 1.0


def _pack_both(outs, params, grads, n_taps=0, ratio=None):
    import jax.numpy as jnp
    names = ["p%d" % i for i in range(len(params))]
    taps = ["att%d" % i for i in range(n_taps)]
    lj = health_j.HealthLayout(len(outs), names, tap_names=taps)
    lt = health_t.HealthLayout(len(outs), names, tap_names=taps)
    tap_vals = [1.5 + i for i in range(max(0, n_taps - 1))]  # one missing
    vj = np.asarray(health_j.pack_summary(
        lj, [jnp.asarray(o) for o in outs], [jnp.asarray(p) for p in params],
        [jnp.asarray(g) for g in grads],
        update_ratio=None if ratio is None else jnp.float32(ratio),
        taps=[jnp.float32(t) for t in tap_vals]))
    vt = health_t.pack_summary(
        lt, [torch.from_numpy(o) for o in outs],
        [torch.from_numpy(p) for p in params],
        [torch.from_numpy(g) for g in grads],
        update_ratio=None if ratio is None else torch.tensor(ratio),
        taps=[torch.tensor(t) for t in tap_vals]).numpy()
    return vj, vt, lt


@pytest.mark.parametrize("seed,n_params,n_taps", [(0, 1, 0), (1, 5, 2),
                                                  (2, 11, 3)])
def test_pack_summary_matches(seed, n_params, n_taps):
    """Slot by slot within 1e-6 relative (f32 reductions in a different
    order)."""
    r = np.random.RandomState(seed)
    outs = [r.randn(4, 3).astype(np.float32), r.rand(5).astype(np.float32)]
    params = [r.randn(*((3, 2) if i % 2 else (4,))).astype(np.float32)
              for i in range(n_params)]
    grads = [r.randn(*p.shape).astype(np.float32) for p in params]
    vj, vt, _ = _pack_both(outs, params, grads, n_taps, ratio=0.125)
    assert vt.dtype == np.float32 and vt.shape == vj.shape
    np.testing.assert_allclose(vt, vj, rtol=1e-6, atol=0)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
@pytest.mark.parametrize("which", [0, 1, 2])
def test_nonfinite_output_clears_its_bit(bad, which):
    r = np.random.RandomState(7)
    outs = [r.rand(3, 2).astype(np.float32) for _ in range(3)]
    outs[which][1, 1] = bad
    params = [r.rand(4).astype(np.float32)]
    grads = [r.rand(4).astype(np.float32)]
    vj, vt, lt = _pack_both(outs, params, grads)
    want = float(7 - (1 << which))
    assert vj[0] == want and vt[0] == want
    assert lt.unpack(vt)["all_finite"] == 0.0


# -- the rule engine ---------------------------------------------------------

def _healthy(grad=1.0, loss=0.5, **over):
    s = {"finite_mask": 1.0, "out_mean": loss, "grad_norm": grad,
         "param_norm": 2.0, "update_ratio": 0.01, "all_finite": 1.0}
    s.update(over)
    return s


def _script():
    """(step, summary) pairs that fire each rule in turn."""
    steps = [(k, _healthy()) for k in range(12)]
    steps.append((12, _healthy(grad=500.0)))               # grad_spike
    steps += [(k, _healthy()) for k in range(13, 20)]
    steps.append((20, _healthy(loss=1e6)))                  # loss_explosion
    steps += [(k, _healthy()) for k in range(21, 25)]
    steps.append((25, _healthy(grad=float("nan"), all_finite=0.0)))
    steps.append((26, _healthy(grad=900.0, all_finite=0.0)))  # two rules
    return steps


@pytest.mark.parametrize("actions", [
    {"nonfinite": "warn", "grad_spike": "warn", "loss_explosion": "warn"},
    {"nonfinite": "dump", "grad_spike": "dump", "loss_explosion": "warn",
     "loss_plateau": "warn"},
])
def test_monitor_fires_the_same_anomalies(actions, tmp_path, monkeypatch):
    """The same scripted summaries fire the same (rule, step) anomalies
    with the same actions; callbacks run before the action; a step that
    fires several rules writes one dump."""
    fired, dumps = {}, {}
    for name, health, flight in (("jax", health_j, flight_j),
                                 ("torch", health_t, flight_t)):
        monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH",
                           str(tmp_path / ("%s.json" % name)))
        flight.reset()
        mon = health.HealthMonitor(actions=actions, plateau_window=6)
        rec = flight.get_recorder()
        order = []
        real_dump = rec.dump

        def dump(path=None, reason="on_demand", sections=None,
                 real_dump=real_dump, order=order):
            order.append(("dump", reason))
            return real_dump(path=path, reason=reason, sections=sections)
        rec.dump = dump
        mon.add_callback(lambda a, order=order: order.append(
            ("callback", a["rule"], a["step"])))
        got = []
        for step, summary in _script():
            got += [(a["rule"], a["step"]) for a in mon.observe(step,
                                                                summary)]
        fired[name] = (got, order)
        dumps[name] = len([o for o in order if o[0] == "dump"])
    assert fired["torch"] == fired["jax"]
    got, order = fired["torch"]
    assert ("grad_spike", 12) in got and ("loss_explosion", 20) in got
    assert ("nonfinite", 26) in got and ("grad_spike", 26) in got
    if actions["nonfinite"] == "dump":
        # one dump for step 26's two rules, after both callbacks
        k = order.index(("callback", "grad_spike", 26))
        assert order[k + 1] == ("dump", "anomaly_nonfinite")
        assert dumps["torch"] == dumps["jax"]


def test_monitor_raise_matches():
    errs = []
    for health in (health_j, health_t):
        mon = health.HealthMonitor()
        for step in range(6):
            mon.observe(step, _healthy())
        with pytest.raises(health.TrainingDivergedError) as err:
            mon.observe(6, _healthy(grad=float("nan"),
                                    loss=float("nan"), all_finite=0.0))
        errs.append((err.value.step, err.value.rule))
    assert errs[0] == errs[1] == (6, "nonfinite")


def test_rule_actions_parse_matches(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_HEALTH_RULES",
                       "nonfinite=dump, grad_spike=off, bogus=warn, "
                       "loss_explosion=banana, loss_plateau:raise")
    assert health_t.rule_actions() == health_j.rule_actions()


# -- the sentinel through Module.fit -----------------------------------------

def _mlp(mx):
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                                name="h_fc1")
    net = mx.sym.Activation(net, act_type="relu", name="h_relu1")
    net = mx.sym.FullyConnected(net, num_hidden=4, name="h_fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _data(nan_batch=None, n=24, bs=8, dim=8, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.rand(n, dim).astype(np.float32)
    y = rng.randint(0, 4, (n,)).astype(np.float32)
    if nan_batch is not None:
        x[nan_batch * bs:(nan_batch + 1) * bs] = np.nan
    return x, y


def _jax_init(ctxs_j):
    """The JAX package's initialisation of the MLP, as numpy."""
    mod = mj.mod.Module(_mlp(mj), context=ctxs_j)
    mod.bind([("data", (8, 8))], [("softmax_label", (8,))])
    mj.random.seed(11)
    mod.init_params(initializer=mj.initializer.Xavier(magnitude=2.0))
    args, auxs = mod.get_params()
    return {k: v.asnumpy() for k, v in args.items()}


def _fit_summaries(mx, contexts, init, nan_batch=None, **fit_kwargs):
    """Fit one epoch of 3 batches under the sentinel; returns (module,
    [(step, summary)] per batch, the raised error or None)."""
    x, y = _data(nan_batch)
    it = mx.io.NDArrayIter(x, y, batch_size=8)
    mod = mx.mod.Module(_mlp(mx), context=contexts)
    if mx is mt:
        args, _ = params_from_numpy(init, ctx=mt.cpu())
    else:
        args = {k: mx.nd.array(v) for k, v in init.items()}
    seen = []

    def grab(param):
        seen.append(mod._last_health_summary)
    err = None
    try:
        mod.fit(it, num_epoch=1, arg_params=args,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                batch_end_callback=grab, **fit_kwargs)
    except Exception as exc:  # noqa: BLE001 -- compared across packages
        err = exc
    return mod, seen, err


PATHS = {"fused": (lambda: mj.cpu(), lambda: mt.cpu()),
         "general_2ctx": (lambda: [mj.cpu(0), mj.cpu(1)],
                          lambda: [mt.cpu(0), mt.cpu(1)])}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_fit_summaries_match(path, monkeypatch):
    """3 steps: every slot of every step's summary within 1e-5 relative
    (1e-7 absolute for slots near zero) of the JAX package's."""
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    cj, ct = PATHS[path]
    init = _jax_init(cj())
    mod_j, seen_j, err_j = _fit_summaries(mj, cj(), init)
    mod_t, seen_t, err_t = _fit_summaries(mt, ct(), init)
    assert err_j is None and err_t is None, (err_j, err_t)
    assert (mod_t._fused_step is not None) == (path == "fused") \
        == (mod_j._fused_step is not None)
    assert [s for s, _ in seen_t] == [s for s, _ in seen_j] == [0, 1, 2]
    for (_, sj), (_, st) in zip(seen_j, seen_t):
        assert list(st) == list(sj)
        np.testing.assert_allclose(list(st.values()), list(sj.values()),
                                   rtol=1e-5, atol=1e-7)
        assert st["all_finite"] == 1.0 and st["update_ratio"] > 0


@pytest.mark.parametrize("path", sorted(PATHS))
def test_fit_nan_batch_diverges_at_the_same_step(path, monkeypatch,
                                                 tmp_path):
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    cj, ct = PATHS[path]
    init = _jax_init(cj())
    docs = {}
    for name, mx, ctx in (("jax", mj, cj), ("torch", mt, ct)):
        dump_path = str(tmp_path / ("%s.json" % name))
        monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH", dump_path)
        _, _, err = _fit_summaries(mx, ctx(), init, nan_batch=1)
        assert isinstance(err, mx.TrainingDivergedError), err
        assert err.step == 1 and err.dump_path == dump_path
        docs[name] = json.load(open(dump_path))
    for doc in docs.values():
        assert doc["first_anomaly_step"] == 1
        assert [s["step"] for s in doc["steps"]] == [0, 1]
        assert doc["steps"][1]["health"]["finite_mask"] == 0.0
    assert sorted(docs["torch"]) == sorted(docs["jax"])
    assert docs["torch"]["kind"] == "mxnet_tpu_flight"
    assert docs["torch"]["fingerprint"]["torch"] == torch.__version__
    tv = _load_traceview()
    assert tv.flight_stats(docs["torch"])["first_anomaly_step"] == 1
    assert tv.main(["--flight", str(tmp_path / "torch.json")]) == 1


def test_fit_exception_hook_dumps(monkeypatch, tmp_path):
    """A callback's exception leaves a fit_exception dump with the
    sentinel on, and nothing with it off."""
    dump_path = str(tmp_path / "crash.json")
    monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH", dump_path)

    def boom(param):
        if param.nbatch == 1:
            raise RuntimeError("callback exploded")
    x, y = _data()
    for flag in ("1", "0"):
        monkeypatch.setenv("MXNET_TPU_HEALTH", flag)
        flight_t.reset()
        mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
        with pytest.raises(RuntimeError, match="callback exploded"):
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
                    batch_end_callback=boom)
        if flag == "1":
            doc = json.load(open(dump_path))
            assert doc["reason"] == "fit_exception"
            assert any("callback exploded" in e["payload"]["message"]
                       for e in doc["events"] if e["kind"] == "exception")
            os.remove(dump_path)
        else:
            assert not os.path.exists(dump_path)


# -- what the flag costs -----------------------------------------------------

def _fit_plain(mx, monitor=None):
    x, y = _data()
    mod = mx.mod.Module(_mlp(mx), context=mx.cpu())
    mod.fit(mx.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
            optimizer_params={"learning_rate": 0.1}, monitor=monitor)
    return mod


def test_health_flag_costs_one_plan_and_off_costs_none(monkeypatch):
    """On: at most one new plan over the off run (the health-on training
    plan; the JAX package's bound is one retrace).  Back off: none, and
    the plan counters, the registry's series and the flight recorder are
    what they are without the sentinel."""
    ec_t.clear()
    ec_t.reset_stats()
    monkeypatch.setenv("MXNET_TPU_HEALTH", "0")
    _fit_plain(mt)
    off = ec_t.stats()
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    mod = _fit_plain(mt)
    on = ec_t.stats()
    assert on["misses"] - off["misses"] == 1
    assert sum(ec_t.trace_counts().values()) - sum(
        off[k] for k in ec_t.trace_counts()) <= 2  # the plan's, the step's
    assert ec_t.stats()["recompile_causes"] == {"health": 1}
    assert mod._last_health_summary[0] == 2
    assert flight_t.get_recorder().steps_recorded() == 3
    tel_t.reset()
    flight_t.reset()
    monkeypatch.setenv("MXNET_TPU_HEALTH", "0")
    before = ec_t.stats()
    _fit_plain(mt)
    after = ec_t.stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] > before["hits"]
    assert not any(k.startswith("health.") for k in tel_t.snapshot())
    assert flight_t.get_recorder().steps_recorded() == 0


def test_health_plans_split_only_with_gradients(monkeypatch):
    sym = _mlp(mt)
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    exe_on = sym.simple_bind(mt.cpu(), grad_req="write", data=(4, 8),
                             softmax_label=(4,))
    pred_on = sym.simple_bind(mt.cpu(), grad_req="null", data=(4, 8),
                              softmax_label=(4,))
    monkeypatch.setenv("MXNET_TPU_HEALTH", "0")
    exe_off = sym.simple_bind(mt.cpu(), grad_req="write", data=(4, 8),
                              softmax_label=(4,))
    pred_off = sym.simple_bind(mt.cpu(), grad_req="null", data=(4, 8),
                               softmax_label=(4,))
    assert exe_on._prog is not exe_off._prog
    assert pred_on._prog is pred_off._prog
    assert exe_on._health_on and not exe_off._health_on
    exe_on.forward_backward(is_train=True)
    exe_off.forward_backward(is_train=True)
    assert exe_off._last_health is None
    summary = exe_on.health_layout.unpack(exe_on._last_health.numpy())
    assert summary["all_finite"] == 1.0


def test_monitor_health_mode_keeps_the_fused_step(monkeypatch, caplog):
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    ec_t.clear()
    ec_t.reset_stats()
    _fit_plain(mt)
    plain = ec_t.trace_counts()
    ec_t.clear()
    ec_t.reset_stats()
    mon = mt.monitor.Monitor(1, stats="health")
    with caplog.at_level(logging.INFO):
        mod = _fit_plain(mt, monitor=mon)
    assert ec_t.trace_counts() == plain
    assert mod._fused_step is not None
    assert any("stays active" in r.getMessage() for r in caplog.records)
    mon.activated = True
    rows = mon.toc()
    assert any(name == "health/grad_norm" for _, name, _ in rows)
    assert all(name.startswith("health/") for _, name, _ in rows)


def test_monitor_health_mode_warns_when_the_sentinel_is_off(caplog):
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    mod.bind([("data", (8, 8))], [("softmax_label", (8,))])
    with caplog.at_level(logging.WARNING):
        mod.install_monitor(mt.monitor.Monitor(1, stats="health"))
    assert any("MXNET_TPU_HEALTH" in r.getMessage() for r in caplog.records)


def test_bucketing_module_binds_the_health_monitor_to_itself(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    mod = mt.mod.BucketingModule(
        lambda key: (_mlp(mt), ("data",), ("softmax_label",)),
        default_bucket_key=8, context=mt.cpu())
    mod.bind([("data", (8, 8))], [("softmax_label", (8,))])
    mon = mt.monitor.Monitor(1, stats="health")
    mod.install_monitor(mon)
    assert mon._module is mod
    mod._last_health_summary = (3, {"grad_norm": 1.5})
    mon.activated = True
    assert mon.toc() == [(3, "health/grad_norm", "1.5")]


@pytest.mark.parametrize("name,params", [
    ("sgd", {"learning_rate": 0.25, "rescale_grad": 0.5}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9, "rescale_grad": -2.0}),
    ("adam", {"learning_rate": 0.01, "rescale_grad": 0.125}),
])
def test_health_update_scale_matches(name, params):
    """Equal to the JAX package's (exactly: the same double arithmetic)
    at each of 5 scheduler steps."""
    scales = []
    for pkg in (mj, mt):
        sched = pkg.lr_scheduler.FactorScheduler(step=2, factor=0.5)
        opt = pkg.optimizer.create(name, lr_scheduler=sched, **params)
        seq = []
        for k in range(5):
            opt.num_update = k * 2
            seq.append(opt.health_update_scale())
        scales.append(seq)
    assert scales[0] == scales[1]


# -- flight recorder ---------------------------------------------------------

def test_flight_ring_and_logs(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TPU_FLIGHT_STEPS", "8")
    flight_t.reset()
    rec = flight_t.get_recorder()
    assert rec.capacity == 8
    for step in range(20):
        rec.record_step(step, health={"grad_norm": float(step)})
    assert rec.steps_recorded() == 8
    logger = logging.getLogger("mxnet_tpu_torch.some.module")
    for i in range(250):
        logger.warning("ring message %d", i)
    path = rec.dump(path=str(tmp_path / "d.json"))
    doc = json.loads(open(path).read(), parse_constant=lambda s: pytest.fail(
        "non-standard JSON token %r" % s))
    assert len(doc["logs"]) == 200
    assert doc["logs"][-1]["message"] == "ring message 249"
    assert [s["step"] for s in doc["steps"]] == list(range(12, 20))
    for section in ("tuning", "elastic", "alerts", "requests",
                    "requests_sampled"):
        assert doc[section] == []
    monkeypatch.setenv("MXNET_TPU_FLIGHT_STEPS", "2k")
    flight_t.reset()
    assert flight_t.get_recorder().capacity == flight_t.DEFAULT_STEPS


def test_flight_dump_keys_match_the_jax_dump(tmp_path):
    """An empty dump of each package: the same top-level keys, and the
    non-finite health values as the same strict-JSON tokens."""
    docs = []
    for flight in (flight_j, flight_t):
        rec = flight.get_recorder()
        rec.record_step(0, health={"grad_norm": float("nan"),
                                   "out_mean": float("inf")})
        path = rec.dump(path=str(tmp_path / ("%d.json" % len(docs))))
        docs.append(json.load(open(path)))
    assert sorted(docs[1]) == sorted(docs[0])
    assert docs[1]["steps"][0]["health"] == docs[0]["steps"][0]["health"]
    assert sorted(docs[1]["steps"][0]) == sorted(docs[0]["steps"][0])
    assert docs[1]["fingerprint"]["pid"] == os.getpid()


def test_flight_dump_once_per_reason(tmp_path):
    rec = flight_t.get_recorder()
    assert rec.dump_once("x", path=str(tmp_path / "1.json")) is not None
    assert rec.dump_once("x", path=str(tmp_path / "2.json")) is None
    assert not (tmp_path / "2.json").exists()


# -- serving ------------------------------------------------------------------

def _server(poison=False, max_batch=4):
    from mxnet_tpu_torch import serving
    rng = np.random.RandomState(0)
    net = mt.sym.FullyConnected(mt.sym.Variable("data"), num_hidden=4,
                                name="s_fc1")
    sym = mt.sym.SoftmaxOutput(net, name="softmax")
    arg_shapes, _, _ = sym.infer_shape(data=(1, 8))
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        value = rng.normal(0, 0.1, shape).astype(np.float32)
        if poison:
            value[...] = np.inf
        params[name] = value
    args, _ = params_from_numpy(params, ctx=mt.cpu())
    server = serving.Server(max_batch_size=max_batch, batch_window_ms=1.0)
    server.add_model("m", sym, args, input_shapes={"data": (8,)},
                     ctx=mt.cpu())
    return server


def test_serving_nonfinite_outputs_counted_and_shipped(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    server = _server(poison=True)
    try:
        for k in range(3):
            outs = server.submit("m", {"data": np.ones((1, 8), np.float32)},
                                 timeout=30)
            assert not np.isfinite(outs[0]).all()  # still served
        snap = tel_t.snapshot()
        assert snap["serving.nonfinite_responses"]["value"] == 3.0
        notes = [e for e in flight_t.get_recorder()._events
                 if e["kind"] == "serving_nonfinite"]
        assert len(notes) == 3 and notes[0]["payload"]["model"] == "m"
    finally:
        server.close(drain=True, timeout=30)


def test_serving_dispatch_failure_dumps_once(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    dump_path = str(tmp_path / "serve_crash.json")
    monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH", dump_path)
    server = _server()
    try:
        model = server.registry.get("m")
        monkeypatch.setattr(model, "run_batch",
                            lambda *a, **k: (_ for _ in ()).throw(
                                RuntimeError("model exploded")))
        for _ in range(2):
            fut = server.submit_async(
                "m", {"data": np.ones((1, 8), np.float32)})
            with pytest.raises(RuntimeError, match="model exploded"):
                fut.result(timeout=30)
        assert server.batcher.alive
        doc = json.load(open(dump_path))
        assert doc["reason"] == "serving_exception"
        errs = [e for e in doc["events"]
                if e["kind"] == "serving_dispatch_error"]
        assert len(errs) == 1 and "model exploded" in \
            errs[0]["payload"]["error"]
        assert flight_t.get_recorder().has_dumped("serving_exception")
    finally:
        server.close(drain=True, timeout=30)


def test_warmup_memory_section_on_the_host(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_MEMPROF", "1")
    ec_t.clear()
    server = _server()
    try:
        report = server.warmup()
        mem = report["memory"]
        per_bucket = mem["per_model"]["m"]
        assert set(per_bucket) == {"1", "2", "4"}
        for b, v in per_bucket.items():
            assert v["output_bytes"] == int(b) * 4 * 4
            assert v["argument_bytes"] == (int(b) * 8 + 4 * 8 + 4
                                           + int(b)) * 4
        assert mem["footprint_bytes"] > 0
        assert mem["device_limit_bytes"] is None
        assert mem["headroom_frac"] is None
    finally:
        server.close(drain=True, timeout=30)

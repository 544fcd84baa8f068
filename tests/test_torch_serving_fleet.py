"""The port's fleet tier (``serving/router.py``) against the JAX package.

A 6-feature MLP (8 hidden, 3 classes) from the same numpy weights in
both packages.  Every routed response of the port's ``FleetServer`` is
bit for bit a plain port ``Predictor`` run at its dispatch bucket,
whichever replica served it, and within atol=rtol=1e-5 of the JAX
package's ``Predictor`` at that bucket (f32, sums in another order).
The cases of ``tests/test_serving_fleet.py`` hold in the port: warmup
measures every replica's bucket costs, least-loaded routing moves work
off a slow replica, a throwing replica is quarantined and its lane
re-routed, a dead group rejects with ``NoHealthyReplica``, a full queue
with ``Overloaded``, a drain deadline with ``ServerClosed``; SLOs reach
the port's metrics.  Replicas run on ``mx.cpu()``; every fleet is closed
by its fixture, so no replica thread outlives the file.
"""
import time

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.predict import Predictor as JPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import executor_cache, serving, threads
from mxnet_tpu_torch.predict import Predictor

FEAT = 6
PARITY_TOL = dict(atol=1e-5, rtol=1e-5)
rng = np.random.RandomState(7)


@pytest.fixture(autouse=True)
def _isolate_serving_env(monkeypatch):
    for name in ("MXNET_TPU_SERVING_DEFAULT_DEADLINE_MS",
                 "MXNET_TPU_SERVING_QUEUE_DEPTH",
                 "MXNET_TPU_SERVING_REPLICAS",
                 "MXNET_TPU_SERVING_SLOT_COUNT",
                 "MXNET_TPU_SERVING_SLO_MS"):
        monkeypatch.delenv(name, raising=False)


def _mlp(pkg):
    net = pkg.sym.FullyConnected(pkg.sym.Variable("data"), num_hidden=8,
                                 name="fc1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.FullyConnected(net, num_hidden=3, name="fc2")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


@pytest.fixture(scope="module")
def weights():
    sym = _mlp(mx)
    arg_shapes, _, _ = sym.infer_shape(data=(1, FEAT))
    r = np.random.RandomState(11)
    return {n: r.normal(0, 0.1, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


@pytest.fixture
def make_fleet(weights):
    made = []

    def make(n_replicas=2, max_batch_size=8, model="mlp", slo_ms=None,
             **kw):
        fleet = serving.FleetServer(ctxs=[mx.cpu()] * n_replicas,
                                    max_batch_size=max_batch_size,
                                    batch_window_ms=1.0, **kw)
        made.append(fleet)
        fleet.add_model(model, _mlp(mx),
                        {k: mx.nd.array(v, ctx=mx.cpu())
                         for k, v in weights.items()},
                        input_shapes={"data": (FEAT,)}, slo_ms=slo_ms)
        return fleet

    yield make
    for fleet in made:
        fleet.close(drain=True, timeout=30)
    for t in threads.live_package_threads():
        t.join(5)
    assert not threads.live_package_threads()


def test_fleet_warmup_verifies_and_measures_costs(make_fleet):
    fleet = make_fleet()
    report = fleet.warmup()
    assert len(report["replicas"]) == 2
    for rep in fleet.group.replicas:
        for b in fleet.registry.get("mlp").buckets:
            assert rep.bucket_cost_ms[("mlp", b)] > 0.0
    for idx in (0, 1):
        costs = report["mlp"]["per_replica"][idx]["bucket_cost_ms"]
        assert set(costs) == {"1", "2", "4", "8"}


def test_responses_bitwise_equal_serverless_replay(make_fleet, weights):
    fleet = make_fleet()
    fleet.warmup()
    payloads = [rng.rand(1 + i % 3, FEAT).astype(np.float32)
                for i in range(24)]
    with executor_cache.watch_traces() as w:
        futs = [fleet.submit_async("mlp", {"data": p}) for p in payloads]
        results = [f.result(timeout=30) for f in futs]
    assert w.total() == 0, w.delta()
    blob = {"arg:%s" % k: v for k, v in weights.items()}
    oracles = {}
    for p, f, outs in zip(payloads, futs, results):
        b = f.request.dispatch_bucket
        if b not in oracles:
            oracles[b] = (
                Predictor(_mlp(mx).tojson(),
                          {k: mx.nd.array(v, ctx=mx.cpu())
                           for k, v in blob.items()},
                          {"data": (b, FEAT)}, ctx=mx.cpu()),
                JPredictor(_mlp(jmx).tojson(),
                           {k: jmx.nd.array(v) for k, v in blob.items()},
                           {"data": (b, FEAT)}))
        solo = np.zeros((b, FEAT), np.float32)
        solo[:p.shape[0]] = p
        for oracle in oracles[b]:
            oracle.forward(data=solo)
        port, jax_ = (o.get_output(0).asnumpy()[:p.shape[0]]
                      for o in oracles[b])
        assert np.array_equal(outs[0], port)
        np.testing.assert_allclose(outs[0], jax_, **PARITY_TOL)


def test_least_loaded_routing_shifts_load_off_slow_replica(make_fleet):
    fleet = make_fleet()
    fleet.warmup()
    slow_model = fleet.group.replicas[0].registry.get("mlp")
    orig = slow_model.run_batch

    def sluggish(bucket, inputs):
        time.sleep(0.03)
        return orig(bucket, inputs)

    slow_model.run_batch = sluggish
    futs = []
    for _ in range(12):
        futs.append(fleet.submit_async(
            "mlp", {"data": rng.rand(8, FEAT).astype(np.float32)}))
        time.sleep(0.005)
    for f in futs:
        f.result(timeout=30)
    r0, r1 = fleet.group.replicas
    assert r1.dispatches > r0.dispatches, (r0.dispatches, r1.dispatches)
    assert r0.dispatches + r1.dispatches == 12


def test_replica_quarantine_drains_not_the_server(make_fleet):
    mx.observability.telemetry.reset()
    fleet = make_fleet()
    fleet.warmup()

    def explode(bucket, inputs):
        raise RuntimeError("induced replica failure")

    fleet.group.replicas[0].registry.get("mlp").run_batch = explode
    payloads = [rng.rand(8, FEAT).astype(np.float32) for _ in range(10)]
    futs = [fleet.submit_async("mlp", {"data": p}) for p in payloads]
    failed = served = 0
    for f in futs:
        try:
            f.result(timeout=30)
            served += 1
        except RuntimeError:
            failed += 1
    assert failed >= 1 and served >= 1 and failed + served == 10
    r0, r1 = fleet.group.replicas
    assert not r0.healthy and r0.quarantine_error is not None
    assert r1.healthy
    out = fleet.submit("mlp", {"data": payloads[0]}, timeout=30)
    assert out[0].shape == (8, 3)
    snap = mx.observability.snapshot()
    assert snap["serving.replica_quarantined"]["value"] >= 1
    assert snap["serving.replica.1.dispatches"]["value"] >= 1


def test_fully_quarantined_group_rejects_typed(make_fleet):
    fleet = make_fleet(n_replicas=1, max_batch_size=4)
    fleet.warmup()
    fleet.group.replicas[0].registry.get("mlp").run_batch = \
        lambda bucket, inputs: (_ for _ in ()).throw(
            RuntimeError("dead replica"))
    doomed = fleet.submit_async(
        "mlp", {"data": rng.rand(2, FEAT).astype(np.float32)})
    with pytest.raises(RuntimeError):
        doomed.result(timeout=30)
    assert not fleet.group.replicas[0].healthy
    after = fleet.submit_async(
        "mlp", {"data": rng.rand(2, FEAT).astype(np.float32)})
    with pytest.raises(serving.NoHealthyReplica):
        after.result(timeout=30)


def test_overload_shedding_is_typed_overloaded(make_fleet):
    mx.observability.telemetry.reset()
    fleet = make_fleet(queue_depth=2, auto_start=False)
    queued = [fleet.submit_async(
        "mlp", {"data": rng.rand(1, FEAT).astype(np.float32)})
        for _ in range(2)]
    with pytest.raises(serving.Overloaded):
        fleet.submit_async("mlp",
                           {"data": rng.rand(1, FEAT).astype(np.float32)})
    snap = mx.observability.snapshot()
    assert snap["serving.rejected_total.overloaded"]["value"] >= 1
    fleet.start()
    for f in queued:
        f.result(timeout=30)


def test_fleet_add_model_refuses_ctx(make_fleet, weights):
    fleet = make_fleet()
    with pytest.raises(mx.base.MXNetError, match="ctxs"):
        fleet.add_model("other", _mlp(mx), weights,
                        input_shapes={"data": (FEAT,)}, ctx=mx.cpu())


def test_default_replicas_env(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_SERVING_REPLICAS", "3")
    assert serving.default_replicas() == 3
    monkeypatch.setenv("MXNET_TPU_SERVING_REPLICAS", "bogus")
    assert serving.default_replicas() == 1
    monkeypatch.setenv("MXNET_TPU_SERVING_SLOT_COUNT", "5")
    assert serving.default_slot_count() == 5


def test_declared_slo_lands_in_the_metrics(make_fleet):
    mx.observability.telemetry.reset()
    fleet = make_fleet(max_batch_size=4, model="slomodel", slo_ms=123.0)
    fleet.warmup()
    for _ in range(4):
        fleet.submit("slomodel",
                     {"data": rng.rand(2, FEAT).astype(np.float32)},
                     timeout=30)
    snap = mx.observability.snapshot()
    assert snap["serving.slo_ms.slomodel"]["value"] == 123.0
    assert snap["serving.request_latency_ms.slomodel"]["count"] == 4
    prom = mx.observability.telemetry.to_prometheus()
    assert "mxnet_tpu_serving_slo_ms_slomodel 123\n" in prom


def test_slo_env_default(monkeypatch, weights):
    monkeypatch.setenv("MXNET_TPU_SERVING_SLO_MS", "77.5")
    model = serving.ServedModel(
        "envslo", _mlp(mx), {k: mx.nd.array(v, ctx=mx.cpu())
                             for k, v in weights.items()}, None,
        {"data": (FEAT,)}, max_batch_size=2, ctx=mx.cpu())
    assert model.slo_ms == 77.5


def test_fleet_drain_deadline_sheds_typed_server_closed(make_fleet):
    fleet = make_fleet()
    fleet.warmup()
    for replica in fleet.group.replicas:
        model = replica.registry.get("mlp")
        orig = model.run_batch

        def crawling(bucket, inputs, orig=orig):
            time.sleep(0.5)
            return orig(bucket, inputs)

        model.run_batch = crawling
    futs = [fleet.submit_async(
        "mlp", {"data": rng.rand(8, FEAT).astype(np.float32)})
        for _ in range(8)]
    fleet.close(drain=True, timeout=1.0)
    outcomes = {"served": 0, "shed": 0}
    for f in futs:
        try:
            f.result(timeout=10)
            outcomes["served"] += 1
        except serving.ServerClosed:
            outcomes["shed"] += 1
    assert outcomes["served"] + outcomes["shed"] == 8
    assert outcomes["shed"] >= 1, outcomes

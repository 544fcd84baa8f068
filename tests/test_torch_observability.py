"""``mx.observability`` and ``mx.profiler`` against the JAX package's, on
the CPU.

- The same instrument calls give equal ``snapshot()`` structures and
  equal ``to_prometheus()`` / ``to_json_lines()`` text in both packages,
  and the histograms' log2 bucket edges are equal.
- ``aggregate_stats`` over one event list is equal; the Chrome dump
  nests spans, ``record_event`` carries the real thread id, and
  ``MXNET_TPU_PROFILER_AUTOSTART=1`` records from import and dumps at
  exit.
- In ``all`` mode each op's span nests in its executor's span; the
  ``StepTracker`` components cover each step of a small ``fit``; the io
  wait, the KV push/pull bytes, the executor cache's counters and
  ``Speedometer(telemetry=True)``'s gauges reach the registry, and the
  Speedometer's log lines keep their format; a served request shows up
  under the JAX package's metric names; an ``io_pipeline`` epoch records
  the JAX package's stage series and ``pipe:*`` events; the engine's ops
  record ``engine`` spans.
"""
import json
import logging
import math
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = [mj, mt]


@pytest.fixture(autouse=True)
def _fresh():
    for pkg in PKGS:
        pkg.observability.telemetry.reset()
        pkg.observability.tracing.clear_events()
        pkg.observability.tracing.set_recording(False)
    yield
    for pkg in PKGS:
        pkg.observability.tracing.set_recording(False)
        pkg.observability.tracing.clear_events()
        pkg.profiler.profiler_set_config("symbolic", "profile.json")


def _drive(pkg):
    """The same instrument calls in either package."""
    tel = pkg.observability.telemetry
    tel.counter("a.count", help="a counter").inc()
    tel.counter("a.count").inc(2.5)
    tel.gauge("b.gauge").set(7)
    h = tel.histogram("c.hist_ms", help="a histogram")
    for v in (0.0001, 0.5, 1.0, 3.0, 1024.0, 5e6, float("nan")):
        h.observe(v)
    tel.gauge("d.fn").set_function(lambda: 42)
    tel.histogram("e.empty")


def _clean(snap):
    """A snapshot without the NaN-bearing fields, which compare unequal
    to themselves, and without ``gen``, the registry's reset count in this
    process (other tests reset either package's registry)."""
    out = {}
    for k, v in snap.items():
        out[k] = {f: x for f, x in v.items()
                  if f != "gen" and not (isinstance(x, float)
                                         and math.isnan(x))}
    return out


def _lines(text):
    """JSON lines with ``gen`` set to 0 (see ``_clean``)."""
    return [json.dumps(dict(json.loads(line), gen=0), sort_keys=True)
            for line in text.splitlines()]


def test_snapshot_and_exporters_equal_between_packages():
    got = []
    for pkg in PKGS:
        _drive(pkg)
        tel = pkg.observability.telemetry
        got.append((_clean(tel.snapshot()), tel.to_prometheus(),
                    _lines(tel.to_json_lines())))
        assert tel.parse_json_lines(tel.to_json_lines()).keys() \
            == tel.snapshot().keys()
    assert got[0][0] == got[1][0]
    assert got[0][1] == got[1][1]
    assert got[0][2] == got[1][2]
    assert 'mxnet_tpu_c_hist_ms_bucket{le="+Inf"} 7' in got[1][1]


def test_histogram_bucket_edges_and_quantiles_equal():
    a, b = mj.observability.telemetry, mt.observability.telemetry
    assert a.BUCKET_BOUNDS == b.BUCKET_BOUNDS
    for v in (1e-6, 2 ** -10, 0.3, 1.0, 1.5, 2.0, 3.0, 2 ** 20, 2 ** 21):
        assert a.Histogram._bucket_index(v) == b.Histogram._bucket_index(v)
    for pkg in PKGS:
        h = pkg.observability.telemetry.histogram("q")
        for v in range(1, 101):
            h.observe(float(v))
    for q in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert a.histogram("q").quantile(q) == b.histogram("q").quantile(q)


def test_disabled_telemetry_hands_out_the_noop(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TELEMETRY", "0")
    tel = mt.observability.telemetry
    assert tel.counter("x") is tel.NOOP and tel.histogram("y") is tel.NOOP
    tel.counter("x").inc()
    assert tel.snapshot() == {}


def _events():
    return [
        {"name": "a", "cat": "operator", "ph": "X", "ts": 0.0,
         "dur": 1000.0, "pid": "cpu/0", "tid": 1},
        {"name": "a", "cat": "operator", "ph": "X", "ts": 5.0,
         "dur": 3000.0, "pid": "cpu/0", "tid": 2},
        {"name": "b", "cat": "symbolic", "ph": "B", "ts": 10.0,
         "pid": "cpu/0", "tid": 1},
        {"name": "b", "cat": "symbolic", "ph": "B", "ts": 20.0,
         "pid": "cpu/0", "tid": 1},
        {"name": "b", "cat": "symbolic", "ph": "E", "ts": 520.0,
         "pid": "cpu/0", "tid": 1},
        {"name": "b", "cat": "symbolic", "ph": "E", "ts": 2010.0,
         "pid": "cpu/0", "tid": 1},
        {"name": "c", "cat": "counter", "ph": "C", "ts": 3.0,
         "pid": "cpu/0", "tid": 0, "args": {"value": 3}},
    ]


def test_aggregate_stats_and_dumps_equal():
    assert mj.profiler.aggregate_stats(_events()) \
        == mt.profiler.aggregate_stats(_events())
    for pkg in PKGS:
        pkg.observability.tracing.set_recording(True)
        for e in _events():
            pkg.observability.tracing.emit(dict(e))
        pkg.observability.tracing.set_recording(False)
    assert mj.profiler.dumps(reset=True) == mt.profiler.dumps(reset=True)
    assert mt.observability.tracing.snapshot_events() == []


def test_chrome_dump_nests_spans_with_real_thread_ids(tmp_path):
    prof = mt.profiler
    path = str(tmp_path / "p.json")
    prof.profiler_set_config("symbolic", path)
    prof.profiler_set_state("run")
    with prof.record_span("outer", category="runtime"):
        with mt.observability.span("inner"):
            pass
        prof.record_instant("marker")
    seen = {}

    def other():
        prof.record_event("worker_op", 0.0, 10.0)
        seen["tid"] = threading.get_ident()

    t = threading.Thread(target=other)
    t.start()
    t.join()
    prof.record_counter("cnt", 3)
    prof.profiler_set_state("stop")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    by = {e["name"]: e for e in events}
    assert by["inner"]["args"]["parent_id"] == by["outer"]["args"]["span_id"]
    assert by["outer"]["ts"] <= by["inner"]["ts"] and \
        by["inner"]["ts"] + by["inner"]["dur"] \
        <= by["outer"]["ts"] + by["outer"]["dur"]
    assert by["worker_op"]["tid"] == seen["tid"] != threading.get_ident()
    assert by["marker"]["ph"] == "i" and by["cnt"]["ph"] == "C"
    assert prof.is_running() is False


def test_autostart_records_from_import_and_dumps_at_exit(tmp_path):
    env = dict(os.environ, MXNET_TPU_PROFILER_AUTOSTART="1",
               PYTHONPATH=ROOT)
    code = ("import mxnet_tpu_torch as mx\n"
            "assert mx.profiler.is_running()\n"
            "with mx.profiler.record_span('auto'):\n"
            "    pass\n")
    subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                   env=env, check=True, timeout=120)
    with open(tmp_path / "profile.json") as f:
        names = {e["name"] for e in json.load(f)["traceEvents"]}
    assert "auto" in names


def _mlp(pkg):
    x = pkg.sym.Variable("data")
    h = pkg.sym.FullyConnected(x, num_hidden=8, name="fc1")
    h = pkg.sym.Activation(h, act_type="relu", name="relu1")
    h = pkg.sym.FullyConnected(h, num_hidden=4, name="fc2")
    return pkg.sym.SoftmaxOutput(h, name="softmax")


def _iter(pkg, n=40, batch=10, seed=0):
    r = np.random.RandomState(seed)
    return pkg.io.NDArrayIter(r.rand(n, 6).astype(np.float32),
                              r.randint(0, 4, n).astype(np.float32),
                              batch_size=batch)


def test_all_mode_op_spans_nest_in_executor_spans(tmp_path):
    prof = mt.profiler
    prof.profiler_set_config("all", str(tmp_path / "all.json"))
    exe = _mlp(mt).simple_bind(mt.cpu(), data=(10, 6), grad_req="write")
    prof.profiler_set_state("run")
    exe.forward_backward()
    out = mt.nd.relu(mt.nd.ones((3,), ctx=mt.cpu()))
    prof.profiler_set_state("stop")
    with open(tmp_path / "all.json") as f:
        events = json.load(f)["traceEvents"]
    ids = {e["args"]["span_id"]: e for e in events
           if e.get("args", {}).get("span_id")}
    ops = [e for e in events if e["cat"] == "operator"]
    names = {e["name"] for e in ops}
    assert {"FullyConnected", "Activation", "SoftmaxOutput",
            "relu"} <= names
    for e in ops:
        if e["name"] == "relu":
            assert "parent_id" not in e.get("args", {})
            continue
        parent = ids[e["args"]["parent_id"]]
        assert parent["name"] == "executor_forward"
        assert parent["pid"] == e["pid"] == "cpu(0)"
        fb = ids[parent["args"]["parent_id"]]
        assert fb["name"] == "executor_fwd_bwd"
    assert out.shape == (3,)


def test_symbolic_mode_records_no_op_spans(tmp_path):
    prof = mt.profiler
    prof.profiler_set_config("symbolic", str(tmp_path / "s.json"))
    exe = _mlp(mt).simple_bind(mt.cpu(), data=(10, 6), grad_req="write")
    prof.profiler_set_state("run")
    exe.forward_backward()
    prof.profiler_set_state("stop")
    with open(tmp_path / "s.json") as f:
        cats = {e["cat"] for e in json.load(f)["traceEvents"]}
    assert "symbolic" in cats and "operator" not in cats


def test_step_tracker_components_cover_each_fit_step(tmp_path):
    prof = mt.profiler
    prof.profiler_set_config("symbolic", str(tmp_path / "fit.json"))
    mod = mt.mod.Module(_mlp(mt), context=mt.cpu())
    prof.profiler_set_state("run")
    mod.fit(_iter(mt), num_epoch=2, optimizer_params={
        "learning_rate": 0.1})
    prof.profiler_set_state("stop")
    with open(tmp_path / "fit.json") as f:
        events = json.load(f)["traceEvents"]
    steps = [e for e in events if e["name"] == "step"]
    assert len(steps) == 8
    comps = {}
    for e in events:
        if e["name"].startswith("step:"):
            comps.setdefault(e["args"]["parent_id"], []).append(e)
    for s in steps:
        kids = comps[s["args"]["span_id"]]
        assert {k["name"] for k in kids} >= {
            "step:data_wait", "step:fwd_bwd_dispatch", "step:update",
            "step:metric", "step:sync"}
        cover = sum(k["dur"] for k in kids) / s["dur"]
        assert 0.8 <= cover <= 1.001, cover
    snap = mt.observability.snapshot()
    assert snap["module.steps"]["value"] == 8
    for c in mt.observability.instrument.STEP_COMPONENTS:
        assert snap["module.step.%s_ms" % c]["count"] == 8
    assert "device.live_bytes" in snap


def test_io_wait_and_kv_bytes_are_recorded():
    it = _iter(mt)
    batches = sum(1 for _ in it)
    kv = mt.kv.create("local")
    a = mt.nd.ones((4, 5), ctx=mt.cpu())
    kv.init(3, a)
    kv.push(3, [a, a])
    out = mt.nd.zeros((4, 5), ctx=mt.cpu())
    kv.pull(3, out=out)
    snap = mt.observability.snapshot()
    assert snap["io.batches"]["value"] == batches == 4
    assert snap["io.next_batch_wait_ms"]["count"] == 4
    assert snap["kvstore.push_bytes"]["value"] == 2 * 4 * 5 * 4
    assert snap["kvstore.pull_bytes"]["value"] == 4 * 5 * 4
    assert snap["kvstore.push_ms"]["count"] == 1


def test_collective_store_reports_exposed_comm():
    kv = mt.kv.create("tpu_ici")
    a = mt.nd.ones((8,), ctx=mt.cpu())
    kv.init(0, a)
    kv.push(0, [a, a])
    snap = mt.observability.snapshot()
    assert snap["comm.exposed_bytes"]["value"] == 8 * 4
    assert snap["comm.exposed_ms"]["count"] == 1


def test_exec_cache_counters_are_mirrored():
    ec = mt.executor_cache
    ec.clear()
    ec.reset_stats()
    sym = _mlp(mt)
    for _ in range(2):
        sym.simple_bind(mt.cpu(), data=(5, 6), grad_req="null").forward()
    s = ec.stats()
    snap = mt.observability.snapshot()
    assert s["misses"] == 1 and s["hits"] == 1 and s["traces_fwd"] == 1
    assert snap["exec_cache.misses"]["value"] == 1
    assert snap["exec_cache.hits"]["value"] == 1
    assert snap["exec_cache.traces_fwd"]["value"] == 1


def test_speedometer_telemetry_keeps_its_log_format(caplog):
    from mxnet_tpu_torch.module.base_module import BatchEndParam
    lines = []
    for tel in (False, True):
        cb = mt.callback.Speedometer(10, frequent=2, telemetry=tel)
        metric = mt.metric.create("acc")
        metric.update([mt.nd.array([1, 0], ctx=mt.cpu())],
                      [mt.nd.array([[0, 1], [1, 0]], ctx=mt.cpu())])
        caplog.clear()
        with caplog.at_level(logging.INFO):
            for nbatch in range(3):
                cb(BatchEndParam(epoch=0, nbatch=nbatch,
                                 eval_metric=metric))
        lines.append([r.getMessage() for r in caplog.records])
    fmt = [[m.split("Speed: ")[0] + m.split("samples/sec")[1]
            for m in group] for group in lines]
    assert fmt[0] == fmt[1] == ["Epoch[0] Batch [2]\t\taccuracy=1.000000"]
    snap = mt.observability.snapshot()
    assert snap["speedometer.samples_per_sec"]["value"] > 0
    assert snap["speedometer.samples_per_sec_hist"]["count"] == 1


def _served_names(pkg):
    pkg.observability.telemetry.reset()
    r = np.random.RandomState(0)
    sym = _mlp(pkg)
    params = {"fc1_weight": r.randn(8, 6), "fc1_bias": np.zeros(8),
              "fc2_weight": r.randn(4, 8), "fc2_bias": np.zeros(4)}
    params = {k: pkg.nd.array(v.astype(np.float32), ctx=pkg.cpu())
              for k, v in params.items()}
    with pkg.serving.Server(max_batch_size=2) as server:
        server.add_model("mlp", sym, params, input_shapes={"data": (6,)},
                         ctx=pkg.cpu())
        server.submit("mlp", {"data": r.rand(2, 6).astype(np.float32)})
        snap = pkg.observability.snapshot()
    return {k: v["type"] for k, v in snap.items()
            if k.startswith("serving.")}


def test_served_request_shows_up_under_the_jax_package_names():
    want = _served_names(mj)
    got = _served_names(mt)
    assert got == want
    assert got["serving.requests_total"] == "counter"
    assert got["serving.request_latency_ms.mlp"] == "histogram"
    prom = mt.observability.telemetry.to_prometheus()
    assert "# TYPE mxnet_tpu_serving_requests_total counter" in prom


def test_device_trace_writes_a_torch_profiler_chrome_trace(tmp_path):
    logdir = mt.profiler.start_jax_trace(str(tmp_path / "trace"))
    mt.nd.dot(mt.nd.ones((8, 8), ctx=mt.cpu()),
              mt.nd.ones((8, 8), ctx=mt.cpu())).asnumpy()
    path = mt.profiler.stop_jax_trace()
    assert os.path.dirname(path) == logdir
    with open(path) as f:
        assert json.load(f)["traceEvents"]
    with pytest.raises(RuntimeError):
        mt.profiler.stop_jax_trace()


def test_host_device_memory_sample_reads_no_card():
    inst = mt.observability.instrument
    assert inst.sample_device_memory() == 0
    sample = inst.last_memory_sample()
    assert sample["live_bytes"] == 0 and sample["peak_bytes"] is None


def test_libinfo_reports_the_profiler():
    assert mt.libinfo.features()["PROFILER"] is True


def test_pipeline_telemetry_matches_the_jax_package(tmp_path):
    """One epoch of the same ``io_pipeline`` in both packages: the same
    stage series and counts (decode, upload, records, uploads ahead, the
    consumer waits past the two primed pulls), gauges and ``pipe:*``
    trace events."""
    path = str(tmp_path / "t.rec")
    r = np.random.RandomState(0)
    writer = mj.recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(37):
        writer.write_idx(i, mj.recordio.pack(
            mj.recordio.IRHeader(0, float(i % 5), i, 0),
            r.rand(12).astype(np.float32).tobytes()))
    writer.close()
    got = []
    for pkg in PKGS:
        iop = pkg.io_pipeline
        pkg.observability.tracing.set_recording(True)
        pipe = iop.Pipeline(iop.RecordFileSource(path, path + ".idx"),
                            iop.NDArrayRecordDecoder((12,)), batch_size=8,
                            shuffle=True, seed=2, num_workers=2,
                            ctx=pkg.cpu())
        with pipe.as_dataiter() as it:
            batches = sum(1 for _ in it)
        pkg.observability.tracing.set_recording(False)
        snap = pkg.observability.snapshot()
        pipe_snap = {k: v.get("count", v.get("value"))
                     for k, v in snap.items() if k.startswith("io_pipeline.")
                     and not k.endswith(("_depth", "_fill"))}
        events = {e["name"] for e in
                  pkg.observability.tracing.snapshot_events()
                  if e["name"].startswith("pipe:")}
        got.append((batches, pipe_snap, events,
                    {"io_pipeline.task_queue_depth",
                     "io_pipeline.reorder_fill"} <= set(snap)))
    assert got[0] == got[1]
    assert got[1][0] == 5 and got[1][1]["io_pipeline.queue_wait_ms"] == 3
    assert got[1][2] == {"pipe:decode", "pipe:h2d", "pipe:queue_wait"}


def test_engine_pipeline_ops_record_engine_spans():
    prof = mt.profiler
    base = _iter(mt, n=40, batch=10)
    it = mt.io.EnginePipelineIter(base, depth=2)
    prof.profiler_set_state("run")
    try:
        n = sum(1 for _ in it)
    finally:
        mt.observability.tracing.set_recording(False)
        it.close()
    spans = [e for e in mt.observability.tracing.snapshot_events()
             if e["cat"] == "engine"]
    assert n == 4
    assert {e["name"] for e in spans} == {"engine_decode_augment"}
    assert len(spans) >= 4

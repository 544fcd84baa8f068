"""The port's memory and build observability against the JAX package's,
on the CPU.

``observability/memprof.py`` and the plan cache's retrace explainer:
plan counters with the memory profiler on and off, one program record a
plan build with the bound arrays' bytes, ``diff_signatures`` on the same
pairs of binds in both packages, the ``recompile_cause:*`` instants,
``is_oom``, the OOM black box (one dump a process, never overwritten,
the error unchanged), the live-tensor census, the KV pool's row and the
report that ``tools/traceview.py --memory`` renders.

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
from mxnet_tpu import executor_cache as ec_j

import mxnet_tpu_torch as mt
from mxnet_tpu_torch import executor_cache as ec_t
from mxnet_tpu_torch.convert import params_from_numpy
from mxnet_tpu_torch.observability import flight_recorder as flight_t
from mxnet_tpu_torch.observability import memprof
from mxnet_tpu_torch.observability import telemetry as tel_t
from mxnet_tpu_torch.observability import tracing as tracing_t


@pytest.fixture(autouse=True)
def _clean_slate(monkeypatch):
    for name in ("MXNET_TPU_MEMPROF", "MXNET_TPU_FLIGHT_PATH",
                 "MXNET_TPU_HEALTH"):
        monkeypatch.delenv(name, raising=False)

    def reset():
        tel_t.reset()
        tracing_t.set_recording(False)
        tracing_t.clear_events()
        flight_t.reset()
        memprof.reset()
        ec_t.reset_stats()
    reset()
    yield
    reset()


def _mlp(mx, prefix="mp"):
    net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=8,
                                name=prefix + "_fc1")
    net = mx.sym.Activation(net, act_type="relu", name=prefix + "_relu1")
    net = mx.sym.FullyConnected(net, num_hidden=4, name=prefix + "_fc2")
    return mx.sym.SoftmaxOutput(net, name="softmax")


def _fit_once(prefix, seed=0):
    """One fresh 2-batch fit over a cleared cache; (counters, params)."""
    ec_t.clear()
    ec_t.reset_stats()
    memprof.reset()
    mt.random.seed(seed)
    rng = np.random.RandomState(seed)
    x = rng.rand(16, 8).astype(np.float32)
    y = rng.randint(0, 4, (16,)).astype(np.float32)
    mod = mt.mod.Module(_mlp(mt, prefix), context=mt.cpu())
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1,
            optimizer_params={"learning_rate": 0.1})
    params = {k: v.asnumpy().copy() for k, v in mod.get_params()[0].items()}
    return ec_t.stats(), params


def _load_traceview():
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools", "traceview.py")
    spec = importlib.util.spec_from_file_location("_tv_torch_memprof", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# -- program records ---------------------------------------------------------

def test_plan_counters_and_params_identical_on_and_off(monkeypatch):
    """The memory profiler changes no plan and no number: identical plan
    counters and bitwise-identical trained parameters."""
    monkeypatch.setenv("MXNET_TPU_MEMPROF", "0")
    off, params_off = _fit_once("par")
    monkeypatch.setenv("MXNET_TPU_MEMPROF", "1")
    on, params_on = _fit_once("par")
    keys = ("hits", "misses", "evictions", "traces_fwd", "traces_fwd_bwd",
            "traces_fused_step")
    assert {k: on[k] for k in keys} == {k: off[k] for k in keys}
    assert len(on["programs"]) == len(off["programs"])
    for k in params_on:
        assert np.array_equal(params_on[k], params_off[k]), k
    assert not any(r["memory"] for r in off["programs"])
    # the fused step runs the plan itself: its own record carries memory
    assert [r["kind"] for r in on["programs"] if r["memory"]] \
        == ["fused_step"]


@pytest.mark.parametrize("grad_req,batch", [("null", 4), ("write", 6)])
def test_one_record_per_build_with_the_bound_bytes(monkeypatch, grad_req,
                                                   batch):
    monkeypatch.setenv("MXNET_TPU_MEMPROF", "1")
    ec_t.clear()
    sym = _mlp(mt, "rec%s" % grad_req)
    exe = sym.simple_bind(mt.cpu(), grad_req=grad_req, data=(batch, 8),
                          softmax_label=(batch,))
    again = sym.simple_bind(mt.cpu(), grad_req=grad_req, data=(batch, 8),
                            softmax_label=(batch,))
    assert again._prog is exe._prog  # a hit builds nothing
    recs = memprof.program_records()
    assert len(recs) == 1 and recs[0]["trace_ms"] > 0
    assert recs[0]["lower_ms"] == 0.0 and recs[0]["compile_ms"] == 0.0
    assert recs[0]["label"] == "softmax@%s" % sym.structural_hash()[:10]
    train = grad_req == "write"
    if train:
        exe.forward_backward(is_train=True)
    else:
        exe.forward(is_train=False)
    rec = exe._prog.memprof_record
    assert rec["kind"] == ("fwd_bwd" if train else "fwd")
    bound = sum(a.tensor.numel() * 4 for t in (exe.arg_dict, exe.aux_dict)
                for a in t.values())
    outs = sum(o.tensor.numel() * 4 for o in exe.outputs)
    assert rec["memory"]["argument_bytes"] == bound
    assert rec["memory"]["output_bytes"] == outs == batch * 4 * 4
    assert rec["memory"]["temp_bytes"] == 0  # the host reports no peak
    assert rec["memory"]["total_bytes"] == bound + outs
    assert ec_t.stats()["programs"][0]["memory"] == rec["memory"]


def test_fused_step_record_on_the_host(monkeypatch):
    monkeypatch.setenv("MXNET_TPU_MEMPROF", "1")
    stats, _ = _fit_once("fsr")
    kinds = [r["kind"] for r in stats["programs"]]
    assert kinds == ["fwd_bwd", "fused_step"]
    rec = stats["programs"][1]
    assert rec["label"].startswith("fused@")
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["output_bytes"] == 8 * 4 * 4
    assert stats["compile_ms"]["count"] == 0  # no capture on the host


# -- the retrace explainer ---------------------------------------------------

BINDS = {
    "base": dict(shape=(8, 6), dtype="float32", name="data",
                 grad="write", health="0"),
    "shapes": dict(shape=(16, 6), dtype="float32", name="data",
                   grad="write", health="0"),
    "dtypes": dict(shape=(8, 6), dtype="float16", name="data",
                   grad="write", health="0"),
    "names": dict(shape=(8, 6), dtype="float32", name="x",
                  grad="write", health="0"),
    "grad": dict(shape=(8, 6), dtype="float32", name="data",
                 grad="null_data", health="0"),
    "health": dict(shape=(8, 6), dtype="float32", name="data",
                   grad="write", health="1"),
    "shapes+health": dict(shape=(4, 6), dtype="float32", name="data",
                          grad="write", health="1"),
}


def _bind(pkg, spec, monkeypatch):
    """Bind one spec in one package; returns the cache key it used."""
    monkeypatch.setenv("MXNET_TPU_HEALTH", spec["health"])
    data = pkg.sym.Variable(spec["name"])
    sym = pkg.sym.FullyConnected(data, num_hidden=3, name="dsfc")
    req = {"dsfc_weight": "write", "dsfc_bias": "write",
           spec["name"]: "null" if spec["grad"] == "null_data" else "write"}
    dt = np.float16 if spec["dtype"] == "float16" else np.float32
    sym.simple_bind(pkg.cpu(), grad_req=req,
                    type_dict={spec["name"]: dt},
                    **{spec["name"]: spec["shape"]})
    ec = pkg.executor_cache
    with ec._lock:
        return next(reversed(ec._entries))


@pytest.mark.parametrize("change", sorted(set(BINDS) - {"base"}))
def test_diff_signatures_matches(change, monkeypatch):
    """The same pair of binds: the same primary cause and cause list in
    both packages (the details name the same components)."""
    got = []
    for pkg in (mj, mt):
        pkg.executor_cache.clear()
        old = _bind(pkg, BINDS["base"], monkeypatch)
        new = _bind(pkg, BINDS[change], monkeypatch)
        primary, causes, detail = pkg.executor_cache.diff_signatures(old,
                                                                     new)
        got.append((primary, causes))
        assert pkg.executor_cache.diff_signatures(old, old) == (None, [],
                                                                "")
        pkg.executor_cache.clear()
    assert got[1] == got[0], got
    assert got[1][0] is not None


def test_diff_signatures_on_hand_built_keys():
    """The JAX package's hand-built 7-part keys through the port's
    explainer, against its own."""
    def sig(shapes, dtypes=None, grad=("w",), platform="cpu", health=False,
            kernel=("auto",)):
        dtypes = dtypes or {}
        arg = tuple(sorted((n, tuple(s), dtypes.get(n, "float32"))
                           for n, s in shapes))
        return ("fp0", arg, (), tuple(grad), platform, bool(health),
                tuple(kernel))
    base = sig([("data", (8, 4))])
    for other in (sig([("data", (16, 4))], platform="tpu"),
                  sig([("data", (8, 4))], grad=("w", "b")),
                  sig([("data", (8, 4))], kernel=("force",)),
                  sig([("data2", (8, 4))]),
                  sig([("data", (8, 4))], {"data": "bfloat16"},
                      health=True)):
        assert ec_t.diff_signatures(base, other) \
            == ec_j.diff_signatures(base, other)


def test_recompile_cause_tallied_logged_and_traced(caplog):
    ec_t.clear()
    sym = _mlp(mt, "why")
    tracing_t.set_recording(True)
    with caplog.at_level(logging.INFO, logger="mxnet_tpu_torch"):
        for batch in (8, 16):
            sym.simple_bind(mt.cpu(), grad_req="write", data=(batch, 8),
                            softmax_label=(batch,))
    tracing_t.set_recording(False)
    assert ec_t.stats()["recompile_causes"] == {"shapes": 1}
    assert tel_t.snapshot()["exec_cache.recompile_cause.shapes"][
        "value"] == 1
    assert any("shapes changed" in r.getMessage() for r in caplog.records)
    names = [e["name"] for e in tracing_t.snapshot_events()
             if e.get("ph") == "i"]
    assert "recompile_cause:shapes" in names


def test_fresh_symbol_miss_has_no_cause():
    ec_t.clear()
    _mlp(mt, "fresh").simple_bind(mt.cpu(), data=(8, 8),
                                  softmax_label=(8,))
    assert ec_t.stats()["recompile_causes"] == {}


# -- the OOM black box -------------------------------------------------------

def _cuda_oom(msg="CUDA out of memory. Tried to allocate 2.00 GiB"):
    return torch.cuda.OutOfMemoryError(msg)


@pytest.mark.parametrize("exc,want", [
    (lambda: torch.cuda.OutOfMemoryError("x"), True),
    (lambda: RuntimeError("CUDA out of memory. Tried to allocate 8 MiB"),
     True),
    (lambda: RuntimeError("RESOURCE_EXHAUSTED: Out of memory"), True),
    (lambda: RuntimeError("INVALID_ARGUMENT: bad shape"), False),
    (lambda: "RESOURCE_EXHAUSTED", False),
])
def test_is_oom(exc, want):
    value = exc()
    assert memprof.is_oom(value) is want
    from mxnet_tpu.observability import memprof as memprof_j
    if "CUDA" not in str(value) and not isinstance(
            value, torch.cuda.OutOfMemoryError):
        assert memprof_j.is_oom(value) is want


def test_injected_oom_dumps_once_and_propagates(monkeypatch, tmp_path):
    """An OutOfMemoryError in the fused step propagates unchanged after
    exactly one dump with the memory report; a second OOM writes no
    second dump, and the fit loop's handler counts the same error
    once."""
    dump_path = str(tmp_path / "oom.json")
    monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH", dump_path)
    monkeypatch.setenv("MXNET_TPU_MEMPROF", "1")
    ec_t.clear()
    from mxnet_tpu_torch.module import fused_step
    boom = _cuda_oom()

    def compute(self):
        raise boom
    monkeypatch.setattr(fused_step.FusedTrainStep, "_compute", compute)
    rng = np.random.RandomState(0)
    x = rng.rand(8, 8).astype(np.float32)
    y = rng.randint(0, 4, (8,)).astype(np.float32)
    mod = mt.mod.Module(_mlp(mt, "oom"), context=mt.cpu())
    with pytest.raises(torch.cuda.OutOfMemoryError) as err:
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=8), num_epoch=1)
    assert err.value is boom
    doc = json.load(open(dump_path))
    assert doc["reason"] == "oom"
    ooms = [a for a in doc["anomalies"] if a["rule"] == "oom"]
    assert len(ooms) == 1 and ooms[0]["context"] == "fused_step"
    mem = doc["memory"]
    assert mem["kind"] == "mxnet_tpu_memory"
    assert [r["kind"] for r in mem["programs"]] == ["fwd_bwd", "fused_step"]
    assert mem["census"]["array_count"] > 0
    assert mem["device_memory"][0]["bytes_limit"] is None
    os.remove(dump_path)
    # a new OOM: counted and noted, no second dump
    assert memprof.maybe_record_oom("again", _cuda_oom()) is None
    assert not os.path.exists(dump_path)
    assert flight_t.get_recorder().anomaly_count("oom") == 2
    assert tel_t.snapshot()["memprof.oom_total"]["value"] == 2


def test_oom_dump_not_overwritten_by_a_generic_dump(monkeypatch, tmp_path):
    from mxnet_tpu_torch import serving
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    dump_path = str(tmp_path / "keep.json")
    monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH", dump_path)
    sym = _mlp(mt, "keep")
    init = {"keep_fc1_weight": np.full((8, 8), 0.1, np.float32),
            "keep_fc1_bias": np.zeros(8, np.float32),
            "keep_fc2_weight": np.full((4, 8), 0.1, np.float32),
            "keep_fc2_bias": np.zeros(4, np.float32)}
    args, _ = params_from_numpy(init, ctx=mt.cpu())
    server = serving.Server(max_batch_size=2)
    try:
        served = server.add_model("m", sym, args,
                                  input_shapes={"data": (8,)},
                                  ctx=mt.cpu())
        server.warmup()

        def boom(bucket, inputs):
            raise _cuda_oom()
        served.run_batch = boom
        for _ in range(2):
            with pytest.raises(torch.cuda.OutOfMemoryError):
                server.submit("m", np.ones((1, 8), np.float32), timeout=30)
    finally:
        server.close(drain=True, timeout=30)
    doc = json.load(open(dump_path))
    assert doc["reason"] == "oom" and "memory" in doc
    assert [a["context"] for a in doc["anomalies"]] == ["serving:m"]
    tv = _load_traceview()
    assert tv.main(["--flight", dump_path]) == 1
    assert tv.main(["--memory", dump_path]) == 0


def test_executor_dispatch_oom_guard(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH", str(tmp_path / "e.json"))
    exe = _mlp(mt, "eoom").simple_bind(mt.cpu(), data=(4, 8),
                                       softmax_label=(4,))

    def boom(*args, **kwargs):
        raise _cuda_oom()
    monkeypatch.setattr(exe._prog, "evaluate", boom)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        exe.forward(is_train=False)
    doc = json.load(open(str(tmp_path / "e.json")))
    assert doc["anomalies"][0]["context"] == "executor_forward"


def test_other_errors_write_nothing(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH", str(tmp_path / "n.json"))
    assert memprof.maybe_record_oom("x", ValueError("nope")) is None
    assert not os.path.exists(str(tmp_path / "n.json"))


# -- census, pools, devices, report ------------------------------------------

def test_census_groups_by_shape_and_dtype_counting_storage_once():
    pins = [torch.zeros((17, 23)) for _ in range(3)]
    views = [p[1:] for p in pins]  # views add nothing
    half = torch.zeros((17, 23), dtype=torch.bfloat16)
    census = memprof.live_array_census(limit=10000, device_type="cpu")
    group = [g for g in census["groups"]
             if g["shape"] == [17, 23] and g["dtype"] == "<f4"]
    assert group and group[0]["count"] == 3
    assert group[0]["total_bytes"] == 3 * 17 * 23 * 4
    bf = [g for g in census["groups"]
          if g["shape"] == [17, 23] and g["dtype"] == "bfloat16"]
    assert bf and bf[0]["total_bytes"] == 17 * 23 * 2
    assert census["total_bytes"] >= group[0]["total_bytes"]
    del pins, views, half


def test_device_memory_rows_on_the_host():
    rows = memprof.device_memory()
    assert rows == [{"device": "cpu:0", "bytes_in_use": None,
                     "peak_bytes_in_use": None, "bytes_limit": None}]


def test_kv_pool_row(monkeypatch):
    from mxnet_tpu_torch.serving.kv_cache import KVBlockPool
    pool = KVBlockPool(num_layers=2, num_heads=2, head_dim=4, num_pages=6,
                       page_size=4, name="kv_test", ctx=mt.cpu())
    try:
        pages = [pool.alloc() for _ in range(3)]
        rows = [r for r in memprof.pool_records() if r["name"] == "kv_test"]
        assert len(rows) == 1
        row = rows[0]
        assert row["page_bytes"] == pool.page_bytes == 2 * 2 * 4 * 2 * 4 * 4
        assert row["total_pages"] == 6
        assert row["pages_used"] == pool.pages_used() == 3
        assert row["bytes_used"] == pool.pages_used() * pool.page_bytes
        del pages
    finally:
        pool.close()
    assert not [r for r in memprof.pool_records() if r["name"] == "kv_test"]


def test_write_report_rendered_by_traceview(monkeypatch, tmp_path):
    monkeypatch.setenv("MXNET_TPU_MEMPROF", "1")
    _fit_once("rep")
    path = memprof.write_report(str(tmp_path / "mem.json"))
    doc = json.load(open(path))
    assert doc["kind"] == "mxnet_tpu_memory" and doc["memprof_enabled"]
    assert any(r["memory"] for r in doc["programs"])
    tv = _load_traceview()
    assert tv.main(["--memory", path]) == 0
    text = tv.summarize_memory(doc)
    assert "per-program table" in text and "fused_step" in text
    assert "live-array census" in text

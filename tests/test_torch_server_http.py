"""The port's HTTP front end, checkpoint loading and SIGTERM drain.

- Every route of ``Server(serve_http=True)``: ``POST
  /v1/models/<name>:predict`` and ``/predict/<name>`` answer what
  ``submit`` answers, bit for bit (f32 survives JSON exactly);
  ``GET /healthz`` and ``/metrics`` (the metrics registry in the
  Prometheus text format, with the JAX package's names); typed
  rejections map to their status (404, 400, 413).
- ``load_model`` of a checkpoint the JAX package wrote with
  ``save_checkpoint``: its responses agree with the JAX ``Predictor`` on
  the same inputs within atol=rtol=1e-5 (f32, sums in another order).
- ``install_signal_handlers``: SIGTERM drains within the deadline, in a
  subprocess (a handler must not touch the test runner's signals).

Models run on ``mx.cpu()``; each server is closed by its fixture.
"""
import json
import os
import subprocess
import sys
from urllib import request as urlreq
from urllib.error import HTTPError

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu.predict import Predictor as JPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving, threads

FEAT = 6
PARITY_TOL = dict(atol=1e-5, rtol=1e-5)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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
    r = np.random.RandomState(3)
    return {n: r.normal(0, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}


@pytest.fixture
def http_server(weights):
    server = serving.Server(max_batch_size=4, batch_window_ms=1.0,
                            serve_http=True)
    server.add_model("mlp", _mlp(mx), {k: mx.nd.array(v, ctx=mx.cpu())
                                       for k, v in weights.items()},
                     input_shapes={"data": (FEAT,)}, ctx=mx.cpu())
    server.warmup()
    host, port = server.http_address
    yield server, "http://%s:%d" % (host, port)
    server.close()
    for t in threads.live_package_threads():
        t.join(5)
    assert not threads.live_package_threads()


def _post(url, body):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urlreq.Request(url, data=data,
                         headers={"Content-Type": "application/json"})
    with urlreq.urlopen(req, timeout=30) as r:
        return r.status, json.loads(r.read())


def _status(fn):
    with pytest.raises(HTTPError) as err:
        fn()
    body = json.loads(err.value.read())
    return err.value.code, body


@pytest.mark.parametrize("route", ["/v1/models/mlp:predict",
                                   "/predict/mlp"])
def test_predict_routes_answer_what_submit_answers(http_server, route):
    server, base = http_server
    x = np.random.RandomState(5).rand(3, FEAT).astype(np.float32)
    status, out = _post(base + route, {"inputs": {"data": x.tolist()}})
    assert status == 200 and out["model"] == "mlp"
    got = np.asarray(out["outputs"][0], dtype=np.float32)
    assert np.array_equal(got, server.submit("mlp", {"data": x})[0])
    # a bare array serves a single-input model
    status, out = _post(base + route, {"data": x[0].tolist()})
    assert status == 200 and len(out["outputs"][0]) == 1


def test_healthz_and_metrics(http_server):
    server, base = http_server
    server.submit("mlp", {"data": np.zeros((1, FEAT), np.float32)})
    with urlreq.urlopen(base + "/healthz", timeout=30) as r:
        assert json.loads(r.read()) == {"status": "ok", "models": ["mlp"]}
    with urlreq.urlopen(base + "/metrics", timeout=30) as r:
        assert r.headers["Content-Type"].startswith("text/plain")
        prom = r.read().decode()
    assert "# TYPE mxnet_tpu_serving_requests_total counter" in prom
    assert 'mxnet_tpu_serving_request_latency_ms_bucket{le="+Inf"}' in prom
    assert "mxnet_tpu_serving_batches " in prom


def test_rejections_map_to_http_statuses(http_server):
    _, base = http_server
    ok_body = {"inputs": {"data": [[0.5] * FEAT]}}
    cases = [
        (lambda: _post(base + "/v1/models/ghost:predict", ok_body), 404,
         "model_not_found"),
        (lambda: _post(base + "/v1/models/mlp:predict", b"not json"), 400,
         "bad_request"),
        (lambda: _post(base + "/v1/models/mlp:predict", b"[1, 2]"), 400,
         "bad_request"),
        (lambda: _post(base + "/v1/models/mlp:predict", {"x": 1}), 400,
         "bad_request"),
        (lambda: _post(base + "/v1/models/mlp:predict",
                       {"inputs": {"data": [[0.5] * (FEAT + 1)]}}), 400,
         "bad_request"),
        (lambda: _post(base + "/v1/models/mlp:predict",
                       {"inputs": {"data": [[0.5] * FEAT] * 5}}), 413,
         "request_too_large"),
    ]
    for fn, code, reason in cases:
        got, body = _status(fn)
        assert (got, body["reason"]) == (code, reason)
    got, body = _status(lambda: _post(base + "/v2/nothing", ok_body))
    assert got == 404 and body["error"] == "not_found"
    got, body = _status(lambda: urlreq.urlopen(base + "/nothing",
                                               timeout=30))
    assert got == 404 and body["path"] == "/nothing"


def test_load_model_of_a_jax_checkpoint(tmp_path, weights):
    prefix = str(tmp_path / "mlp")
    jargs = {k: jmx.nd.array(v) for k, v in weights.items()}
    jmx.model.save_checkpoint(prefix, 3, _mlp(jmx), jargs, {})
    server = serving.Server(max_batch_size=4, batch_window_ms=1.0)
    try:
        server.load_model("ckpt", prefix, 3, {"data": (FEAT,)},
                          ctx=mx.cpu())
        server.warmup()
        x = np.random.RandomState(8).rand(4, FEAT).astype(np.float32)
        got = server.submit("ckpt", {"data": x})[0]
    finally:
        server.close()
    want = JPredictor(prefix + "-symbol.json", prefix + "-0003.params",
                      {"data": (4, FEAT)})
    want.forward(data=x)
    np.testing.assert_allclose(got, want.get_output(0).asnumpy(),
                               **PARITY_TOL)
    # the registry alone, as a custom front end would use it
    model = serving.ModelRegistry().load(
        "ckpt", prefix, 3, {"data": (FEAT,)}, max_batch_size=4, ctx=mx.cpu())
    assert np.array_equal(model.run_batch(4, {"data": x})[0], got)


_SIGTERM_CHILD = r"""
import json, os, signal, sys, time
import numpy as np
import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving
net = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=3,
                            name="fc")
args = {"fc_weight": mx.nd.ones((3, 4), ctx=mx.cpu()),
        "fc_bias": mx.nd.zeros((3,), ctx=mx.cpu())}
server = serving.Server(max_batch_size=1, batch_window_ms=0.0,
                        auto_start=False)
server.add_model("m", net, args, input_shapes={"data": (4,)},
                 ctx=mx.cpu())
server.warmup()
installed = server.install_signal_handlers(drain_deadline_s=0.2)
model = server.registry.get("m")
real = model.run_batch
def slow(bucket, padded):
    time.sleep(0.6)
    return real(bucket, padded)
model.run_batch = slow
futs = [server.submit_async("m", {"data": np.ones((1, 4), np.float32)})
        for _ in range(4)]
server.start()
time.sleep(0.1)
os.kill(os.getpid(), signal.SIGTERM)
deadline = time.monotonic() + 5.0
while not server.closed and time.monotonic() < deadline:
    time.sleep(0.01)
out = {"installed": signal.SIGTERM in installed, "closed": server.closed,
       "completed": 0, "rejected": 0}
for f in futs:
    try:
        f.result(timeout=30)
        out["completed"] += 1
    except serving.ServerClosed:
        out["rejected"] += 1
try:
    server.submit("m", {"data": np.ones((1, 4), np.float32)})
    out["after"] = "served"
except serving.ServerClosed:
    out["after"] = "server_closed"
print(json.dumps(out))
"""


def test_sigterm_drains_within_the_deadline():
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _SIGTERM_CHILD], env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["installed"] and out["closed"]
    assert out["completed"] >= 1, out  # the in-flight batch finishes
    assert out["rejected"] >= 1, out   # the queue past the deadline sheds
    assert out["completed"] + out["rejected"] == 4
    assert out["after"] == "server_closed"


def test_default_context_is_the_card(weights):
    """Not given ``ctx``, a model binds on ``gpu(0)``: without a card
    ``add_model`` and ``load_model`` raise instead of serving on the
    host."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default context works there")
    server = serving.Server(max_batch_size=2, auto_start=False)
    try:
        with pytest.raises(mx.base.MXNetError, match="CUDA"):
            server.add_model("mlp", _mlp(mx), weights,
                             input_shapes={"data": (FEAT,)})
        with pytest.raises(mx.base.MXNetError, match="CUDA"):
            mx.ops.quantize.calibrate(
                _mlp(mx), weights, {}, {"data": (2, FEAT)},
                [{"data": np.zeros((2, FEAT), np.float32)}])
    finally:
        server.close(drain=False)

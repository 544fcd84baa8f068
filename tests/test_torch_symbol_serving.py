"""The port's symbol, NDArray and serving path against the JAX package.

A small ``TransformerLM`` (vocab 64, width 256, 2 heads of 128, 2
layers, 16 tokens) exported by the JAX package's Gluon is the shared
artifact: its graph JSON and ``.params`` file load in the port, the
port's own builder writes the same JSON, and both packages serve it.
The JAX server runs its Pallas flash kernel in interpret mode
(``MXNET_TPU_PALLAS_ATTN=1``); the port runs on ``mx.cpu()``, where the
kernel wrapper takes its plain version.  Logits agree within
atol=rtol=1e-4 (f32 on both sides; twelve chained ops reassociate sums).
"""
import json

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu.gluon.model_zoo.transformer import TransformerLM
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import threads
from mxnet_tpu_torch.models import transformer_lm_symbol
from mxnet_tpu_torch.serving import ModelNotFound, RequestTooLarge

CFG = dict(embed_dim=256, num_heads=2, num_layers=2, seq_len=16)
VOCAB = 64
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """The JAX Gluon export: (symbol json text, params path, {name: np}).
    Built under a fresh name scope, so its prefix is ``transformerlm0_``
    whatever another test file built before it in this process."""
    jmx.random.seed(3)
    with JNameManager():
        lm = TransformerLM(VOCAB, **CFG)
    lm.initialize(jmx.initializer.Xavier())
    lm.hybridize()
    lm(jmx.nd.array(np.zeros((1, CFG["seq_len"]), np.float32)))
    prefix = str(tmp_path_factory.mktemp("lm") / "lm")
    lm.export(prefix)
    with open(prefix + "-symbol.json") as f:
        text = f.read()
    params = prefix + "-0000.params"
    arrays = {k: v.asnumpy() for k, v in jmx.nd.load(params).items()}
    return text, params, arrays


def _tokens(rows, seed):
    return np.random.RandomState(seed).randint(
        0, VOCAB, (rows, CFG["seq_len"])).astype(np.float32)


def _ops(text):
    return [(n["op"], n["name"]) for n in json.loads(text)["nodes"]]


def _no_threads_left():
    for t in threads.live_package_threads():
        t.join(5)
    return not threads.live_package_threads()


# -- graph and parameter formats ----------------------------------------------

def test_gluon_export_loads_in_the_port(exported):
    text, _, _ = exported
    sym = mx.sym.load_json(text)
    assert sym.tojson() == text
    assert sym.list_arguments() == jmx.sym.load_json(text).list_arguments()
    names = [n for _, n in _ops(sym.tojson())]
    # exported graphs repeat node names: keyed by index, they survive
    assert names.count("fwd") == 2 * CFG["num_layers"] + 2
    assert names.count("attn") == CFG["num_layers"]


def test_port_builder_writes_the_gluon_graph(exported):
    text, _, _ = exported
    sym = transformer_lm_symbol(VOCAB, **CFG)
    assert sym.tojson() == text
    jsym = jmx.sym.load_json(sym.tojson())
    assert jsym.list_arguments() == sym.list_arguments()
    assert _ops(jsym.tojson()) == _ops(sym.tojson())
    assert jsym.tojson() == sym.tojson()
    assert mx.sym.load_json(text).structural_hash() == sym.structural_hash()


def test_shape_inference_matches_jax(exported):
    text, _, _ = exported
    want = jmx.sym.load_json(text).infer_shape(data=(3, CFG["seq_len"]))
    got = mx.sym.load_json(text).infer_shape(data=(3, CFG["seq_len"]))
    assert [[tuple(s) for s in g] for g in got] == \
        [[tuple(s) for s in w] for w in want]


def test_params_file_round_trips_bitwise(exported, tmp_path):
    _, params, arrays = exported
    loaded = mx.nd.load(params)
    assert sorted(loaded) == sorted(arrays)
    out = str(tmp_path / "port.params")
    mx.nd.save(out, loaded)
    with open(out, "rb") as a, open(params, "rb") as b:
        assert a.read() == b.read()


def test_port_params_load_in_jax(tmp_path):
    r = np.random.RandomState(5)
    data = {"w": mx.nd.array(r.normal(size=(3, 4)).astype(np.float32),
                             ctx=mx.cpu()),
            "ids": mx.nd.array(np.arange(6, dtype=np.int32), ctx=mx.cpu()),
            "h": mx.nd.array(r.normal(size=(5,)), ctx=mx.cpu(),
                             dtype="bfloat16")}
    path = str(tmp_path / "p.params")
    mx.nd.save(path, data)
    back = jmx.nd.load(path)
    assert "bfloat16" in str(back["h"].dtype)
    for k in ("w", "ids"):
        assert np.dtype(back[k].dtype) == np.dtype(data[k].dtype)
    for k, v in data.items():
        np.testing.assert_array_equal(
            np.asarray(back[k].asnumpy(), np.float32),
            np.asarray(v.asnumpy(), np.float32))
    jpath = str(tmp_path / "j.params")
    jmx.nd.save(jpath, back)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    again = mx.nd.load(jpath)
    assert again["h"].tensor.dtype == torch.bfloat16


# -- the serving path ------------------------------------------------------------

def test_server_matches_jax_server(exported, monkeypatch):
    text, params, arrays = exported
    monkeypatch.setenv("MXNET_TPU_PALLAS_ATTN", "1")
    requests = [_tokens(r, seed=10 + i) for i, r in enumerate((1, 3, 2, 4))]
    jargs = {k[4:]: v for k, v in jmx.nd.load(params).items()}
    with jmx.serving.Server(max_batch_size=4) as jserver:
        jserver.add_model("lm", jmx.sym.load_json(text), jargs,
                          input_shapes={"data": (CFG["seq_len"],)})
        jserver.warmup()
        want = [jserver.submit("lm", {"data": x})[0] for x in requests]

    arg_params, aux_params = mx.convert.params_from_numpy(arrays, mx.cpu())
    assert not aux_params
    server = mx.serving.Server(max_batch_size=4)
    try:
        server.add_model("lm", mx.sym.load_json(text), arg_params,
                         input_shapes={"data": (CFG["seq_len"],)},
                         ctx=mx.cpu())
        report = server.warmup(verify=True)["lm"]
        assert report["buckets"] == [1, 2, 4]
        assert report["traces_verify_pass"] == 0
        with mx.executor_cache.watch_traces() as w:
            futs = [server.submit_async("lm", {"data": x}) for x in requests]
            got = [f.result(timeout=120)[0] for f in futs]
        assert w.total() == 0
    finally:
        server.close()
    assert _no_threads_left()
    for g, x, want_g in zip(got, requests, want):
        assert g.shape == (x.shape[0], CFG["seq_len"], VOCAB)
        np.testing.assert_allclose(g, want_g, **LOGIT_TOL)


def test_rejections_are_typed(exported):
    text, _, arrays = exported
    arg_params, _ = mx.convert.params_from_numpy(arrays, mx.cpu())
    with mx.serving.Server(max_batch_size=2) as server:
        server.add_model("lm", mx.sym.load_json(text), arg_params,
                         input_shapes={"data": (CFG["seq_len"],)},
                         ctx=mx.cpu())
        with pytest.raises(ModelNotFound):
            server.submit("nope", _tokens(1, seed=0))
        with pytest.raises(RequestTooLarge):
            server.submit("lm", _tokens(3, seed=0))
        counters = mx.serving.metrics.snapshot()["counters"]
        assert counters["serving.rejected_total.model_not_found"] >= 1
        assert counters["serving.rejected_total.request_too_large"] >= 1
    assert _no_threads_left()


def test_predictor_buckets_share_weights(exported):
    text, _, arrays = exported
    arg_params, _ = mx.convert.params_from_numpy(arrays, mx.cpu())
    base = mx.Predictor(text, {"arg:" + k: v for k, v in arg_params.items()},
                        {"data": (1, CFG["seq_len"])}, ctx=mx.cpu())
    assert base.get_output_shape() == (1, CFG["seq_len"], VOCAB)
    wide = base.reshaped({"data": (4, CFG["seq_len"])})
    name = "transformerlm0_head_weight"
    assert wide._exe.arg_dict[name] is base._exe.arg_dict[name]
    x = _tokens(4, seed=7)
    wide.forward(data=x)
    base.forward(data=x[:1])
    np.testing.assert_allclose(wide.get_output(0).asnumpy()[:1],
                               base.get_output(0).asnumpy(), atol=1e-5,
                               rtol=1e-5)


def test_executor_reshape_flags(exported):
    text, _, _ = exported
    exe = mx.sym.load_json(text).simple_bind(mx.cpu(),
                                             data=(2, CFG["seq_len"]))
    with pytest.raises(mx.MXNetError):
        exe.reshape(data=(4, CFG["seq_len"]))  # grows without permission
    big = exe.reshape(allow_up_sizing=True, data=(4, CFG["seq_len"]))
    assert big.arg_dict["data"].shape == (4, CFG["seq_len"])
    w = "transformerlm0_embed_weight"
    assert big.arg_dict[w] is exe.arg_dict[w]


def test_default_context_is_the_card():
    assert mx.current_context() == mx.gpu(0)
    x = np.zeros((2, 3), np.float32)
    if torch.cuda.is_available():
        assert mx.nd.array(x).tensor.is_cuda
        return
    with pytest.raises(mx.MXNetError):
        mx.nd.array(x)
    with pytest.raises(mx.MXNetError):
        mx.convert.params_from_numpy({"w": x})
    sym = transformer_lm_symbol(VOCAB, **CFG)
    with pytest.raises(mx.MXNetError):
        mx.Predictor(sym.tojson(), {}, {"data": (1, CFG["seq_len"])})
    with mx.serving.Server(max_batch_size=1) as server:
        with pytest.raises(mx.MXNetError):
            server.add_model("lm", sym, {},
                             input_shapes={"data": (CFG["seq_len"],)})
    assert _no_threads_left()
    assert mx.nd.array(x, ctx=mx.cpu()).context == mx.cpu()

"""The port's int8 path (``ops/quantize.py``) against the JAX package's.

- ``quantize_weight`` is bit for bit the JAX package's.
- ``quantize_symbol`` writes the JAX package's graph JSON byte for byte,
  with equal int8 weights and scales, dynamic, calibrated and with
  ``skip=``.
- Both quantized ops: the int8 activations and the int32 accumulators
  are exactly the JAX package's (an integer product has one right
  answer), and the f32 outputs agree within atol=rtol=1e-5 (the same
  rescale in the same order; f32 rounding of the bias add may differ),
  over stride, pad, dilation, groups, ``no_bias``, dynamic and
  calibrated ranges.  The card's im2col + padded-GEMM route runs here
  with the plain integer product in place of cuBLAS: it must equal the
  plain convolution bit for bit.
- ``calibrate`` agrees with the JAX package's within rtol=1e-6, and a
  ``CalibrationTable`` written by either package loads in the other.
- ``Symbol.get_children`` (the logits subgraph int8 serving binds)
  gives the JAX package's graph.
- ``Predictor(quantize="int8")`` on ``bench.py``'s convnet: outputs
  within atol=1e-5 of the JAX package's int8 predictor and within 0.05,
  same argmax, of the port's f32 one (the JAX test's rule).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax import lax

import mxnet_tpu as jmx
from mxnet_tpu import serving as jserving
from mxnet_tpu.ops import quantize as jq
from mxnet_tpu.ops.nn import _conv_dn
from mxnet_tpu.predict import Predictor as JPredictor

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import serving
from mxnet_tpu_torch.ops import quantize as Q
from mxnet_tpu_torch.predict import Predictor

OUT_TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed):
    return np.random.RandomState(seed)


def test_quantize_weight_is_the_jax_packages():
    for shape, axis in (((6, 10), 0), ((8, 3, 3, 3), 0), ((5, 7), 1)):
        w = _rng(9).randn(*shape).astype(np.float32)
        w[0] = 0.0  # an all-zero channel takes the 1e-12 floor
        q, s = Q.quantize_weight(w, axis=axis)
        jqw, js = jq.quantize_weight(w, axis=axis)
        assert q.dtype == np.int8 and np.array_equal(q, jqw)
        assert s.dtype == np.float32 and np.array_equal(s, js)


# -- the ops ------------------------------------------------------------------

CONV_CASES = [  # N, C, H, W, F, k, stride, pad, dilate, groups, no_bias, act
    (2, 3, 9, 9, 8, 3, 1, 1, 1, 1, False, 0.0),
    (2, 4, 11, 10, 6, 3, 2, 0, 1, 2, False, 0.0),
    (1, 4, 12, 12, 8, 3, 1, 2, 2, 1, True, 0.0),
    (3, 8, 5, 6, 16, 1, 1, 0, 1, 4, False, 0.02),
    (2, 3, 15, 15, 8, 7, 2, 3, 1, 1, True, 0.0),
]


def _jax_conv_acc(x, wq, act, stride, pad, dilate, groups):
    xq, _ = jq._quantize_act(jnp.asarray(x), act)
    acc = lax.conv_general_dilated(
        xq, jnp.asarray(wq), window_strides=stride,
        padding=[(p, p) for p in pad], rhs_dilation=dilate,
        dimension_numbers=_conv_dn(2), feature_group_count=groups,
        preferred_element_type=jnp.int32)
    return np.asarray(xq), np.asarray(acc)


@pytest.mark.parametrize("case", CONV_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_quantized_conv_matches_the_jax_op(case):
    n, c, h, w, f, k, s, p, d, g, no_bias, act = case
    r = _rng(1)
    x = r.randn(n, c, h, w).astype(np.float32)
    wq = r.randint(-127, 128, (f, c // g, k, k)).astype(np.int8)
    scale = (r.rand(f).astype(np.float32) + 0.5) * 1e-2
    bias = r.randn(f).astype(np.float32)
    attrs = dict(kernel=(k, k), stride=(s, s), pad=(p, p), dilate=(d, d),
                 num_filter=f, num_group=g, no_bias=no_bias, act_scale=act)
    want_xq, want_acc = _jax_conv_acc(x, wq, act, (s, s), (p, p), (d, d), g)
    xq, _ = Q.quantize_act(torch.from_numpy(x), act)
    assert np.array_equal(xq.numpy(), want_xq)
    acc = Q.int8_conv(xq, torch.from_numpy(wq), (s, s), (p, p), (d, d), g)
    assert acc.dtype == torch.int32
    assert np.array_equal(acc.numpy(), want_acc)
    # the card's route: int8 im2col into a zero-padded GEMM operand
    route = Q.im2col_conv(xq, torch.from_numpy(wq), (s, s), (p, p), (d, d),
                          g, Q.plain_int8_matmul)
    assert torch.equal(route, acc)
    rest = () if no_bias else (bias,)
    want = np.asarray(jq._quantized_convolution(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
        *[jnp.asarray(b) for b in rest], **attrs))
    got = Q._quantized_convolution(
        torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scale),
        *[torch.from_numpy(b) for b in rest], **attrs)
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)


FC_CASES = [  # data shape, hidden, flatten, no_bias, act
    ((4, 3, 5, 5), 10, True, False, 0.0),
    ((3, 147), 20, True, True, 0.0),
    ((2, 6, 12), 7, False, False, 0.0),
    ((5, 16), 9, True, False, 0.05),
]


@pytest.mark.parametrize("case", FC_CASES, ids=lambda c: "-".join(
    map(str, c)))
def test_quantized_fc_matches_the_jax_op(case):
    shape, hidden, flatten, no_bias, act = case
    r = _rng(2)
    x = r.randn(*shape).astype(np.float32)
    k = int(np.prod(shape[1:])) if flatten else shape[-1]
    wq = r.randint(-127, 128, (hidden, k)).astype(np.int8)
    scale = (r.rand(hidden).astype(np.float32) + 0.5) * 1e-2
    bias = r.randn(hidden).astype(np.float32)
    x2 = x.reshape(shape[0], -1) if flatten else x
    jxq, _ = jq._quantize_act(jnp.asarray(x2), act)
    want_acc = np.asarray(lax.dot_general(
        jxq, jnp.asarray(wq), (((x2.ndim - 1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32))
    xq, _ = Q.quantize_act(torch.from_numpy(x2), act)
    assert np.array_equal(xq.numpy(), np.asarray(jxq))
    flat = xq.reshape(-1, k)
    acc = Q.int8_matmul(flat, torch.from_numpy(wq))
    assert np.array_equal(acc.reshape(want_acc.shape).numpy(), want_acc)
    assert torch.equal(Q.padded_matmul(flat, torch.from_numpy(wq),
                                       Q.plain_int8_matmul), acc)
    attrs = dict(num_hidden=hidden, flatten=flatten, no_bias=no_bias,
                 act_scale=act)
    rest = () if no_bias else (bias,)
    want = np.asarray(jq._quantized_fully_connected(
        jnp.asarray(x), jnp.asarray(wq), jnp.asarray(scale),
        *[jnp.asarray(b) for b in rest], **attrs))
    got = Q._quantized_fully_connected(
        torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(scale),
        *[torch.from_numpy(b) for b in rest], **attrs)
    np.testing.assert_allclose(got.numpy(), want, **OUT_TOL)


def test_round_half_to_even_like_jnp():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    xq, _ = Q.quantize_act(x, 1.0)
    jxq, _ = jq._quantize_act(jnp.asarray(x.numpy()), 1.0)
    assert xq.tolist() == [[0, 2, 2, 0, -2, 127]] == np.asarray(jxq).tolist()


def test_int8_inputs_round_the_same_on_every_device():
    # int8 serving rounds what inference BatchNorm and average pooling
    # feed it, so card and host agree only if these round exactly: the
    # correctly rounded f32 sqrt then an IEEE reciprocal (numpy's), and a
    # true division by the window size (the tests on the card hold the
    # card to the host bit for bit)
    r = _rng(4)
    x = r.normal(0, 2, (2, 4096, 3, 3)).astype(np.float32)
    gamma, beta, mean = (r.normal(0, 1, 4096).astype(np.float32)
                         for _ in range(3))
    var = r.uniform(1e-3, 5, 4096).astype(np.float32)
    y = mx.nd.BatchNorm(*[mx.nd.array(v, ctx=mx.cpu()) for v in
                          (x, gamma, beta, mean, var)],
                        eps=2e-5, fix_gamma=False)
    inv = np.float32(1) / np.sqrt(var + np.float32(2e-5))
    c = (slice(None), None, None)
    want = (x - mean[c]) * inv[c] * gamma[c] + beta[c]
    np.testing.assert_array_equal(y.asnumpy(), want)
    pooled = mx.nd.Pooling(y, kernel=(3, 3), pool_type="avg",
                           global_pool=True).asnumpy()[:, :, 0, 0]
    total = np.zeros(x.shape[:2], np.float32)
    for i in range(3):
        for j in range(3):
            total += want[:, :, i, j]
    np.testing.assert_array_equal(pooled, total / np.float32(9))


# -- the graph rewrite and calibration ----------------------------------------

def _convnet(pkg):
    net = pkg.sym.Convolution(pkg.sym.Variable("data"), kernel=(3, 3),
                              num_filter=8, pad=(1, 1), name="conv1")
    net = pkg.sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = pkg.sym.Activation(net, act_type="relu", name="relu1")
    net = pkg.sym.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max", name="pool1")
    net = pkg.sym.Flatten(net, name="flat1")
    net = pkg.sym.FullyConnected(net, num_hidden=4, name="fc1")
    return pkg.sym.SoftmaxOutput(net, name="softmax")


@pytest.fixture(scope="module")
def convnet():
    """(port symbol, JAX symbol, {arg: numpy}, {aux: numpy})."""
    sym, jsym = _convnet(mx), _convnet(jmx)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(1, 3, 8, 8))
    r = _rng(3)
    args = {n: r.normal(0, 0.3, s).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    auxs = {n: (r.rand(*s) + 0.5 if "var" in n else r.randn(*s) * 0.1)
            .astype(np.float32)
            for n, s in zip(sym.list_auxiliary_states(), aux_shapes)}
    return sym, jsym, args, auxs


def test_logits_subgraph_is_the_jax_packages(convnet):
    """``get_children()[0]``, the graph below the loss head that int8
    serving of logits binds, as in the JAX package."""
    sym, jsym, _, _ = convnet
    assert sym.get_children().list_outputs() == \
        jsym.get_children().list_outputs()
    assert sym.get_children()[0].tojson() == jsym.get_children()[0].tojson()
    assert mx.sym.Variable("x").get_children() is None


def _nd(pkg, arrays, **kw):
    return {k: pkg.nd.array(v, **kw) for k, v in arrays.items()}


@pytest.mark.parametrize("mode", ["dynamic", "calibrated", "skip"])
def test_quantize_symbol_writes_the_jax_graph(convnet, mode):
    sym, jsym, args, auxs = convnet
    table = {"conv1": 0.0123, "fc1": 0.5} if mode == "calibrated" else None
    skip = ("fc1",) if mode == "skip" else ()
    qsym, qargs, qauxs = Q.quantize_symbol(
        sym, _nd(mx, args, ctx=mx.cpu()), _nd(mx, auxs, ctx=mx.cpu()),
        calibration=table, skip=skip)
    jqsym, jqargs, _ = jq.quantize_symbol(
        jsym, _nd(jmx, args), _nd(jmx, auxs), calibration=table, skip=skip)
    assert qsym.tojson() == jqsym.tojson()
    assert sorted(qargs) == sorted(jqargs)
    for k, v in jqargs.items():
        assert qargs[k].dtype == v.dtype, k
        assert np.array_equal(qargs[k].asnumpy(), v.asnumpy()), k
    assert sorted(qauxs) == sorted(auxs)
    ops = {n["name"]: n["op"] for n in __import__("json").loads(
        qsym.tojson())["nodes"]}
    assert ops["conv1"] == "_contrib_quantized_conv"
    assert ops["fc1"] == ("FullyConnected" if skip
                          else "_contrib_quantized_fc")


def test_calibrate_matches_the_jax_package(convnet):
    sym, jsym, args, auxs = convnet
    r = _rng(4)
    batches = [{"data": r.rand(4, 3, 8, 8).astype(np.float32)}
               for _ in range(3)]
    table = Q.calibrate(sym, args, auxs, {"data": (4, 3, 8, 8)}, batches,
                        ctx=mx.cpu())
    jtable = jq.calibrate(jsym, _nd(jmx, args), _nd(jmx, auxs),
                          {"data": (4, 3, 8, 8)}, batches)
    assert sorted(table) == sorted(jtable) == ["conv1", "fc1"]
    for k in table:
        np.testing.assert_allclose(table[k], jtable[k], rtol=1e-6)
    # the serialized layout reads in both packages
    assert Q.CalibrationTable.loads(jtable.dumps()) == jtable
    assert jq.CalibrationTable.loads(table.dumps()) == table
    assert table.describe()["slots"] == jtable.describe()["slots"]


@pytest.mark.parametrize("calibrated", [False, True])
def test_int8_predictor_matches_the_jax_predictor(convnet, calibrated):
    sym, jsym, args, auxs = convnet
    r = _rng(5)
    x = r.rand(8, 3, 8, 8).astype(np.float32)
    table = Q.calibrate(sym, args, auxs, {"data": (8, 3, 8, 8)},
                        [{"data": x}], ctx=mx.cpu()) if calibrated else None
    blob = {"arg:%s" % k: v for k, v in args.items()}
    blob.update({"aux:%s" % k: v for k, v in auxs.items()})
    p8 = Predictor(sym.tojson(), _nd(mx, blob, ctx=mx.cpu()),
                   {"data": (8, 3, 8, 8)}, ctx=mx.cpu(), quantize="int8",
                   calibration=table)
    p32 = Predictor(sym.tojson(), _nd(mx, blob, ctx=mx.cpu()),
                    {"data": (8, 3, 8, 8)}, ctx=mx.cpu())
    j8 = JPredictor(jsym.tojson(), _nd(jmx, blob), {"data": (8, 3, 8, 8)},
                    quantize="int8", calibration=table)
    for p in (p8, p32, j8):
        p.forward(data=x)
    o8, o32 = p8.get_output(0).asnumpy(), p32.get_output(0).asnumpy()
    np.testing.assert_allclose(o8, j8.get_output(0).asnumpy(), **OUT_TOL)
    assert float(np.max(np.abs(o8 - o32))) < 0.05
    assert np.array_equal(np.argmax(o8, 1), np.argmax(o32, 1))
    # reshaped() keeps the rewrite and shares the int8 weights
    p1 = p8.reshaped({"data": (1, 3, 8, 8)})
    assert p1._quantize == "int8"
    assert p1._exe.arg_dict["conv1_weight_int8"] is \
        p8._exe.arg_dict["conv1_weight_int8"]
    p1.forward(data=x[:1])
    np.testing.assert_allclose(p1.get_output(0).asnumpy(), o8[:1],
                               **OUT_TOL)


def test_quantize_env_default(convnet, monkeypatch):
    sym, _, args, auxs = convnet
    monkeypatch.setenv("MXNET_TPU_QUANTIZE", "int8")
    model = serving.ServedModel("m", sym, _nd(mx, args, ctx=mx.cpu()),
                                _nd(mx, auxs, ctx=mx.cpu()),
                                {"data": (3, 8, 8)}, max_batch_size=2,
                                ctx=mx.cpu())
    assert model.quantize == "int8"
    assert any(n.endswith("_int8") for n in model._base._exe.arg_dict)
    monkeypatch.delenv("MXNET_TPU_QUANTIZE")
    model2 = serving.ServedModel("m2", sym, _nd(mx, args, ctx=mx.cpu()),
                                 _nd(mx, auxs, ctx=mx.cpu()),
                                 {"data": (3, 8, 8)}, max_batch_size=2,
                                 ctx=mx.cpu())
    assert model2.quantize is None
    jmodel = jserving.ServedModel("j", _convnet(jmx), _nd(jmx, args),
                                  _nd(jmx, auxs), {"data": (3, 8, 8)},
                                  max_batch_size=2)
    assert jmodel.quantize is None


def test_int8_served_bucket_replay_bitwise(convnet):
    """``Server.add_model(quantize="int8")``: zero plan builds after
    warmup, and every response bit for bit an int8 Predictor replay at
    its dispatch bucket."""
    sym, _, args, auxs = convnet
    server = serving.Server(max_batch_size=4, batch_window_ms=2.0,
                            queue_depth=32)
    try:
        server.add_model("q8", sym, _nd(mx, args, ctx=mx.cpu()),
                         _nd(mx, auxs, ctx=mx.cpu()),
                         input_shapes={"data": (3, 8, 8)}, ctx=mx.cpu(),
                         quantize="int8")
        server.warmup()
        r = _rng(12)
        payloads = [r.rand(1 + i % 3, 3, 8, 8).astype(np.float32)
                    for i in range(9)]
        with mx.executor_cache.watch_traces() as w:
            futs = [server.submit_async("q8", {"data": p})
                    for p in payloads]
            results = [f.result(timeout=60) for f in futs]
        assert w.total() == 0, w.delta()
    finally:
        server.close(drain=True, timeout=30)
    blob = {"arg:%s" % k: v for k, v in args.items()}
    blob.update({"aux:%s" % k: v for k, v in auxs.items()})
    for p, fut, outs in zip(payloads, futs, results):
        b = fut.request.dispatch_bucket
        oracle = Predictor(sym.tojson(), _nd(mx, blob, ctx=mx.cpu()),
                           {"data": (b, 3, 8, 8)}, ctx=mx.cpu(),
                           quantize="int8")
        solo = np.zeros((b, 3, 8, 8), np.float32)
        solo[:p.shape[0]] = p
        oracle.forward(data=solo)
        assert np.array_equal(outs[0],
                              oracle.get_output(0).asnumpy()[:p.shape[0]])

"""The Gluon training slice as a whole: the zoo TransformerLM trained
through ``autograd.record()`` -> ``SoftmaxCrossEntropyLoss`` ->
``loss.backward()`` -> ``gluon.Trainer(..., "adam").step`` in the port
(``mxnet_tpu_torch``, on the CPU, so the flash kernel's plain LSE
variant and the blockwise flash backward) and in the JAX package, from
the same numpy weights and tokens.

Head_dim 128 (1 head) runs the JAX side with ``MXNET_TPU_PALLAS_ATTN=1``:
its flash kernel in the Pallas interpreter with the custom VJP, the
path the port's attention mirrors.  Head_dim 64 (2 heads) takes the
JAX reference attention under ``jax.grad``.

Tolerances, all f32: losses rtol 1e-5 (XLA:CPU and torch sum in other
orders); first-step gradients atol 2e-5 + rtol 1e-3 (the flash
backward recomputes the probabilities from the row log-sum-exp);
final parameters after 3 Adam steps atol 5e-5 + rtol 1e-4 (Adam divides
each element's step by the root of its second moment, so an element
with a small gradient amplifies that gradient's rounding difference;
measured worst 1.5e-5) — except where a first-step gradient is rounding
noise (the key bias: a constant added
to every score of a row changes no probability, so its gradient is
~1e-9 in both packages).  Adam turns such a gradient into a step of
about ±lr whose sign is the noise's, so those parameters are held to
2 * lr per step: 6e-3 at lr 1e-3 over 3 steps.
"""
import json

import numpy as np
import pytest

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.models import transformer_lm_symbol
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.symbol import NameManager

VOCAB, SEQ, EMBED, LAYERS, BATCH = 97, 16, 128, 2, 2
LR, STEPS = 1e-3, 3
NOISE_GRAD = 1e-6  # a first-step gradient this small is rounding noise


def _weights(heads):
    """Seeded numpy weights keyed by the nets' (shared) parameter names."""
    with NameManager():
        net = gluon.model_zoo.TransformerLM(VOCAB, embed_dim=EMBED,
                                            num_heads=heads,
                                            num_layers=LAYERS, seq_len=SEQ)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.zeros((BATCH, SEQ), ctx=mx.cpu()))  # resolves deferred shapes
    r = np.random.RandomState(heads)
    out = {}
    for name, p in net.collect_params().items():
        if name.endswith("gamma"):
            out[name] = (1 + 0.1 * r.standard_normal(p.shape)).astype(
                np.float32)
        else:
            out[name] = (0.05 * r.standard_normal(p.shape)).astype(np.float32)
    return out


def _batch():
    r = np.random.RandomState(7)
    x = r.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
    y = r.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
    return x, y


def _train(pkg, ag, gl, names, weights, heads, hybridize, ctx):
    with names():
        net = gl.model_zoo.TransformerLM(VOCAB, embed_dim=EMBED,
                                         num_heads=heads, num_layers=LAYERS,
                                         seq_len=SEQ)
    params = net.collect_params()
    assert sorted(params.keys()) == sorted(weights)
    net.initialize(ctx=ctx)
    x, y = _batch()
    x, y = pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx)
    net(x)  # deferred init
    for name, p in params.items():
        p.set_data(pkg.nd.array(weights[name], ctx=ctx))
    if hybridize:
        net.hybridize()
    loss_fn = gl.loss.SoftmaxCrossEntropyLoss()
    trainer = gl.Trainer(params, "adam", {"learning_rate": LR})
    losses, grads = [], None
    for _ in range(STEPS):
        with ag.record():
            loss = loss_fn(net(x), y)
        loss.backward()
        if grads is None:
            grads = {k: p.grad().asnumpy().copy() for k, p in params.items()}
        trainer.step(BATCH)
        losses.append(loss.asnumpy().copy())
    final = {k: p.data().asnumpy().copy() for k, p in params.items()}
    return np.array(losses), grads, final


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
@pytest.mark.parametrize("heads", [1, 2], ids=["hd128", "hd64"])
def test_transformer_lm_trains_like_the_jax_package(heads, hybridize,
                                                    monkeypatch):
    if heads == 1:
        monkeypatch.setenv("MXNET_TPU_PALLAS_ATTN", "1")
    weights = _weights(heads)
    K.reset_launch_counts()
    got = _train(mx, autograd, gluon, NameManager, weights, heads, hybridize,
                 mx.cpu())
    # CPU tensors take the plain versions: no kernel launch counted
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)
    want = _train(jmx, jag, jgluon, JNameManager, weights, heads, hybridize,
                  jmx.cpu())
    (l_got, g_got, p_got), (l_want, g_want, p_want) = got, want
    assert np.all(np.isfinite(l_got)) and l_got[-1].mean() < l_got[0].mean()
    np.testing.assert_allclose(l_got, l_want, rtol=1e-5, atol=0)
    for name in weights:
        np.testing.assert_allclose(g_got[name], g_want[name], rtol=1e-3,
                                   atol=2e-5, err_msg=name)
        noise = np.abs(g_want[name]) < NOISE_GRAD
        atol = np.where(noise, 2 * LR * STEPS, 5e-5)
        err = np.abs(p_got[name] - p_want[name])
        assert np.all(err <= atol + 1e-4 * np.abs(p_want[name])), \
            (name, float(err.max()))
    # the q/k/v projections learn: their weights take real gradients
    for side in ("query", "key", "value"):
        g = g_got["transformerlm0_l0_%s_weight" % side]
        assert np.abs(g).max() > 1e-4, side


def test_hybridized_gradients_equal_the_imperative_ones():
    weights = _weights(2)
    runs = [_train(mx, autograd, gluon, NameManager, weights, 2, h, mx.cpu())
            for h in (False, True)]
    (l0, g0, p0), (l1, g1, p1) = runs
    np.testing.assert_allclose(l0, l1, rtol=1e-6, atol=0)
    for name in weights:
        np.testing.assert_allclose(g0[name], g1[name], rtol=1e-5, atol=1e-8,
                                   err_msg=name)


@pytest.mark.parametrize("heads", [1, 2])
def test_gluon_export_equals_the_symbol_builder(heads, tmp_path):
    with NameManager():
        net = gluon.model_zoo.TransformerLM(VOCAB, embed_dim=EMBED,
                                            num_heads=heads,
                                            num_layers=LAYERS, seq_len=SEQ)
    net.initialize(ctx=mx.cpu())
    net.hybridize()
    net(mx.nd.zeros((1, SEQ), ctx=mx.cpu()))
    net.export(str(tmp_path / "lm"))
    exported = json.loads((tmp_path / "lm-symbol.json").read_text())
    built = json.loads(transformer_lm_symbol(
        VOCAB, embed_dim=EMBED, num_heads=heads, num_layers=LAYERS,
        seq_len=SEQ).tojson())
    assert exported == built
    # the exported params load into the symbol path's Predictor unchanged
    loaded = mx.nd.load(str(tmp_path / "lm-0000.params"))
    args, _ = mx.convert.params_from_numpy(
        {k: v.asnumpy() for k, v in loaded.items()}, mx.cpu())
    x = np.random.RandomState(0).randint(0, VOCAB, (1, SEQ)).astype(
        np.float32)
    pred = mx.Predictor((tmp_path / "lm-symbol.json").read_text(), args,
                        {"data": x.shape}, ctx=mx.cpu())
    pred.forward(data=x)
    np.testing.assert_allclose(pred.get_output(0).asnumpy(),
                               net(mx.nd.array(x, ctx=mx.cpu())).asnumpy(),
                               rtol=1e-5, atol=1e-6)


def test_gluon_export_matches_the_jax_export(tmp_path):
    for pkg, names, tag in ((mx, NameManager, "port"),
                            (jmx, JNameManager, "jax")):
        with names():
            net = pkg.gluon.model_zoo.TransformerLM(
                VOCAB, embed_dim=EMBED, num_heads=2, num_layers=LAYERS,
                seq_len=SEQ)
        net.initialize(ctx=pkg.cpu())
        net.hybridize()
        net(pkg.nd.zeros((1, SEQ), ctx=pkg.cpu()))
        net.export(str(tmp_path / tag))
    port = json.loads((tmp_path / "port-symbol.json").read_text())
    jax_ = json.loads((tmp_path / "jax-symbol.json").read_text())
    assert port == jax_

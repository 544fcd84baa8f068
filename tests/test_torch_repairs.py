"""Repairs of two faults of the port against the JAX package.

C1: attention on the host takes the plain version for every head_dim and
floating dtype (the kernel's limits hold on the card only), so the zoo
``TransformerLM`` at its default widths (embed 128, 4 heads: head_dim
32) runs on ``mx.cpu()``.  C2: the training kernels take f16 and f64 as
well as f32 and bf16, so BatchNorm training and 2-D pooling in those
dtypes run them; on the host, their plain versions, checked here against
the JAX ops (f16 with the ``pool`` and ``bn`` kernel families
interpreted; f64 on the JAX package's XLA path, since its interpreted
kernels run with x64 off and refuse f64).

Tolerances: the LM's f32 logits atol=rtol=1e-5 and its Adam step's
parameters atol=5e-5 + rtol=1e-4 (the bounds of
``tests/test_torch_gluon_lm.py``); plain attention f32/f64 1e-5, f16
atol=rtol=2e-3 (the port computes f16 inputs in f32, the JAX reference
in f16); f16 BatchNorm and pooling atol=rtol=1e-2 against the JAX ops in
f16 (one f16 rounding of values of order 1), f64 pooling at 1e-12 (both
sides compare and sum in f64; max-pool ties below f32's resolution go to
the true maximum, exactly), f64 BatchNorm 1e-6 (the channel sums run in
f32 in both packages).
"""
import os
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu import autograd as jag, gluon as jgluon
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.symbol.symbol import NameManager as JNameManager

import mxnet_tpu_torch as mx
from mxnet_tpu_torch import autograd, gluon
from mxnet_tpu_torch.ops import _build
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.symbol import NameManager

from test_torch_train_ops import _run_both
from test_torch_vision_zoo import build, images, seeded_weights, set_weights

VOCAB, SEQ, BATCH = 100, 8, 2


def _default_lm(names, gl):
    with names():
        return gl.model_zoo.TransformerLM(VOCAB, seq_len=SEQ)


def _lm_run(pkg, ag, gl, names, weights, x, y):
    """Logits, then the parameters after one Adam step, of the default
    zoo LM set to ``weights``."""
    ctx = pkg.cpu()
    net = _default_lm(names, gl)
    net.initialize(ctx=ctx)
    x, y = pkg.nd.array(x, ctx=ctx), pkg.nd.array(y, ctx=ctx)
    net(x)  # resolves the deferred shapes
    params = net.collect_params()
    for name, p in params.items():
        p.set_data(pkg.nd.array(weights[name], ctx=ctx))
    logits = net(x).asnumpy()
    trainer = gl.Trainer(params, "adam", {"learning_rate": 1e-3})
    with ag.record():
        loss = gl.loss.SoftmaxCrossEntropyLoss()(net(x), y)
    loss.backward()
    trainer.step(BATCH)
    return logits, {k: p.data().asnumpy() for k, p in params.items()}


def test_default_width_transformer_lm_runs_on_the_host_like_the_jax_package():
    net = _default_lm(NameManager, gluon)
    assert net.collect_params()  # embed 128, 4 heads
    r = np.random.RandomState(3)
    x = r.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
    y = r.randint(0, VOCAB, (BATCH, SEQ)).astype(np.float32)
    net.initialize(ctx=mx.cpu())
    net(mx.nd.array(x, ctx=mx.cpu()))
    weights = {}
    for name, p in net.collect_params().items():
        scale = 0.1 if name.endswith("gamma") else 0.05
        weights[name] = ((name.endswith("gamma"))
                         + scale * r.standard_normal(p.shape)).astype(
                             np.float32)
    logits, after = _lm_run(mx, autograd, gluon, NameManager, weights, x, y)
    j_logits, j_after = _lm_run(jmx, jag, jgluon, JNameManager, weights, x, y)
    assert logits.shape == (BATCH, SEQ, VOCAB)
    np.testing.assert_allclose(logits, j_logits, atol=1e-5, rtol=1e-5)
    for name in weights:
        np.testing.assert_allclose(after[name], j_after[name], atol=5e-5,
                                   rtol=1e-4, err_msg=name)
        if not name.endswith("key_bias"):  # its gradient is rounding noise
            assert not np.array_equal(after[name], weights[name]), name


@pytest.mark.parametrize("d, dtype", [(16, "float32"), (32, "float32"),
                                      (48, "float32"), (80, "float32"),
                                      (32, "float16"), (64, "float64")])
@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_plain_attention_takes_every_head_dim_and_dtype(d, dtype, causal):
    """Against the JAX package's ``_reference_attention``; rows with no
    valid key are left out (the port gives 0 there, the reference the
    mean of v: an intended difference)."""
    r = np.random.RandomState(d)
    q, k, v = (r.standard_normal((2, 12, 3, d)).astype(dtype)
               for _ in range(3))
    lens = np.array([12, 5], np.int32)
    got = K.attention(*(torch.from_numpy(t) for t in (q, k, v)),
                      causal=causal, kv_lens=torch.from_numpy(lens))
    want = np.asarray(pk._reference_attention(
        *(jnp.asarray(t) for t in (q, k, v)), causal, 1.0 / d ** 0.5,
        jnp.asarray(lens)))
    assert got.dtype == getattr(torch, dtype) and got.shape == q.shape
    tol = dict(atol=2e-3, rtol=2e-3) if dtype == "float16" \
        else dict(atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.double().numpy(), want.astype(np.float64),
                               **tol)


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_plain_attention_gradients_in_half_and_double(dtype):
    """``attention()`` under grad on host tensors of f16/f64 goes through
    the differentiable flash function (its plain forward and the
    blockwise backward) and matches autograd through the plain forward:
    f64 1e-10, f16 atol=rtol=1e-2 (f16 outputs and gradients)."""
    r = np.random.RandomState(5)
    base = [torch.from_numpy(r.standard_normal((2, 10, 2, 32))).to(
        getattr(torch, dtype)) for _ in range(3)]
    grads = []
    for fn in (lambda q, k, v: K.attention(q, k, v, causal=True),
               lambda q, k, v: K._reference_attention(q, k, v, True,
                                                      32 ** -0.5)):
        q, k, v = (t.clone().requires_grad_() for t in base)
        out = fn(q, k, v)
        grads.append(torch.autograd.grad(out.double().square().sum(),
                                         (q, k, v)))
    tol = dict(atol=1e-2, rtol=1e-2) if dtype == "float16" \
        else dict(atol=1e-10, rtol=1e-10)
    for got, want in zip(*grads):
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got.double().numpy(),
                                   want.double().numpy(), **tol)


def _jax_kernels_for(dtype, monkeypatch):
    """The JAX package's pool and bn kernel families interpreted for f16.
    Its interpreted kernels cannot take f64 (they run with x64 off), so
    f64 is held against its XLA path, which computes in f64."""
    if dtype == "float16":
        monkeypatch.setenv("MXNET_TPU_PALLAS_POOL", "1")
        monkeypatch.setenv("MXNET_TPU_PALLAS_BN", "1")


POOL_CASES = [
    dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1)),
    dict(pool_type="avg", kernel=(3, 3), stride=(2, 2), pad=(1, 1),
         count_include_pad=False),
    dict(pool_type="avg", kernel=(7, 7), global_pool=True),
]


@pytest.mark.parametrize("dtype", ["float16", "float64"])
@pytest.mark.parametrize("attrs", POOL_CASES,
                         ids=lambda a: a["pool_type"] + str(a["kernel"][0]))
def test_half_and_double_pooling_match_the_jax_kernels(attrs, dtype,
                                                       monkeypatch):
    _jax_kernels_for(dtype, monkeypatch)
    x = np.random.RandomState(6).standard_normal((2, 3, 7, 7)).astype(dtype)
    outs_j, outs_t, grads_j, grads_t = _run_both("Pooling", [x], attrs)
    tol = dict(atol=1e-2, rtol=1e-2) if dtype == "float16" \
        else dict(atol=1e-12, rtol=1e-12)
    for a, b in zip(outs_j + grads_j, outs_t + grads_t):
        np.testing.assert_allclose(b, a, **tol)


def test_double_max_pooling_routes_to_the_true_maximum():
    """f64 max pooling compares doubles.  Input pixel (2, 2) lies in one
    window only, which also holds (2, 3) and (3, 3).  Where (2, 2) and the
    other tap differ below f32's resolution (1 and 1 + 2**-40), or lie
    beyond f32's range (1e300 and 2e300), the gradient goes to the larger,
    as on the JAX package's f64 path, and not to the first tap (where an
    f32 comparison sends it)."""
    x = np.random.RandomState(8).standard_normal((1, 2, 6, 6)) * 1e-3
    x[0, 0, 2, 2], x[0, 0, 2, 3] = 1.0, 1.0 + 2.0 ** -40
    x[0, 1, 2, 2], x[0, 1, 3, 3] = 1e300, 2e300
    attrs = dict(pool_type="max", kernel=(3, 3), stride=(2, 2), pad=(1, 1))
    outs_j, outs_t, grads_j, grads_t = _run_both("Pooling", [x], attrs)
    for a, b in zip(outs_j + grads_j, outs_t + grads_t):
        np.testing.assert_array_equal(b, a)
    dx = grads_t[0]
    assert dx[0, 0, 2, 2] == 0 and dx[0, 0, 2, 3] != 0
    assert dx[0, 1, 2, 2] == 0 and dx[0, 1, 3, 3] != 0


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_half_and_double_batchnorm_training_matches_the_jax_kernels(
        dtype, monkeypatch):
    """Train-mode BatchNorm through ``bn_channel_sums``: outputs, moving
    statistics and gradients; gamma/beta and the moving statistics stay
    f32 for f16 data (``_bn_infer_type``), f64 for f64."""
    _jax_kernels_for(dtype, monkeypatch)
    r = np.random.RandomState(7)
    pdt = "float32" if dtype == "float16" else dtype
    inputs = [r.normal(0.5, 1, (4, 3, 5, 5)).astype(dtype),
              r.normal(1, 0.1, 3).astype(pdt), r.normal(0, 0.1, 3).astype(pdt),
              r.normal(0, 0.1, 3).astype(pdt),
              r.uniform(0.5, 1.5, 3).astype(pdt)]
    attrs = {"fix_gamma": False, "eps": 1e-3}
    outs_j, outs_t, grads_j, grads_t = _run_both("BatchNorm", inputs, attrs,
                                                 train=True, n_diff=3)
    tol = dict(atol=1e-2, rtol=1e-2) if dtype == "float16" \
        else dict(atol=1e-6, rtol=1e-6)
    for a, b in zip(outs_j + grads_j, outs_t + grads_t):
        np.testing.assert_allclose(b, a, **tol)
    op = mx.ops.registry.get_op("BatchNorm")
    _, out_types = op.infer_type([dtype, None, None, None, None], {})
    filled, _ = op.infer_type([dtype, None, None, None, None], {})
    assert [str(t) for t in filled] == [dtype] + [pdt] * 4
    assert [str(t) for t in out_types] == [dtype]


def test_training_kernels_take_four_dtypes_on_the_card():
    """The wrappers' dtype codes are the C entries' ``DType`` values, and
    the kernel dtypes are f32, bf16, f16 and f64."""
    assert K.KERNEL_DTYPES == (torch.float32, torch.bfloat16, torch.float16,
                               torch.float64)
    for source in ("bn_channel_sums", "pool_bwd"):
        with open(os.path.join(_build.SRC_DIR, source + ".cu")) as f:
            enum = re.search(r"enum DType \{(.*?)\};", f.read()).group(1)
        codes = dict((name, int(v)) for name, v in
                     re.findall(r"(\w+) = (\d+)", enum))
        assert codes == {"F32": K._DTYPE_CODES[torch.float32],
                         "BF16": K._DTYPE_CODES[torch.bfloat16],
                         "F16": K._DTYPE_CODES[torch.float16],
                         "F64": K._DTYPE_CODES[torch.float64]}


def test_flash_head_dims_include_the_zoo_default():
    assert K.FLASH_HEAD_DIMS == (32, 64, 128)
    with open(os.path.join(_build.SRC_DIR, "flash_attn_fwd.cu")) as f:
        text = f.read()
    for d in K.FLASH_HEAD_DIMS:
        assert "if (D == %d)" % d in text


def test_float16_cast_keeps_batchnorm_parameters_f32_like_the_jax_package():
    """``Block.cast('float16')`` casts every Parameter but BatchNorm's
    (gamma, beta and the moving statistics stay f32, the type rule of
    ``_bn_infer_type``); the f16 zoo net's predict forward and its
    train-mode forward through the f16 BatchNorm and pooling paths agree
    with the JAX package's within f16 rounding (relative L2 5e-3)."""
    x = images(32, 2)
    outs, weights = [], None
    for pkg in (mx, jmx):
        net = build(pkg, "resnet18_v1")
        net.infer_shape(pkg.nd.array(x, ctx=pkg.cpu()))
        weights = weights or seeded_weights(net)
        set_weights(pkg, net, weights)
        net.cast("float16")
        for name, p in net.collect_params().items():
            want = "float32" if "batchnorm" in name else "float16"
            assert np.dtype(p.data().dtype).name == want, name
        net.hybridize()
        xa = pkg.nd.array(x, ctx=pkg.cpu(), dtype="float16")
        with pkg.autograd.predict_mode():
            pred = net(xa).asnumpy().astype(np.float64)
        with pkg.autograd.record():
            train = net(xa).asnumpy().astype(np.float64)
        outs.append((pred, train))
    for got, want in zip(*outs):
        assert np.linalg.norm(got - want) <= 5e-3 * np.linalg.norm(want)

"""The port's 13 ``_image_*`` ops against the JAX package's, on the CPU.

Deterministic ops (``to_tensor``, ``normalize``, the two flips,
``adjust_lighting``) run through both registries on the same numpy
inputs: forward within 1e-6 and gradients under one random cotangent
within 1e-5 (``_run_both`` of ``test_torch_train_ops.py``).  The random
ops draw from different generators (the port's per-device
``torch.Generator``, the JAX package's keys), so they are held by their
statistics, as ``test_torch_random.py`` holds the samplers: a scalar of
each call's output over 3,000 calls in each package, sample mean and
variance within 6 standard errors of each other, and a two-sample
Kolmogorov-Smirnov test at p 1e-4; and each output is checked against
the op's formula at the factor it implies (flips, brightness, contrast,
saturation and lighting)."""
import numpy as np
import pytest
import torch
from scipy import stats

import jax
import jax.numpy as jnp

import mxnet_tpu as jmx
from mxnet_tpu.ops.registry import get_op as jax_op, op_registry as jax_ops

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops.registry import get_op as port_op, op_registry

from test_torch_train_ops import _run_both

N_CALLS = 3000
P_MIN = 1e-4
SIGMAS = 6.0
IMAGE_OPS = sorted(n for n in jax_ops() if n.startswith("_image_"))
RANDOM_OPS = [n for n in IMAGE_OPS if jax_ops()[n].needs_rng]
FWD_TOL = dict(atol=1e-6, rtol=1e-6)
GRAD_TOL = dict(atol=1e-5, rtol=1e-5)


def _image(shape, seed=0, lo=0.0, hi=255.0):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def test_the_13_ops_are_registered_alike():
    assert len(IMAGE_OPS) == 13
    for name in IMAGE_OPS:
        op, ref = port_op(name), jax_op(name)
        assert op.needs_rng == ref.needs_rng, name
        assert set(op.params) == set(ref.params), name
    assert len(RANDOM_OPS) == 8
    assert sorted(n for n in op_registry() if n.startswith("_image_")) \
        == IMAGE_OPS


DETERMINISTIC = [
    ("_image_to_tensor", [(6, 5, 3)], {}),
    ("_image_to_tensor", [(2, 6, 5, 3)], {}),
    ("_image_normalize", [(3, 6, 5)],
     {"mean": (0.4914, 0.4822, 0.4465), "std": (0.2023, 0.1994, 0.2010)}),
    ("_image_normalize", [(2, 3, 4, 5)], {"mean": (1.0,), "std": (2.0,)}),
    ("_image_flip_left_right", [(6, 5, 3)], {}),
    ("_image_flip_left_right", [(2, 6, 5, 3)], {}),
    ("_image_flip_top_bottom", [(6, 5, 3)], {}),
    ("_image_adjust_lighting", [(6, 5, 3)], {"alpha": (0.1, -0.2, 0.3)}),
]


@pytest.mark.parametrize("case", DETERMINISTIC,
                         ids=lambda c: "%s-%s" % (c[0], "x".join(
                             map(str, c[1][0]))))
def test_deterministic_ops(case):
    name, shapes, attrs = case
    inputs = [_image(s, seed=i) for i, s in enumerate(shapes)]
    outs_j, outs_t, grads_j, grads_t = _run_both(name, inputs, attrs)
    for a, b in zip(outs_j, outs_t):
        np.testing.assert_allclose(b, a, **FWD_TOL)
    for a, b in zip(grads_j, grads_t):
        np.testing.assert_allclose(b, a, **GRAD_TOL)


def test_to_tensor_of_uint8():
    img = np.random.RandomState(1).randint(0, 256, (7, 9, 3)).astype(
        np.uint8)
    got = mx.nd.image.to_tensor(mx.nd.array(img, ctx=mx.cpu()))
    want = jmx.nd.image.to_tensor(jmx.nd.array(img, dtype=np.uint8))
    assert got.dtype == np.float32 and got.shape == (3, 7, 9)
    np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), **FWD_TOL)


def test_namespaces_and_symbols():
    x = _image((3, 4, 5), seed=2)
    nd = mx.nd.array(x, ctx=mx.cpu())
    got = mx.nd.image.normalize(nd, mean=(1.0, 2.0, 3.0), std=(2.0, 2.0, 4.0))
    sym = mx.sym.image.normalize(mx.sym.var("data"), mean=(1.0, 2.0, 3.0),
                                 std=(2.0, 2.0, 4.0))
    out = mx.test_utils.simple_forward(sym, ctx=mx.cpu(), data=x)
    np.testing.assert_allclose(got.asnumpy(), out, **FWD_TOL)
    assert sym.infer_shape(data=(3, 4, 5))[1] == [(3, 4, 5)]
    flipped = mx.sym.image.flip_left_right(mx.sym.var("data"))
    np.testing.assert_array_equal(
        mx.test_utils.simple_forward(flipped, ctx=mx.cpu(), data=x),
        x[:, ::-1])


# ---------------------------------------------------------------------------
# Random ops
# ---------------------------------------------------------------------------

# name -> (input shape, attrs); the statistic is read off each output
RANDOM_CASES = {
    "_image_random_flip_left_right": ((4, 5, 3), {}),
    "_image_random_flip_top_bottom": ((4, 5, 3), {}),
    "_image_random_brightness": ((4, 5, 3),
                                 {"min_factor": 0.5, "max_factor": 1.5}),
    "_image_random_contrast": ((4, 5, 3),
                               {"min_factor": 0.6, "max_factor": 1.4}),
    "_image_random_saturation": ((4, 5, 3),
                                 {"min_factor": 0.2, "max_factor": 1.8}),
    "_image_random_hue": ((4, 5, 3), {"min_factor": -0.4, "max_factor": 0.4}),
    "_image_random_color_jitter": ((4, 5, 3), {"brightness": 0.3,
                                               "contrast": 0.3,
                                               "saturation": 0.3,
                                               "hue": 0.2}),
    "_image_random_lighting": ((4, 5, 3), {"alpha_std": 0.5}),
}


def _statistic(out, x):
    """A scalar per call: the output's first pixel's first channel, minus
    the input's (every random op moves it)."""
    return float(out[0, 0, 0] - x[0, 0, 0])


def _port_draws(name, x, attrs, n=N_CALLS):
    op = port_op(name)
    a = op.normalize_attrs(attrs)
    t = torch.from_numpy(x)
    return [op.impl(t, **a).numpy() for _ in range(n)]


def _jax_draws(name, x, attrs, n=N_CALLS, seed=0):
    op = jax_op(name)
    a = op.normalize_attrs(attrs)
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    outs = jax.jit(jax.vmap(lambda k: op.impl(k, jnp.asarray(x), **a)))(keys)
    return list(np.asarray(outs))


def _z(a, b):
    """Two-sample z of the means and of the variances (the variance's
    standard error from the fourth central moment)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)

    def se_var(v):
        m4 = np.mean((v - v.mean()) ** 4)
        return (m4 - v.var() ** 2) / len(v)

    zm = (a.mean() - b.mean()) / np.sqrt(a.var() / len(a) + b.var() / len(b)
                                         + 1e-30)
    zv = (a.var() - b.var()) / np.sqrt(se_var(a) + se_var(b) + 1e-30)
    return abs(zm), abs(zv)


@pytest.mark.parametrize("name", sorted(RANDOM_CASES))
def test_random_op_distribution_matches(name):
    shape, attrs = RANDOM_CASES[name]
    x = _image(shape, seed=3, lo=10.0, hi=240.0)
    mx.random.seed(5)
    port = _port_draws(name, x, attrs)
    ref = _jax_draws(name, x, attrs)
    # (the JAX package's factor follows its x64 setting; the port's is f32)
    assert port[0].shape == ref[0].shape and port[0].dtype == np.float32
    sp = [_statistic(o, x) for o in port]
    sr = [_statistic(o, x) for o in ref]
    zm, zv = _z(sp, sr)
    assert zm < SIGMAS and zv < SIGMAS, (zm, zv)
    if len(set(np.round(sp, 4))) > 2:  # continuous: KS
        assert stats.ks_2samp(sp, sr).pvalue > P_MIN


def _gray(x):
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def test_random_ops_follow_their_formulas():
    x = _image((4, 5, 3), seed=4, lo=10.0, hi=240.0)
    mx.random.seed(6)
    flips = _port_draws("_image_random_flip_left_right", x, {}, 400)
    kinds = {o.tobytes() for o in flips}
    assert kinds == {x.tobytes(), x[:, ::-1].copy().tobytes()}
    flips = _port_draws("_image_random_flip_top_bottom", x, {}, 400)
    assert {o.tobytes() for o in flips} == \
        {x.tobytes(), x[::-1].copy().tobytes()}
    for o in _port_draws("_image_random_brightness", x,
                         {"min_factor": 0.5, "max_factor": 1.5}, 200):
        alpha = o[0, 0, 0] / x[0, 0, 0]
        assert 0.5 <= alpha < 1.5 + 1e-6
        np.testing.assert_allclose(o, x * alpha, rtol=1e-5)
    m = _gray(x).mean()
    for o in _port_draws("_image_random_contrast", x,
                         {"min_factor": 0.6, "max_factor": 1.4}, 200):
        alpha = (o[0, 0, 0] - m) / (x[0, 0, 0] - m)
        assert 0.6 - 1e-4 <= alpha < 1.4 + 1e-4
        np.testing.assert_allclose(o, x * alpha + m * (1 - alpha),
                                   rtol=1e-4, atol=1e-3)
    g = _gray(x)[..., None]
    for o in _port_draws("_image_random_saturation", x,
                         {"min_factor": 0.2, "max_factor": 1.8}, 200):
        alpha = (o[0, 0, 0] - g[0, 0, 0]) / (x[0, 0, 0] - g[0, 0, 0])
        np.testing.assert_allclose(o, x * alpha + g * (1 - alpha),
                                   rtol=1e-4, atol=1e-3)
    vec = np.array([[-0.5675, 0.7192, 0.4009],
                    [-0.5808, -0.0045, -0.8140],
                    [-0.5836, -0.6948, 0.4203]])
    val = np.array([55.46, 4.794, 1.148])
    alphas = []
    for o in _port_draws("_image_random_lighting", x, {"alpha_std": 0.5},
                         2000):
        delta = o - x
        np.testing.assert_allclose(delta, np.broadcast_to(delta[0, 0],
                                                          delta.shape),
                                   atol=1e-3)
        alphas.append(np.linalg.solve(vec, delta[0, 0]) / val)
    alphas = np.asarray(alphas)
    se = 0.5 / np.sqrt(len(alphas))
    assert np.all(np.abs(alphas.mean(0)) < SIGMAS * se)
    assert np.all(np.abs(alphas.std(0) - 0.5) < 0.05)


def test_random_ops_draw_from_the_ports_generator():
    x = _image((4, 5, 3), seed=5)
    attrs = {"min_factor": 0.5, "max_factor": 1.5}
    mx.random.seed(7)
    a = _port_draws("_image_random_brightness", x, attrs, 20)
    mx.random.seed(7)
    torch.manual_seed(123)
    b = _port_draws("_image_random_brightness", x, attrs, 20)
    mx.random.seed(8)
    c = _port_draws("_image_random_brightness", x, attrs, 20)
    assert all(np.array_equal(u, v) for u, v in zip(a, b))
    assert not all(np.array_equal(u, v) for u, v in zip(a, c))
    nd = mx.nd.image.random_brightness(mx.nd.array(x, ctx=mx.cpu()),
                                       min_factor=0.5, max_factor=1.5)
    assert nd.shape == x.shape


def test_color_jitter_applies_its_drawn_order():
    """The jitter computes every order and selects the drawn one on the
    device: its output is the drawn order applied with the drawn factors
    (the four uniforms, then the order, from the same generator), and
    every order is drawn."""
    from mxnet_tpu_torch.ops import image_ops as P
    op = port_op("_image_random_color_jitter")
    attrs = op.normalize_attrs({"brightness": 0.3, "contrast": 0.3,
                                "saturation": 0.3, "hue": 0.2})
    x = torch.from_numpy(np.random.RandomState(0).uniform(
        10, 240, (4, 5, 3)).astype(np.float32))
    gen = mx.random.generator("cpu")
    fns = (P._brightness, P._contrast, P._saturation, P._hue_rotate)
    seen = set()
    for _ in range(40):
        state = gen.get_state()
        got = op.impl(x, **attrs)
        gen.set_state(state)
        alphas = [torch.empty(()).uniform_(lo, hi, generator=gen)
                  for lo, hi in ((1 - 0.3, 1 + 0.3), (1 - 0.3, 1 + 0.3),
                                 (1 - 0.3, 1 + 0.3), (-0.2, 0.2))]
        pick = int(torch.empty((), dtype=torch.int64).random_(
            4, generator=gen))
        want = x
        for i in P._JITTER_ORDERS[pick]:
            want = fns[i](want, alphas[i])
        assert torch.equal(got, want)
        seen.add(pick)
    assert seen == {0, 1, 2, 3}


def test_random_op_shape_inference_draws_nothing():
    state = mx.random.generator("cpu").get_state()
    sym = mx.sym.image.random_color_jitter(mx.sym.var("data"),
                                           brightness=0.1, hue=0.1)
    assert sym.infer_shape(data=(2, 4, 5, 3))[1] == [(2, 4, 5, 3)]
    assert torch.equal(state, mx.random.generator("cpu").get_state())

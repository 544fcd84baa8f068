"""The port's plain versions of the training kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

``bn_channel_sums`` against ``pallas_kernels.bn_channel_sums(...,
interpret=True)``; ``max_pool_backward``/``avg_pool_backward`` against
the gradients of ``ops.nn._pool_core(..., "interpret")``, over the
reference's own eight pooling cases (tests/test_pallas_kernels.py), a
post-ReLU input full of tied zeros, and bf16.  Tolerances: f32 within
1e-5 (the same terms summed in another order); bf16 compared in f32
within 2e-2 (rounding of the bf16 output).  On CPU tensors the wrappers
take the plain versions and count no launch.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mxnet_tpu_torch as mx
from mxnet_tpu.ops import pallas_kernels as pk
from mxnet_tpu.ops.nn import _pool_core
from mxnet_tpu_torch.ops import kernels as K
from mxnet_tpu_torch.ops import nn as nn_ops

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)

# (pool_type, kernel, stride, pad, convention, count_include_pad): the
# reference's POOL_CASES
POOL_CASES = [
    ("max", (3, 3), (2, 2), (1, 1), "valid", True),
    ("max", (3, 2), (2, 3), (1, 0), "valid", True),
    ("max", (3, 3), (2, 2), (1, 1), "full", True),
    ("max", (2, 2), (2, 2), (0, 0), "valid", True),
    ("avg", (3, 3), (2, 2), (1, 1), "valid", True),
    ("avg", (3, 3), (2, 2), (1, 1), "valid", False),
    ("avg", (3, 2), (1, 2), (1, 1), "full", False),
    ("sum", (2, 3), (2, 1), (0, 1), "valid", True),
]


def _jax_pool(x, cfg):
    """(out, dx) of the reference's kernel path in interpret mode for the
    loss sum(out**2), so dy = 2 * out."""
    core = _pool_core(*cfg, "interpret")
    xj = jnp.asarray(x)
    out = core(xj)
    dx = jax.grad(lambda v: jnp.sum(core(v).astype(jnp.float32) ** 2))(xj)
    return np.asarray(out.astype(jnp.float32)), np.asarray(
        dx.astype(jnp.float32))


def _port_pool_grad(x, dy, cfg):
    pool, kernel, stride, pad, conv, cip = cfg
    pads = nn_ops._pool_spatial_pads(x.shape[2:], kernel, stride, pad, conv)
    if pool == "max":
        return K.max_pool_backward(x, dy, kernel, stride, pads)
    div = nn_ops._pool_divisor(pool, cip, tuple(x.shape), kernel, stride,
                               pads, tuple(dy.shape[2:]), x.device)
    return K.avg_pool_backward(dy, div, tuple(x.shape), kernel, stride,
                               pads, x.dtype)


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=["-".join(map(str, c)) for c in POOL_CASES])
def test_pool_backward_plain_matches_pallas_interpret(case):
    x = np.random.RandomState(1).randn(2, 3, 11, 13).astype(np.float32)
    out, want = _jax_pool(x, case)
    K.reset_launch_counts()
    got = _port_pool_grad(torch.from_numpy(x),
                          torch.from_numpy(2.0 * out), case)
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("shift", [0.0, 1.0], ids=["relu", "mostly-zero"])
def test_max_pool_ties_go_to_the_first_tap(shift):
    """Post-ReLU input: windows of tied zeros route dy to their first tap
    in row-major order, as the Pallas kernel does (with shift 1, 84% of
    the input is 0 and many windows are all zeros)."""
    r = np.random.RandomState(2)
    x = np.maximum(r.randn(2, 4, 12, 12) - shift, 0).astype(np.float32)
    cfg = ("max", (3, 3), (2, 2), (1, 1), "valid", True)
    out, want = _jax_pool(x, cfg)
    got = _port_pool_grad(torch.from_numpy(x), torch.from_numpy(2.0 * out),
                          cfg)
    np.testing.assert_allclose(got.numpy(), want, **F32)
    # the routing, not only the values: each window's gradient lands on
    # exactly one input pixel
    assert np.count_nonzero(got.numpy()) == np.count_nonzero(want)


def test_pool_backward_bf16():
    x = np.random.RandomState(3).randn(2, 4, 12, 12).astype(np.float32)
    cfg = ("max", (3, 3), (2, 2), (1, 1), "valid", True)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    out, want = _jax_pool(xb, cfg)
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).bfloat16()
    dy = torch.from_numpy(2.0 * out).bfloat16()
    got = _port_pool_grad(xt, dy, cfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16)


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_bn_channel_sums_plain_matches_pallas_interpret(paired):
    r = np.random.RandomState(4)
    a = r.randn(4, 6, 5, 7).astype(np.float32)
    b = r.randn(4, 6, 5, 7).astype(np.float32) if paired else None
    want = pk.bn_channel_sums(jnp.asarray(a),
                              None if b is None else jnp.asarray(b),
                              interpret=True)
    K.reset_launch_counts()
    got = K.bn_channel_sums(torch.from_numpy(a),
                            None if b is None else torch.from_numpy(b))
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (6,)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


def test_bn_channel_sums_bf16():
    a = np.random.RandomState(5).randn(4, 6, 5, 7).astype(np.float32)
    ab = jnp.asarray(a).astype(jnp.bfloat16)
    want = pk.bn_channel_sums(ab, interpret=True)
    at = torch.from_numpy(np.array(ab.astype(jnp.float32))).bfloat16()
    got = K.bn_channel_sums(at)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


@pytest.mark.parametrize("bad", ["bn-3d", "bn-shapes", "bn-dtypes",
                                 "pool-3d", "pool-taps", "pool-dtypes",
                                 "avg-div"])
def test_wrappers_reject_what_the_kernels_cannot_take(bad):
    x = torch.randn(2, 3, 9, 9)
    dy = torch.randn(2, 3, 4, 4)
    pads = ((1, 1), (1, 1))
    with pytest.raises(mx.MXNetError):
        if bad == "bn-3d":
            K.bn_channel_sums(torch.randn(2, 3, 4))
        elif bad == "bn-shapes":
            K.bn_channel_sums(x, torch.randn(2, 3, 9, 8))
        elif bad == "bn-dtypes":
            K.bn_channel_sums(x, x.double())
        elif bad == "pool-3d":
            K.max_pool_backward(x[0], dy[0], (3, 3), (2, 2), pads)
        elif bad == "pool-taps":
            K.max_pool_backward(x, torch.randn(2, 3, 1, 1), (9, 9), (1, 1),
                                ((0, 0), (0, 0)))
        elif bad == "pool-dtypes":
            K.max_pool_backward(x, dy.double(), (3, 3), (2, 2), pads)
        else:
            K.avg_pool_backward(dy, torch.ones(3, 3), tuple(x.shape),
                                (3, 3), (2, 2), pads)


def test_kernel_signature_names_every_family():
    assert K.kernel_signature("cpu") == (("attn", "plain"), ("bn", "plain"),
                                         ("pool", "plain"))

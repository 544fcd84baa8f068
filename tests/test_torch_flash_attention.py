"""The port's flash-attention forward (``mxnet_tpu_torch.ops.kernels``)
against the JAX package's Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain version; the JAX
kernel runs in the Pallas interpreter (``use_pallas=True,
interpret=True``), as the JAX package's own tests run it.  Inputs come
from a numpy seed.  Tolerance f32 atol=rtol=1e-5: both sides compute in
f32 and differ only in summation order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from mxnet_tpu.ops import pallas_kernels as pk

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.ops import kernels as K

TOL = dict(atol=1e-5, rtol=1e-5)

CASES = [(d, s, causal, lens)
         for d in (64, 128) for s in (40, 128)
         for causal in (False, True) for lens in (False, True)]


def _qkv(b, s, h, d, seed):
    r = np.random.RandomState(seed)
    return [r.normal(0, 1, (b, s, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize(
    "d,s,causal,lens", CASES,
    ids=["d%d-s%d-%s%s" % (d, s, "causal" if c else "full",
                           "-lens" if ln else "") for d, s, c, ln in CASES])
def test_flash_matches_pallas_kernel(d, s, causal, lens):
    q, k, v = _qkv(2, s, 2, d, seed=d + s)
    kv = np.array([0, s - 7], np.int32) if lens else None
    want = pk.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        use_pallas=True, interpret=True, block_q=32, block_k=32,
        kv_lens=None if kv is None else jnp.asarray(kv))
    before = K.launch_counts()
    got = K.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, kv_lens=None if kv is None else torch.from_numpy(kv))
    # the CPU tensor took the plain version: no kernel launch counted
    assert K.launch_counts() == before
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if lens:  # the row batch with no valid key is all zeros in both
        assert not got[0].any()


def test_launch_counter_stays_zero_on_cpu():
    K.reset_launch_counts()
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 64, seed=0))
    K.attention(q, k, v, causal=True)
    assert K.launch_counts()["flash_attn_fwd"] == 0
    assert K.launch_counts() == dict.fromkeys(K.LAUNCHES, 0)


@pytest.mark.parametrize("bad", ["head_dim", "dtype", "lens_dtype",
                                 "lens_shape", "stride"])
def test_wrapper_rejects_what_the_kernel_cannot_take(bad):
    """Malformed arguments raise on every device.  What only the CUDA
    kernel cannot take (a head_dim other than 32/64/128, a dtype other
    than f32/bf16, a strided head_dim axis) raises in the check the CUDA
    path applies, while host tensors take the plain version (the card's
    raising is tests/test_torch_cuda.py's)."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 16, 2, 64, seed=1))
    lens = None
    if bad == "head_dim":
        q, k, v = (torch.from_numpy(a) for a in _qkv(2, 16, 2, 48, seed=1))
    elif bad == "dtype":
        q, k, v = (t.double() for t in (q, k, v))
    elif bad == "lens_dtype":
        lens = torch.tensor([16, 3], dtype=torch.int64)
    elif bad == "lens_shape":
        lens = torch.tensor([16], dtype=torch.int32)
    else:
        q = q.transpose(2, 3).contiguous().transpose(2, 3)
    if bad.startswith("lens"):
        with pytest.raises(mx.MXNetError):
            K.flash_attention(q, k, v, kv_lens=lens)
        return
    with pytest.raises(mx.MXNetError, match="unsupported on the card"
                       if bad != "stride" else "contiguous"):
        K._check_flash_kernel_args(q, k, v)
    out = K.flash_attention(q, k, v)
    want = K._reference_attention(q, k, v, False, q.shape[-1] ** -0.5)
    assert out.dtype == q.dtype and torch.equal(out, want)


def test_plain_bf16_rounds_like_f32_within_bf16_tolerance():
    q, k, v = (torch.from_numpy(a) for a in _qkv(2, 40, 2, 64, seed=2))
    want = K.flash_attention(q, k, v, causal=True)
    got = K.flash_attention(*(t.bfloat16() for t in (q, k, v)), causal=True)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               atol=2e-2, rtol=0)


def test_kernel_signature_follows_the_device():
    assert K.kernel_signature(torch.device("cpu")) == tuple(
        (k, "plain") for k in K.KERNEL_FAMILIES)
    assert K.kernel_signature("cuda:0") == tuple(
        (k, "cuda") for k in K.KERNEL_FAMILIES)
    assert K.KERNEL_FAMILIES[0] == "attn"

"""The flash kernel's LSE variant and the differentiable attention
(``_FlashAttnFn``: the LSE forward plus the blockwise flash backward) of
``mxnet_tpu_torch.ops.kernels``, against the JAX package.

On the CPU the port's wrappers run the kernel's plain versions; the JAX
kernel runs in the Pallas interpreter (``interpret=True``), as the JAX
package's own tests run it.  Inputs come from a numpy seed.

Tolerances: ``(out, lse)`` f32 atol=rtol=1e-5 (summation order only);
gradients at head_dim 128 against ``jax.grad`` of the Pallas kernel as
``tests/test_attention.py`` holds that kernel to its reference: f32
atol=rtol=2e-4, bf16 3e-2; gradients at head_dim 64 (which the JAX
kernel does not take on the TPU) against ``jax.grad`` of its reference
attention at the same tolerances; the port's flash backward against
torch autograd through the port's plain forward f32 atol=rtol=1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from mxnet_tpu.ops import pallas_kernels as pk

from mxnet_tpu_torch.ops import kernels as K


def _qkv(b, s, h, d, seed):
    r = np.random.RandomState(seed)
    return [r.normal(0, 1, (b, s, h, d)).astype(np.float32) for _ in range(3)]


def _jax_flash_lse(q, k, v, causal, scale, lens, block):
    """(out, lse) of the JAX Pallas kernel's LSE variant, interpreted,
    laid out as the port's [B, S, H, D] and [B, H, S]."""
    b, s, h, d = q.shape
    fold = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3).reshape(b * h, s, d)  # noqa: E731
    lens_f = jnp.full((b,), s, jnp.float32) if lens is None \
        else jnp.asarray(lens, jnp.float32)
    lens_f = jnp.broadcast_to(lens_f[:, None], (b, h)).reshape(b * h, 1)
    lens_f = jnp.broadcast_to(lens_f, (b * h, 128))
    fn = pk._flash_jitted(b, h, s, s, d, "float32", causal, float(scale),
                          block, block, True, with_lse=True)
    out, lse = fn(fold(q), fold(k), fold(v), lens_f)
    out = np.asarray(out).reshape(b, h, s, d).transpose(0, 2, 1, 3)
    return out, np.asarray(lse)[:, :, 0].reshape(b, h, s)


LSE_CASES = [(d, causal, lens) for d in (64, 128) for causal in (False, True)
             for lens in (False, True)]


@pytest.mark.parametrize(
    "d,causal,lens", LSE_CASES,
    ids=["d%d-%s%s" % (d, "causal" if c else "full", "-lens" if ln else "")
         for d, c, ln in LSE_CASES])
def test_plain_lse_variant_matches_pallas_kernel(d, causal, lens):
    q, k, v = _qkv(2, 64, 2, d, seed=d)
    kv = np.array([0, 41], np.int32) if lens else None
    scale = 1.0 / d ** 0.5
    want_out, want_lse = _jax_flash_lse(q, k, v, causal, scale, kv, 32)
    before = K.launch_counts()
    got_out, got_lse = K.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, scale=scale,
        kv_lens=None if kv is None else torch.from_numpy(kv), with_lse=True)
    assert K.launch_counts() == before  # CPU tensors: the plain version
    assert got_lse.dtype == torch.float32 and got_lse.shape == (2, 2, 64)
    np.testing.assert_allclose(got_out.numpy(), want_out, atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(got_lse.numpy(), want_lse, atol=1e-5,
                               rtol=1e-5)
    if lens:  # the batch with no valid key: -1e30, as the TPU kernel writes
        assert np.all(got_lse[0].numpy() == np.float32(-1e30))


# the cases of tests/test_attention.py's flash gradient test
ATTN_CASES = [
    ("float32", False, False, 16), ("float32", True, False, 16),
    ("float32", False, True, 16), ("float32", True, True, 13),
    ("bfloat16", False, False, 16), ("bfloat16", True, True, 16),
]
ATTN_IDS = ["%s-%s%s-s%d" % (c[0], "causal" if c[1] else "full",
                             "-lens" if c[2] else "", c[3])
            for c in ATTN_CASES]


def _grads_both(d, dtype, causal, with_lens, seq, jax_attention):
    r = np.random.RandomState(2)
    q, k, v = (r.normal(0, 1, (2, seq, 2, d)).astype(np.float32)
               for _ in range(3))
    w = np.random.RandomState(3).normal(0, 1, q.shape).astype(np.float32)
    lens = np.array([seq, max(1, seq - 5)], np.int32) if with_lens else None
    scale = 1.0 / d ** 0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jl = None if lens is None else jnp.asarray(lens)

    def f(q_, k_, v_):
        o = jax_attention(q_, k_, v_, causal, scale, jl)
        return jnp.sum(o.astype(jnp.float32) * w)

    want = jax.grad(f, argnums=(0, 1, 2))(
        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tq, tk, tv = (torch.tensor(a).to(tdt).requires_grad_() for a in (q, k, v))
    out = K.attention(tq, tk, tv, causal=causal, scale=scale,
                      kv_lens=None if lens is None else torch.tensor(lens))
    assert type(out.grad_fn).__name__ == "_FlashAttnFnBackward"
    got = torch.autograd.grad((out.float() * torch.tensor(w)).sum(),
                              (tq, tk, tv))
    tol = dict(atol=3e-2, rtol=3e-2) if dtype == "bfloat16" \
        else dict(atol=2e-4, rtol=2e-4)
    for g, ref, name in zip(got, want, "qkv"):
        assert g.dtype == tdt
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(ref, np.float32),
                                   err_msg="d%s diverged" % name, **tol)


@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_grads_match_the_pallas_kernel_d128(case):
    dtype, causal, with_lens, seq = case

    def pallas(q, k, v, causal, scale, lens):
        return pk.flash_attention(q, k, v, causal=causal, scale=scale,
                                  use_pallas=True, interpret=True,
                                  kv_lens=lens)

    _grads_both(128, dtype, causal, with_lens, seq, pallas)


@pytest.mark.parametrize("case", ATTN_CASES, ids=ATTN_IDS)
def test_grads_match_the_reference_d64(case):
    dtype, causal, with_lens, seq = case
    _grads_both(64, dtype, causal, with_lens, seq, pk._reference_attention)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_blockwise_backward_matches_autograd_of_the_plain_forward(causal):
    """Several query blocks (300 rows in blocks of 128, the last ragged)
    and a sequence with no valid key: the flash backward against torch
    autograd through the port's plain forward; the keyless sequence
    takes exactly zero gradient."""
    q, k, v = (torch.from_numpy(a).requires_grad_()
               for a in _qkv(3, 300, 2, 64, seed=5))
    lens = torch.tensor([300, 0, 111], dtype=torch.int32)
    w = torch.from_numpy(np.random.RandomState(6).normal(
        0, 1, q.shape).astype(np.float32))
    got = torch.autograd.grad(
        (K.attention(q, k, v, causal=causal, kv_lens=lens) * w).sum(),
        (q, k, v))
    want = torch.autograd.grad(
        (K._reference_attention(q, k, v, causal, 1 / 8.0, lens) * w).sum(),
        (q, k, v))
    for g, ref in zip(got, want):
        np.testing.assert_allclose(g.numpy(), ref.numpy(), atol=1e-5,
                                   rtol=1e-5)
        assert not g[1].any()


def test_undifferentiated_calls_take_the_lse_less_forward():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 16, 2, 64, seed=0))
    assert K.attention(q, k, v).grad_fn is None  # nothing requires grad
    q.requires_grad_()
    with torch.no_grad():
        assert K.attention(q, k, v).grad_fn is None
    assert K.attention(q, k, v).grad_fn is not None

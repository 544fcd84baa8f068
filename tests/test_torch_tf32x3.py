"""The accuracy argument of the flash kernel's 3xTF32 products, on the CPU.

The CUDA flash forward (``mxnet_tpu_torch/csrc/flash_attn_fwd.cu``) runs
its f32 products on the tensor cores as three TF32 passes: each operand
x = big + small, big = x rounded to TF32 (10 mantissa bits, to nearest,
ties away from zero), small = the f32 residual x - big, which the MMA
reads truncated to TF32; a.b ~ small_a.big_b + big_a.small_b +
big_a.big_b, accumulated in f32.  No kernel runs here, so these tests
emulate that arithmetic in torch: TF32 values times TF32 values are exact
in f32, so an f32 matmul of the emulated operands gives the MMA's
products.  Both products of the plain attention (S = Q K^T and O = P V)
go through the split, and output and log-sum-exp must stay within the
kernel's f32 gate (atol = rtol = 1e-4) of the plain f32 version; the
single-pass TF32 error is printed beside it, not asserted.
"""
import numpy as np
import pytest
import torch

from mxnet_tpu_torch.ops import kernels as K

F32_TOL = dict(atol=1e-4, rtol=1e-4)
_MASK = -8192  # 0xffffe000 as int32: clears the 13 bits below TF32's


def tf32_round(x):
    """x rounded to TF32, to nearest with ties away from zero (the
    kernel's ``(bits + 0x1000) & 0xffffe000``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & _MASK).view(torch.float32)


def tf32_truncate(x):
    """x truncated to TF32: what the MMA reads from an f32 register."""
    return (x.contiguous().view(torch.int32) & _MASK).view(torch.float32)


def split(x):
    big = tf32_round(x)
    return big, tf32_truncate(x - big)


def einsum_3xtf32(eq, a, b):
    """``torch.einsum(eq, a, b)`` as the kernel's three TF32 passes."""
    ab, asm = split(a)
    bb, bsm = split(b)
    return (torch.einsum(eq, asm, bb) + torch.einsum(eq, ab, bsm)) \
        + torch.einsum(eq, ab, bb)


def einsum_tf32(eq, a, b):
    """One TF32 pass, for comparison."""
    return torch.einsum(eq, tf32_round(a), tf32_round(b))


def attention_lse(q, k, v, causal, scale, einsum):
    """``K._reference_attention_lse`` with both products through
    ``einsum``."""
    s = einsum("bqhd,bkhd->bhqk", q, k) * scale
    n_q, n_k = q.shape[1], k.shape[1]
    valid = torch.ones((n_q, n_k), dtype=torch.bool)
    if causal:
        valid = torch.tril(valid)
    s = s.masked_fill(~valid[None, None], K._NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]) * valid[None, None]
    return einsum("bhqk,bkhd->bqhd", p, v), lse


def _inputs(seed, b, s, h, d):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, s, h, d),
                                                 dtype=np.float32))
            for _ in range(3)]


def _err(got, want):
    return float((got - want).abs().max())


@pytest.mark.parametrize("causal,d", [(True, 64), (False, 128)],
                         ids=["causal-d64", "full-d128"])
def test_three_pass_tf32_attention_within_the_f32_gate(causal, d):
    q, k, v = _inputs(0, 2, 256, 2, d)
    scale = d ** -0.5
    ref_out, ref_lse = K._reference_attention_lse(q, k, v, causal, scale)
    out3, lse3 = attention_lse(q, k, v, causal, scale, einsum_3xtf32)
    out1, lse1 = attention_lse(q, k, v, causal, scale, einsum_tf32)
    print("3xTF32: out %.3g, lse %.3g; one TF32 pass: out %.3g, lse %.3g "
          "(max abs error against plain f32)"
          % (_err(out3, ref_out), _err(lse3, ref_lse),
             _err(out1, ref_out), _err(lse1, ref_lse)))
    np.testing.assert_allclose(out3.numpy(), ref_out.numpy(), **F32_TOL)
    np.testing.assert_allclose(lse3.numpy(), ref_lse.numpy(), **F32_TOL)


def test_split_reconstructs_f32_to_within_2_pow_minus_21():
    """big + small (as the MMA reads it) is x to within 2^-21 relative:
    big carries 11 significant bits, small the next 11."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.standard_normal(100000) * 10.0 ** rng.uniform(
        -6, 6, 100000)).astype(np.float32))
    big, small = split(x)
    assert torch.all((big.view(torch.int32) & 0x1FFF) == 0)
    assert torch.all((small.view(torch.int32) & 0x1FFF) == 0)
    # round to nearest: big is within half a TF32 ulp (2^-11 relative)
    assert torch.all((x - big).abs() <= x.abs() * 2.0 ** -11)
    rel = ((big.double() + small.double()) - x.double()).abs() \
        / x.double().abs()
    assert float(rel.max()) <= 2.0 ** -21

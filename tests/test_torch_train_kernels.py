"""The port's plain versions of the training kernels against the JAX
package's Pallas kernels, run in interpret mode on the CPU.

``bn_channel_sums`` against ``pallas_kernels.bn_channel_sums(...,
interpret=True)``; ``max_pool_backward``/``avg_pool_backward`` against
the gradients of ``ops.nn._pool_core(..., "interpret")``, over the
reference's own eight pooling cases (tests/test_pallas_kernels.py), a
post-ReLU input full of tied zeros, the global pool, and bf16; the
channel-sums planner (every element of every channel summed once, the
multiply-high plane division exact) and the cached pooling divisor.
Tolerances: f32 within
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


@pytest.mark.parametrize("pool", ["avg", "sum"])
def test_global_pool_backward_plain_matches_pallas_interpret(pool):
    """``global_pool=True`` through the port's Pooling op (the window the
    whole 7 x 7 plane, as ResNet's last pool) against the reference's
    kernel path on that window."""
    x = np.random.RandomState(6).randn(2, 8, 7, 7).astype(np.float32)
    out, want = _jax_pool(x, (pool, (7, 7), (1, 1), (0, 0), "valid", True))
    xt = torch.from_numpy(x).requires_grad_()
    y = nn_ops._pooling(xt, pool_type=pool, global_pool=True)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(2.0 * out))
    assert y.shape == (2, 8, 1, 1)
    np.testing.assert_allclose(y.detach().numpy(), out, **F32)
    np.testing.assert_allclose(got.numpy(), want, **F32)


@pytest.mark.parametrize("case", POOL_CASES,
                         ids=["-".join(map(str, c)) for c in POOL_CASES])
def test_pool_divisor_is_cached_per_geometry_and_device(case):
    """The backward's divisor map is built once per geometry and device
    (no fill per step) and equals a freshly built one."""
    pool, kernel, stride, pad, conv, cip = case
    x_shape = (2, 3, 11, 13)
    pads = nn_ops._pool_spatial_pads(x_shape[2:], kernel, stride, pad, conv)
    out_shape = tuple(nn_ops._pool_out_dim(x_shape[2 + i], kernel[i],
                                           stride[i], pad[i], conv)
                      for i in range(2))
    args = (pool, cip, x_shape, kernel, stride, pads, out_shape)
    cpu = torch.device("cpu")
    div = nn_ops._pool_divisor(*args, cpu)
    assert nn_ops._pool_divisor(*args, cpu) is div
    fresh = nn_ops._make_pool_divisor(*args, cpu)
    assert div.dtype == torch.float32 and torch.equal(div, fresh)
    meta = nn_ops._pool_divisor(*args, torch.device("meta"))
    assert meta.device.type == "meta" and meta.shape == div.shape
    wider = (2, 3, 11, 13 + stride[1])
    other = nn_ops._pool_divisor(pool, cip, wider, kernel, stride, pads,
                                 (out_shape[0], out_shape[1] + 1), cpu)
    assert other is not div and other.shape[1] == out_shape[1] + 1


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


@pytest.mark.parametrize("shape", [(2, 64, 7, 7), (3, 3, 16, 16)],
                         ids=["hw49-c64", "c3"])
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_bn_channel_sums_plain_matches_pallas_interpret_at_resnet_layouts(
        shape, paired):
    """The layouts the kernel's planner treats apart: 7 x 7 planes with
    many more channels than images, and 3 channels (the raw image)."""
    r = np.random.RandomState(7)
    a = r.randn(*shape).astype(np.float32)
    b = r.randn(*shape).astype(np.float32) if paired else None
    want = pk.bn_channel_sums(jnp.asarray(a),
                              None if b is None else jnp.asarray(b),
                              interpret=True)
    got = K.bn_channel_sums(torch.from_numpy(a),
                            None if b is None else torch.from_numpy(b))
    for g, w in zip(got, want):
        assert g.shape == (shape[1],)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32)


# ResNet-50 v2's 13 train-mode BatchNorm input shapes at batch 32
RESNET_BN_SHAPES = [
    (32, 3, 224, 224), (32, 64, 112, 112), (32, 64, 56, 56),
    (32, 128, 56, 56), (32, 256, 56, 56), (32, 128, 28, 28),
    (32, 256, 28, 28), (32, 512, 28, 28), (32, 256, 14, 14),
    (32, 512, 14, 14), (32, 1024, 14, 14), (32, 512, 7, 7),
    (32, 2048, 7, 7)]
ODD_BN_SHAPES = [(1, 1, 1, 1), (3, 5, 7, 9), (1, 3, 2, 2), (2, 1, 1, 4099),
                 (5, 7, 0, 3), (1, 2, 3000, 3001)]


def _bn_block_ranges(c, plan, total):
    """(channel, first unit, end unit) of each block of the kernel's grid,
    as ``channel_sums_kernel`` reads its block index."""
    splits, group, chunk = plan[:3]
    if group > 1:
        for blk in range(-(-c // group)):
            for ch in range(blk * group, min(c, blk * group + group)):
                yield ch, 0, total
    else:
        for blk in range(c * splits):
            ch, s = divmod(blk, splits)
            yield ch, s * chunk, min(total, s * chunk + chunk)


@pytest.mark.parametrize("sms", [132, 1])
@pytest.mark.parametrize("shape", RESNET_BN_SHAPES + ODD_BN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_bn_plan_sums_every_element_once(shape, sms):
    n, c, h, w = shape
    for vec in (1, 4, 8):
        if h * w % vec:
            continue
        plan = K._bn_plan(n, c, h, w, vec, sms)
        splits, group, chunk, magic, shift = plan
        total = n * h * w // vec
        assert splits >= 1 and group >= 1 and (splits == 1 or group == 1)
        assert chunk * splits >= total and (splits - 1) * chunk < max(total, 1)
        ranges = {}
        for ch, u0, u1 in _bn_block_ranges(c, plan, total):
            ranges.setdefault(ch, []).append((u0, u1))
        assert sorted(ranges) == list(range(c))
        for spans in ranges.values():
            spans.sort()
            assert spans[0][0] == 0 and spans[-1][1] == total
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        # each unit's plane, as the kernel divides
        plane = max(h * w // vec, 1)
        u = np.arange(total, dtype=np.uint64)
        got = ((u * np.uint64(magic)) >> np.uint64(32)) + u >> np.uint64(shift)
        assert np.array_equal(got, u // np.uint64(plane))
        if shape in RESNET_BN_SHAPES and sms == 132:
            blocks = c * splits if group == 1 else -(-c // group)
            assert blocks >= sms  # the card is full, 3 channels or 2048
            per_block = n * h * w * (group if group > 1 else 1) // (
                splits if group == 1 else 1)
            assert per_block >= 2048  # no block of a few hundred elements


@pytest.mark.parametrize("d", [1, 2, 3, 7, 49, 196, 3136, 12544, 50176,
                               2 ** 20 + 1, 2 ** 31 - 1])
def test_fast_divider_is_exact_below_2_to_31(d):
    magic, shift = K._fast_divider(d)
    assert 0 < magic < 2 ** 32
    r = np.random.RandomState(d % 1000)
    xs = np.concatenate([np.arange(0, min(4 * d + 5, 10 ** 5)),
                         d * np.arange(1, 50) - 1, [2 ** 31 - 1, 2 ** 31 - d],
                         r.randint(0, 2 ** 31, 1000)]).astype(np.uint64)
    xs = xs[xs < 2 ** 31]
    got = ((xs * np.uint64(magic)) >> np.uint64(32)) + xs >> np.uint64(shift)
    assert np.array_equal(got, xs // np.uint64(d))


def test_bn_vector_loads_need_aligned_plane_contiguous_views():
    x = torch.zeros(4, 6, 8, 8)
    assert K._bn_vec((x,), 8, 8) == (4, True)
    assert K._bn_vec((x.bfloat16(),), 8, 8) == (8, True)
    off = torch.zeros(4 * 6 * 8 * 8 + 1)[1:].view(4, 6, 8, 8)
    assert K._bn_vec((x, off), 8, 8) == (1, True)
    assert K._bn_vec((torch.zeros(4, 6, 7, 7),), 7, 7) == (1, True)
    assert K._bn_vec((x.transpose(2, 3),), 8, 8) == (1, False)


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
                                         ("pool", "plain"), ("nms", "plain"),
                                         ("deform", "plain"))


@pytest.mark.parametrize("source, struct_name, packer", [
    ("bn_channel_sums", "BnArgs", K._BN_ARGS),
    ("pool_bwd", "AvgArgs", K._AVG_POOL_ARGS)])
def test_packed_launch_arguments_match_the_c_struct(source, struct_name,
                                                    packer):
    """The wrappers pack a launch's arguments as int64s, one per field of
    the C entry's argument struct, in the order the struct declares."""
    import os
    import re
    from mxnet_tpu_torch.ops import _build
    with open(os.path.join(_build.SRC_DIR, source + ".cu")) as f:
        text = f.read()
    body = re.search(r"struct %s \{(.*?)\};" % struct_name, text, re.S)
    fields = re.findall(r"\w+(?=[,;])", body.group(1))
    assert all(t == "long long" for t in re.findall(
        r"(long long|int|unsigned int|void\*)\s", body.group(1)))
    assert len(fields) == packer.size // 8
    assert "static_assert(sizeof(%s) == %d * 8" % (
        struct_name, len(fields)) in text

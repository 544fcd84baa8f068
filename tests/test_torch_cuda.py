"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``: on a machine without a CUDA device every test here skips
(the decision is made inside a fixture, at run time).  On the card, run
``python -m pytest tests/test_torch_cuda.py -q``; the first test builds
the kernels with nvcc (a few seconds).  Tolerances: flash attention and
the channel sums f32 atol=rtol=1e-4 (f32 sums in another order); bf16
compared in f32 at atol=2e-2 (output rounding to bf16); the pooling
gradients exactly, since kernel and plain version form each pixel's sum
from the same terms in the same order.
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer_lm_symbol
from mxnet_tpu_torch.ops import kernels as K

import dcgan_net
import random_cases

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


CASES = [  # B, Sq, Sk, H, D, causal, dtype, kv_lens
    (2, 128, 128, 4, 64, True, torch.float32, None),
    (2, 77, 77, 3, 64, False, torch.float32, None),
    (3, 130, 130, 2, 128, True, torch.float32, [130, 0, 41]),
    (2, 40, 96, 2, 128, False, torch.float32, [96, 50]),
    (2, 100, 100, 4, 64, True, torch.bfloat16, [100, 63]),
    # many q-tiles under causal, Sq not a tile multiple
    (1, 1000, 1000, 2, 64, True, torch.float32, None),
    # causal with Sq != Sk, both ways
    (2, 200, 77, 2, 64, True, torch.float32, None),
    (2, 70, 300, 2, 128, True, torch.float32, None),
    # kv_len shorter than one KV tile, and 0
    (3, 150, 150, 2, 64, False, torch.float32, [5, 0, 150]),
    (2, 96, 96, 2, 128, True, torch.float32, [17, 0]),
    # D 128 in bf16
    (2, 300, 300, 3, 128, True, torch.bfloat16, None),
    (2, 64, 130, 2, 128, False, torch.bfloat16, [130, 9]),
    # D 32 (the zoo TransformerLM's default head), f32 and bf16
    (2, 200, 200, 4, 32, True, torch.float32, None),
    (3, 77, 150, 2, 32, False, torch.float32, [150, 0, 33]),
    (2, 130, 130, 4, 32, True, torch.bfloat16, [130, 64]),
]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(card, case):
    b, sq, sk, h, d, causal, dtype, lens = case
    g = torch.Generator(device=card).manual_seed(0)
    q = torch.randn(b, sq, h, d, generator=g, device=card).to(dtype)
    k = torch.randn(b, sk, h, d, generator=g, device=card).to(dtype)
    v = torch.randn(b, sk, h, d, generator=g, device=card).to(dtype)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=card)
    before = K.launch_counts()["flash_attn_fwd"]
    out = K.flash_attention(q, k, v, causal=causal, kv_lens=kl)
    torch.cuda.synchronize()
    assert K.launch_counts()["flash_attn_fwd"] == before + 1
    ref = K._reference_attention(q, k, v, causal, 1.0 / d ** 0.5, kl)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **tol)


def _strided_qkv(card, layout, d, dtype, seed):
    """[B, S, H, D] views of one buffer: ``fused`` slices a [B, S, 3, H,
    D] projection (16-byte aligned strides: the kernel's asynchronous
    copies), ``offset`` starts each view one element into a [B, S, H,
    D + 1] buffer (unaligned: the kernel's plain loads)."""
    g = torch.Generator(device=card).manual_seed(seed)
    if layout == "fused":
        qkv = torch.randn(2, 150, 3, 3, d, generator=g, device=card)
        return list(qkv.to(dtype).unbind(2))
    return [torch.randn(2, 150, 3, d + 1, generator=g, device=card)
            .to(dtype)[..., 1:] for _ in range(3)]


@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["fused", "offset"])
@pytest.mark.parametrize("with_lse", [False, True], ids=["fwd", "lse"])
def test_flash_kernel_reads_strided_inputs(card, layout, dtype, d, with_lse):
    q, k, v = _strided_qkv(card, layout, d, dtype, 1)
    assert not q.is_contiguous() and q.stride(-1) == 1
    name = "flash_attn_fwd_lse" if with_lse else "flash_attn_fwd"
    before = K.launch_counts()[name]
    got = K.flash_attention(q, k, v, causal=True, with_lse=with_lse)
    torch.cuda.synchronize()
    assert K.launch_counts()[name] == before + 1
    ref_out, ref_lse = K._reference_attention_lse(q, k, v, True, d ** -0.5)
    out = got[0] if with_lse else got
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref_out.float().cpu().numpy(), **tol)
    if with_lse:
        np.testing.assert_allclose(got[1].cpu().numpy(),
                                   ref_lse.cpu().numpy(), atol=1e-4,
                                   rtol=1e-4)


def test_small_lm_on_the_card_matches_the_host(card):
    cfg = dict(embed_dim=128, num_heads=2, num_layers=2, seq_len=32)
    sym = transformer_lm_symbol(100, **cfg)
    shapes, _, _ = sym.infer_shape(data=(1, 32))
    r = np.random.RandomState(0)
    arrays = {n: (r.normal(size=s) * 0.05).astype(np.float32)
              for n, s in zip(sym.list_arguments(), shapes) if n != "data"}
    x = r.randint(0, 100, (3, 32)).astype(np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        args, _ = mx.convert.params_from_numpy(arrays, ctx)
        pred = mx.Predictor(sym.tojson(), args, {"data": x.shape}, ctx=ctx)
        pred.forward(data=x)
        outs.append(pred.get_output(0).asnumpy())
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-4, rtol=1e-4)


def _pos(g, shape, card, dtype=torch.float32):
    """Inputs with a nonzero mean, so that no channel sum sits near 0 where
    only the absolute tolerance would hold."""
    return (torch.randn(*shape, generator=g, device=card) + 0.5).to(dtype)


BN_CASES = [  # shape, dtype
    ((4, 3, 20, 20), torch.float32),
    ((4, 6, 5, 7), torch.float32),
    ((3, 5, 7, 9), torch.float32),
    ((2, 64, 9, 9), torch.float32),
    ((8, 16, 12, 12), torch.bfloat16),
]


@pytest.mark.parametrize("case", BN_CASES, ids=lambda c: "x".join(
    map(str, c[0])) + "-" + str(c[1]).replace("torch.", ""))
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_bn_channel_sums_matches_plain(card, case, paired):
    shape, dtype = case
    g = torch.Generator(device=card).manual_seed(2)
    a = _pos(g, shape, card, dtype)
    b = _pos(g, shape, card, dtype) if paired else None
    before = K.launch_counts()["bn_channel_sums"]
    got = K.bn_channel_sums(a, b)
    torch.cuda.synchronize()
    assert K.launch_counts()["bn_channel_sums"] == before + 1
    want = K._plain_channel_sums(a, b)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=1e-4)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and x.shape == (shape[1],)
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), **tol)
    again = K.bn_channel_sums(a, b)  # deterministic: no float atomics
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_bn_channel_sums_reads_strided_views(card):
    g = torch.Generator(device=card).manual_seed(3)
    base = _pos(g, (4, 6, 10, 16), card)
    a = base[:, :, ::2, 3:11]           # plane not contiguous
    b = _pos(g, (6, 4, 5, 8), card).transpose(0, 1)  # N, C swapped
    got = K.bn_channel_sums(a, b)
    want = K._plain_channel_sums(a, b)
    for x, y in zip(got, want):
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                   atol=1e-4, rtol=1e-4)


# ResNet-50 v2's 13 train-mode BatchNorm input shapes at batch 32
RESNET_BN_SHAPES = [
    (32, 3, 224, 224), (32, 64, 112, 112), (32, 64, 56, 56),
    (32, 128, 56, 56), (32, 256, 56, 56), (32, 128, 28, 28),
    (32, 256, 28, 28), (32, 512, 28, 28), (32, 256, 14, 14),
    (32, 512, 14, 14), (32, 1024, 14, 14), (32, 512, 7, 7),
    (32, 2048, 7, 7)]


def _check_bn(a, b, tol=dict(atol=1e-4, rtol=1e-4)):
    """One launch, within ``tol`` of the plain version, and a second call
    bit-identical to the first (the arrival counters were reset)."""
    before = K.launch_counts()["bn_channel_sums"]
    got = K.bn_channel_sums(a, b)
    again = K.bn_channel_sums(a, b)
    torch.cuda.synchronize()
    assert K.launch_counts()["bn_channel_sums"] == before + 2
    want = K._plain_channel_sums(a, b)
    for x, y, z in zip(got, want, again):
        assert x.dtype == torch.float32 and x.shape == (a.shape[1],)
        np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(), **tol)
        assert torch.equal(x, z)


@pytest.mark.parametrize("shape", RESNET_BN_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_bn_channel_sums_at_every_resnet50_shape(card, shape, paired):
    g = torch.Generator(device=card).manual_seed(10)
    a = _pos(g, shape, card)
    _check_bn(a, _pos(g, shape, card) if paired else None)


@pytest.mark.parametrize("shape", [(32, 512, 7, 7), (32, 3, 224, 224),
                                   (4, 1, 9, 9), (2, 3, 5, 5), (3, 1, 1, 1),
                                   (32, 1, 56, 56)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64],
                         ids=["f32", "bf16", "f16", "f64"])
def test_bn_channel_sums_small_and_bf16(card, shape, dtype):
    """bf16, f16 and f64 at H*W 49 and 224^2; one channel, three, and
    N*H*W below one block's share.  f16 and f64 inputs are summed in f32
    from the same elements on both sides, so they keep f32's tolerance."""
    g = torch.Generator(device=card).manual_seed(11)
    tol = dict(atol=2e-2, rtol=1e-4) if dtype == torch.bfloat16 \
        else dict(atol=1e-4, rtol=1e-4)
    for paired in (False, True):
        a = _pos(g, shape, card, dtype)
        _check_bn(a, _pos(g, shape, card, dtype) if paired else None, tol)


def test_bn_channel_sums_misaligned_view_takes_the_scalar_path(card):
    g = torch.Generator(device=card).manual_seed(12)
    shape = (32, 64, 28, 28)
    flat = _pos(g, (int(np.prod(shape)) + 1,), card)
    a = flat[1:].view(shape)          # 4 bytes past a 16-byte boundary
    b = _pos(g, shape, card)
    assert K._bn_vec((a, b), 28, 28) == (1, True)
    assert K._bn_vec((b,), 28, 28) == (4, True)
    _check_bn(a, b)
    _check_bn(a, None)


def test_bn_channel_sums_on_two_streams(card):
    """Calls in flight on two streams at once each keep their own arrival
    counters: both agree with the plain version, call after call."""
    g = torch.Generator(device=card).manual_seed(13)
    xs = [_pos(g, (32, 64, 56, 56), card) for _ in range(2)]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(card) for _ in range(2)]
    outs = [[], []]
    for _ in range(5):
        for i, st in enumerate(streams):
            with torch.cuda.stream(st):
                outs[i].append(K.bn_channel_sums(xs[i], xs[1 - i]))
    torch.cuda.synchronize()
    for i in range(2):
        want = K._plain_channel_sums(xs[i], xs[1 - i])
        for got in outs[i]:
            for x, y in zip(got, want):
                np.testing.assert_allclose(x.cpu().numpy(), y.cpu().numpy(),
                                           atol=1e-4, rtol=1e-4)
            assert all(torch.equal(x, y) for x, y in zip(got, outs[i][0]))


POOL_CUDA_CASES = [  # pool_type, shape, kernel, stride, pad, convention,
    #                  count_include_pad, dtype, post-ReLU
    ("max", (2, 4, 16, 16), (3, 3), (2, 2), (1, 1), "valid", True,
     torch.float32, True),
    ("max", (2, 3, 11, 13), (3, 3), (2, 2), (1, 1), "full", True,
     torch.float32, False),
    ("max", (2, 4, 12, 12), (3, 3), (2, 2), (1, 1), "valid", True,
     torch.bfloat16, True),
    ("avg", (2, 8, 7, 7), (7, 7), (1, 1), (0, 0), "valid", True,
     torch.float32, False),
    ("avg", (2, 3, 11, 13), (3, 3), (2, 2), (1, 1), "full", False,
     torch.float32, False),
    ("sum", (2, 3, 11, 13), (2, 3), (2, 1), (0, 1), "valid", True,
     torch.float32, False),
    # the stem's geometry across several bands
    ("max", (2, 3, 112, 112), (3, 3), (2, 2), (1, 1), "valid", True,
     torch.float32, True),
    ("max", (2, 3, 112, 112), (3, 3), (2, 2), (1, 1), "valid", True,
     torch.bfloat16, True),
    # heavy overlap: 49 windows cover most pixels
    ("max", (2, 3, 23, 29), (7, 7), (1, 1), (3, 3), "valid", True,
     torch.float32, True),
    # stride past the window: pixels no window covers
    ("max", (2, 3, 17, 20), (2, 2), (3, 3), (0, 0), "valid", True,
     torch.float32, False),
    # a plane wider than one shared-memory column tile
    ("max", (1, 2, 9, 1030), (3, 3), (2, 2), (1, 1), "valid", True,
     torch.float32, True),
    ("max", (1, 2, 40, 600), (3, 2), (1, 2), (1, 0), "full", True,
     torch.bfloat16, False),
    # the global pool's own path: ResNet's, bf16, a plane narrower than a
    # vector, and an N*C*H*W tail shorter than one
    ("avg", (32, 2048, 7, 7), (7, 7), (1, 1), (0, 0), "valid", True,
     torch.float32, False),
    ("avg", (32, 2048, 7, 7), (7, 7), (1, 1), (0, 0), "valid", True,
     torch.bfloat16, False),
    ("avg", (3, 5, 7, 7), (7, 7), (1, 1), (0, 0), "valid", True,
     torch.float32, False),
    ("sum", (3, 7, 1, 3), (1, 3), (1, 1), (0, 0), "valid", True,
     torch.bfloat16, False),
    # the general path: a row width that is no multiple of 4, bf16
    ("avg", (2, 3, 9, 10), (3, 3), (1, 1), (1, 1), "valid", False,
     torch.bfloat16, False),
    # f16 and f64: the stem, the global pool and the general paths
    ("max", (2, 3, 112, 112), (3, 3), (2, 2), (1, 1), "valid", True,
     torch.float16, True),
    ("max", (2, 3, 112, 112), (3, 3), (2, 2), (1, 1), "valid", True,
     torch.float64, True),
    ("max", (2, 3, 23, 29), (7, 7), (1, 1), (3, 3), "valid", True,
     torch.float16, False),
    ("max", (2, 3, 11, 13), (3, 3), (2, 2), (1, 1), "full", True,
     torch.float64, False),
    ("avg", (32, 2048, 7, 7), (7, 7), (1, 1), (0, 0), "valid", True,
     torch.float16, False),
    ("avg", (32, 2048, 7, 7), (7, 7), (1, 1), (0, 0), "valid", True,
     torch.float64, False),
    ("avg", (3, 5, 7, 7), (7, 7), (1, 1), (0, 0), "valid", True,
     torch.float16, False),
    ("avg", (2, 3, 11, 13), (3, 3), (2, 2), (1, 1), "full", False,
     torch.float16, False),
    ("sum", (2, 3, 12, 16), (2, 3), (2, 1), (0, 1), "valid", True,
     torch.float64, False),
]


@pytest.mark.parametrize("case", POOL_CUDA_CASES,
                         ids=lambda c: "-".join(map(str, c[:1] + c[2:7])))
def test_pool_backward_kernel_matches_plain(card, case):
    """Bit for bit; f64 inputs are drawn in f64 (values an f32 draw cast
    up could not hold)."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    pool, shape, kernel, stride, pad, conv, cip, dtype, relu = case
    g = torch.Generator(device=card).manual_seed(4)
    draw = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(*shape, generator=g, device=card, dtype=draw)
    if relu:
        x = torch.clamp_min(x, 0.0)  # windows full of tied zeros
    x = x.to(dtype)
    pads = nn_ops._pool_spatial_pads(shape[2:], kernel, stride, pad, conv)
    out_shape = tuple(nn_ops._pool_out_dim(shape[2 + i], kernel[i],
                                           stride[i], pad[i], conv)
                      for i in range(2))
    dy = torch.randn(shape[:2] + out_shape, generator=g, device=card,
                     dtype=draw).to(dtype)
    name = "max_pool_backward" if pool == "max" else "avg_pool_backward"
    before = K.launch_counts()[name]
    if pool == "max":
        got = K.max_pool_backward(x, dy, kernel, stride, pads)
        want = K._plain_max_pool_backward(x, dy, kernel, stride, pads)
    else:
        div = nn_ops._pool_divisor(pool, cip, shape, kernel, stride, pads,
                                   out_shape, card, K._acc_dtype(dtype))
        got = K.avg_pool_backward(dy, div, shape, kernel, stride, pads)
        want = K._plain_avg_pool_backward(dy, div, shape, kernel, stride,
                                          pads, dtype)
    torch.cuda.synchronize()
    assert K.launch_counts()[name] == before + 1
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64],
                         ids=["f32", "bf16", "f16", "f64"])
def test_global_avg_pool_backward_keeps_the_sign_of_zero(card, dtype):
    """The plain version forms 0 + dy * div, so dy = -0 gives +0: the
    kernel's dx equals it bit for bit, signs of zero included."""
    g = torch.Generator(device=card).manual_seed(14)
    dy = torch.randn(4, 6, 1, 1, generator=g, device=card)
    dy[0, :3] = -0.0
    dy[2, 5] = 0.0
    dy = dy.to(dtype)
    shape, pads = (4, 6, 7, 7), ((0, 0), (0, 0))
    from mxnet_tpu_torch.ops import nn as nn_ops
    div = nn_ops._pool_divisor("avg", True, shape, (7, 7), (1, 1), pads,
                               (1, 1), card, K._acc_dtype(dtype))
    got = K.avg_pool_backward(dy, div, shape, (7, 7), (1, 1), pads)
    want = K._plain_avg_pool_backward(dy, div, shape, (7, 7), (1, 1), pads,
                                      dtype)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(torch.signbit(got), torch.signbit(want))
    assert not torch.signbit(got[0, 0]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.float64],
                         ids=["f32", "bf16", "f16", "f64"])
def test_max_pool_backward_routes_nan_windows_nowhere(card, dtype):
    """A window holding a NaN gives its gradient to no tap (the plain
    version's max-then-equality test); the other windows are unchanged."""
    g = torch.Generator(device=card).manual_seed(8)
    x = torch.clamp_min(torch.randn(2, 3, 30, 34, generator=g, device=card),
                        0.0)
    x[0, 1, 4, 7] = float("nan")
    x[1, 2, 29, 0] = float("nan")
    x = x.to(dtype)
    dy = torch.randn(2, 3, 15, 17, generator=g, device=card).to(dtype)
    pads = ((1, 1), (1, 1))
    before = K.launch_counts()["max_pool_backward"]
    got = K.max_pool_backward(x, dy, (3, 3), (2, 2), pads)
    torch.cuda.synchronize()
    assert K.launch_counts()["max_pool_backward"] == before + 1
    want = K._plain_max_pool_backward(x, dy, (3, 3), (2, 2), pads)
    assert torch.equal(got, want)
    assert got[0, 1, 4, 7] == 0 and got[1, 2, 29, 0] == 0


@pytest.mark.parametrize("kernel,stride", [((3, 3), (2, 2)), ((2, 2), (2, 2))],
                         ids=["stem", "general"])
def test_double_max_pool_backward_routes_near_ties_to_the_larger_tap(
        card, kernel, stride):
    """f64 compares doubles on the card, in the stem's compiled 3x3/s2
    instance and in the general one: in the one window holding pixel
    (2, 2), taps 1 and 1 + 2**-40 (equal in f32) and 1e300 and 2e300
    (both inf in f32) send the gradient to the larger, bit for bit as the
    plain version."""
    g = torch.Generator(device=card).manual_seed(16)
    x = torch.randn(2, 3, 12, 12, generator=g, device=card,
                    dtype=torch.float64) * 1e-3
    x[0, 0, 2, 2], x[0, 0, 2, 3] = 1.0, 1.0 + 2.0 ** -40
    x[1, 2, 2, 2], x[1, 2, 3, 3] = 1e300, 2e300
    pad = 1 if kernel[0] == 3 else 0
    pads = ((pad, pad), (pad, pad))
    out = (12 + 2 * pad - kernel[0]) // stride[0] + 1
    dy = torch.randn(2, 3, out, out, generator=g, device=card,
                     dtype=torch.float64)
    before = K.launch_counts()["max_pool_backward"]
    got = K.max_pool_backward(x, dy, kernel, stride, pads)
    torch.cuda.synchronize()
    assert K.launch_counts()["max_pool_backward"] == before + 1
    want = K._plain_max_pool_backward(x, dy, kernel, stride, pads)
    assert torch.equal(got, want)
    assert got[0, 0, 2, 2] == 0 and got[0, 0, 2, 3] != 0
    assert got[1, 2, 2, 2] == 0 and got[1, 2, 3, 3] != 0


def test_max_pool_backward_reads_non_contiguous_inputs(card):
    g = torch.Generator(device=card).manual_seed(9)
    base = torch.clamp_min(torch.randn(4, 2, 27, 50, generator=g,
                                       device=card), 0.0)
    x = base.transpose(0, 1)[:, :, :, 3:46]   # (2, 4, 27, 43), N and C swapped
    dy = torch.randn(2, 4, 28, 15, generator=g, device=card)[:, :, ::2]
    pads = ((1, 1), (1, 1))
    assert not x.is_contiguous() and not dy.is_contiguous()
    before = K.launch_counts()["max_pool_backward"]
    got = K.max_pool_backward(x, dy, (3, 3), (2, 3), pads)
    torch.cuda.synchronize()
    assert K.launch_counts()["max_pool_backward"] == before + 1
    want = K._plain_max_pool_backward(x, dy, (3, 3), (2, 3), pads)
    assert got.shape == x.shape and torch.equal(got, want)


def test_small_convnet_trains_alike_on_card_and_host(card):
    torch.backends.cudnn.allow_tf32 = False
    from mxnet_tpu_torch.models import resnet
    sym = resnet.get_symbol(10, 18, "3,40,40")
    r = np.random.RandomState(0)
    x = r.rand(4, 3, 40, 40).astype(np.float32)
    y = r.randint(0, 10, (4,)).astype(np.float32)
    params = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mx.random.seed(0)
        mod = mx.mod.Module(sym, context=ctx)
        mod.fit(mx.io.NDArrayIter(x, y, batch_size=2), num_epoch=1,
                initializer=mx.initializer.Xavier(magnitude=2),
                optimizer_params={"learning_rate": 0.01, "momentum": 0.9})
        params.append(mod.get_params())
    (ag, xg), (ac, xc) = params
    for k in ac:
        np.testing.assert_allclose(ag[k].asnumpy(), ac[k].asnumpy(),
                                   atol=1e-4, rtol=1e-4)
    for k in xc:
        np.testing.assert_allclose(xg[k].asnumpy(), xc[k].asnumpy(),
                                   atol=1e-4, rtol=1e-4)


LSE_CASES = [  # B, S, H, D, causal, dtype, kv_lens
    (2, 130, 3, 64, True, torch.float32, None),
    (3, 96, 2, 128, False, torch.float32, [96, 0, 41]),
    (2, 100, 4, 64, True, torch.bfloat16, [100, 63]),
    (1, 1000, 2, 64, True, torch.float32, None),
    (3, 150, 2, 64, True, torch.float32, [7, 0, 150]),
    (2, 300, 3, 128, True, torch.bfloat16, [300, 33]),
    (2, 140, 4, 32, True, torch.float32, [140, 70]),
    (2, 96, 4, 32, False, torch.bfloat16, None),
]


@pytest.mark.parametrize("case", LSE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_lse_variant_matches_plain(card, case):
    """The kernel's LSE output: f32 [B, H, Sq] at atol=rtol=1e-4 (bf16
    inputs too: the kernel and the plain version both work in f32 from
    the same inputs); -1e30 for a row with no valid key."""
    b, s, h, d, causal, dtype, lens = case
    g = torch.Generator(device=card).manual_seed(5)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=card).to(dtype)
               for _ in range(3))
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=card)
    before = K.launch_counts()
    out, lse = K.flash_attention(q, k, v, causal=causal, kv_lens=kl,
                                 with_lse=True)
    torch.cuda.synchronize()
    after = K.launch_counts()
    assert after["flash_attn_fwd_lse"] == before["flash_attn_fwd_lse"] + 1
    assert after["flash_attn_fwd"] == before["flash_attn_fwd"]
    ref_out, ref_lse = K._reference_attention_lse(q, k, v, causal,
                                                  1.0 / d ** 0.5, kl)
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=2e-2, rtol=0)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref_out.float().cpu().numpy(), **tol)
    np.testing.assert_allclose(lse.cpu().numpy(), ref_lse.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", LSE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_attn_fn_grads_on_the_card_match_the_host(card, case):
    """``attention()`` under grad on CUDA tensors is differentiable (the
    LSE kernel and the flash backward): its gradients against torch
    autograd through the plain forward, on the card, at f32
    atol=rtol=1e-4 (bf16: 3e-2, as the JAX package holds its kernel)."""
    b, s, h, d, causal, dtype, lens = case
    g = torch.Generator(device=card).manual_seed(6)
    base = [torch.randn(b, s, h, d, generator=g, device=card).to(dtype)
            for _ in range(3)]
    w = torch.randn(b, s, h, d, generator=g, device=card)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=card)
    grads = []
    for fn in (lambda q, k, v: K.attention(q, k, v, causal, None, kl),
               lambda q, k, v: K._reference_attention(q, k, v, causal,
                                                      1.0 / d ** 0.5, kl)):
        q, k, v = (t.clone().requires_grad_() for t in base)
        out = fn(q, k, v)
        grads.append(torch.autograd.grad((out.float() * w).sum(), (q, k, v)))
    tol = dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32 \
        else dict(atol=3e-2, rtol=3e-2)
    for got, want in zip(*grads):
        assert got.abs().max() > 0
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   want.float().cpu().numpy(), **tol)


def test_mha_module_gradients_on_the_card_match_the_host(card):
    """Module.forward_backward through ``multi_head_attention`` (the
    graph of tests/test_attention.py:212): the q/k/v weight and bias
    gradients on the card are nonzero and equal the host's at
    atol=rtol=1e-4 (f32, TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    data = mx.sym.var("data")
    attn = mx.sym.multi_head_attention(data, data, data, num_heads=2,
                                       causal=True, name="attn0")
    net = mx.sym.FullyConnected(mx.sym.Flatten(data + attn), num_hidden=3,
                                name="fc")
    sym = mx.sym.SoftmaxOutput(net, name="softmax")
    r = np.random.RandomState(7)
    x = r.normal(0, 1, (2, 8, 128)).astype(np.float32)
    y = r.randint(0, 3, (2,)).astype(np.float32)
    grads = []
    for ctx in (mx.gpu(0), mx.cpu()):
        mod = mx.mod.Module(sym, context=ctx)
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        mx.random.seed(0)
        mod.init_params(mx.initializer.Xavier())
        batch = mx.io.DataBatch([mx.nd.array(x, ctx=ctx)],
                                [mx.nd.array(y, ctx=ctx)])
        mod.forward_backward(batch)
        exe = mod._exec_group.execs[0]
        grads.append({n: g.asnumpy() for n, g in exe.grad_dict.items()})
    for side in ("query", "key", "value"):
        for part in ("weight", "bias"):
            name = "attn0_%s_%s" % (side, part)
            if part == "weight" or side != "key":  # the key bias: ~0
                assert np.abs(grads[0][name]).max() > 1e-6, name
            np.testing.assert_allclose(grads[0][name], grads[1][name],
                                       atol=1e-4, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("bad", ["d48", "d80", "f16", "f64"])
def test_flash_kernel_raises_outside_its_limits(card, bad):
    """On the card a head_dim or dtype the kernel does not take raises an
    MXNetError naming the limit: no silent fallback to the plain
    version.  The same tensors on the host take the plain version."""
    d = int(bad[1:]) if bad.startswith("d") else 64
    dtype = {"f16": torch.float16, "f64": torch.float64}.get(
        bad, torch.float32)
    q = torch.randn(2, 16, 2, d, device=card).to(dtype)
    before = K.launch_counts()
    with pytest.raises(mx.MXNetError,
                       match="head_dim %d unsupported" % d
                       if bad.startswith("d") else "dtype .* unsupported"):
        K.attention(q, q, q, causal=True)
    assert K.launch_counts() == before
    assert K.attention(q.cpu(), q.cpu(), q.cpu(), causal=True).shape \
        == q.shape


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64],
                         ids=["f16", "f64"])
def test_half_and_double_batchnorm_and_pooling_run_the_kernels(card, dtype):
    """Train-mode BatchNorm and 2-D max/avg pooling in f16 and f64 on the
    card launch the hand-written kernels (2 channel sums, 1 of each pool
    backward) and agree with the host: the pool gradients bit for bit
    given the same upstream gradient, BatchNorm within f16's rounding
    (atol=rtol=1e-2) and, in f64, within f32 sums' (atol=rtol=1e-4: its
    statistics and backward pair are summed in f32, as the reference's
    are, by blocks on the card and in one pass on the host)."""
    from mxnet_tpu_torch.ops import nn as nn_ops
    r = np.random.RandomState(15)
    x0 = r.normal(0.5, 1, (4, 6, 14, 14))
    g0, b0 = r.normal(1, 0.1, 6), r.normal(0, 0.1, 6)
    dys = [r.normal(0, 1, s) for s in ((4, 6, 14, 14), (4, 6, 7, 7),
                                       (4, 6, 1, 1))]
    res = {}
    for dev in (card, torch.device("cpu")):
        x = torch.tensor(x0, dtype=dtype, device=dev, requires_grad=True)
        g = torch.tensor(g0, dtype=torch.float32, device=dev,
                         requires_grad=True)
        b = torch.tensor(b0, dtype=torch.float32, device=dev,
                         requires_grad=True)
        mm = torch.zeros(6, device=dev)
        mv = torch.ones(6, device=dev)
        before = K.launch_counts()
        y, _, _ = nn_ops._batch_norm(x, g, b, mm, mv, fix_gamma=False,
                                     _train=True)
        ybn = torch.autograd.grad(y, (x, g, b), torch.tensor(
            dys[0], dtype=dtype, device=dev))
        xp = x.detach().clamp_min(0).requires_grad_()
        mp = nn_ops._pooling(xp, "max", (3, 3), (2, 2), (1, 1))
        dmax = torch.autograd.grad(mp, xp, torch.tensor(
            dys[1], dtype=dtype, device=dev))[0]
        # the global pool of a 7 x 7 plane (49 taps, in the kernel's reach)
        xa = mp.detach().requires_grad_()
        gp = nn_ops._pooling(xa, "avg", global_pool=True)
        davg = torch.autograd.grad(gp, xa, torch.tensor(
            dys[2], dtype=dtype, device=dev))[0]
        if dev.type == "cuda":
            torch.cuda.synchronize()
            after = K.launch_counts()
            assert {n: after[n] - before[n] for n in after} == {
                "flash_attn_fwd": 0, "flash_attn_fwd_lse": 0,
                "bn_channel_sums": 2, "max_pool_backward": 1,
                "avg_pool_backward": 1}
        assert y.dtype == dtype and ybn[0].dtype == dtype
        assert ybn[1].dtype == torch.float32
        res[dev.type] = [t.detach().cpu() for t in (y, *ybn, dmax, davg)]
    tol = dict(atol=1e-2, rtol=1e-2) if dtype == torch.float16 \
        else dict(atol=1e-4, rtol=1e-4)
    for got, want in zip(res["cuda"][:4], res["cpu"][:4]):
        np.testing.assert_allclose(got.double().numpy(),
                                   want.double().numpy(), **tol)
    for got, want in zip(res["cuda"][4:], res["cpu"][4:]):
        assert torch.equal(got, want)


# -- the fused RNN op and the CTC loss (cuDNN and torch ops, no kernel of
# the port's own): the card against the host, f32 with TF32 off --------------

@pytest.fixture
def no_tf32():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


def _rnn_op_run(ctx, mode, bid, p, seed=0):
    from mxnet_tpu_torch.ops.rnn_op import rnn_param_size
    r = np.random.RandomState(seed)
    T, N, C, H, L = 7, 5, 12, 16, 2
    dirs = 2 if bid else 1
    ins = [r.normal(size=(T, N, C)),
           r.uniform(-0.3, 0.3, rnn_param_size(L, C, H, bid, mode))]
    ins += [r.normal(size=(L * dirs, N, H))
            for _ in range(2 if mode == "lstm" else 1)]
    nds = [mx.nd.array(a.astype(np.float32), ctx=ctx) for a in ins]
    for a in nds:
        a.attach_grad()
    with mx.autograd.record():
        outs = mx.nd.RNN(*nds, state_size=H, num_layers=L, bidirectional=bid,
                         mode=mode, state_outputs=True, p=p)
        loss = sum((o * o).sum() for o in outs)
    loss.backward()
    return [o.asnumpy() for o in outs] + [a.grad.asnumpy() for a in nds]


@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
@pytest.mark.parametrize("bid", [False, True], ids=["uni", "bi"])
def test_rnn_op_on_the_card_matches_the_host(card, no_tf32, mode, bid):
    got = _rnn_op_run(mx.gpu(0), mode, bid, 0.0)
    want = _rnn_op_run(mx.cpu(), mode, bid, 0.0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4)


def test_rnn_op_dropout_on_the_card_follows_the_seed(card, no_tf32):
    with mx.autograd.train_mode():
        mx.random.seed(3)
        a = _rnn_op_run(mx.gpu(0), "lstm", False, 0.5)
        mx.random.seed(3)
        b = _rnn_op_run(mx.gpu(0), "lstm", False, 0.5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    plain = _rnn_op_run(mx.gpu(0), "lstm", False, 0.0)
    assert not np.allclose(a[0], plain[0])


@pytest.mark.parametrize("blank", ["first", "last"])
def test_ctc_loss_on_the_card_matches_the_host(card, blank):
    r = np.random.RandomState(1)
    T, N, A, L = 40, 6, 9, 12
    lo, hi = (1, A) if blank == "first" else (0, A - 1)
    labels = r.randint(lo, hi, (N, L)).astype(np.float32)
    labels[1, 5:] = 0 if blank == "first" else -1
    labels[2] = labels[2, 0]  # 12 repeats need 23 steps
    data = r.normal(size=(T, N, A)).astype(np.float32) * 2
    res = []
    for ctx in (mx.gpu(0), mx.cpu()):
        d = mx.nd.array(data, ctx=ctx)
        d.attach_grad()
        with mx.autograd.record():
            loss = mx.nd.CTCLoss(d, mx.nd.array(labels, ctx=ctx),
                                 blank_label=blank)
        loss.backward()
        res.append((loss.asnumpy(), d.grad.asnumpy()))
    (loss, grad), (hloss, hgrad) = res
    np.testing.assert_allclose(loss, hloss, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(grad, hgrad, atol=1e-4, rtol=1e-4)
    assert np.isfinite(grad).all() and loss.max() < 1e3


# -- the fused train step as a CUDA graph ------------------------------------

FUSED_KERNELS = ("bn_channel_sums", "max_pool_backward", "avg_pool_backward")


def _graph_net(dtype, dropout=0.0):
    """conv -> BN -> relu -> 3x3/s2 max pool -> conv -> BN -> relu ->
    [dropout] -> global avg pool -> FC -> softmax, cast to ``dtype``
    after the data and back to f32 before the loss."""
    s = mx.sym
    net = s.Variable("data")
    if dtype != "float32":
        net = s.Cast(net, dtype=dtype)
    for i, (width, stride) in enumerate(((8, 1), (16, 2))):
        net = s.Convolution(net, num_filter=width, kernel=(3, 3),
                            stride=(stride, stride), pad=(1, 1),
                            no_bias=True, name="conv%d" % i)
        net = s.Activation(s.BatchNorm(net, fix_gamma=False,
                                       name="bn%d" % i), act_type="relu")
        if i == 0:
            net = s.Pooling(net, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                            pool_type="max")
    if dropout:
        net = s.Dropout(net, p=dropout)
    net = s.Pooling(net, global_pool=True, kernel=(1, 1), pool_type="avg")
    net = s.FullyConnected(s.Flatten(net), num_hidden=5, name="fc")
    if dtype != "float32":
        net = s.Cast(net, dtype="float32")
    return s.SoftmaxOutput(net, name="softmax")


def _graph_module(dtype, batches=4, batch=8, momentum=0.9, lr=0.1,
                  dropout=0.0, seed=0):
    r = np.random.RandomState(seed)
    x = r.rand(batch * batches, 3, 16, 16).astype(np.float32)
    y = r.randint(0, 5, batch * batches).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(_graph_net(dtype, dropout), context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(magnitude=2))
    mod.init_optimizer(optimizer_params={
        "learning_rate": lr, "momentum": momentum, "wd": 1e-4,
        "multi_precision": True})
    return mod, list(it)


def _steps(mod, batches):
    for b in batches:
        mod.forward_backward(b)
        mod.update()
    torch.cuda.synchronize()


@pytest.fixture
def deterministic():
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = saved


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_graph_replays_match_the_eager_general_path(card, deterministic,
                                                    dtype):
    """One eager fused step and three graph replays against four steps of
    the general path (the Updater; ``mp_sgd_mom_update`` in bf16) from one
    state on the same batches: the same arithmetic, so masters, momenta
    and moving statistics agree bit for bit."""
    graph, batches = _graph_module(dtype)
    eager, _ = _graph_module(dtype)
    eager._fused_step = None
    _steps(graph, batches)
    _steps(eager, batches)
    fs = graph._fused_step
    assert fs.captures == 1 and fs.replays == 3
    for j, name in enumerate(fs.param_names):
        i = eager._param_names.index(name)
        st = eager._updater.states[i]
        mom, master = st if isinstance(st, tuple) else \
            (st, eager._exec_group.param_arrays[i][0])
        assert torch.equal(fs._masters[j].float(), master.tensor.float())
        assert torch.equal(fs.states[j].float(), mom.tensor.float())
    for k, v in graph.get_params()[1].items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      eager.get_params()[1][k].asnumpy())


def test_lr_change_between_replays_takes_effect(card):
    """With the graph captured, a learning rate of 0 leaves the weights as
    they are and 0.1 moves them again, with no new capture."""
    mod, batches = _graph_module("bfloat16", momentum=0.0)
    _steps(mod, batches[:2])
    fs = mod._fused_step
    assert fs.captures == 1
    before = [m.clone() for m in fs._masters]
    mod._optimizer.lr = 0.0
    _steps(mod, batches[2:3])
    assert all(torch.equal(a, b) for a, b in zip(before, fs._masters))
    mod._optimizer.lr = 0.1
    _steps(mod, batches[3:4])
    assert all(not torch.equal(a, b) for a, b in zip(before, fs._masters))
    assert fs.captures == 1 and fs.replays == 3


def test_reshape_recaptures_and_carries_the_masters(card):
    """A reshape to batch 4: the step carries its f32 masters and momenta
    to the new executor, runs one eager step and captures anew."""
    mod, batches = _graph_module("bfloat16")
    _steps(mod, batches[:3])
    fs = mod._fused_step
    masters = [m.clone() for m in fs._masters]
    small = mx.io.NDArrayIter(
        np.random.RandomState(5).rand(8, 3, 16, 16).astype(np.float32),
        np.zeros(8, np.float32), batch_size=4)
    mod.reshape(small.provide_data, small.provide_label)
    first = next(small)
    mod.forward_backward(first)
    mod.update()
    torch.cuda.synchronize()
    assert mod._fused_step is fs and fs.exe is mod._exec_group.execs[0]
    for j, m in enumerate(masters):  # SGD: w += mom
        assert torch.equal(fs._masters[j], m + fs.states[j])
    _steps(mod, [first] + list(small))  # the rest of the iterator
    assert fs.captures == 1 and fs.replays == 2
    assert all(bool(torch.isfinite(m).all()) for m in fs._masters)


def test_set_params_between_replays_is_honoured(card, deterministic):
    """set_params into the captured tensors between replays: the next
    replay trains from the new values, as a fresh module's first step
    from them does (bit for bit: the same arithmetic)."""
    mod, batches = _graph_module("bfloat16", momentum=0.0)
    _steps(mod, batches[:2])
    fresh, _ = _graph_module("bfloat16", momentum=0.0, seed=7)
    arg, aux = fresh.get_params()
    arg = {k: v.copyto(mx.cpu()) for k, v in arg.items()}
    aux = {k: v.copyto(mx.cpu()) for k, v in aux.items()}
    mod.set_params(arg, aux)
    _steps(mod, batches[2:3])
    _steps(fresh, batches[2:3])
    assert mod._fused_step.replays == 2
    got, want = mod.get_params()[0], fresh.get_params()[0]
    for k in want:
        np.testing.assert_array_equal(got[k].asnumpy(), want[k].asnumpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rebound_parameter_keeps_training_across_replays(card, dtype):
    """A parameter rebound to a new tensor between replays (``w += 1``
    under ``autograd.record()``): the step captures anew, and the next
    step moves the new tensor by exactly its momentum (w += mom), from a
    master re-derived from it where the parameter has one."""
    mod, batches = _graph_module(dtype)
    _steps(mod, batches[:3])
    fs = mod._fused_step
    name = next(n for n in fs.param_names if n.endswith("_weight"))
    j = fs.param_names.index(name)
    w = mod._exec_group.execs[0].arg_dict[name]
    old = w.tensor
    with mx.autograd.record():
        w += 1.0
    assert w.tensor is not old
    rebound = w.tensor.detach().float().clone()
    _steps(mod, batches[3:4])
    want = rebound + fs.states[j].float()
    assert torch.equal(fs._masters[j].float(), want)
    assert torch.equal(w.tensor, want.to(w.tensor.dtype))
    assert fs.captures == 1 and fs.graph is None  # recaptured at the next
    _steps(mod, batches[:2])
    assert fs.captures == 2
    assert all(bool(torch.isfinite(m).all()) for m in fs._masters)


def test_launch_counts_across_replays(card):
    """Each replay counts the launches its capture recorded: per step
    exactly the graph's kernels, none for the capture itself."""
    mod, batches = _graph_module("bfloat16", batches=5)
    K.reset_launch_counts()
    per_step = []
    for b in batches:
        before = K.launch_counts()
        _steps(mod, [b])
        now = K.launch_counts()
        per_step.append({k: now[k] - before[k] for k in FUSED_KERNELS})
    want = {"bn_channel_sums": 4, "max_pool_backward": 1,
            "avg_pool_backward": 1}
    assert per_step == [want] * 5
    assert mod._fused_step.graph_launches == want


def test_replays_draw_fresh_dropout_masks(card):
    """The port's generator is registered with the graph: two replays of
    a Dropout net at lr 0 (the weights fixed) give different outputs on
    the same batch, and the same seed gives the same first replay."""
    outs = []
    for _ in range(2):
        mod, batches = _graph_module("float32", momentum=0.0, dropout=0.5)
        _steps(mod, batches[:2])
        mod._optimizer.lr = 0.0
        mod._optimizer.wd = 0.0
        run = []
        for _ in range(2):
            _steps(mod, batches[2:3])
            run.append(mod.get_outputs()[0].asnumpy())
        assert mod._fused_step.replays == 3
        assert not np.array_equal(run[0], run[1])
        outs.append(run)
    np.testing.assert_array_equal(outs[0][0], outs[1][0])


def test_capture_failure_raises(card, monkeypatch):
    """A step that cannot be captured (here, one that reads a value back
    to the host) raises MXNetError instead of leaving for the general
    path, and counts no launches."""
    mod, batches = _graph_module("float32")
    fs = mod._fused_step
    compute = fs._compute

    def host_sync():
        outs = compute()
        if torch.cuda.is_current_stream_capturing():
            outs[0].sum().item()
        return outs

    monkeypatch.setattr(fs, "_compute", host_sync)
    _steps(mod, batches[:1])
    before = K.launch_counts()
    with pytest.raises(mx.MXNetError, match="CUDA graph"):
        mod.forward_backward(batches[1])
    assert K.launch_counts() == before


# -- bucketing: one CUDA graph per bucket over one shared state --------------

def _bucket_module(fused=True, momentum=0.9):
    """A 2-layer LSTM LM (vocabulary 30, hidden 16) bucketed at 5 and 10
    on the card, from seeded weights."""
    hidden, vocab = 16, 30
    stack = mx.rnn.FusedRNNCell(hidden, num_layers=2, mode="lstm")

    def sym_gen(seq_len):
        embed = mx.sym.Embedding(data=mx.sym.Variable("data"),
                                 input_dim=vocab, output_dim=12, name="embed")
        stack.reset()
        out, _ = stack.unroll(seq_len, inputs=embed, merge_outputs=True)
        pred = mx.sym.FullyConnected(mx.sym.Reshape(out, shape=(-1, hidden)),
                                     num_hidden=vocab, name="pred")
        label = mx.sym.Reshape(mx.sym.Variable("softmax_label"), shape=(-1,))
        return (mx.sym.SoftmaxOutput(pred, label, name="softmax"),
                ("data",), ("softmax_label",))

    mod = mx.mod.BucketingModule(sym_gen, default_bucket_key=10,
                                 context=mx.gpu(0))
    batches = [_bucket_batch(k, i) for i, k in enumerate([10, 5] * 3)]
    mod.bind(batches[0].provide_data, batches[0].provide_label)
    mx.random.seed(3)
    mod.init_params(mx.initializer.Xavier(factor_type="in", magnitude=2.34))
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": momentum})
    mod.prepare(batches[1])
    if not fused:
        mod._buckets[10]._retire_fused_step("the eager general path")
    return mod, batches


def _bucket_batch(key, seed, n=8, vocab=30):
    r = np.random.RandomState(seed)
    data = r.randint(1, vocab, (n, key)).astype(np.float32)
    label = np.roll(data, -1, axis=1)
    return mx.io.DataBatch(
        [mx.nd.array(data, ctx=mx.cpu())], [mx.nd.array(label, ctx=mx.cpu())],
        bucket_key=key, provide_data=[mx.io.DataDesc("data", (n, key))],
        provide_label=[mx.io.DataDesc("softmax_label", (n, key))])


def _bucket_run(mod, batches):
    outs = []
    for b in batches:
        mod.forward_backward(b)
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    return outs


def test_bucket_graphs_match_the_eager_general_path(card, deterministic,
                                                    no_tf32):
    """Buckets 10 and 5 alternating: per bucket one eager step, one
    capture and replay, one more replay, against the eager general path
    from one state (one Updater).  Masters, momenta and every batch's
    outputs agree bit for bit: the same arithmetic on the same tensors.
    Each bucket's replay follows the other bucket's, so an output read
    from a graph's pool after another graph ran is checked too."""
    graph, batches = _bucket_module()
    eager, _ = _bucket_module(fused=False)
    got, want = _bucket_run(graph, batches), _bucket_run(eager, batches)
    steps = {k: m._fused_step for k, m in graph._buckets.items()}
    assert all(s.captures == 1 and s.replays == 2 for s in steps.values())
    assert steps[10].shared is steps[5].shared
    assert steps[10].graph is not steps[5].graph
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    shared = steps[10].shared
    anchor = eager._buckets[10]
    for i, name in enumerate(anchor._param_names):
        assert torch.equal(shared.masters[name],
                           anchor._exec_group.execs[0].arg_dict[name].tensor)
        assert torch.equal(shared.states[name],
                           anchor._updater.states[i].tensor)
    assert graph._optimizer.num_update == len(batches)


def test_bucket_replay_outputs_survive_the_other_buckets_replay(card,
                                                                no_tf32):
    """The outputs a bucket's replay hands back are copies: a later replay
    of the other bucket's graph leaves them as they were."""
    mod, batches = _bucket_module()
    _bucket_run(mod, batches[:4])  # both buckets captured
    mod.forward_backward(batches[4])
    mod.update()
    first = mod.get_outputs()[0]
    kept = first.asnumpy()
    mod.forward_backward(batches[5])
    mod.update()
    np.testing.assert_array_equal(first.asnumpy(), kept)
    assert mod._buckets[5]._fused_step.replays == 2


def test_bucket_graphs_share_the_parameter_tensors(card):
    mod, batches = _bucket_module()
    _bucket_run(mod, batches[:4])
    a, b = (mod._buckets[k]._exec_group.execs[0] for k in (10, 5))
    fa, fb = (mod._buckets[k]._fused_step for k in (10, 5))
    for name in fa.param_names:
        ptr = a.arg_dict[name].tensor.data_ptr()
        assert b.arg_dict[name].tensor.data_ptr() == ptr
        assert any(t.data_ptr() == ptr for t in fa._bound)
        assert any(t.data_ptr() == ptr for t in fb._bound)


# -- slice 4: int8 serving, paged decode, continuous batching -----------------
#
# The int8 route (``torch._int_mm``, cuBLAS) against the plain version, bit
# for bit: both are exact integer products.  The decode step's CUDA graph
# replay against the same step run eagerly, bit for bit; the card against
# the host within 1e-4 (f32, other kernels).

@pytest.mark.parametrize("rows", [1, 2, 3, 8, 16, 17, 32])
@pytest.mark.parametrize("k,n", [(147, 64), (2048, 1000), (576, 64)])
def test_int8_matmul_route_matches_plain(card, rows, k, n):
    from mxnet_tpu_torch.ops import quantize as Q
    g = torch.Generator().manual_seed(rows * 7 + k)
    a = torch.randint(-127, 128, (rows, k), generator=g, dtype=torch.int8)
    w = torch.randint(-127, 128, (n, k), generator=g, dtype=torch.int8)
    got = Q.int8_matmul(a.to(card), w.to(card))
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), Q.plain_int8_matmul(a, w))
    assert torch.equal(got, Q.plain_int8_matmul(a.to(card), w.to(card)))


@pytest.mark.parametrize("case", [  # N, C, H, W, F, k, stride, pad, groups
    (1, 3, 224, 224, 64, 7, 2, 3, 1),    # the ResNet stem at bucket 1
    (2, 64, 56, 56, 64, 3, 1, 1, 1),
    (3, 256, 14, 14, 512, 1, 2, 0, 1),
    (2, 8, 9, 9, 12, 3, 2, 1, 4),
], ids=lambda c: "-".join(map(str, c)))
def test_int8_conv_route_matches_plain(card, case):
    from mxnet_tpu_torch.ops import quantize as Q
    n, c, h, w_, f, k, s, p, grp = case
    g = torch.Generator().manual_seed(n * c + f)
    x = torch.randint(-127, 128, (n, c, h, w_), generator=g,
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (f, c // grp, k, k), generator=g,
                      dtype=torch.int8)
    got = Q.int8_conv(x.to(card), w.to(card), (s, s), (p, p), (1, 1), grp)
    assert got.is_cuda
    assert torch.equal(got.cpu(), Q.plain_int8_conv(x, w, (s, s), (p, p),
                                                    (1, 1), grp))


def test_int8_route_raises_rather_than_falls_back(card, monkeypatch):
    from mxnet_tpu_torch.ops import quantize as Q

    def broken(a, b):
        raise RuntimeError("no int8 GEMM here")

    monkeypatch.setattr(torch, "_int_mm", broken)
    a = torch.ones((4, 16), dtype=torch.int8, device=card)
    with pytest.raises(mx.base.MXNetError, match="_int_mm"):
        Q.int8_matmul(a, a)


# The quantized ops on f32 input, card against host: int8 activations
# equal except where the host's x/scale is an exact .5 tie, outputs of the
# rows without such a flip within atol=rtol=1e-5 (both rescale the same
# exact int32 sums in the same IEEE f32 order).

@pytest.mark.parametrize("case", [  # conv: N, C, H, W, F, k, stride, pad
    ("conv", 2, 3, 224, 224, 64, 7, 2, 3),   # the ResNet stem
    ("conv", 2, 64, 56, 56, 64, 3, 1, 1),
    ("conv", 3, 256, 14, 14, 512, 1, 2, 0),
    ("fc", 4, 2048, 1000),
], ids=lambda c: "-".join(map(str, c)))
@pytest.mark.parametrize("calibrated", [False, True],
                         ids=["dynamic", "calibrated"])
def test_int8_quantized_op_on_the_card_matches_the_host(card, case,
                                                        calibrated):
    from mxnet_tpu_torch.ops import quantize as Q
    r = np.random.RandomState(len(case) + case[2])
    if case[0] == "conv":
        _, n, c, h, w_, f, k, s, p = case
        x = np.maximum(r.normal(0, 1, (n, c, h, w_)), 0).astype(np.float32)
        wf = r.normal(0, np.sqrt(2.0 / (c * k * k)), (f, c, k, k))
        attrs = dict(kernel=(k, k), stride=(s, s), pad=(p, p),
                     num_filter=f)
        op = Q._quantized_convolution
    else:
        _, n, c, f = case
        x = np.maximum(r.normal(0, 1, (n, c)), 0).astype(np.float32)
        wf = r.normal(0, 0.01, (f, c))
        attrs = dict(num_hidden=f)
        op = Q._quantized_fully_connected
    wq, scale = Q.quantize_weight(wf.astype(np.float32))
    bias = r.normal(0, 0.1, (f,)).astype(np.float32)
    # a calibrated range that clips the top 20%
    act = float(np.abs(x).max()) * 0.8 / 127 if calibrated else 0.0
    outs, acts = [], []
    for dev in (card, torch.device("cpu")):
        t = [torch.from_numpy(a).to(dev) for a in (x, wq, scale, bias)]
        with torch.inference_mode():
            outs.append(op(*t, act_scale=act, **attrs).cpu())
            acts.append(Q.quantize_act(t[0], act)[0].cpu())
    x_host = torch.from_numpy(x)
    _, s_host = Q.quantize_act(x_host, act)
    flip = acts[0] != acts[1]
    tie = (torch.abs(x_host / s_host) % 1.0) == 0.5
    assert not bool((flip & ~tie).any())
    rows = ~flip.reshape(n, -1).any(1)
    assert bool(rows.any())
    np.testing.assert_allclose(outs[0][rows], outs[1][rows], atol=1e-5,
                               rtol=1e-5)


def test_inference_batchnorm_and_avg_pool_on_the_card_equal_the_host(card):
    # bit for bit: int8 serving rounds what these feed it, so a last-bit
    # difference between card and host flips int8 steps downstream
    r = np.random.RandomState(5)
    x = r.normal(0, 2, (4, 2048, 7, 7)).astype(np.float32)
    gamma, beta, mean = (r.normal(0, 1, 2048).astype(np.float32)
                         for _ in range(3))
    var = r.uniform(1e-3, 5, 2048).astype(np.float32)
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        a = [mx.nd.array(v, ctx=ctx) for v in (x, gamma, beta, mean, var)]
        y = mx.nd.BatchNorm(*a, eps=2e-5, fix_gamma=False)
        pooled = mx.nd.Pooling(y, kernel=(7, 7), pool_type="avg",
                               global_pool=True)
        outs.append((y.asnumpy(), pooled.asnumpy()))
    for got, want in zip(*outs):
        np.testing.assert_array_equal(got, want)


def _decode_parts(seed=0, vocab=97, embed=64, heads=2, layers=2, seq=64):
    r = np.random.RandomState(seed)
    p = {"embed": r.normal(0, 0.5, (vocab, embed)),
         "pos": r.normal(0, 0.1, (seq, embed))}
    shapes = (("ln1_g", (embed,)), ("ln1_b", (embed,)),
              ("wq", (embed, embed)), ("bq", (embed,)),
              ("wk", (embed, embed)), ("bk", (embed,)),
              ("wv", (embed, embed)), ("bv", (embed,)),
              ("wo", (embed, embed)), ("bo", (embed,)),
              ("ln2_g", (embed,)), ("ln2_b", (embed,)),
              ("w1", (4 * embed, embed)), ("b1", (4 * embed,)),
              ("w2", (embed, 4 * embed)), ("b2", (embed,)))
    for l in range(layers):
        for k, s in shapes:
            p["l%d.%s" % (l, k)] = (1.0 if k.endswith("_g") else 0.0) \
                + r.normal(0, 0.15, s)
    p.update(lnf_g=1 + r.normal(0, 0.1, (embed,)),
             lnf_b=r.normal(0, 0.1, (embed,)),
             head_w=r.normal(0, 0.2, (vocab, embed)),
             head_b=r.normal(0, 0.1, (vocab,)))
    cfg = dict(vocab_size=vocab, embed_dim=embed, num_heads=heads,
               num_layers=layers, seq_len=seq, ffn_dim=4 * embed)
    return {k: v.astype(np.float32) for k, v in p.items()}, cfg


def _decode_run(ctx, cuda_graph=True, slots=4):
    params, cfg = _decode_parts()
    pool = mx.serving.KVBlockPool(cfg["num_layers"], cfg["num_heads"],
                                  cfg["embed_dim"] // cfg["num_heads"],
                                  num_pages=32, page_size=8, ctx=ctx)
    dec = mx.serving.PagedTransformerDecoder(params, cfg, slot_count=slots,
                                             pool=pool)
    dec.cuda_graph = dec.cuda_graph and cuda_graph
    r = np.random.RandomState(1)
    try:
        dec.warmup()
        streams = [dec.submit(r.randint(0, 97, size=n), max_new_tokens=6)
                   for n in (3, 11, 20, 16, 5)]
        dec.step()
        streams.append(dec.submit(streams[3].prompt, max_new_tokens=4))
        dec.drain(max_iterations=500)
        return dec, [s.outputs() for s in streams]
    finally:
        dec.close()


def test_decode_graph_replay_matches_eager_bit_for_bit(card, no_tf32):
    dec, got = _decode_run(mx.gpu(0))
    assert dec.captures == 1 and dec.replays > 0
    eager, want = _decode_run(mx.gpu(0), cuda_graph=False)
    assert eager.captures == 0
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_array_equal(gl, wl)


def test_decode_on_the_card_matches_the_host(card, no_tf32):
    _, got = _decode_run(mx.gpu(0))
    _, want = _decode_run(mx.cpu())
    for (gt, gl), (wt, wl) in zip(got, want):
        assert gt == wt
        np.testing.assert_allclose(gl, wl, atol=1e-4, rtol=1e-4)


def test_continuous_batcher_on_the_card_matches_the_host(card, no_tf32):
    data = mx.sym.Variable("data")
    cell = mx.rnn.LSTMCell(16, prefix="lstm_")
    out, (nh, nc) = cell(data, [mx.sym.Variable("state_h"),
                                mx.sym.Variable("state_c")])
    step = mx.sym.Group([mx.sym.FullyConnected(out, num_hidden=7,
                                               name="proj"), nh, nc])
    shapes, _, _ = step.infer_shape(data=(1, 5), state_h=(1, 16),
                                    state_c=(1, 16))
    r = np.random.RandomState(2)
    params = {n: r.normal(0, 0.3, s).astype(np.float32)
              for n, s in zip(step.list_arguments(), shapes)
              if n not in ("data", "state_h", "state_c")}
    seqs = [r.rand(t, 5).astype(np.float32) for t in (6, 3, 9, 4)]
    outs = []
    for ctx in (mx.gpu(0), mx.cpu()):
        cb = mx.serving.ContinuousBatcher(
            step, params, input_shapes={"data": (5,)},
            state_shapes={"state_h": (16,), "state_c": (16,)},
            state_pairs=[("state_h", 1), ("state_c", 2)], slot_count=3,
            ctx=ctx)
        cb.warmup()
        streams = [cb.submit({"data": s}) for s in seqs]
        cb.drain(max_iterations=100)
        outs.append([s.outputs()[0] for s in streams])
    for a, b in zip(*outs):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(64, 20, 24, 24), (64, 50, 8, 8)],
                         ids=["lenet-pool1", "lenet-pool2"])
def test_max_pool_backward_at_lenet_shapes(card, shape):
    """LeNet's two 2x2/s2 max pools (post-tanh inputs): one launch each,
    bit for bit the plain version."""
    g = torch.Generator(device=card).manual_seed(11)
    x = torch.tanh(torch.randn(*shape, generator=g, device=card))
    dy = torch.randn(shape[:2] + (shape[2] // 2, shape[3] // 2),
                     generator=g, device=card)
    pads = ((0, 0), (0, 0))
    before = K.launch_counts()["max_pool_backward"]
    got = K.max_pool_backward(x, dy, (2, 2), (2, 2), pads)
    torch.cuda.synchronize()
    assert K.launch_counts()["max_pool_backward"] == before + 1
    want = K._plain_max_pool_backward(x, dy, (2, 2), (2, 2), pads)
    assert torch.equal(got, want)


def test_lenet_first_step_on_the_card_matches_the_host(card, monkeypatch):
    """BASELINE config 1's LeNet through ``Module`` (SGD lr 0.05,
    momentum 0.9, wd 1e-4) from the same weights on the same batch of 64:
    the step's outputs within 1e-4 and each parameter's first momentum
    (the step's gradient, scaled) within 1e-3, relative L2."""
    from mxnet_tpu_torch.models import lenet
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    rng = np.random.RandomState(0)
    images = rng.rand(64, 1, 28, 28).astype(np.float32)
    labels = rng.randint(0, 10, 64).astype(np.float32)
    symbol = lenet.get_symbol(10)
    arg_shapes, _, _ = symbol.infer_shape(data=images.shape)
    weights = {n: (rng.randn(*s) * np.sqrt(2.0 / np.prod(s[1:])))
               .astype(np.float32) if len(s) > 1
               else np.zeros(s, np.float32)
               for n, s in zip(symbol.list_arguments(), arg_shapes)
               if n not in ("data", "softmax_label")}
    results = []
    for ctx in (mx.gpu(0), mx.cpu()):
        it = mx.io.NDArrayIter(images, labels, batch_size=64)
        mod = mx.mod.Module(symbol, context=ctx)
        mod.bind(it.provide_data, it.provide_label)
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in weights.items()})
        mod.init_optimizer(optimizer_params={"learning_rate": 0.05,
                                             "momentum": 0.9, "wd": 1e-4})
        mod.forward_backward(next(it))
        mod.update()
        fs = mod._fused_step
        moms = {n: fs.states[j].float().cpu().numpy()
                for j, n in enumerate(fs.param_names)}
        results.append((mod.get_outputs()[0].asnumpy(), moms))
    (out_c, mom_c), (out_h, mom_h) = results

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    assert rel(out_c, out_h) <= 1e-4
    for name in mom_h:
        assert rel(mom_c[name], mom_h[name]) <= 1e-3, name


# -- random sampling on the card, a replayed step that draws, DCGAN ---------

CARD_DRAWS = 1000000


@pytest.mark.parametrize("case", [0, 1])
@pytest.mark.parametrize("canonical", sorted(random_cases.SPECS))
def test_random_op_on_the_card(card, canonical, case):
    """10^6 draws on the card: the output on the card, its support, mean
    and variance within 6 standard errors of the analytic values; the
    same ``mx.random.seed`` the same bits, another seed others, and
    ``torch.manual_seed`` nothing."""
    spec = random_cases.SPECS[canonical][case]
    rows = 1 if "attrs" in spec else len(spec["mean"])

    def draw(seed, torch_seed=None):
        mx.random.seed(seed)
        if torch_seed is not None:
            torch.manual_seed(torch_seed)
        return random_cases.call(mx, canonical, (CARD_DRAWS // rows,),
                                 mx.gpu(0), case=case)

    out = draw(5)
    assert out.context == mx.gpu(0) and out.tensor.is_cuda
    x = out.asnumpy()
    assert random_cases.support_ok(canonical, x, case)
    means = [spec["mean"]] if "attrs" in spec else spec["mean"]
    variances = [spec["var"]] if "attrs" in spec else spec["var"]
    for row, mean, var in zip(random_cases.rows_of(x, spec), means,
                              variances):
        ok, z_mean, z_var = random_cases.moments(row, mean, var)
        assert ok, (z_mean, z_var)
    np.testing.assert_array_equal(draw(5, torch_seed=77).asnumpy(), x)
    assert not np.array_equal(draw(6).asnumpy(), x)


@pytest.mark.parametrize("dtype", ["float16", "float64"])
def test_random_dtypes_on_the_card(card, dtype):
    mx.random.seed(3)
    u = mx.nd.random.uniform(-1, 3, shape=(CARD_DRAWS,), dtype=dtype,
                             ctx=mx.gpu(0))
    assert np.dtype(u.dtype) == np.dtype(dtype)
    x = u.asnumpy().astype(np.float64)
    assert x.min() >= -1 and x.max() < 3
    assert random_cases.moments(x, 1.0, 16 / 12)[0]
    n = mx.nd.random.normal(2, 0.5, shape=(CARD_DRAWS,), dtype=dtype,
                            ctx=mx.gpu(0))
    assert np.dtype(n.dtype) == np.dtype(dtype)
    assert random_cases.moments(n.asnumpy().astype(np.float64), 2.0,
                                0.25)[0]


def test_multinomial_and_shuffle_on_the_card(card):
    from scipy import stats
    mx.random.seed(4)
    data = mx.nd.array(random_cases.PROBS, ctx=mx.gpu(0))
    idx, prob = mx.nd.random.multinomial(data, shape=CARD_DRAWS // 2,
                                         get_prob=True)
    assert idx.tensor.is_cuda and prob.tensor.is_cuda
    idx = idx.asnumpy()
    for row, p in zip(idx, random_cases.PROBS):
        expected = p.astype(np.float64) / p.astype(np.float64).sum()
        counts = np.bincount(row, minlength=len(p))
        assert stats.chisquare(counts, expected * row.size).pvalue \
            > random_cases.P_MIN
    picked = np.take_along_axis(mx.nd.log(data).asnumpy(), idx, axis=1)
    np.testing.assert_array_equal(prob.asnumpy(), picked)
    rows = mx.nd.random.shuffle(mx.nd.array(random_cases.SHUFFLED,
                                            ctx=mx.gpu(0))).asnumpy()
    assert sorted(map(tuple, rows)) == sorted(map(tuple,
                                                  random_cases.SHUFFLED))


def _noisy_fit(fused, seed=0, batch=16, steps=6):
    """A graph that adds ``mx.sym.random.normal`` noise to its input, SGD
    momentum; per-step outputs and the final parameters."""
    rng = np.random.RandomState(seed)
    x = rng.randn(batch * 3, 12).astype(np.float32)
    y = (x @ rng.randn(12, 4)).argmax(1).astype(np.float32)
    data = mx.sym.Variable("data")
    noisy = data + mx.sym.random.normal(0.0, 0.5, shape=(batch, 12))
    net = mx.sym.SoftmaxOutput(mx.sym.FullyConnected(
        noisy, num_hidden=4, name="fc"), name="softmax")
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(net, context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mod.init_params(arg_params={
        "fc_weight": mx.nd.array(rng.uniform(-0.1, 0.1, (4, 12)).astype(
            np.float32), ctx=mx.cpu()),
        "fc_bias": mx.nd.zeros((4,), ctx=mx.cpu())})
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9})
    if not fused:
        mod._fused_step = None
    batches = list(it)
    mx.random.seed(21)
    outs = []
    for k in range(steps):
        mod.forward_backward(batches[k % len(batches)])
        mod.update()
        outs.append(mod.get_outputs()[0].asnumpy())
    params = {k: v.asnumpy() for k, v in mod.get_params()[0].items()}
    return mod, outs, params


def test_replayed_step_draws_fresh_noise_and_equals_eager(card, no_tf32):
    """The fused step with a random node is one CUDA graph; its replays
    draw from the registered generator (the same batch sees new noise),
    and every step equals the eager general path from the same generator
    state within 1e-6."""
    mod, outs, params = _noisy_fit(True)
    fs = mod._fused_step
    assert fs is not None and fs.captures == 1 and fs.replays == 5
    assert not np.allclose(outs[1], outs[4])  # batch 1, steps 2 and 5
    _, eager_outs, eager_params = _noisy_fit(False)
    for a, b in zip(outs, eager_outs):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    for k in params:
        np.testing.assert_allclose(params[k], eager_params[k], rtol=1e-6,
                                   atol=1e-6)


def test_dcgan_first_iteration_on_the_card_matches_the_host(card, no_tf32):
    """One dcgan.py iteration (ngf = ndf = 16, Z 100, batch 16, 64x64)
    from the same weights, noise and images on the card and the host,
    by chip_smoke.py phase 12b's rule: outputs within 1e-4, gradients and
    updated parameters within 1e-3 relative L2, or within 4 times the
    host's own floor (two runs with its noise and images moved by 1e-7);
    26 ``bn_channel_sums`` launches on the card."""
    cfg = dict(ngf=16, ndf=16, nc=3, z=100, batch=16, size=64)
    rng = np.random.RandomState(0)
    noise = rng.randn(cfg["batch"], cfg["z"], 1, 1).astype(np.float32)
    real = rng.uniform(-1, 1, (cfg["batch"], 3, 64, 64)).astype(np.float32)

    def nudged(a):
        return (a * (1 + 1e-7 * rng.randn(*a.shape))).astype(np.float32)

    sym_g, sym_d = dcgan_net.dcgan_symbols(mx.sym, cfg["ngf"], cfg["ndf"])
    weights_g = dcgan_net.dcgan_weights(sym_g, {"rand": noise.shape}, 1)
    weights_d = dcgan_net.dcgan_weights(
        sym_d, {"data": real.shape, "label": (cfg["batch"],)}, 2)
    seen = []
    for ctx, z, images in ((mx.gpu(0), noise, real), (mx.cpu(), noise, real),
                           (mx.cpu(), nudged(noise), nudged(real)),
                           (mx.cpu(), nudged(noise), nudged(real))):
        mods = dcgan_net.dcgan_modules(mx, ctx, cfg, weights_g, weights_d)
        before = K.launch_counts()["bn_channel_sums"]
        seen.append(dcgan_net.dcgan_iteration(mx, ctx, *mods, z, images))
        if ctx == mx.gpu(0):
            assert K.launch_counts()["bn_channel_sums"] - before == 26
    assert dcgan_net.gaps_within_floor(seen[0], seen[1], seen[2:]) == []

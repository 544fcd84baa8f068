"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``: on a machine without a CUDA device every test here skips
(the decision is made inside a fixture, at run time).  On the card, run
``python -m pytest tests/test_torch_cuda.py -q``; the first test builds
the kernels with nvcc (a few seconds).  Tolerances: flash attention and
the channel sums f32 atol=rtol=1e-4 (f32 sums in another order); bf16
compared in f32 at atol=2e-2 (output rounding to bf16); the pooling
gradients exactly, since kernel and plain version form each pixel's sum
from the same terms in the same order.  The ``mx.rtc`` tests compile user
CUDA C with NVRTC (MXNet 1.0's ``test_cuda_rtc`` axpy, a template through
``exports``, a shared-memory row sum within 1e-5 of torch); with them
``Custom`` under autograd, the fused step's refusal of it, ``all``-mode
op spans during a graph capture, and the device-memory gauge; the health
vector packed inside the fused step's CUDA graph against its plain
recomputation (1e-5 relative) and the OOM black box.
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
                "avg_pool_backward": 1, "box_nms": 0,
                "deformable_im2col": 0}
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


# ---------------------------------------------------------------------------
# Data I/O: the image ops, the device double buffer
# ---------------------------------------------------------------------------

IMAGE_OP_CASES = [
    ("to_tensor", (224, 224, 3), {}),
    ("to_tensor", (128, 32, 32, 3), {}),
    ("normalize", (128, 3, 32, 32), {"mean": (0.4914, 0.4822, 0.4465),
                                     "std": (0.2023, 0.1994, 0.2010)}),
    ("flip_left_right", (224, 224, 3), {}),
    ("flip_top_bottom", (128, 32, 32, 3), {}),
    ("adjust_lighting", (224, 224, 3), {"alpha": (0.1, -0.2, 0.3)}),
]


@pytest.mark.parametrize("case", IMAGE_OP_CASES,
                         ids=lambda c: "%s-%s" % (c[0], "x".join(
                             map(str, c[1]))))
def test_image_ops_card_against_host(card, case):
    name, shape, attrs = case
    sym = getattr(mx.sym.image, name)(mx.sym.var("data"), **attrs)
    mx.test_utils.check_consistency(
        sym, [{"ctx": mx.cpu(0), "data": shape},
              {"ctx": mx.gpu(0), "data": shape}], tol=1e-6)


def test_random_image_ops_on_the_card(card):
    x = mx.nd.array(np.random.RandomState(0).uniform(
        0, 255, (64, 64, 3)).astype(np.float32), ctx=mx.gpu(0))
    for name, attrs in (("random_flip_left_right", {}),
                        ("random_brightness", {"min_factor": 0.5,
                                               "max_factor": 1.5}),
                        ("random_color_jitter", {"brightness": 0.2,
                                                 "contrast": 0.2,
                                                 "saturation": 0.2,
                                                 "hue": 0.1}),
                        ("random_lighting", {"alpha_std": 0.1})):
        mx.random.seed(3)
        a = getattr(mx.nd.image, name)(x, **attrs)
        mx.random.seed(3)
        b = getattr(mx.nd.image, name)(x, **attrs)
        assert a.context == mx.gpu(0) and a.shape == x.shape
        np.testing.assert_array_equal(a.asnumpy(), b.asnumpy())


def _image_op_module(seed=0, batches=4, batch=8):
    """A Module whose symbol jitters, lights, flips and normalizes NHWC
    images (the random image ops inside the trained graph), then conv ->
    BN -> relu -> global avg pool -> FC -> softmax."""
    s = mx.sym
    net = s.image.random_color_jitter(s.Variable("data"), brightness=0.3,
                                      contrast=0.3, saturation=0.3, hue=0.1)
    net = s.image.random_lighting(net, alpha_std=0.1)
    net = s.image.random_flip_left_right(net)
    net = s.image.normalize(s.image.to_tensor(net),
                            mean=(0.4914, 0.4822, 0.4465),
                            std=(0.2023, 0.1994, 0.2010))
    net = s.Convolution(net, num_filter=8, kernel=(3, 3), pad=(1, 1),
                        no_bias=True, name="conv")
    net = s.Activation(s.BatchNorm(net, fix_gamma=False, name="bn"),
                       act_type="relu")
    net = s.Pooling(net, global_pool=True, kernel=(1, 1), pool_type="avg")
    net = s.FullyConnected(s.Flatten(net), num_hidden=5, name="fc")
    r = np.random.RandomState(seed)
    x = r.uniform(0, 255, (batch * batches, 16, 16, 3)).astype(np.float32)
    y = r.randint(0, 5, batch * batches).astype(np.float32)
    it = mx.io.NDArrayIter(x, y, batch_size=batch)
    mod = mx.mod.Module(s.SoftmaxOutput(net, name="softmax"),
                        context=mx.gpu(0))
    mod.bind(it.provide_data, it.provide_label)
    mx.random.seed(seed)
    mod.init_params(mx.initializer.Xavier(magnitude=2))
    mod.init_optimizer(optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9, "wd": 1e-4})
    return mod, list(it)


def test_random_image_ops_in_a_captured_step_match_eager(card, deterministic,
                                                         monkeypatch):
    """A Module fit whose graph holds the random image ops: one eager
    fused step, then the step captured as a CUDA graph and replayed,
    against the same fit with every step eager.  The ops read nothing back
    to the host, so the capture succeeds; the generator registered with
    the graph gives each replay the draws of the eager step in its place,
    so outputs and weights agree bit for bit."""
    from mxnet_tpu_torch.module import fused_step

    def fit(mod, batches):
        outs = []
        for b in batches:
            mod.forward_backward(b)
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        return outs

    graph, batches = _image_op_module()
    got = fit(graph, batches)
    fs = graph._fused_step
    assert fs.captures == 1 and fs.replays == len(batches) - 1
    monkeypatch.setattr(fused_step, "WARMUP_STEPS", len(batches) + 1)
    eager, _ = _image_op_module()
    want = fit(eager, batches)
    assert eager._fused_step.graph is None
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for k, v in graph.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      eager.get_params()[0][k].asnumpy())


def test_device_prefetch_orders_copies_under_a_delayed_stream(card):
    """The side stream is held back before each copy: every batch handed
    out still equals its host batch (the consumer waits for the copy's
    event), and no pinned buffer is refilled while its copy is queued."""
    from mxnet_tpu_torch import io as tio
    rng = np.random.RandomState(0)
    x = rng.rand(48, 3, 64, 64).astype(np.float32)
    y = np.arange(48, dtype=np.float32)
    it = tio.DevicePrefetchIter(mx.io.NDArrayIter(x, y, batch_size=8),
                                ctx=mx.gpu(0))
    up = it._uploader
    plain_copy = up._copy

    def delayed(dst, src):
        torch.cuda._sleep(20_000_000)  # ~10 ms of the side stream
        plain_copy(dst, src)

    up._copy = delayed
    got = []
    for b in it:
        assert b.data[0].context == mx.gpu(0)
        # read on the consumer's stream right away
        got.append((b.data[0].tensor.sum(dim=(1, 2, 3)).cpu().numpy(),
                    b.label[0].tensor.cpu().numpy()))
    assert len(got) == 6
    for i, (s, lab) in enumerate(got):
        np.testing.assert_allclose(s, x[8 * i:8 * i + 8].sum(axis=(1, 2, 3)),
                                   rtol=1e-5)
        np.testing.assert_array_equal(lab, y[8 * i:8 * i + 8])


def _pipeline_rec(tmp_path, n=40, shape=(3, 64, 64)):
    """n records of f32 arrays of ``shape``, written by the port."""
    path = str(tmp_path / "p.rec")
    rng = np.random.RandomState(2)
    w = mx.recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(n):
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(i % 7), i, 0),
            rng.rand(*shape).astype(np.float32).tobytes()))
    w.close()
    return path


@pytest.mark.parametrize("mode,double_buffer", [("thread", True),
                                                ("thread", False),
                                                ("process", True)])
def test_pipeline_upload_is_never_read_early(card, tmp_path, monkeypatch,
                                             mode, double_buffer):
    """io_pipeline's DeviceTransfer with the side stream held back ~10 ms
    before each copy (the ``_copy`` hook): a batch read on the consumer's
    stream the moment ``next()`` returns it is still its host batch, bit
    for bit, with the upload issued on a worker (thread mode), on the
    upload thread (process mode) or at pull time (no double buffer)."""
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import io_pipeline as iop
    from io_pipeline_cases import NoisyDecoder
    rec = _pipeline_rec(tmp_path)
    plain_copy = tio._Uploader._copy

    def delayed(self, dst, src):
        torch.cuda._sleep(20_000_000)
        plain_copy(self, dst, src)

    def pipe(ctx):
        return iop.Pipeline(iop.RecordFileSource(rec, rec + ".idx"),
                            NoisyDecoder("mxnet_tpu_torch", (3, 64, 64)),
                            batch_size=8, shuffle=True, seed=3,
                            num_workers=2, mode=mode, ctx=ctx,
                            double_buffer=double_buffer)

    with pipe(None) as host_pipe:
        want = list(host_pipe.host_batches(0))
    monkeypatch.setattr(tio._Uploader, "_copy", delayed)
    with pipe(mx.gpu(0)).as_dataiter() as it:
        got = []
        for b in it:
            assert b.data[0].context == mx.gpu(0)
            # a device reduction first, on the consumer's stream
            sums = b.data[0].tensor.double().sum(dim=(1, 2, 3))
            got.append((sums.cpu().numpy(), b.data[0].asnumpy(),
                        b.label[0].asnumpy()))
    assert len(got) == len(want) == 5
    for (sums, data, label), hb in zip(got, want):
        np.testing.assert_array_equal(data, hb.data)
        np.testing.assert_array_equal(label, hb.label)
        np.testing.assert_allclose(
            sums, hb.data.astype(np.float64).sum(axis=(1, 2, 3)), rtol=1e-12)


def test_spawn_pool_under_a_live_cuda_context(card, tmp_path):
    """A process pool started by a parent that holds a CUDA context: the
    workers (spawned, never forked) have not initialized CUDA, and their
    batches are bit for bit the thread pool's."""
    import multiprocessing
    from mxnet_tpu_torch import io_pipeline as iop
    from io_pipeline_cases import CudaStateDecoder
    torch.ones(1, device=card).sum().item()
    assert torch.cuda.is_initialized()
    rec = _pipeline_rec(tmp_path, n=20, shape=(3, 16, 16))
    runs = {}
    for mode in ("thread", "process"):
        with iop.Pipeline(iop.RecordFileSource(rec, rec + ".idx"),
                          CudaStateDecoder("mxnet_tpu_torch", (3, 16, 16)),
                          batch_size=4, shuffle=True, seed=8, num_workers=2,
                          mode=mode) as pipe:
            runs[mode] = list(pipe.host_batches(0))
    assert all((b.label == 1.0).all() for b in runs["thread"])
    assert all((b.label == 0.0).all() for b in runs["process"])
    for a, b in zip(runs["thread"], runs["process"]):
        np.testing.assert_array_equal(a.data, b.data)
    assert not multiprocessing.active_children()


def test_fit_from_a_pipeline_captures_while_workers_upload(
        card, deterministic, tmp_path, monkeypatch):
    """``Module.fit`` from a thread-mode Pipeline on the card, the fused
    step captured as a CUDA graph while the workers upload later batches
    on their own threads: their decode is held until the capture has
    begun, and the capture waits until one of their uploads has been
    issued inside it.  The capture succeeds, and the weights are bit for
    bit those of the same fit with every step eager."""
    import threading
    import time
    from mxnet_tpu_torch import io as tio
    from mxnet_tpu_torch import io_pipeline as iop
    from mxnet_tpu_torch.module import fused_step

    # the capture runs at the second step, when the adapter has pulled
    # batches 0-3 (it holds two ahead): the records of batch 4 on wait
    n, batch = 64, 8
    held_from = 4 * batch
    path = str(tmp_path / "g.rec")
    rng = np.random.RandomState(4)
    w = mx.recordio.MXIndexedRecordIO(path + ".idx", path, "w")
    for i in range(n):
        w.write_idx(i, mx.recordio.pack(
            mx.recordio.IRHeader(0, float(i % 5), i, 0),
            rng.rand(3, 16, 16).astype(np.float32).tobytes()))
    w.close()
    uploads = [0]
    plain_upload = tio._Uploader.upload

    def counted_upload(self, b):
        out = plain_upload(self, b)
        uploads[0] += 1
        return out

    monkeypatch.setattr(tio._Uploader, "upload", counted_upload)
    plain_compute = fused_step.FusedTrainStep._compute

    def fit(gate, in_capture):
        inner = iop.NDArrayRecordDecoder((3, 16, 16))

        def decode(raw, r):
            if mx.recordio.unpack(raw)[0].id >= held_from:
                assert gate.wait(30)
            return inner(raw, r)

        def compute(self):
            if torch.cuda.is_current_stream_capturing():
                start = uploads[0]
                gate.set()
                deadline = time.monotonic() + 30
                while uploads[0] == start and time.monotonic() < deadline:
                    time.sleep(0.001)
                in_capture.append(uploads[0] - start)
            return plain_compute(self)

        monkeypatch.setattr(fused_step.FusedTrainStep, "_compute", compute)
        pipe = iop.Pipeline(iop.RecordFileSource(path, path + ".idx"),
                            decode, batch_size=batch, num_workers=2,
                            prefetch_depth=8, mode="thread", ctx=mx.gpu(0))
        mod = mx.mod.Module(_graph_net("float32"), context=mx.gpu(0))
        mx.random.seed(0)
        mod.fit(pipe, num_epoch=1, optimizer="sgd",
                initializer=mx.initializer.Xavier(magnitude=2),
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
        torch.cuda.synchronize()
        return mod

    in_capture = []
    graph = fit(threading.Event(), in_capture)
    assert graph._fused_step.captures == 1
    assert len(in_capture) == 1 and in_capture[0] >= 1
    assert not [t for t in mx.threads.live_package_threads()
                if "io_pipeline" in t.name]
    monkeypatch.setattr(fused_step, "WARMUP_STEPS", n // batch + 1)
    opened = threading.Event()
    opened.set()
    eager = fit(opened, [])
    assert eager._fused_step.graph is None
    for k, v in graph.get_params()[0].items():
        np.testing.assert_array_equal(v.asnumpy(),
                                      eager.get_params()[0][k].asnumpy())


def test_image_record_iter_on_the_card_equals_the_host(card, tmp_path):
    rng = np.random.RandomState(1)
    w = mx.recordio.MXIndexedRecordIO(str(tmp_path / "a.idx"),
                                      str(tmp_path / "a.rec"), "w")
    for i in range(20):
        img = rng.randint(0, 256, (40, 52, 3)).astype(np.uint8)
        w.write_idx(i, mx.recordio.pack_img(
            mx.recordio.IRHeader(0, float(i % 4), i, 0), img))
    w.close()
    runs = []
    for ctx, threads in ((None, 0), (mx.gpu(0), 0), (mx.gpu(0), 3)):
        it = mx.io.ImageRecordIter(
            path_imgrec=str(tmp_path / "a.rec"),
            path_imgidx=str(tmp_path / "a.idx"), data_shape=(3, 32, 32),
            batch_size=4, shuffle=True, rand_crop=True, rand_mirror=True,
            mean_r=123.68, mean_g=116.779, mean_b=103.939, seed=5, ctx=ctx,
            preprocess_threads=threads)
        batches = []
        for b in it:
            assert b.data[0].context == (ctx or mx.cpu())
            batches.append(b.data[0].asnumpy())
        runs.append(batches)
    for a, b in zip(runs[0], runs[1]):
        np.testing.assert_array_equal(a, b)
    assert len(runs[2]) == len(runs[0])


# -- the KVStore over contexts on one card ---------------------------------

def _dp_conv_bn(sym):
    net = sym.Convolution(sym.Variable("data"), kernel=(3, 3), num_filter=4,
                          pad=(1, 1), name="conv1")
    net = sym.BatchNorm(net, fix_gamma=False, name="bn1")
    net = sym.Activation(net, act_type="relu", name="relu1")
    net = sym.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool1")
    net = sym.FullyConnected(sym.Flatten(net), num_hidden=3, name="fc")
    return sym.SoftmaxOutput(net, name="softmax")


@pytest.mark.parametrize("store", ["tpu_ici", "device"])
def test_push_pull_list_over_two_contexts_on_the_card(card, store):
    """Keys of two dtypes pushed from [gpu(0), gpu(0)] and pulled back into
    the pushed arrays: equal to the host's [cpu(0), cpu(1)] bit for bit
    (one add of two copies)."""
    rng = np.random.RandomState(0)
    shapes = [((64, 3, 7, 7), np.float32), ((1000,), np.float32),
              ((5, 5), np.float64)]
    vals = [[rng.standard_normal(s).astype(dt) for _ in range(2)]
            for s, dt in shapes]
    got = {}
    for where, ctxs in (("card", [mx.gpu(0)] * 2),
                        ("host", [mx.cpu(0), mx.cpu(1)])):
        kv = mx.kv.create(store)
        arrays = []
        for k, ((s, dt), copies) in enumerate(zip(shapes, vals)):
            kv.init(k, mx.nd.zeros(s, ctx=ctxs[0], dtype=dt))
            arrays.append([mx.nd.array(v, ctx=c, dtype=dt)
                           for v, c in zip(copies, ctxs)])
        if hasattr(kv, "push_pull_list"):
            kv.push_pull_list(list(range(3)), arrays, arrays)
        else:
            for k, a in enumerate(arrays):
                kv.push(k, a)
                kv.pull(k, out=a)
        got[where] = [[x.asnumpy() for x in a] for a in arrays]
    for card_copies, host_copies, copies in zip(got["card"], got["host"],
                                                vals):
        for c, h in zip(card_copies, host_copies):
            np.testing.assert_array_equal(c, h)
            np.testing.assert_array_equal(c, copies[0] + copies[1])


@pytest.mark.parametrize("store", ["device", "local"])
def test_store_updates_on_the_card_after_a_host_init(card, no_tf32, store,
                                                     tmp_path):
    """A store initialized from host weights (as Module's masters are) and
    pushed gradients from [gpu(0), gpu(0)] keeps the weight and the SGD
    momentum on the card from the first push on; pulled weights equal the
    host's [cpu(0), cpu(1)] run within 1e-6 over 3 pushes, and states saved
    on the card load into a fresh store whose next push matches."""
    rng = np.random.RandomState(3)
    w0 = rng.standard_normal((256, 64)).astype(np.float32)
    grads = [[rng.standard_normal(w0.shape).astype(np.float32)
              for _ in range(2)] for _ in range(3)]
    got = {}
    for where, ctxs in (("card", [mx.gpu(0)] * 2),
                        ("host", [mx.cpu(0), mx.cpu(1)])):
        kv = mx.kv.create(store)
        kv.init("w", mx.nd.array(w0, ctx=mx.cpu()))
        kv.set_optimizer(mx.optimizer.create(
            "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4))
        outs = [mx.nd.zeros(w0.shape, ctx=c) for c in ctxs]
        for g in grads:
            kv.push("w", [mx.nd.array(x, ctx=c) for x, c in zip(g, ctxs)])
            kv.pull("w", out=outs)
        got[where] = outs[0].asnumpy()
        if where == "card":
            assert kv._stored["w"].tensor.is_cuda
            assert kv._updater.states["w"].tensor.is_cuda
            kv.save_optimizer_states(str(tmp_path / "states"))
            resumed = mx.kv.create(store)
            resumed.init("w", mx.nd.array(got[where], ctx=mx.cpu()))
            resumed.set_optimizer(mx.optimizer.create(
                "sgd", learning_rate=0.1, momentum=0.9, wd=1e-4))
            resumed.load_optimizer_states(str(tmp_path / "states"))
            push = [mx.nd.array(x, ctx=c) for x, c in zip(grads[0], ctxs)]
            for k in (kv, resumed):
                k.push("w", push)
            np.testing.assert_array_equal(resumed._stored["w"].asnumpy(),
                                          kv._stored["w"].asnumpy())
    np.testing.assert_allclose(got["card"], got["host"], rtol=1e-6,
                               atol=1e-6)


def test_two_bit_codes_on_the_card_equal_the_hosts(card):
    """The quantizer on the card, residual carried over 3 pushes, at
    ResNet-50's largest gradient (2048 x 1000) and an odd length: codes
    and residuals bit for bit the host's."""
    from mxnet_tpu_torch.kvstore import gradient_compression as gc
    gen = torch.Generator().manual_seed(1)
    for n in (2048 * 1000, 1001):
        res_c, res_h = torch.zeros(n, device=card), torch.zeros(n)
        for _ in range(3):
            g = torch.randn(n, generator=gen) * 0.4
            codes_c, res_c = gc.quantize_flat(g.to(card), res_c, 0.5)
            codes_h, res_h = gc.quantize_flat(g, res_h, 0.5)
            assert torch.equal(codes_c.cpu(), codes_h)
            assert torch.equal(res_c.cpu(), res_h)
        rows = torch.stack([codes_h, codes_h.flip(0)])
        assert torch.equal(gc.dequantize_sum_flat(rows.to(card), n,
                                                  0.5).cpu(),
                           gc.dequantize_sum_flat(rows, n, 0.5))


def test_two_context_conv_bn_step_on_the_card_against_the_host(card):
    """One step of a conv+BatchNorm net at 3x24x24, batch 8 over two
    contexts (each normalizing its slice), from the same weights: outputs
    within 1e-3, and each gradient summed over the contexts within 1e-3
    relative L2 or 4 times the host's own change when the images move by
    1e-7 (phase 4's rule); the card's two contexts hold one sum."""
    rng = np.random.RandomState(2)
    x = rng.standard_normal((8, 3, 24, 24)).astype(np.float32)
    y = rng.randint(0, 3, 8).astype(np.float32)
    sym = _dp_conv_bn(mx.sym)
    arg_shapes, _, aux_shapes = sym.infer_shape(data=(8, 3, 24, 24))
    args = {n: (0.3 * rng.standard_normal(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    args["bn1_gamma"] = 1 + 0.1 * args["bn1_gamma"]

    def step(ctxs, data):
        mod = mx.mod.Module(sym, context=ctxs)
        # inputs_need_grad keeps the general path (the fused dp step
        # refuses it): each context normalizes its own slice here
        mod.bind([("data", data.shape)], [("softmax_label", y.shape)],
                 inputs_need_grad=True)
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in args.items()})
        mod.init_optimizer(kvstore="tpu_ici", optimizer="sgd")
        assert mod._fused_step is None
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(data, ctx=mx.cpu())], [mx.nd.array(y, ctx=mx.cpu())]))
        group = mod._exec_group
        mod._kvstore.push_pull_list(mod._param_names, group.grad_arrays,
                                    group.grad_arrays)
        for grads in group.grad_arrays:
            assert torch.equal(grads[0].tensor.cpu(), grads[1].tensor.cpu())
        return mod.get_outputs()[0].asnumpy(), {
            n: g[0].asnumpy() for n, g in zip(mod._param_names,
                                              group.grad_arrays)}

    host = [mx.cpu(0), mx.cpu(1)]
    out_c, g_c = step([mx.gpu(0)] * 2, x)
    out_h, g_h = step(host, x)
    nudged = (x * (1 + 1e-7 * rng.standard_normal(x.shape))).astype(
        np.float32)
    _, g_n = step(host, nudged)
    np.testing.assert_allclose(out_c, out_h, atol=1e-3, rtol=1e-3)

    def rel(a, b):
        return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    for n in g_h:
        assert rel(g_c[n], g_h[n]) <= max(1e-3, 4 * rel(g_n[n], g_h[n])), n


_DIST_WORKER = r"""
import numpy as np
import mxnet_tpu_torch as mx
kv = mx.kv.create("dist_sync")
ctx = mx.gpu(0)
kv.init("w", mx.nd.zeros((1000,), ctx=ctx))
kv.push("w", mx.nd.ones((1000,), ctx=ctx) * (kv.rank + 1))
out = mx.nd.zeros((1000,), ctx=ctx)
kv.pull("w", out=out)
assert out.context == ctx and np.all(out.asnumpy() == 3.0), out.asnumpy()
assert kv.backend == "gloo", kv.backend
kv.barrier()
print("CARD_DIST_OK rank=%d backend=%s" % (kv.rank, kv.backend), flush=True)
"""


def test_dist_sync_push_pull_of_two_processes_on_the_card(card, tmp_path):
    """Two processes on gpu(0) through ``tools/launch.py``: gloo (NCCL
    refuses two ranks on one card), the sum on the card in both; the
    process group is killed past 180 s."""
    import os
    import signal
    import socket
    import subprocess
    import sys
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_DIST_WORKER)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, os.path.join(repo, "tools", "launch.py"), "-n", "2",
         "--port", str(port), "--", sys.executable, str(script)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=repo, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=180)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, _ = proc.communicate()
        raise AssertionError("the ranks hung; output:\n" + out)
    assert proc.returncode == 0 and out.count("CARD_DIST_OK") == 2, out


# -- the mesh layer (mx.parallel) on the card ---------------------------------

def _parallel_meshes(n=4, **sizes):
    from mxnet_tpu_torch.parallel import MeshSpec, create_mesh
    spec = MeshSpec(**(sizes or {"dp": 2, "tp": 2}))
    return (create_mesh(spec, devices=[mx.gpu(0)] * n),
            create_mesh(spec, devices=[mx.cpu()] * n))


@pytest.mark.parametrize("kind", ["psum", "pmean", "all_gather", "ppermute",
                                  "all_to_all"])
def test_collective_over_card_positions_equals_host_positions(card, kind):
    """Each collective over [gpu(0)] * 4 against the same collective over
    four host positions: bit for bit (moves, and sums in position order)."""
    from mxnet_tpu_torch.parallel import collectives as C
    on_card, on_host = _parallel_meshes()
    g = torch.Generator().manual_seed(1)
    host = [torch.randn(4, 6, generator=g) for _ in range(4)]
    calls = {
        "psum": lambda b, m: C.psum(b, m, "tp"),
        "pmean": lambda b, m: C.pmean(b, m, "dp"),
        "all_gather": lambda b, m: C.all_gather(b, m, "dp"),
        "ppermute": lambda b, m: C.ppermute(b, m, "tp", [(0, 1), (1, 0)]),
        "all_to_all": lambda b, m: C.all_to_all(b, m, "dp", 0, 1),
    }
    with C.watch(timed=True) as w:
        got = calls[kind]([t.to(card) for t in host], on_card)
    want = calls[kind](host, on_host)
    for a, b in zip(got, want):
        assert a.device == card
        assert torch.equal(a.cpu(), b)
    assert sum(w.counts.values()) == 1
    assert sum(w.spans_ms().values()) > 0


def test_ring_attention_step_on_the_card_matches_its_host_run(card, no_tf32):
    """A causal ring self-attention forward and backward over
    [gpu(0)] * 4 (dp 2, sp 2) against the same over host positions:
    outputs and gradients within phase 2's f32 limit, atol=rtol=1e-4
    (f32 products and sums of up to 256 terms in another order)."""
    from mxnet_tpu_torch.parallel import ring_self_attention
    on_card, on_host = _parallel_meshes(dp=2, sp=2)
    g = torch.Generator().manual_seed(2)
    x = torch.randn(4, 64, 32, generator=g)
    ws = [torch.randn(32, 32, generator=g) * 0.2 for _ in range(4)]
    results = []
    for mesh, dev in ((on_card, card), (on_host, torch.device("cpu"))):
        leaves = [t.to(dev).requires_grad_(True) for t in [x] + ws]
        out = ring_self_attention(*leaves, num_heads=4, mesh=mesh,
                                  batch_axis="dp")
        (out ** 2).sum().backward()
        results.append([out.detach().cpu()]
                       + [t.grad.cpu() for t in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_sharded_train_step_on_the_card_matches_the_host(card, no_tf32):
    """The GPipe training problem at dp 2, pp 2 over [gpu(0)] * 4 against
    host positions: 3 steps' losses and weights within 1e-5."""
    from mxnet_tpu_torch.parallel import (NamedSharding, P,
                                          ShardedTrainStep, pipeline_stages)
    rng = np.random.RandomState(7)
    w0 = rng.randn(2, 8, 8).astype(np.float32) * 0.3
    batch = {"x": rng.randn(16, 8).astype(np.float32),
             "y": rng.randn(16, 8).astype(np.float32)}
    runs = []
    for mesh in _parallel_meshes(dp=2, pp=2):
        def loss_fn(params, b, mesh=mesh):
            y = pipeline_stages(params["w"], b["x"],
                                lambda p, xm: torch.tanh(xm @ p), n_micro=4,
                                mesh=mesh, batch_axis="dp")
            return torch.mean((y - b["y"]) ** 2)
        step = ShardedTrainStep(
            loss_fn, {"w": w0}, mesh, lr=0.2,
            param_sharding={"w": NamedSharding(mesh, P("pp"))},
            batch_spec={k: NamedSharding(mesh, P("dp")) for k in batch})
        losses = [float(step(batch)) for _ in range(3)]
        runs.append((losses, np.asarray(step.params["w"])))
    np.testing.assert_allclose(runs[0][0], runs[1][0], rtol=1e-5)
    np.testing.assert_allclose(runs[0][1], runs[1][1], rtol=1e-5, atol=1e-6)


def test_synced_batchnorm_over_two_card_groups_matches_one_group(card,
                                                                  no_tf32):
    """Training BatchNorm over two groups of [gpu(0)] * 2 (each group's
    rows apart, the channel sums psum'd) against one group holding every
    row, on the card: outputs, the global mean and variance, and the
    gradients of x, gamma (summed over the groups) and beta within
    atol=rtol=1e-4 (f32 sums in another order).  bn_channel_sums runs
    once per group forward (x) and once backward (dy, x)."""
    from mxnet_tpu_torch.module import _spmd
    from mxnet_tpu_torch.ops import nn as tnn
    from mxnet_tpu_torch.parallel import create_mesh
    g = torch.Generator(device=card).manual_seed(3)
    x = torch.randn(8, 16, 12, 12, generator=g, device=card) * 2 + 0.5
    gamma = torch.rand(16, generator=g, device=card) + 0.5
    beta = torch.randn(16, generator=g, device=card)
    dy = torch.randn(8, 16, 12, 12, generator=g, device=card)
    mesh = create_mesh(dp=2, devices=[mx.gpu(0)] * 2)

    def run(groups):
        xs = [t.clone().requires_grad_(True) for t in x.chunk(groups)]
        gs = [gamma.clone().requires_grad_(True) for _ in xs]
        bs = [beta.clone().requires_grad_(True) for _ in xs]
        if groups == 1:
            out, mean, var = tnn._BNTrainFn.apply(xs[0], gs[0], bs[0], 1e-3)
            outs = [out]
        else:
            res = _spmd._SyncBNFn.apply(mesh, 1e-3, *xs, *gs, *bs)
            outs, mean, var = res[:groups], res[-2], res[-1]
        torch.autograd.backward(list(outs) + [mean, var],
                                list(dy.chunk(groups)) + [
                                    torch.ones_like(mean),
                                    torch.ones_like(var)])
        return [torch.cat(outs), mean, var, torch.cat([t.grad for t in xs]),
                sum(t.grad for t in gs), sum(t.grad for t in bs)]

    want = run(1)
    before = K.launch_counts()["bn_channel_sums"]
    got = run(2)
    torch.cuda.synchronize()
    assert K.launch_counts()["bn_channel_sums"] == before + 4
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


def test_sharded_module_step_on_the_card_matches_the_host(card, no_tf32):
    """One ShardedModule step of a conv + BatchNorm net over dp=2, tp=2
    positions of [gpu(0)] * 4 against the same over host positions:
    outputs, parameters and moving statistics within atol=rtol=1e-4;
    the card's step launches bn_channel_sums twice a BatchNorm and
    group, and a pooling backward once a pooling and group."""
    rng = np.random.RandomState(5)
    x = rng.standard_normal((8, 3, 16, 16)).astype(np.float32)
    y = rng.randint(0, 4, 8).astype(np.float32)
    S = mx.sym
    net = S.Convolution(S.var("data"), num_filter=8, kernel=(3, 3),
                        pad=(1, 1), name="c1")
    net = S.Activation(S.BatchNorm(net, fix_gamma=False, name="bn1"),
                       act_type="relu")
    net = S.Pooling(net, kernel=(2, 2), stride=(2, 2), pool_type="max")
    net = S.Pooling(net, global_pool=True, kernel=(1, 1), pool_type="avg")
    net = S.SoftmaxOutput(S.FullyConnected(S.Flatten(net), num_hidden=4,
                                           name="fc"), name="softmax")
    arg_shapes, _, _ = net.infer_shape(data=x.shape)
    args = {n: (0.3 * rng.standard_normal(s)).astype(np.float32)
            for n, s in zip(net.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    results = []
    for mesh in _parallel_meshes(dp=2, tp=2):
        mod = mx.mod.ShardedModule(net, mesh=mesh)
        mod.bind([("data", x.shape)], [("softmax_label", y.shape)])
        mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                    for k, v in args.items()},
                        aux_params={"bn1_moving_mean": mx.nd.zeros(
                            (8,), ctx=mx.cpu()), "bn1_moving_var":
                            mx.nd.ones((8,), ctx=mx.cpu())})
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        assert mod.dp_mode == "split"
        before = K.launch_counts()
        mod.forward_backward(mx.io.DataBatch(
            [mx.nd.array(x, ctx=mx.cpu())], [mx.nd.array(y, ctx=mx.cpu())]))
        after = K.launch_counts()
        launched = {k: after[k] - before[k] for k in after}
        arg, aux = mod.get_params()
        results.append((mod.get_outputs()[0].asnumpy(),
                        {k: v.asnumpy() for k, v in arg.items()},
                        {k: v.asnumpy() for k, v in aux.items()},
                        launched))
    (out_c, arg_c, aux_c, launched), (out_h, arg_h, aux_h, _) = results
    assert launched["bn_channel_sums"] == 4
    assert launched["max_pool_backward"] == 2
    assert launched["avg_pool_backward"] == 2
    np.testing.assert_allclose(out_c, out_h, rtol=1e-4, atol=1e-4)
    for c, h in ((arg_c, arg_h), (aux_c, aux_h)):
        for k in h:
            np.testing.assert_allclose(c[k], h[k], rtol=1e-4, atol=1e-4,
                                       err_msg=k)


def _dp_fused_module(graphed, seed=7):
    """The conv + BatchNorm net over [gpu(0)] * 2 under 'tpu_ici' (the
    fused data-parallel step) at batch 8, and 4 batches; ``graphed``
    False runs every step eagerly."""
    rng = np.random.RandomState(seed)
    sym = _dp_conv_bn(mx.sym)
    arg_shapes, _, _ = sym.infer_shape(data=(8, 3, 24, 24))
    args = {n: (0.3 * rng.standard_normal(s)).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)
            if n not in ("data", "softmax_label")}
    args["bn1_gamma"] = 1 + 0.1 * args["bn1_gamma"]
    batches = [mx.io.DataBatch(
        [mx.nd.array(rng.standard_normal((8, 3, 24, 24)), ctx=mx.cpu())],
        [mx.nd.array(rng.randint(0, 3, 8), ctx=mx.cpu())])
        for _ in range(4)]
    mod = mx.mod.Module(sym, context=[mx.gpu(0)] * 2)
    mod.bind([("data", (8, 3, 24, 24))], [("softmax_label", (8,))])
    mod.init_params(arg_params={k: mx.nd.array(v, ctx=mx.cpu())
                                for k, v in args.items()})
    mod.init_optimizer(kvstore="tpu_ici", optimizer="sgd",
                       optimizer_params={"learning_rate": 0.1,
                                         "momentum": 0.9, "wd": 1e-4})
    fs = mod._fused_step
    assert fs is not None and fs.dp_mode == "split"
    fs._graphable = graphed
    return mod, batches


def test_fused_dp_replays_match_the_eager_dp_step(card, no_tf32,
                                                  deterministic):
    """The fused dp step over [gpu(0)] * 2: one eager step, a capture and
    two replays against four eager steps from one state: masters,
    momenta and moving statistics within 1e-6, the replicas bit for
    bit."""
    graph, batches = _dp_fused_module(True)
    eager, _ = _dp_fused_module(False)
    _steps(graph, batches)
    _steps(eager, batches)
    fs, fe = graph._fused_step, eager._fused_step
    assert fs.captures == 1 and fs.replays == 3 and fe.graph is None
    for a, b in zip(fs._masters + fs.states, fe._masters + fe.states):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-6, atol=1e-6)
    for k, v in graph.get_params()[1].items():
        np.testing.assert_allclose(v.asnumpy(),
                                   eager.get_params()[1][k].asnumpy(),
                                   rtol=1e-6, atol=1e-6)
    group = graph._exec_group
    for blocks in group.param_arrays + group.aux_arrays:
        assert torch.equal(blocks[0].tensor, blocks[1].tensor)


def test_fused_dp_replays_count_collectives_and_launches(card):
    """Each replay counts the collectives and kernel launches its capture
    recorded: two replays give equal counts, equal to the eager step's
    (2 BatchNorm all-reduces, one a gradient; 2 channel sums and 1
    max-pool backward a position)."""
    mod, batches = _dp_fused_module(True)
    fs = mod._fused_step
    counts, launches = [], []
    for b in batches:
        before = K.launch_counts()
        mod.forward_backward(b)
        mod.update()
        torch.cuda.synchronize()
        after = K.launch_counts()
        counts.append(dict(fs.collectives))
        launches.append({k: after[k] - before[k] for k in after
                         if after[k] != before[k]})
    assert fs.replays == 3
    n_params = len(fs.param_names)
    assert all(c == counts[0] for c in counts), counts
    assert counts[0]["all-reduce"] == 2 + n_params
    assert fs.graph_collectives == {"all-reduce": 2 + n_params}
    assert all(l == launches[0] for l in launches), launches
    assert launches[0] == {"bn_channel_sums": 4, "max_pool_backward": 2}


def test_group2ctx_host_weights_on_a_card_bind(card, no_tf32):
    """fc1 in a group on the host, fc2 in one on the card, bound on
    gpu(0): fc1's weight and gradient stay on the host, fc2's on the
    card, and the outputs and gradients are bit for bit the plain gpu(0)
    bind's (the same products on the card)."""
    with mx.AttrScope(ctx_group="host"):
        a = mx.sym.FullyConnected(mx.sym.var("data"), num_hidden=16,
                                  name="fc1")
    with mx.AttrScope(ctx_group="card"):
        b = mx.sym.FullyConnected(mx.sym.Activation(a, act_type="tanh"),
                                  num_hidden=4, name="fc2")
    net = mx.sym.SoftmaxOutput(b, name="softmax")
    rng = np.random.RandomState(4)
    placed = net.simple_bind(mx.gpu(0), data=(8, 32), group2ctx={
        "host": mx.cpu(0), "card": mx.gpu(0)})
    plain = net.simple_bind(mx.gpu(0), data=(8, 32))
    vals = {k: rng.standard_normal(v.shape).astype(np.float32) * 0.3
            for k, v in plain.arg_dict.items()}
    vals["softmax_label"] = (np.arange(8) % 4).astype(np.float32)
    got = []
    for exe in (placed, plain):
        for k, v in vals.items():
            exe.arg_dict[k][:] = v
        out = exe.forward(is_train=True)[0].asnumpy()
        exe.backward()
        got.append((out, {k: g.asnumpy() for k, g in exe.grad_dict.items()}))
    for name in ("fc1_weight", "fc1_bias"):
        assert placed.arg_dict[name].context == mx.cpu(0)
        assert not placed.grad_dict[name].tensor.is_cuda
    assert placed.grad_dict["fc2_weight"].tensor.is_cuda
    assert np.array_equal(got[0][0], got[1][0])
    for k in got[1][1]:
        assert np.array_equal(got[0][1][k], got[1][1][k]), k


# -- the dense op surface (ops/extra.py, ops/contrib_ops.py): each op on the
# card against the host at small shapes, f32 with TF32 off; the LeNet-STN
# pool instances and the box_nms kernel against their plain versions -------

def _dense_rng(seed):
    return np.random.RandomState(seed)


def _spd_batch(r, b, n):
    a = r.rand(b, n, n)
    return (a @ np.swapaxes(a, -1, -2) + n * np.eye(n)).astype(np.float32)


def _corner_boxes(r, *lead, n):
    xy = r.rand(*lead, n, 2) * 0.7
    return np.concatenate([xy, xy + r.rand(*lead, n, 2) * 0.3 + 0.02],
                          -1).astype(np.float32)


def _det_batch(r, b, n, n_cls):
    boxes = _corner_boxes(r, b, n=n)
    boxes[:, 1::3] = boxes[:, 0::3][:, :boxes[:, 1::3].shape[1]] + 0.01
    scores = np.round(r.rand(b, n), 1).astype(np.float32)
    cls = r.randint(0, n_cls, (b, n)).astype(np.float32)
    return np.concatenate([cls[..., None], scores[..., None], boxes], -1)


def _prior_anchors():
    from mxnet_tpu_torch.ops.registry import get_op
    return get_op("MultiBoxPrior").impl(
        torch.zeros(1, 1, 5, 5), sizes=(0.2, 0.272), ratios=(1.0, 2.0, 0.5),
        steps=(0.2, 0.2)).numpy()


def _dense_inputs(name):
    """(inputs, attrs, differentiable input count) of one card case."""
    r = _dense_rng(sum(map(ord, name)))
    f = lambda *s: r.randn(*s).astype(np.float32)  # noqa: E731
    spd = _spd_batch(r, 2, 5)
    tril = np.tril(r.rand(2, 5, 5) + 0.5).astype(np.float32)
    anchors = _prior_anchors()
    a = anchors.shape[1]
    labels = -np.ones((2, 3, 5), np.float32)
    labels[:, :2, 0] = [[1, 4], [0, 2]]
    labels[:, :2, 1:] = _corner_boxes(r, 2, n=2)
    probs = np.exp(f(2, 4, a) * 2)
    probs = (probs / probs.sum(1, keepdims=True)).astype(np.float32)
    identity = np.tile(np.array([[1, 0, 0, 0, 1, 0]], np.float32), (2, 1))
    cases = {
        "linalg_gemm": ([f(2, 3, 4), f(2, 4, 5), f(2, 3, 5)],
                        {"alpha": 0.5, "beta": 2.0}, 3),
        "linalg_gemm2": ([f(2, 4, 3), f(2, 4, 5)], {"transpose_a": True}, 2),
        "linalg_potrf": ([spd], {}, 1),
        "linalg_potri": ([np.linalg.cholesky(spd).astype(np.float32)], {}, 1),
        "linalg_trsm": ([tril, f(2, 5, 3)], {"alpha": 1.5}, 2),
        "linalg_trmm": ([tril, f(2, 3, 5)], {"rightside": True}, 2),
        "linalg_syrk": ([f(2, 3, 5)], {"transpose": True}, 1),
        "linalg_sumlogdiag": ([spd], {}, 1),
        "linalg_gelqf": ([f(2, 3, 5)], {}, 1),
        "linalg_syevd": ([spd], {}, 0),
        "khatri_rao": ([f(3, 4), f(2, 4)], {}, 2),
        "_contrib_khatri_rao": ([f(3, 4), f(2, 4)], {}, 2),
        "Crop": ([f(2, 3, 7, 8)], {"offset": (1, 2), "h_w": (4, 5)}, 1),
        "smooth_l1": ([f(3, 7) * 2], {"scalar": 1.5}, 1),
        "depth_to_space": ([f(2, 8, 3, 3)], {"block_size": 2}, 1),
        "space_to_depth": ([f(2, 2, 6, 4)], {"block_size": 2}, 1),
        "IdentityAttachKLSparseReg": ([f(3, 4)], {}, 1),
        "GridGenerator": ([identity + f(2, 6) * 0.1],
                          {"transform_type": "affine",
                           "target_shape": (6, 7)}, 1),
        "BilinearSampler": ([f(2, 3, 6, 7), f(2, 2, 5, 4) * 0.8], {}, 2),
        "SpatialTransformer": ([f(2, 3, 8, 8), identity],
                               {"target_shape": (8, 8)}, 2),
        "ROIPooling": ([np.maximum(f(2, 4, 10, 12), 0),
                        np.array([[0, 0, 0, 11, 9], [1, 2, 1, 8, 8],
                                  [0, 4, 4, 60, 60]], np.float32)],
                       {"pooled_size": (3, 3), "spatial_scale": 1.0}, 1),
        "Correlation": ([f(2, 4, 9, 10), f(2, 4, 9, 10)],
                        {"kernel_size": 3, "max_displacement": 2,
                         "stride1": 2, "stride2": 2, "pad_size": 2}, 2),
        "box_iou": ([_corner_boxes(r, n=6), _corner_boxes(r, n=4)],
                    {"format": "corner"}, 2),
        "box_nms": ([_det_batch(r, 3, 70, 3)],
                    {"overlap_thresh": 0.3, "topk": 50, "id_index": 0}, 1),
        "MultiBoxPrior": ([f(1, 2, 5, 5)],
                          {"sizes": (0.2, 0.272), "ratios": (1, 2, 0.5)}, 0),
        "MultiBoxTarget": ([anchors, labels, f(2, 4, a)],
                           {"overlap_threshold": 0.3}, 0),
        "MultiBoxDetection": ([probs, f(2, a * 4) * 0.3, anchors],
                              {"nms_threshold": 0.45, "nms_topk": 30,
                               "threshold": 0.05}, 0),
        "quantize": ([f(3, 9), np.array([-1.5], np.float32),
                      np.array([2.0], np.float32)], {"out_type": "int8"}, 0),
        "dequantize": ([r.randint(0, 256, (3, 9)).astype(np.uint8),
                        np.array([-1.5], np.float32),
                        np.array([2.0], np.float32)], {}, 0),
        "fft": ([f(3, 16)], {}, 1),
        "ifft": ([f(3, 32)], {}, 1),
    }
    return cases[name]


DENSE_CARD_OPS = [
    "linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_potri",
    "linalg_trsm", "linalg_trmm", "linalg_syrk", "linalg_sumlogdiag",
    "linalg_gelqf", "linalg_syevd", "khatri_rao", "_contrib_khatri_rao",
    "Crop", "smooth_l1", "depth_to_space", "space_to_depth",
    "IdentityAttachKLSparseReg", "GridGenerator", "BilinearSampler",
    "SpatialTransformer", "ROIPooling", "Correlation", "box_iou", "box_nms",
    "MultiBoxPrior", "MultiBoxTarget", "MultiBoxDetection", "quantize",
    "dequantize", "fft", "ifft"]
# outputs compared exactly: suppression decisions, codes, identities
DENSE_EXACT = {"box_nms", "quantize", "Crop",
               "depth_to_space", "space_to_depth",
               "IdentityAttachKLSparseReg", "MultiBoxPrior"}


def _dense_run(name, inputs, attrs, n_diff, device):
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op(name)
    ts = [torch.tensor(x, device=device, requires_grad=i < n_diff)
          for i, x in enumerate(inputs)]
    outs = op.impl(*ts, **op.normalize_attrs(attrs))
    outs = outs if isinstance(outs, tuple) else (outs,)
    outs = outs[:op.str_outputs(op.normalize_attrs(attrs))]
    grads = []
    live = [o for o in outs if o.requires_grad]
    if n_diff and live:
        g = torch.Generator().manual_seed(5)
        cts = [torch.randn(o.shape, generator=g).to(device) for o in live]
        grads = torch.autograd.grad(live, ts[:n_diff], cts,
                                    allow_unused=True)
        grads = [None if x is None else x.detach().cpu() for x in grads]
    return [o.detach().cpu() for o in outs], grads


def _near(got, want, rel):
    got, want = got.double(), want.double()
    scale = max(1.0, float(want.abs().max())) if want.numel() else 1.0
    torch.testing.assert_close(got, want, rtol=rel, atol=rel * scale)


@pytest.mark.parametrize("name", DENSE_CARD_OPS)
def test_dense_op_on_the_card_matches_the_host(card, no_tf32, name):
    """Outputs within 1e-4 relative to their scale (exact for suppression
    decisions, codes and layout ops), input gradients within 1e-4;
    ``syevd`` through its eigenvalues and ``U^T diag(L) U``."""
    inputs, attrs, n_diff = _dense_inputs(name)
    host = _dense_run(name, inputs, attrs, n_diff, "cpu")
    dev = _dense_run(name, inputs, attrs, n_diff, card)
    if name == "linalg_syevd":
        (hu, hl), (du, dl) = host[0], dev[0]
        _near(dl, hl, 1e-4)
        _near(du.transpose(-1, -2) @ (dl[..., None] * du),
              hu.transpose(-1, -2) @ (hl[..., None] * hu), 1e-4)
        return
    for d, h in zip(dev[0], host[0]):
        assert d.dtype == h.dtype and d.shape == h.shape
        if name == "MultiBoxDetection":
            # the same decisions; the decoded boxes go through exp, whose
            # last bit differs between the card and the host
            assert torch.equal(d[..., 0], h[..., 0])
        if name in DENSE_EXACT:
            assert torch.equal(d, h)
        else:
            _near(d, h, 1e-4)
    for d, h in zip(dev[1], host[1]):
        assert (d is None) == (h is None)
        if d is not None:
            _near(d, h, 1e-4)


@pytest.mark.parametrize("case", [
    ("max", (64, 30, 12, 12), (2, 2), (2, 2)),      # the loc net's pool
    ("avg", (64, 60, 6, 6), (6, 6), (1, 1)),        # its global pool
], ids=["loc-max-2x2s2", "loc-global-avg"])
def test_pool_backward_at_lenet_stn_loc_net_shapes(card, case):
    """The LeNet-STN localisation net's pools (post-ReLU inputs, ties):
    one launch each, bit for bit the plain version."""
    pool, shape, kernel, stride = case
    g = torch.Generator(device=card).manual_seed(12)
    x = torch.clamp_min(torch.randn(*shape, generator=g, device=card), 0.0)
    out = (shape[2] // stride[0] if pool == "max" else 1,
           shape[3] // stride[1] if pool == "max" else 1)
    dy = torch.randn(shape[:2] + out, generator=g, device=card)
    pads = ((0, 0), (0, 0))
    name = pool + "_pool_backward"
    before = K.launch_counts()[name]
    if pool == "max":
        got = K.max_pool_backward(x, dy, kernel, stride, pads)
        want = K._plain_max_pool_backward(x, dy, kernel, stride, pads)
    else:
        div = torch.full(out, 1.0 / 36, device=card)
        got = K.avg_pool_backward(dy, div, shape, kernel, stride, pads)
        want = K._plain_avg_pool_backward(dy, div, shape, kernel, stride,
                                          pads, torch.float32)
    torch.cuda.synchronize()
    assert K.launch_counts()[name] == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", [
    (1, 1, 2, 0.5, False), (3, 70, 3, 0.3, False), (2, 64, 2, 0.3, True),
    (4, 129, 1, 0.45, False), (2, 1000, 5, 0.2, False),
    (32, 8732, 20, 0.45, False)],
    ids=lambda c: "x".join(map(str, c)))
def test_box_nms_kernel_matches_plain(card, case):
    """The keep flags, bit for bit: ties in score, boxes of one block and
    of several, class-aware and forced suppression, SSD-300's 8,732
    anchors at batch 32 (the plain version on every 8th picture)."""
    b, m, n_cls, thresh, force = case
    r = _dense_rng(m)
    det = torch.tensor(_det_batch(r, b, m, n_cls), device=card)
    scores = det[..., 1]
    valid = scores > 0.05
    order, rank = K.nms_order(scores)
    before = K.launch_counts()["box_nms"]
    got = K.box_nms_keep(det[..., 2:6], det[..., 0], valid, order, rank,
                         thresh, force)
    torch.cuda.synchronize()
    assert K.launch_counts()["box_nms"] == before + 1
    pick = slice(None) if b * m <= 10000 else slice(0, b, 8)
    want = K._plain_box_nms_keep(det[pick, :, 2:6], det[pick, :, 0],
                                 valid[pick], order[pick], rank[pick], thresh,
                                 force)
    assert torch.equal(got[pick], want)


def test_box_nms_kernel_raises_outside_its_limits(card):
    det = torch.rand(1, 10, 6, device=card, dtype=torch.float64)
    order, rank = K.nms_order(det[..., 1])
    with pytest.raises(mx.MXNetError):
        K.box_nms_keep(det[..., 2:6], det[..., 0], det[..., 1] > 0, order,
                       rank, 0.5, False)


# Proposal's suppression and deformable convolution's column --------------

@pytest.mark.parametrize("case", [
    (1, 1, 0.7), (1, 130, 0.7), (2, 1000, 0.7), (3, 300, 0.5),
    (1, 6000, 0.7)], ids=lambda c: "x".join(map(str, c)))
def test_proposal_nms_kernel_matches_plain(card, case):
    """Proposal's mode of ``csrc/box_nms.cu`` (pixel-inclusive IoU, every
    box in the sweep): the keep flags bit for bit the plain loop's, on
    boxes with integer corners (many equal IoUs, some exactly at the
    threshold) and RPN's 6,000."""
    b, m, thresh = case
    g = torch.Generator().manual_seed(m)
    xy = torch.floor(torch.rand(b, m, 2, generator=g) * 500)
    wh = torch.floor(torch.rand(b, m, 2, generator=g) * 120)
    boxes = torch.cat([xy, xy + wh], -1).to(card)
    before = K.launch_counts()["box_nms"]
    got = K.proposal_nms_keep(boxes, thresh)
    torch.cuda.synchronize()
    assert K.launch_counts()["box_nms"] == before + 1
    want = K._plain_proposal_nms_keep(boxes, thresh)
    assert torch.equal(got, want)


DEFORM_CASES = [  # N, C, H, W, kernel, stride, pad, dilate, deformable groups
    (1, 4, 9, 11, 3, 1, 1, 1, 1), (2, 16, 20, 24, 3, 2, 2, 2, 4),
    (1, 8, 7, 5, 1, 1, 0, 1, 2), (1, 512, 38, 63, 3, 1, 2, 2, 4)]


@pytest.mark.parametrize("case", DEFORM_CASES,
                         ids=lambda c: "x".join(map(str, c)))
def test_deformable_im2col_kernel_matches_plain(card, case):
    """The column bit for bit the plain version's on the card, offsets
    reaching past every edge; one launch; the last case is Deformable
    R-FCN's res5 branch2b."""
    n, c, h, w, k, s, p, d, dg = case
    ho = (h + 2 * p - (d * (k - 1) + 1)) // s + 1
    wo = (w + 2 * p - (d * (k - 1) + 1)) // s + 1
    g = torch.Generator(device=card).manual_seed(c)
    data = torch.randn(n, c, h, w, generator=g, device=card)
    off = torch.randn(n, 2 * dg * k * k, ho, wo, generator=g,
                      device=card) * 3
    geometry = ((k, k), (s, s), (p, p), (d, d), dg)
    before = K.launch_counts()["deformable_im2col"]
    got = K.deformable_im2col(data, off, *geometry)
    torch.cuda.synchronize()
    assert K.launch_counts()["deformable_im2col"] == before + 1
    assert torch.equal(got, K._plain_deformable_im2col(data, off, *geometry))


def test_deformable_convolution_on_the_card_matches_the_host(card, no_tf32):
    """The op forward and backward (the kernel's column, the recomputed
    plain backward, cuBLAS) against the host within 1e-4 of scale."""
    from mxnet_tpu_torch.ops.registry import get_op
    op = get_op("_contrib_DeformableConvolution")
    attrs = op.normalize_attrs(dict(kernel=(3, 3), pad=(2, 2),
                                    dilate=(2, 2), num_filter=8,
                                    num_group=2, num_deformable_group=2))
    g = torch.Generator().manual_seed(3)
    inputs = [torch.randn(2, 8, 11, 13, generator=g),
              torch.randn(2, 36, 11, 13, generator=g) * 2,
              torch.randn(8, 4, 3, 3, generator=g),
              torch.randn(8, generator=g)]
    ct = torch.randn(2, 8, 11, 13, generator=g)
    res = {}
    for dev in ("cpu", card):
        ts = [t.to(dev).requires_grad_() for t in inputs]
        out = op.impl(*ts, **attrs)
        grads = torch.autograd.grad(out, ts, ct.to(dev))
        res[str(dev)] = [x.detach().cpu() for x in (out, *grads)]
    for got, want in zip(res[str(card)], res["cpu"]):
        scale = max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * scale)


# -- mx.rtc's CUDA C route, Custom, the profiler and telemetry --------------

RTC_SOURCE = r'''
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}

extern "C" __global__ void saxpy(const float *x, float *y, float alpha) {
    extern __shared__ float smem[];
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    smem[threadIdx.x] = x[i];
    y[i] += alpha * smem[threadIdx.x];
}

extern "C" __global__ void axpy_n(const float *x, float *y, float alpha,
                                  int n) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    if (i < n) y[i] = alpha * x[i] + y[i];
}

extern "C" __global__ void row_sum(const float *x, float *out, int cols) {
    extern __shared__ float part[];
    const float *row = x + (long long)blockIdx.x * cols;
    float acc = 0.f;
    for (int j = threadIdx.x; j < cols; j += blockDim.x) acc += row[j];
    part[threadIdx.x] = acc;
    __syncthreads();
    for (int s = blockDim.x / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) part[threadIdx.x] += part[threadIdx.x + s];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}

template <typename T>
__global__ void scale(const T *x, T *y, T a, int n) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    if (i < n) y[i] = a * x[i];
}
'''


def test_rtc_cuda_axpy_as_mxnet_tests_it(card):
    """MXNet 1.0's ``test_cuda_rtc``: axpy, then saxpy through dynamic
    shared memory, at grid (1, 1, 1) and (2, 1, 1)."""
    module = mx.rtc.CudaModule(RTC_SOURCE)
    axpy = module.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mx.nd.ones((10,), ctx=mx.gpu(0))
    y = mx.nd.zeros((10,), ctx=mx.gpu(0))
    axpy.launch([x, y, 3.0], mx.gpu(0), (1, 1, 1), (10, 1, 1))
    assert (y.asnumpy() == 3).all()
    saxpy = module.get_kernel("saxpy", "const float *x, float *y, "
                                       "float alpha")
    saxpy.launch([x, y, 4.0], mx.gpu(0), (1, 1, 1), (10, 1, 1), 10 * 4)
    assert (y.asnumpy() == 7).all()
    saxpy.launch([x, y, 5.0], mx.gpu(0), (2, 1, 1), (5, 1, 1), 5 * 4)
    assert (y.asnumpy() == 12).all()
    assert axpy.launches == 1 and saxpy.launches == 2


def test_rtc_cuda_axpy_is_exact_without_contraction(card):
    """``--fmad=false``: the kernel rounds ``alpha * x`` and the sum
    apart, as torch's multiply then add do, so the result is bit for
    bit; the default (contracted to one FMA) stays within one rounding."""
    n = 1 << 20
    g = torch.Generator(device=card).manual_seed(0)
    x = torch.randn(n, generator=g, device=card)
    y0 = torch.randn(n, generator=g, device=card)
    for options, exact in ((("--fmad=false",), True), ((), False)):
        k = mx.rtc.CudaModule(RTC_SOURCE, options=options).get_kernel(
            "axpy_n", "const float *x, float *y, float alpha, int n")
        y = mx.nd.NDArray(y0.clone())
        k.launch([mx.nd.NDArray(x), y, 1.7, n], mx.gpu(0),
                 ((n + 255) // 256, 1, 1), (256, 1, 1))
        plain = y0 + torch.tensor(1.7, device=card) * x
        if exact:
            assert torch.equal(y.tensor, plain)
        else:
            torch.testing.assert_close(y.tensor, plain, rtol=1e-6,
                                       atol=1e-6)


def test_rtc_cuda_template_through_exports(card):
    mod = mx.rtc.CudaModule(RTC_SOURCE,
                            exports=("scale<float>", "scale<double>"))
    for dt, cname, tdt in (("float", "float32", torch.float32),
                           ("double", "float64", torch.float64)):
        k = mod.get_kernel("scale<%s>" % dt, "const %s *x, %s *y, %s a, "
                           "int n" % (dt, dt, dt))
        x = torch.arange(100, dtype=tdt, device=card)
        y = torch.zeros(100, dtype=tdt, device=card)
        k.launch([mx.nd.NDArray(x), mx.nd.NDArray(y), 0.5, 100], mx.gpu(0),
                 (1, 1, 1), (128, 1, 1))
        assert torch.equal(y, x * 0.5), cname
    assert mod.lowered_names["scale<float>"].startswith("_Z")


def test_rtc_cuda_shared_memory_row_sum(card):
    rows, cols, threads = 512, 4096, 256
    g = torch.Generator(device=card).manual_seed(1)
    x = torch.rand(rows, cols, generator=g, device=card)
    out = torch.empty(rows, device=card)
    k = mx.rtc.CudaModule(RTC_SOURCE).get_kernel(
        "row_sum", "const float *x, float *out, int cols")
    k.launch([mx.nd.NDArray(x), mx.nd.NDArray(out), cols], mx.gpu(0),
             (rows, 1, 1), (threads, 1, 1), shared_mem=threads * 4)
    want = x.double().sum(1)
    assert float(((out.double() - want).abs() / want).max()) <= 1e-5


def test_rtc_cuda_checks_arguments(card):
    k = mx.rtc.CudaModule(RTC_SOURCE).get_kernel(
        "axpy", "const float *x, float *y, float alpha")
    f64 = mx.nd.NDArray(torch.zeros(4, dtype=torch.float64, device=card))
    f32 = mx.nd.NDArray(torch.zeros(4, device=card))
    strided = mx.nd.NDArray(torch.zeros(8, device=card)[::2])
    host = mx.nd.zeros((4,), ctx=mx.cpu())
    for args, what in (([f64, f32, 1.0], "float32"),
                       ([strided, f32, 1.0], "contiguous"),
                       ([host, f32, 1.0], "lies on"),
                       ([f32, f32, f32], "number"),
                       ([f32, f32], "expects 3")):
        with pytest.raises(mx.MXNetError, match=what):
            k.launch(args, mx.gpu(0), (1, 1, 1), (4, 1, 1))
    assert k.launches == 0


def test_rtc_cuda_compile_error_carries_the_log(card):
    mod = mx.rtc.CudaModule(
        'extern "C" __global__ void bad(float *x) { x[0] = undeclared; }')
    k = mod.get_kernel("bad", "float *x")
    with pytest.raises(mx.MXNetError) as e:
        k.launch([mx.nd.zeros((1,), ctx=mx.gpu(0))], mx.gpu(0), (1, 1, 1),
                 (1, 1, 1))
    assert "rtc compilation failed" in str(e.value)
    assert "undeclared" in str(e.value) and "error" in str(e.value)


class _CardSquare(mx.operator.CustomOp):
    def forward(self, is_train, req, in_data, out_data, aux):
        self.assign(out_data[0], req[0], in_data[0] ** 2)

    def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
        self.assign(in_grad[0], req[0], 2 * in_data[0] * out_grad[0])


@mx.operator.register("card_square")
class _CardSquareProp(mx.operator.CustomOpProp):
    def create_operator(self, ctx, shapes, dtypes):
        return _CardSquare()


def test_custom_under_autograd_on_the_card(card):
    x = mx.nd.array(np.array([1.0, -2.0, 3.0], np.float32), ctx=mx.gpu(0))
    x.attach_grad()
    with mx.autograd.record():
        y = mx.nd.Custom(x, op_type="card_square")
        loss = mx.nd.sum(y * y)
    loss.backward()
    assert y.tensor.device == card and x.grad.tensor.device == card
    np.testing.assert_array_equal(y.asnumpy(), [1, 4, 9])
    # d/dx sum(x^4) = 4 x^3
    np.testing.assert_array_equal(x.grad.asnumpy(), [4, -32, 108])


def test_fused_step_refuses_custom_on_the_card(card):
    from mxnet_tpu_torch.module.fused_step import FusedTrainStep
    h = mx.sym.FullyConnected(mx.sym.Variable("data"), num_hidden=4,
                              name="fc")
    net = mx.sym.MakeLoss(mx.sym.Custom(h, op_type="card_square",
                                        name="sq"))
    mod = mx.mod.Module(net, context=mx.gpu(0), label_names=None)
    mod.bind([("data", (8, 5))], None)
    mod.init_params(mx.initializer.Xavier())
    mod.init_optimizer()
    why = FusedTrainStep.refusal(mod)
    assert why is not None and "Custom" in why and "sq" in why
    assert mod._fused_step is None
    batch = mx.io.DataBatch([mx.nd.ones((8, 5), ctx=mx.gpu(0))], None)
    w0 = mod.get_params()[0]["fc_weight"].asnumpy()
    mod.forward_backward(batch)
    mod.update()
    assert not np.array_equal(mod.get_params()[0]["fc_weight"].asnumpy(), w0)


def test_all_mode_op_spans_during_a_capture(card, deterministic, tmp_path):
    """In ``all`` mode a fused step's capture records each op's span
    without synchronizing (which would break the capture): the step still
    captures once and replays, equal to a run with the profiler off."""
    prof = mx.profiler
    prof.profiler_set_config("all", str(tmp_path / "capture.json"))
    runs = []
    try:
        for on in (False, True):
            mod, batches = _graph_module("float32", batches=3)
            if on:
                prof.profiler_set_state("run")
            _steps(mod, batches)
            if on:
                prof.profiler_set_state("stop")
            fs = mod._fused_step
            assert fs.captures == 1 and fs.replays == 2
            runs.append(mod.get_params()[0])
    finally:
        mx.observability.tracing.set_recording(False)
        prof.profiler_set_config("symbolic", "profile.json")
    for k, v in runs[0].items():
        np.testing.assert_array_equal(runs[1][k].asnumpy(), v.asnumpy())
    import json
    with open(tmp_path / "capture.json") as f:
        events = json.load(f)["traceEvents"]
    ops = [e for e in events if e["cat"] == "operator"]
    captured = [e for e in ops if e.get("args", {}).get("capturing")]
    assert captured and len(captured) < len(ops)
    assert sum(e["name"] == "fused_train_step" for e in events) == 3


def test_sample_device_memory_reads_torch_cuda(card):
    inst = mx.observability.instrument
    keep = torch.empty(64 << 20, dtype=torch.uint8, device=card)
    live = inst.sample_device_memory()
    sample = inst.last_memory_sample()
    stats = torch.cuda.memory_stats(card)
    assert live >= keep.numel() and live == sample["live_bytes"]
    assert sample["peak_bytes"] >= live
    assert live <= stats["allocated_bytes.all.current"] * \
        torch.cuda.device_count()
    snap = mx.observability.snapshot()
    assert snap["device.live_bytes"]["value"] == live
    del keep


def _plain_health(layout, outs, params, grads, new):
    """The packed health vector recomputed eagerly in float64 from the
    step's outputs, masters before and after the update, and gradients."""
    def l2(ts):
        return float(torch.stack([t.double().square().sum()
                                  for t in ts]).sum().sqrt())
    mask = sum(float(1 << i) for i, o in enumerate(outs[:layout.n_outputs])
               if bool(torch.isfinite(o).all()))
    pn = l2(params)
    ratio = l2([a.double() - b.double() for a, b in zip(new, params)]) / pn
    maxes = [float(torch.stack([g.double().abs().max()
                                for g in grads[a:b]]).max())
             for _, a, b in layout.groups]
    return np.array([mask, float(outs[0].double().mean()), l2(grads), pn,
                     ratio] + maxes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_health_vector_from_inside_the_graph(card, deterministic,
                                             monkeypatch, dtype):
    """Under MXNET_TPU_HEALTH=1 the fused step packs the health vector in
    its eager step and inside its CUDA graph: each step's vector, read
    from the pinned copy, against its plain float64 recomputation from
    the same step's outputs, gradients and masters, within 1e-5 relative
    (f32 reductions in another order)."""
    monkeypatch.setenv("MXNET_TPU_HEALTH", "1")
    mod, batches = _graph_module(dtype)
    fs = mod._fused_step
    assert fs.health_layout is not None
    for b in batches:
        mod.forward_backward(b)
        mod.update()
        vec = fs.take_health()
        grads, old = fs.health_inputs
        want = _plain_health(fs.health_layout,
                             [o.tensor for o in mod.get_outputs()], old,
                             grads, fs._masters)
        np.testing.assert_allclose(vec, want, rtol=1e-5, atol=0)
        assert fs.take_health() is None
    assert fs.captures == 1 and fs.replays == 3


def test_oom_black_box_on_the_card(card, tmp_path, monkeypatch):
    """A forward that cannot fit on the card: torch.cuda.OutOfMemoryError
    propagates after one flight dump with the memory report (the card's
    total as ``bytes_limit``); a second one writes no second dump."""
    import json
    import os
    from mxnet_tpu_torch.observability import flight_recorder
    dump = tmp_path / "oom.json"
    monkeypatch.setenv("MXNET_TPU_FLIGHT_PATH", str(dump))
    flight_recorder.reset()
    try:
        exe = mx.sym.tile(mx.sym.Variable("data"),
                          reps=(1 << 18, 1 << 18)).simple_bind(
            mx.gpu(0), data=(4, 4), grad_req="null")
        with pytest.raises(torch.cuda.OutOfMemoryError) as err:
            exe.forward()
        assert err.value._mxtpu_oom_recorded
        with open(dump) as f:
            doc = json.load(f)
        assert doc["reason"] == "oom"
        assert doc["anomalies"][0]["context"] == "executor_forward"
        rows = doc["memory"]["device_memory"]
        assert rows[0]["bytes_limit"] == torch.cuda.mem_get_info(0)[1]
        assert doc["memory"]["census"]["array_count"] > 0
        os.remove(dump)
        with pytest.raises(torch.cuda.OutOfMemoryError):
            exe.forward()
        assert not dump.exists()
        assert flight_recorder.get_recorder().anomaly_count("oom") == 2
    finally:
        flight_recorder.reset()

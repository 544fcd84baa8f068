"""The port's CUDA kernels on the card: each against its plain version.

Marked ``cuda``: on a machine without a CUDA device every test here skips
(the decision is made inside a fixture, at run time).  On the card, run
``python -m pytest tests/test_torch_cuda.py -q``; the first test builds
the kernels with nvcc (a few seconds).  Tolerances: f32 atol=rtol=1e-4
(f32 sums in another order); bf16 compared in f32 at atol=2e-2 (output
rounding to bf16).
"""
import numpy as np
import pytest
import torch

import mxnet_tpu_torch as mx
from mxnet_tpu_torch.models import transformer_lm_symbol
from mxnet_tpu_torch.ops import kernels as K

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


def test_flash_kernel_reads_strided_inputs(card):
    g = torch.Generator(device=card).manual_seed(1)
    qkv = torch.randn(2, 64, 3, 4, 64, generator=g, device=card)
    q, k, v = qkv.unbind(2)  # [B, S, H, D] views, row stride 3*H*D
    out = K.flash_attention(q, k, v, causal=True)
    ref = K._reference_attention(q, k, v, True, 1.0 / 8.0)
    np.testing.assert_allclose(out.cpu().numpy(), ref.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


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

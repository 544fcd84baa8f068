"""``mx.rtc`` against the JAX package's, on the CPU.

- The Python-source route: the same ``axpy`` source runs in both packages
  (``outputs=`` and returned results), bit for bit (``a`` is a power of
  two, so ``a * x`` is exact and XLA's fused multiply-add rounds as
  torch's multiply then add do); a source that does
  not compile and a kernel the module lacks raise ``MXNetError`` with
  the same message in both.
- The CUDA C route (MXNet 1.0's own contract), as far as a host can
  take it: the signature parser's table, and a launch with a host
  context raises ``MXNetError`` without loading NVRTC or the driver.
  Its compile and launches on the card are in ``test_torch_cuda.py``.
"""
import numpy as np
import pytest

import mxnet_tpu as mj
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import rtc

AXPY = "def axpy(a, x, y):\n    return a * x + y\n"
TWO = ("def pair(x, y):\n    return x + y, x * y\n")
CUDA_AXPY = r'''
extern "C" __global__ void axpy(const float *x, float *y, float alpha) {
    int i = threadIdx.x + blockIdx.x * blockDim.x;
    y[i] += alpha * x[i];
}
'''


def _inputs(seed=0, n=64):
    r = np.random.RandomState(seed)
    return r.randn(n).astype(np.float32), r.randn(n).astype(np.float32)


@pytest.mark.parametrize("pkg", [mj, mt], ids=["jax", "torch"])
def test_python_axpy_returns_and_writes_outputs(pkg):
    x, y = _inputs()
    mod = pkg.rtc.CudaModule(AXPY)
    k = mod.get_kernel("axpy", "float a, float *x, float *y")
    assert mod.get_kernel("axpy", "float a, float *x, float *y") is k
    xs = pkg.nd.array(x, ctx=pkg.cpu())
    ys = pkg.nd.array(y, ctx=pkg.cpu())
    got = k.launch((2.0, xs, ys), pkg.cpu(), (1, 1, 1), (64, 1, 1))
    out = pkg.nd.zeros((64,), ctx=pkg.cpu())
    k.launch((2.0, xs, ys), pkg.cpu(), (1, 1, 1), (64, 1, 1),
             outputs=(out,))
    np.testing.assert_array_equal(got.asnumpy(), out.asnumpy())
    np.testing.assert_array_equal(out.asnumpy(),
                                  np.float32(2.0) * x + y)


def test_python_source_agrees_between_packages():
    x, y = _inputs(1)
    res = []
    for pkg in (mj, mt):
        mod = pkg.rtc.CudaModule(AXPY + TWO)
        a = mod.get_kernel("axpy").launch(
            (0.5, pkg.nd.array(x, ctx=pkg.cpu()),
             pkg.nd.array(y, ctx=pkg.cpu())), pkg.cpu())
        s, p = mod.get_kernel("pair").launch(
            (pkg.nd.array(x, ctx=pkg.cpu()),
             pkg.nd.array(y, ctx=pkg.cpu())), pkg.cpu())
        res.append([a.asnumpy(), s.asnumpy(), p.asnumpy()])
    for got, want in zip(res[1], res[0]):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("source, name", [
    ("def broken(:\n    pass\n", None),
    ("raise ValueError('at import')\n", None),
    (AXPY, "nope"),
], ids=["syntax", "raises", "missing_kernel"])
def test_errors_match_between_packages(source, name):
    msgs = []
    for pkg in (mj, mt):
        with pytest.raises(pkg.MXNetError) as e:
            pkg.rtc.CudaModule(source).get_kernel(name or "axpy")
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert ("not found" in msgs[1]) == (name is not None)


@pytest.mark.parametrize("signature, want", [
    ("const float *x, float *y, float alpha",
     [(True, True, "float32", "x"), (True, False, "float32", "y"),
      (False, False, "float32", "alpha")]),
    ("const float* x, float* y, float alpha, int n",
     [(True, True, "float32", "x"), (True, False, "float32", "y"),
      (False, False, "float32", "alpha"), (False, False, "int32", "n")]),
    ("double *a, int64_t n", [(True, False, "float64", "a"),
                              (False, False, "int64", "n")]),
    ("__half *h, uint8_t *m, int8_t s, char c, int32_t k",
     [(True, False, "float16", "h"), (True, False, "uint8", "m"),
      (False, False, "int8", "s"), (False, False, "int8", "c"),
      (False, False, "int32", "k")]),
    ("const float *", [(True, True, "float32", None)]),
])
def test_signature_parser_table(signature, want):
    got = [(p, c, d.name, n) for p, c, d, n in rtc.parse_signature(signature)]
    assert got == want


@pytest.mark.parametrize("signature", [
    "float x y", "unsigned int n", "float4 *v", "const float *x, ,",
    "bfloat16 *x"])
def test_signature_parser_refuses(signature):
    with pytest.raises(mt.MXNetError, match="invalid kernel signature"):
        rtc.parse_signature(signature)


def test_cuda_c_on_a_host_context_raises_without_loading_a_library():
    mod = mt.rtc.CudaModule(CUDA_AXPY)
    assert mod.is_cuda
    k = mod.get_kernel("axpy", "const float *x, float *y, float alpha")
    x = mt.nd.ones((10,), ctx=mt.cpu())
    y = mt.nd.zeros((10,), ctx=mt.cpu())
    with pytest.raises(mt.MXNetError, match="GPU context"):
        k.launch([x, y, 3.0], mt.cpu(0), (1, 1, 1), (10, 1, 1))
    assert k.launches == 0
    assert "nvrtc" not in rtc._libs and "cuda" not in rtc._libs
    np.testing.assert_array_equal(y.asnumpy(), np.zeros(10, np.float32))

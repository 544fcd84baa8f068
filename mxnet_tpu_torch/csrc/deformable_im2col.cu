// The bilinear im2col of deformable convolution for Hopper (sm_90a), CUDA
// C++ with a plain C entry.
//
// Replaces no TPU kernel.  The JAX package's `_deformable_convolution`
// (mxnet_tpu/ops/detection_ops.py:332-385) builds a column tensor
// col[n, c, i, j, ho, wo] from four clipped gathers per tap
// (`_bilinear_gather`, :307-329) and runs one grouped matrix product on
// it; XLA fuses the gathers.  Ported as torch ops, the same column costs
// four gathers of the whole column, their masks and weights, each a pass
// over device memory several times the column's size.  Here one thread
// writes one column element: it reads its tap's two offsets, computes the
// sample point (the tap's base grid point plus the offset), the four
// corner weights and indices, applies the JAX package's per-corner
// validity rule (a corner outside [0, H-1] x [0, W-1] contributes zero;
// its index is clipped, its value multiplied by 0), and writes the column
// once.  Every product, sum and difference is rounded on its own
// (explicitly rounded intrinsics: no FMA contraction), in the plain
// version's order, so the column equals the plain version's torch ops bit
// for bit.  The grouped product stays cuBLAS (the JAX package computes it
// outside any Pallas kernel), and so does the bias.
//
// Bound on an H100 SXM: bytes.  The column (N C kh kw Ho Wo f32) is
// written once and the offsets read once; the input is read once in the
// bound's count (the kernel reads each input pixel once for each tap and
// column that samples it, mostly from L2).  About 20 f32 operations an
// element are far below the memory time at 67 TFLOP/s.  Neighbouring
// threads write neighbouring output columns (wo fastest), so the stores
// coalesce; the gathers of one warp touch one or two input rows.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// one corner of the bilinear sample: the pixel at the clipped (yy, xx)
// times 1 when (yy, xx) lies in the image, else times 0
__device__ __forceinline__ float tap(const float* __restrict__ img, float yy, float xx, int H,
                                     int W) {
  const bool ok = yy >= 0.f && yy <= (float)(H - 1) && xx >= 0.f && xx <= (float)(W - 1);
  const int yi = (int)fminf(fmaxf(yy, 0.f), (float)(H - 1));
  const int xi = (int)fminf(fmaxf(xx, 0.f), (float)(W - 1));
  return __fmul_rn(img[yi * W + xi], ok ? 1.f : 0.f);
}

__global__ void __launch_bounds__(THREADS)
deformable_im2col_kernel(const float* __restrict__ data, const float* __restrict__ offset,
                         float* __restrict__ col, long long total, int C, int H, int W, int kh,
                         int kw, int sh, int sw, int ph, int pw, int dh, int dw, int cpg, int DG,
                         int Ho, int Wo) {
  for (long long e = blockIdx.x * (long long)THREADS + threadIdx.x; e < total;
       e += (long long)gridDim.x * THREADS) {
    long long t = e;
    const int wo = (int)(t % Wo);
    t /= Wo;
    const int ho = (int)(t % Ho);
    t /= Ho;
    const int j = (int)(t % kw);
    t /= kw;
    const int i = (int)(t % kh);
    t /= kh;
    const int c = (int)(t % C);
    const long long n = t / C;
    const int dg = c / cpg;
    // offset channel ((dg * kh + i) * kw + j) * 2 + {0: y, 1: x} of image n
    const long long ch = (((n * DG + dg) * kh + i) * kw + j) * 2;
    const long long plane = (long long)Ho * Wo;
    const long long pix = (long long)ho * Wo + wo;
    const float oy = offset[ch * plane + pix];
    const float ox = offset[(ch + 1) * plane + pix];
    const float y = __fadd_rn((float)(ho * sh - ph + i * dh), oy);
    const float x = __fadd_rn((float)(wo * sw - pw + j * dw), ox);
    const float y0 = floorf(y), x0 = floorf(x);
    const float wy1 = __fsub_rn(y, y0), wx1 = __fsub_rn(x, x0);
    const float y1 = __fadd_rn(y0, 1.f), x1 = __fadd_rn(x0, 1.f);
    const float* img = data + (n * C + c) * (long long)H * W;
    const float v00 = tap(img, y0, x0, H, W), v01 = tap(img, y0, x1, H, W);
    const float v10 = tap(img, y1, x0, H, W), v11 = tap(img, y1, x1, H, W);
    const float a = __fsub_rn(1.f, wy1), b = __fsub_rn(1.f, wx1);
    // v00 (1 - wy1)(1 - wx1) + v01 (1 - wy1) wx1 + v10 wy1 (1 - wx1) + v11 wy1 wx1,
    // left to right
    float r = __fmul_rn(__fmul_rn(v00, a), b);
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(v01, a), wx1));
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(v10, wy1), b));
    r = __fadd_rn(r, __fmul_rn(__fmul_rn(v11, wy1), wx1));
    col[e] = r;
  }
}

}  // namespace

// data: [N, C, H, W] f32; offset: [N, 2 DG kh kw, Ho, Wo] f32; col: [N, C,
// kh, kw, Ho, Wo] f32 out.  All contiguous; C divisible by DG.  Returns the
// CUDA error of the launch (0 when it was accepted).
extern "C" int mxtt_deformable_im2col(const void* data, const void* offset, void* col, int N,
                                      int C, int H, int W, int kh, int kw, int sh, int sw, int ph,
                                      int pw, int dh, int dw, int DG, int Ho, int Wo,
                                      void* stream) {
  const long long total = (long long)N * C * kh * kw * Ho * Wo;
  if (total == 0) return 0;
  if (DG <= 0 || C % DG != 0) return (int)cudaErrorInvalidValue;
  const long long want = (total + THREADS - 1) / THREADS;
  const int blocks = (int)(want < 132LL * 64 ? want : 132LL * 64);
  deformable_im2col_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(data), static_cast<const float*>(offset),
      static_cast<float*>(col), total, C, H, W, kh, kw, sh, sw, ph, pw, dh, dw, C / DG, DG, Ho,
      Wo);
  return (int)cudaGetLastError();
}

// 2-D max- and avg-pooling input gradients for Hopper (sm_90a), CUDA C++
// with plain C entries.
//
// Replaces the TPU kernels `_max_pool_bwd_kernel` (mxnet_tpu/ops/
// pallas_kernels.py:515) and `_avg_pool_bwd_kernel` (:544), both launched
// by the `pl.pallas_call` of `_pool_bwd_jitted` (:580).  With (lo, hi) pads
// per axis, window (oh, ow) covers padded rows oh*sh .. oh*sh + kh - 1 and
// columns ow*sw .. ow*sw + kw - 1; padded position (hp, wp) is input pixel
// (hp - pad_top, wp - pad_left), and a tap outside the input is -inf for
// max (it never wins) and contributes nothing for avg.
//
//   max: dx[p] = sum over the windows whose FIRST maximal tap, in row-major
//        window order, is p, of dy[window].  A window holding a NaN routes
//        its gradient nowhere (the TPU kernel's max-then-equality test).
//   avg: dx[p] = sum over the windows covering p of dy[window] * div[window],
//        where div is the (OH, OW) f32 divisor map (1 for sum pooling,
//        1/prod(kernel), or 1/valid-count under count_include_pad=False).
//
// Design (a simple first kernel).  The TPU kernel views the padded input
// phase-major (space to depth by the stride) so that every tap is a
// contiguous lane slice, and scatters each window's cotangent into its
// taps.  Neither is needed here: one thread owns one input pixel (a
// gather), finds the range of windows covering it along each axis with
// two divisions, and walks them so that its tap (i, j) in each runs in
// row-major order, adding each window's share in f32.  For max pooling a
// first pass (one thread per window) writes each window's first argmax
// tap into a byte map, the select of select-and-scatter, so that the
// gather reads one byte per covering window instead of recomputing the
// window.  Each pixel's sum is formed by one thread in a fixed order (no
// atomics, deterministic), and that order is the plain version's tap
// loop, so the two agree bit for bit in f32.  The
// avg sum uses explicitly rounded multiply and add so that the compiler
// does not contract them into an FMA the plain version does not make.
// Pixels that no window covers get 0.
//
// Bound on an H100 SXM: bytes, over 3.35 TB/s.  Max: x read once, dy read
// once, dx written once; at ResNet-50's stem (x (32, 64, 112, 112), dy
// (32, 64, 56, 56), f32) that is 231 MB, 0.069 ms.  Avg: dy, div and dx;
// at the global 7 x 7 pool (dy (32, 2048, 1, 1), dx (32, 2048, 7, 7), f32)
// 13.1 MB, 0.004 ms, which launch latency exceeds.  The argmax map adds
// N*C*OH*OW bytes written and read once (6.4 MB at the stem).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides4 {
  long long n, c, h, w;
};

struct Geometry {
  int N, C, H, W, OH, OW, kh, kw, sh, sw, pt, pl;
};

// The windows along one axis that cover padded position p: o runs from
// *hi down to *lo, so the tap p - o * s runs upwards from p - *hi * s.
__device__ __forceinline__ void covering(int p, int k, int s, int out, int* lo, int* hi) {
  const int first = p - k + 1;  // lowest window start that still covers p
  *lo = first <= 0 ? 0 : (first + s - 1) / s;
  *hi = p / s < out - 1 ? p / s : out - 1;
}

constexpr unsigned char NO_TAP = 255;  // a window holding a NaN

// Pass 1: one thread per window writes its first maximal tap, in
// row-major order (-inf outside x, so padding never wins), or NO_TAP.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
window_argmax_kernel(const T* __restrict__ x, unsigned char* __restrict__ arg_out,
                     Geometry g, Strides4 xs) {
  const unsigned int idx = blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= (unsigned int)g.N * g.C * g.OH * g.OW) return;
  const unsigned int rows = idx / (unsigned int)g.OW;
  const int ow = (int)(idx - rows * g.OW);
  const unsigned int plane = rows / (unsigned int)g.OH;
  const int oh = (int)(rows - plane * g.OH);
  const int n = (int)(plane / (unsigned int)g.C);
  const int c = (int)(plane - n * g.C);
  const T* xp = x + n * xs.n + c * xs.c;
  const int h0 = oh * g.sh - g.pt, w0 = ow * g.sw - g.pl;
  float best = -INFINITY;
  int arg = 0;
  bool has_nan = false;
  for (int ti = 0; ti < g.kh; ++ti) {
    const int hi = h0 + ti;
    const bool row_in = hi >= 0 && hi < g.H;
    for (int tj = 0; tj < g.kw; ++tj) {
      const int wj = w0 + tj;
      const float v = (row_in && wj >= 0 && wj < g.W) ? to_f32(xp[hi * xs.h + wj * xs.w])
                                                       : -INFINITY;
      const int t = ti * g.kw + tj;
      if (v != v) has_nan = true;
      if (t == 0 || v > best) {  // strict: a tie keeps the earlier tap
        best = v;
        arg = t;
      }
    }
  }
  arg_out[idx] = has_nan ? NO_TAP : (unsigned char)arg;
}

// Pass 2: one thread per input pixel sums dy over the covering windows
// whose first maximal tap it is.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
max_pool_gather_kernel(const unsigned char* __restrict__ arg, const T* __restrict__ dy,
                       T* __restrict__ dx, Geometry g, Strides4 ys) {
  // 32-bit index arithmetic: the entry refuses more than 2^31 - 1 pixels
  const unsigned int idx = blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= (unsigned int)g.N * g.C * g.H * g.W) return;
  const unsigned int rows = idx / (unsigned int)g.W;
  const int w = (int)(idx - rows * g.W);
  const unsigned int plane = rows / (unsigned int)g.H;
  const int h = (int)(rows - plane * g.H);
  const int n = (int)(plane / (unsigned int)g.C);
  const int c = (int)(plane - n * g.C);
  const unsigned char* ap = arg + (size_t)plane * g.OH * g.OW;
  const T* yp = dy + n * ys.n + c * ys.c;
  int oh_lo, oh_hi, ow_lo, ow_hi;
  covering(h + g.pt, g.kh, g.sh, g.OH, &oh_lo, &oh_hi);
  covering(w + g.pl, g.kw, g.sw, g.OW, &ow_lo, &ow_hi);
  float acc = 0.f;
  // taps (i, j) in row-major order: windows by descending oh, then ow
  for (int oh = oh_hi; oh >= oh_lo; --oh) {
    const int i = h + g.pt - oh * g.sh;
    for (int ow = ow_hi; ow >= ow_lo; --ow) {
      const int j = w + g.pl - ow * g.sw;
      if (ap[oh * g.OW + ow] == i * g.kw + j) acc += to_f32(yp[oh * ys.h + ow * ys.w]);
    }
  }
  dx[idx] = from_f32<T>(acc);
}

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
avg_pool_bwd_kernel(const T* __restrict__ dy, const float* __restrict__ div,
                    T* __restrict__ dx, Geometry g, Strides4 ys) {
  // 32-bit index arithmetic: the entry refuses more than 2^31 - 1 pixels
  const unsigned int idx = blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= (unsigned int)g.N * g.C * g.H * g.W) return;
  const unsigned int rows = idx / (unsigned int)g.W;
  const int w = (int)(idx - rows * g.W);
  const unsigned int plane = rows / (unsigned int)g.H;
  const int h = (int)(rows - plane * g.H);
  const int n = (int)(plane / (unsigned int)g.C);
  const int c = (int)(plane - n * g.C);
  const T* yp = dy + n * ys.n + c * ys.c;
  int oh_lo, oh_hi, ow_lo, ow_hi;
  covering(h + g.pt, g.kh, g.sh, g.OH, &oh_lo, &oh_hi);
  covering(w + g.pl, g.kw, g.sw, g.OW, &ow_lo, &ow_hi);
  float acc = 0.f;
  for (int oh = oh_hi; oh >= oh_lo; --oh) {
    for (int ow = ow_hi; ow >= ow_lo; --ow) {
      acc = __fadd_rn(acc, __fmul_rn(to_f32(yp[oh * ys.h + ow * ys.w]), div[oh * g.OW + ow]));
    }
  }
  dx[idx] = from_f32<T>(acc);
}

unsigned int blocks_for(const Geometry& g) {
  const long long total = (long long)g.N * g.C * g.H * g.W;
  return (unsigned int)((total + NTHREADS - 1) / NTHREADS);
}

bool too_large(const Geometry& g) {
  return (long long)g.N * g.C * g.H * g.W > 0x7fffffffLL;
}

}  // namespace

// Both entries return the cudaGetLastError() code of the launches (0 on
// success).  Strides are in elements; dx is a contiguous NCHW output;
// argmax is uint8 scratch of N*C*OH*OW bytes.
extern "C" int mxtt_max_pool_bwd(
    const void* x, const void* dy, void* dx, unsigned char* argmax,
    int N, int C, int H, int W, int OH, int OW, int kh, int kw, int sh, int sw,
    int pad_top, int pad_left,
    long long x_sn, long long x_sc, long long x_sh, long long x_sw,
    long long y_sn, long long y_sc, long long y_sh, long long y_sw,
    int is_bf16, void* stream) {
  const Geometry g{N, C, H, W, OH, OW, kh, kw, sh, sw, pad_top, pad_left};
  if (blocks_for(g) == 0) return 0;
  if (too_large(g)) return (int)cudaErrorInvalidValue;
  const Strides4 xs{x_sn, x_sc, x_sh, x_sw}, ys{y_sn, y_sc, y_sh, y_sw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long windows = (long long)N * C * OH * OW;
  if (kh * kw > NO_TAP || windows > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned int wblocks = (unsigned int)((windows + NTHREADS - 1) / NTHREADS);
  if (is_bf16) {
    window_argmax_kernel<__nv_bfloat16><<<wblocks, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), argmax, g, xs);
  } else {
    window_argmax_kernel<float><<<wblocks, NTHREADS, 0, st>>>(
        static_cast<const float*>(x), argmax, g, xs);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (is_bf16) {
    max_pool_gather_kernel<__nv_bfloat16><<<blocks_for(g), NTHREADS, 0, st>>>(
        argmax, static_cast<const __nv_bfloat16*>(dy), static_cast<__nv_bfloat16*>(dx), g, ys);
  } else {
    max_pool_gather_kernel<float><<<blocks_for(g), NTHREADS, 0, st>>>(
        argmax, static_cast<const float*>(dy), static_cast<float*>(dx), g, ys);
  }
  return (int)cudaGetLastError();
}

extern "C" int mxtt_avg_pool_bwd(
    const void* dy, const float* div, void* dx,
    int N, int C, int H, int W, int OH, int OW, int kh, int kw, int sh, int sw,
    int pad_top, int pad_left,
    long long y_sn, long long y_sc, long long y_sh, long long y_sw,
    int is_bf16, void* stream) {
  const Geometry g{N, C, H, W, OH, OW, kh, kw, sh, sw, pad_top, pad_left};
  if (blocks_for(g) == 0) return 0;
  if (too_large(g)) return (int)cudaErrorInvalidValue;
  const Strides4 ys{y_sn, y_sc, y_sh, y_sw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    avg_pool_bwd_kernel<__nv_bfloat16><<<blocks_for(g), NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(dy), div, static_cast<__nv_bfloat16*>(dx), g, ys);
  } else {
    avg_pool_bwd_kernel<float><<<blocks_for(g), NTHREADS, 0, st>>>(
        static_cast<const float*>(dy), div, static_cast<float*>(dx), g, ys);
  }
  return (int)cudaGetLastError();
}

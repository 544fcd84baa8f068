// Per-channel paired sums over an NCHW tensor, for Hopper (sm_90a), CUDA
// C++ with a plain C entry.
//
// Replaces the TPU kernel `_make_channel_sums_kernel` / `pl.pallas_call` of
// mxnet_tpu/ops/pallas_kernels.py:643 and :699 (`bn_channel_sums`).
// Computes, for a and b of shape [N, C, H, W] (b = a when b is null):
//
//   out1[c] = sum_{n,h,w} a[n, c, h, w]
//   out2[c] = sum_{n,h,w} a[n, c, h, w] * b[n, c, h, w]
//
// in f32 from f32 or bf16 inputs.  With b = a that is BatchNorm's forward
// statistics (sum, sum of squares); (dy, x) gives its backward pair
// (sum dy, sum dy * x).  Inputs are read through their 4-D strides.
//
// Design (a simple first kernel).  The TPU kernel walks the batch as a
// sequential grid axis and keeps whole H x W planes of a channel block in
// VMEM; here blocks run in parallel and in no order, and a channel count as
// small as 3 (BatchNorm over the raw image) would leave the card idle if the
// grid were split over channels alone.  So the grid is (split, channel): the
// wrapper picks the number of splits of each channel's N*H*W elements from
// the SM count so that the card holds a few waves of blocks.  Each block of
// 256 threads walks its contiguous range of (n, h*w) positions, consecutive
// threads on consecutive addresses, with one f32 running pair per thread,
// then reduces the pair with warp shuffles and one shared-memory step into
// a partial-sum buffer.  A second small launch sums each channel's partials
// in split order.  No atomics: a rerun gives bit-identical sums.
//
// Bound on an H100 SXM: bytes.  One read of a (and b) at 3.35 TB/s; the
// arithmetic is one or two FMAs per element.  At BatchNorm bn0's input of
// ResNet-50 at batch 32 ((32, 64, 112, 112) f32) that is 102.8 MB for the
// single form (0.031 ms) and 205.5 MB for the pair (0.061 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct View {
  long long sn, sc, sh, sw;
  int plane_contiguous;  // sh == W * sw: (h, w) flattens to r * sw
};

__device__ __forceinline__ long long offset(const View& v, int n, int c, int r, int W) {
  if (v.plane_contiguous) return n * v.sn + c * v.sc + r * v.sw;
  const int h = r / W;
  return n * v.sn + c * v.sc + h * v.sh + (r - h * W) * v.sw;
}

template <typename T, bool PAIR>
__global__ void __launch_bounds__(NTHREADS)
partial_sums_kernel(const T* __restrict__ a, const T* __restrict__ b, View av, View bv,
                    float* __restrict__ partial, int N, int HW, int W, int splits,
                    long long chunk) {
  const int s = blockIdx.x, c = blockIdx.y;
  const long long total = (long long)N * HW;
  const long long p0 = s * chunk;
  const long long p1 = p0 + chunk < total ? p0 + chunk : total;
  float s1 = 0.f, s2 = 0.f;
  long long p = p0 + threadIdx.x;
  if (p < p1) {
    int n = (int)(p / HW);
    int r = (int)(p - (long long)n * HW);
    for (; p < p1; p += NTHREADS) {
      const float x = to_f32(a[offset(av, n, c, r, W)]);
      const float y = PAIR ? to_f32(b[offset(bv, n, c, r, W)]) : x;
      s1 += x;
      s2 = fmaf(x, y, s2);
      r += NTHREADS;
      while (r >= HW) {
        r -= HW;
        ++n;
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    s2 += __shfl_xor_sync(0xffffffffu, s2, off);
  }
  __shared__ float sm[2][NWARPS];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[0][warp] = s1;
    sm[1][warp] = s2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      t1 += sm[0][w];
      t2 += sm[1][w];
    }
    float* dst = partial + 2 * ((long long)c * splits + s);
    dst[0] = t1;
    dst[1] = t2;
  }
}

// One thread per channel sums that channel's partials in split order.
__global__ void combine_kernel(const float* __restrict__ partial, float* __restrict__ out1,
                               float* __restrict__ out2, int C, int splits) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const float* src = partial + 2 * (long long)c * splits;
  float t1 = 0.f, t2 = 0.f;
  for (int s = 0; s < splits; ++s) {
    t1 += src[2 * s];
    t2 += src[2 * s + 1];
  }
  out1[c] = t1;
  out2[c] = t2;
}

template <typename T>
int launch(const void* a, const void* b, View av, View bv, float* partial, float* out1,
           float* out2, int N, int C, int H, int W, int splits, cudaStream_t stream) {
  const int HW = H * W;
  const long long total = (long long)N * HW;
  const long long chunk = (total + splits - 1) / splits;
  dim3 grid(splits, C);
  if (b != nullptr) {
    partial_sums_kernel<T, true><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(b), av, bv, partial, N, HW, W, splits,
        chunk);
  } else {
    partial_sums_kernel<T, false><<<grid, NTHREADS, 0, stream>>>(
        static_cast<const T*>(a), static_cast<const T*>(a), av, av, partial, N, HW, W, splits,
        chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  combine_kernel<<<(C + 255) / 256, 256, 0, stream>>>(partial, out1, out2, C, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaGetLastError() code of the launches (0 on success).
// Strides are in elements.  b may be null (then b = a).  partial is f32
// scratch of 2 * C * splits floats; out1 and out2 are f32 (C,).
extern "C" int mxtt_bn_channel_sums(
    const void* a, const void* b, float* partial, float* out1, float* out2,
    int N, int C, int H, int W,
    long long a_sn, long long a_sc, long long a_sh, long long a_sw,
    long long b_sn, long long b_sc, long long b_sh, long long b_sw,
    int splits, int is_bf16, void* stream) {
  if (C == 0) return 0;
  if (splits < 1) return (int)cudaErrorInvalidValue;
  const View av{a_sn, a_sc, a_sh, a_sw, a_sh == (long long)W * a_sw};
  const View bv{b_sn, b_sc, b_sh, b_sw, b_sh == (long long)W * b_sw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(a, b, av, bv, partial, out1, out2, N, C, H, W, splits, st)
                 : launch<float>(a, b, av, bv, partial, out1, out2, N, C, H, W, splits, st);
}

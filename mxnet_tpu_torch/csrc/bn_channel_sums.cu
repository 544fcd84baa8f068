// Per-channel paired sums over an NCHW tensor, for Hopper (sm_90a), CUDA
// C++ with a plain C entry.
//
// Replaces the TPU kernel `_make_channel_sums_kernel` / `pl.pallas_call` of
// mxnet_tpu/ops/pallas_kernels.py:643 and :699 (`bn_channel_sums`).
// Computes, for a and b of shape [N, C, H, W] (b = a when b is null):
//
//   out[0][c] = sum_{n,h,w} a[n, c, h, w]
//   out[1][c] = sum_{n,h,w} a[n, c, h, w] * b[n, c, h, w]
//
// in f32 from f32, bf16, f16 or f64 inputs (f64 elements are rounded to
// f32 and summed in f32, as the TPU kernel and the plain version do).  With b = a that is BatchNorm's forward
// statistics (sum, sum of squares); (dy, x) gives its backward pair
// (sum dy, sum dy * x).  Inputs are read through their 4-D strides.
//
// Bound on an H100 SXM: bytes.  One read of a (and b) at 3.35 TB/s; the
// arithmetic is one or two FMAs per element.  At BatchNorm bn0's input of
// ResNet-50 at batch 32 ((32, 64, 112, 112) f32) that is 102.8 MB for the
// single form (0.031 ms) and 205.5 MB for the pair (0.061 ms).  Half of
// ResNet-50's 51 BatchNorm inputs are 3-13 MB, where a launch and its
// tail, not the bytes, set the time.
//
// Design.  One launch per call.  The TPU kernel walks the batch as a
// sequential grid axis and keeps whole H x W planes of a channel block in
// VMEM; here blocks run in parallel and in no order.  The wrapper's
// planner (`_bn_plan` in ops/kernels.py) cuts each channel's N*H*W
// elements, seen as one flat range of N planes, into `splits` equal chunks
// when a channel is large (bn0 of 3 channels still fills the card), or
// gives one block `group` whole channels when channels are small (the
// 7 x 7 and 14 x 14 stages: no block sums a few hundred elements).
//
// A block walks its range in units of VEC elements: 16-byte loads (4 f32,
// 8 bf16 or f16, 2 f64) where every plane, stride and the base are VEC-aligned, else
// one element.  A unit's plane comes from a multiply-high division by the
// plane's units (precomputed on the host), not a loop or a divide, so
// planes of 49 or 196 elements keep every thread busy; each thread keeps
// UNROLL loads in flight.  Threads reduce with warp shuffles and one
// shared-memory step.  A channel of one block writes its sums directly.
// A split channel's blocks each write their partial pair, fence, and
// count their arrival on the channel's int32 counter with one integer
// atomicAdd; the block that arrives last sums the channel's partials in
// split order (fixed, whatever the arrival order), writes the output and
// resets the counter to 0 for the next call.  No float atomics: a rerun
// gives bit-identical sums.
//
// The counters belong to one stream: calls in one stream run one after
// the other and each leaves every counter at 0, but calls in flight on
// two streams at once would add their arrivals to one counter, so the
// last block of one call could combine the partials of another.  The
// wrapper keeps a counter buffer per (device, stream).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int NTHREADS = 256;
constexpr int NWARPS = NTHREADS / 32;
constexpr int UNROLL = 4;

struct View {
  long long sn, sc, sh, sw;
};

// How the wrapper cut the work (units are VEC elements; see _bn_plan).
struct Plan {
  int C, splits, group;
  unsigned int chunk;    // units per split
  unsigned int plane;    // units per plane (H*W / VEC)
  unsigned int total;    // units per channel (N*H*W / VEC)
  unsigned int magic;    // unit / plane == (umulhi(unit, magic) + unit) >> shift
  int shift, W;
};

__device__ __forceinline__ unsigned int plane_of(unsigned int u, const Plan& p) {
  return (__umulhi(u, p.magic) + u) >> p.shift;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(double x) { return (float)x; }

// VEC consecutive elements of plane n at unit r of channel base `ch`.
// FLAT: the plane is contiguous along w and h (sh == W * sw), so unit r
// is at r * VEC * sw; else (VEC == 1) h and w are unflattened.
template <typename T, int VEC, bool FLAT>
__device__ __forceinline__ void load_unit(const T* __restrict__ ch, const View& v,
                                          unsigned int n, unsigned int r, int W,
                                          float (&out)[VEC]) {
  const T* p = ch + (long long)n * v.sn;
  if constexpr (VEC == 1) {
    if constexpr (FLAT) {
      out[0] = to_f32(p[(long long)r * v.sw]);
    } else {
      const unsigned int h = r / (unsigned int)W;
      out[0] = to_f32(p[(long long)h * v.sh + (long long)(r - h * W) * v.sw]);
    }
  } else if constexpr (std::is_same<T, float>::value) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p) + r);
    out[0] = f.x;
    out[1] = f.y;
    out[2] = f.z;
    out[3] = f.w;
  } else if constexpr (std::is_same<T, double>::value) {
    const double2 f = __ldg(reinterpret_cast<const double2*>(p) + r);
    out[0] = (float)f.x;
    out[1] = (float)f.y;
  } else {
    using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                         __nv_bfloat162>::type;
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p) + r);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const T2 h2 = *reinterpret_cast<const T2*>(&w[k]);
      out[2 * k] = __low2float(h2);
      out[2 * k + 1] = __high2float(h2);
    }
  }
}

// Sum of (t1, t2) over the block, in thread 0 (fixed order).
__device__ __forceinline__ void block_sum(float& t1, float& t2, float (*sm)[NWARPS]) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    t1 += __shfl_xor_sync(0xffffffffu, t1, off);
    t2 += __shfl_xor_sync(0xffffffffu, t2, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sm[0][warp] = t1;
    sm[1][warp] = t2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    t1 = 0.f;
    t2 = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) {
      t1 += sm[0][w];
      t2 += sm[1][w];
    }
  }
  __syncthreads();  // sm is free again for the next channel
}

template <typename T, int VEC, bool PAIR, bool FLAT>
__global__ void __launch_bounds__(NTHREADS)
channel_sums_kernel(const T* __restrict__ a, const T* __restrict__ b, View av, View bv,
                    float* __restrict__ partial, int* __restrict__ counters,
                    float* __restrict__ out, Plan p) {
  __shared__ float sm[2][NWARPS];
  __shared__ bool last;
  int c0, c1;
  unsigned int u0, u1;
  const int split = p.group > 1 ? 0 : (int)(blockIdx.x % (unsigned int)p.splits);
  if (p.group > 1) {
    c0 = blockIdx.x * p.group;
    c1 = min(p.C, c0 + p.group);
    u0 = 0;
    u1 = p.total;
  } else {
    c0 = blockIdx.x / p.splits;
    c1 = c0 + 1;
    u0 = split * p.chunk;
    u1 = min(p.total, u0 + p.chunk);
  }
  for (int c = c0; c < c1; ++c) {
    const T* ac = a + (long long)c * av.sc;
    const T* bc = b + (long long)c * bv.sc;
    float t1 = 0.f, t2 = 0.f;
    for (unsigned int u = u0 + threadIdx.x; u < u1; u += NTHREADS * UNROLL) {
      float x[UNROLL][VEC], y[PAIR ? UNROLL : 1][VEC];
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
        const unsigned int uk = u + k * NTHREADS;
        if (uk < u1) {
          const unsigned int n = plane_of(uk, p), r = uk - n * p.plane;
          load_unit<T, VEC, FLAT>(ac, av, n, r, p.W, x[k]);
          if constexpr (PAIR) load_unit<T, VEC, FLAT>(bc, bv, n, r, p.W, y[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            x[k][e] = 0.f;
            if constexpr (PAIR) y[k][e] = 0.f;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < UNROLL; ++k) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          t1 += x[k][e];
          t2 = fmaf(x[k][e], PAIR ? y[PAIR ? k : 0][e] : x[k][e], t2);
        }
      }
    }
    block_sum(t1, t2, sm);
    if (p.splits == 1) {
      if (threadIdx.x == 0) {
        out[c] = t1;
        out[p.C + c] = t2;
      }
      continue;
    }
    // a split channel: publish the partial, count the arrival
    if (threadIdx.x == 0) {
      float* dst = partial + 2 * ((long long)c * p.splits + split);
      dst[0] = t1;
      dst[1] = t2;
      __threadfence();
      last = atomicAdd(counters + c, 1) == p.splits - 1;
    }
    __syncthreads();
    if (last && threadIdx.x < 32) {
      __threadfence();
      const float* src = partial + 2 * (long long)c * p.splits;
      float s1 = 0.f, s2 = 0.f;
      for (int k = threadIdx.x; k < p.splits; k += 32) {
        s1 += __ldcg(src + 2 * k);
        s2 += __ldcg(src + 2 * k + 1);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        s2 += __shfl_xor_sync(0xffffffffu, s2, off);
      }
      if (threadIdx.x == 0) {
        out[c] = s1;
        out[p.C + c] = s2;
        counters[c] = 0;
      }
    }
  }
}

template <typename T, int VEC, bool FLAT>
void launch(const void* a, const void* b, const View& av, const View& bv, float* partial,
            int* counters, float* out, const Plan& p, unsigned int blocks, cudaStream_t st) {
  const T* at = static_cast<const T*>(a);
  if (b != nullptr) {
    channel_sums_kernel<T, VEC, true, FLAT><<<blocks, NTHREADS, 0, st>>>(
        at, static_cast<const T*>(b), av, bv, partial, counters, out, p);
  } else {
    channel_sums_kernel<T, VEC, false, FLAT><<<blocks, NTHREADS, 0, st>>>(
        at, at, av, av, partial, counters, out, p);
  }
}

// The launch for one element type: VEC-wide loads where the wrapper
// chose them, else element by element, plane-flat or not.
template <typename T>
void launch_type(int vec, bool flat, const void* a, const void* b, const View& av,
                 const View& bv, float* partial, int* counters, float* out, const Plan& p,
                 unsigned int blocks, cudaStream_t st) {
  constexpr int VEC = 16 / (int)sizeof(T);
  if (vec > 1)
    launch<T, VEC, true>(a, b, av, bv, partial, counters, out, p, blocks, st);
  else if (flat)
    launch<T, 1, true>(a, b, av, bv, partial, counters, out, p, blocks, st);
  else
    launch<T, 1, false>(a, b, av, bv, partial, counters, out, p, blocks, st);
}

// The element types, as the wrapper codes them (`_DTYPE_CODES` in
// ops/kernels.py).
enum DType { F32 = 0, BF16 = 1, F16 = 2, F64 = 3 };
constexpr int ELEM_BYTES[4] = {4, 2, 2, 8};

}  // namespace

// The launch's arguments, as the wrapper packs them: int64s in this order
// (`_BN_ARGS` in ops/kernels.py), one pointer through ctypes.  Strides
// are in elements; b may be 0 (then b = a).  `vec` is 1 or the elements
// of 16 bytes (4 f32, 8 bf16 or f16, 2 f64): the elements of one load,
// which the wrapper chooses only where
// both views are plane-contiguous and VEC-aligned; `flat` says both views
// are plane-contiguous (sh == W * sw).  `partial` is f32 scratch of
// 2 * C * splits floats (unused when splits == 1), `counters` C int32
// zeros that the launch leaves zero, `out` f32 (2, C).  splits, group,
// chunk, magic and shift are _bn_plan's; `dtype` a DType.
struct BnArgs {
  long long a, b, partial, counters, out;
  long long N, C, H, W;
  long long a_sn, a_sc, a_sh, a_sw, b_sn, b_sc, b_sh, b_sw;
  long long vec, flat, splits, group, chunk, magic, shift, dtype, stream;
};
static_assert(sizeof(BnArgs) == 26 * 8, "BnArgs is 26 int64s");

// Returns the cudaGetLastError() code of the launch (0 on success).
extern "C" int mxtt_bn_channel_sums(const BnArgs* x) {
  const int C = (int)x->C, H = (int)x->H, W = (int)x->W, vec = (int)x->vec;
  const int splits = (int)x->splits, group = (int)x->group;
  if (C == 0) return 0;
  if (x->dtype < F32 || x->dtype > F64) return (int)cudaErrorInvalidValue;
  if (splits < 1 || group < 1 || (splits > 1 && group > 1) || (vec > 1 && !x->flat))
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && vec != 16 / ELEM_BYTES[x->dtype]) return (int)cudaErrorInvalidValue;
  const long long plane = (long long)H * W / vec, total = x->N * plane;
  if (total > 0x7fffffffLL || (long long)H * W % vec != 0) return (int)cudaErrorInvalidValue;
  const Plan p{C, splits, group, (unsigned int)x->chunk,
               (unsigned int)(plane > 0 ? plane : 1), (unsigned int)total,
               (unsigned int)x->magic, (int)x->shift, W};
  const View av{x->a_sn, x->a_sc, x->a_sh, x->a_sw}, bv{x->b_sn, x->b_sc, x->b_sh, x->b_sw};
  const unsigned int blocks =
      group > 1 ? (unsigned int)((C + group - 1) / group) : (unsigned int)C * splits;
  const void* a = reinterpret_cast<const void*>(x->a);
  const void* b = reinterpret_cast<const void*>(x->b);
  float* partial = reinterpret_cast<float*>(x->partial);
  int* counters = reinterpret_cast<int*>(x->counters);
  float* out = reinterpret_cast<float*>(x->out);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(x->stream);
  const bool flat = x->flat != 0;
  switch (x->dtype) {
    case BF16:
      launch_type<__nv_bfloat16>(vec, flat, a, b, av, bv, partial, counters, out, p, blocks, st);
      break;
    case F16:
      launch_type<__half>(vec, flat, a, b, av, bv, partial, counters, out, p, blocks, st);
      break;
    case F64:
      launch_type<double>(vec, flat, a, b, av, bv, partial, counters, out, p, blocks, st);
      break;
    default:
      launch_type<float>(vec, flat, a, b, av, bv, partial, counters, out, p, blocks, st);
  }
  return (int)cudaGetLastError();
}

// Flash-attention forward for Hopper (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces the TPU kernel `_flash_kernel` / `pl.pallas_call` of
// mxnet_tpu/ops/pallas_kernels.py:63 and :338, with and without its
// `emit_lse` output (:138-145).  Computes, for q [B, Sq, H, D] and k, v
// [B, Sk, H, D]:
//
//   o[b, i, h, :] = sum_j softmax_j(scale * q[b, i, h, :] . k[b, j, h, :]) v[b, j, h, :]
//
// over the keys j < kv_len[b] (and j <= i when causal).  A row with no valid
// key gives 0, as the TPU kernel's `l == 0 -> 1` does.  When `lse` is not
// null, the differentiated forward also writes each row's log-sum-exp
// m + log(l), f32, in the compact layout [B, H, Sq] (the TPU kernel's
// lane-broadcast [BH, Sq, 128] exists only for Mosaic's tiling): m and l are
// the very registers that normalised the row's output, so the backward's
// exp(s - lse) reproduces its probabilities.  A row with no valid key gets
// -1e30 there, as the TPU kernel's m + log(1) does; the backward re-masks
// p, so that row takes zero gradient.  Any Sq and Sk: the
// ragged tails are masked here, not padded by the caller.  q, k and v are
// read through their [B, S, H, D] strides (the last dim contiguous), so the
// caller needs no transpose copy; o is written through its own strides.
//
// Design (a simple first kernel: no wgmma, TMA or warp specialisation yet).
// One block of 256 threads owns one (b, h) and a tile of BQ = 64 query rows.
// It walks the KV sequence in tiles of BK = 64 keys staged in shared memory,
// skipping tiles past kv_len and, under causal, above the diagonal.  The
// running max, sum and output accumulator stay in f32 registers: the 256
// threads form a 16 x 16 grid, each owning 4 query rows x 4 score columns of
// S = Q K^T and 4 rows x D/16 output columns; the row max and sum reduce over
// the 16 lanes that share a row with warp shuffles.  P goes through shared
// memory once per tile for the P V product.  Shared rows are padded by one
// float so that column walks hit 32 distinct banks.  bf16 inputs are
// widened to f32 on the way into shared memory; all arithmetic is f32.
//
// Bound on an H100 SXM: the work is 4 * D * (valid (i, j) pairs) * H
// operations, in f32 on the CUDA cores here (67 TFLOP/s), against the bytes
// of q, k, v read once and o written once over 3.35 TB/s.  At the serving
// shape (B 4, S 1024, H 12, D 64, causal, f32) that is 6.4 GFLOP against
// 50 MB, so operations bound it (0.096 ms against 0.015 ms).  This design
// feeds each FMA from shared memory, so it reaches a fraction of that rate;
// tensor-core (wgmma) tiles are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;         // query rows per block
constexpr int BK = 64;         // keys per KV tile
constexpr int NTHREADS = 256;  // a 16 x 16 thread grid
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

struct Strides {
  long long b, s, h;
};

template <int D>
constexpr size_t smem_bytes() {
  return (size_t)(BQ * (D + 1) + 2 * BK * (D + 1) + BQ * (BK + 1)) * sizeof(float);
}

// Copy rows [row0, row0 + rows) of one (b, h) slice into a padded f32 tile;
// rows past `limit` are zero.  Consecutive threads read consecutive d.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          Strides st, int b, int h, int row0,
                                          int rows, int limit) {
  for (int idx = threadIdx.x; idx < rows * D; idx += NTHREADS) {
    const int r = idx / D, c = idx % D;
    const int row = row0 + r;
    float val = 0.f;
    if (row < limit) val = to_f32(src[b * st.b + row * st.s + h * st.h + c]);
    dst[r * (D + 1) + c] = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ kv_lens, float* __restrict__ lse,
                 int H, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 float scale, int causal) {
  constexpr int DP = D + 1;
  constexpr int SP = BK + 1;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [BQ][DP]
  float* sK = sQ + BQ * DP;    // [BK][DP]
  float* sV = sK + BK * DP;    // [BK][DP]
  float* sP = sV + BK * DP;    // [BQ][SP]

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y % H;
  const int q0 = blockIdx.x * BQ;

  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Sk);
  // under causal no row of this tile sees a key past its last row
  const int kv_end = causal ? min(kv_len, q0 + BQ) : kv_len;

  load_tile<T, D>(sQ, q, qs, b, h, q0, BQ, Sq);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += BK) {
    load_tile<T, D>(sK, k, ks, b, h, kv0, BK, Sk);
    load_tile<T, D>(sV, v, vs, b, h, kv0, BK, Sk);
    __syncthreads();

    // S = Q K^T for rows ty*4 + i, columns tx + 16*j of this tile
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online-softmax update, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool valid[4];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kv0 + tx + 16 * j;
        valid[j] = col < kv_len && (!causal || col <= row);
        s[i][j] = valid[j] ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = valid[j] ? __expf(s[i][j] - m_new) : 0.f;
        sP[(ty * 4 + i) * SP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = __expf(m[i] - m_new);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DPT; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

    // O += P V over the keys of this tile that can carry weight
    const int ncols = min(BK, kv_end - kv0);
    for (int c = 0; c < ncols; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * SP + c];
#pragma unroll
      for (int j = 0; j < DPT; ++j) {
        const float vv = sV[c * DP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();  // the next tile overwrites sK, sV and sP
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* dst = o + b * os.b + row * os.s + h * os.h;
#pragma unroll
    for (int j = 0; j < DPT; ++j) dst[tx + 16 * j] = from_f32<T>(acc[i][j] * inv);
    // every lane of the row holds the same m and l after the shuffles
    if (lse != nullptr && tx == 0)
      lse[(long long)blockIdx.y * Sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : NEG_INF;
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_lens, float* lse, int B, int Sq, int Sk, int H, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, int causal,
           cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_lens, lse, H, Sq, Sk, qs, ks, vs, os, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaGetLastError() code of the launch (0 on success); an
// unsupported head_dim returns cudaErrorInvalidValue.  Strides are in
// elements.  kv_lens is an int32 device pointer of length B, or null; lse a
// contiguous f32 [B, H, Sq] device buffer, or null for the forward alone.
extern "C" int mxtt_flash_attn_fwd(
    const void* q, const void* k, const void* v, void* o, const int* kv_lens,
    float* lse, int B, int Sq, int Sk, int H, int D,
    long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, int is_bf16, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  const Strides qs{q_sb, q_ss, q_sh}, ks{k_sb, k_ss, k_sh};
  const Strides vs{v_sb, v_ss, v_sh}, os{o_sb, o_ss, o_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, k, v, o, kv_lens, lse, B, Sq, Sk, H, qs, ks, vs, os, scale, causal, st)
                   : launch<float, 64>(q, k, v, o, kv_lens, lse, B, Sq, Sk, H, qs, ks, vs, os, scale, causal, st);
  }
  if (D == 128) {
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, k, v, o, kv_lens, lse, B, Sq, Sk, H, qs, ks, vs, os, scale, causal, st)
                   : launch<float, 128>(q, k, v, o, kv_lens, lse, B, Sq, Sk, H, qs, ks, vs, os, scale, causal, st);
  }
  return (int)cudaErrorInvalidValue;
}

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
// -1e30 there, as the TPU kernel's m + log(1) does.  Any Sq and Sk: the
// ragged tails are masked here, not padded by the caller.  q, k and v are
// read through their [B, S, H, D] strides (the last dim contiguous), so the
// caller needs no transpose copy; o is written through its own strides.
//
// Design: tensor-core products (`mma.sync`), online softmax in registers.
// - One block of 4 warps owns one (b, h) and a tile of BQ = 64 query rows;
//   each warp owns 16 rows, the M of one m16n8 tile, so the row max and sum
//   never leave the warp (4 warps rather than 8 with 128 rows: a 64-row
//   tile keeps 2 blocks of 87 KB shared memory on an SM at D 64 f32, and
//   halves the causal work wasted on the diagonal tile).
// - f32 products use the 3xTF32 split (CUTLASS's "fast f32"): every
//   operand x is big + small, big = tf32(x), small = tf32(x - big) (see
//   split_tf32 for how each is rounded), and
//   a.b ~ small_a.big_b + big_a.small_b + big_a.big_b, three
//   m16n8k8 TF32 MMAs accumulated in f32.  The dropped small.small term is
//   below f32 rounding, so the error is near plain f32's (plain TF32 keeps
//   ~3 digits and would miss the 1e-4 gates).  The Q fragments are split
//   once per block and stay in registers for the whole KV walk (at f32 D
//   128 they would take 128 registers, so there they are re-read from
//   shared memory and split per tile).  bf16 uses m16n8k16 BF16 MMAs with
//   f32 accumulation; P is rounded to bf16 before P V, as the TPU kernel's
//   `p.astype(v.dtype)` (:126-128) does; the row sum l is taken in f32.
// - S = Q K^T stays in the accumulator registers.  Row max and sum reduce
//   over the 4 lanes of a quad; exponentials are exp2f of logits scaled by
//   scale * log2(e) once.  Only tiles that cross the causal diagonal or the
//   kv_len edge are masked.  P goes from the accumulator layout to the A
//   operand of P V without shuffles or shared memory: for TF32 the K index
//   of the P V product is permuted (k = t <-> key 2t, k = t + 4 <-> key
//   2t + 1), and V's B fragment is read with the same permutation; for
//   bf16 the m16n8k16 A layout is the accumulator pair of two n-tiles, and
//   V's B fragment comes from `ldmatrix.trans`.
// - K and V tiles arrive by 16-byte `cp.async` into a double-buffered ring,
//   tile j + 1 in flight while tile j is computed.  Shared rows are padded
//   (4 floats for f32, 8 bf16) so every fragment load hits 32 distinct
//   banks.  Rows past Sk are zero-filled by the copy itself (src-size 0).
//   Inputs whose base or strides are not 16-byte aligned load by a scalar
//   path in the same kernel.
// - Schedule: the grid is (B * H, q-tiles) with the q-tile index reversed,
//   so the blocks with the most KV tiles (the last rows under causal) start
//   first and the short ones fill the tail of the launch.
//
// Bound on an H100 SXM: 4 * D * H operations per valid (row, key) pair.  At
// f32 accuracy on the tensor cores that is three TF32 passes, so the least
// time is 3 * ops / 494.7 TFLOP/s, against q, k, v read once and o written
// once over 3.35 TB/s.  At the serving shape (B 4, S 1024, H 12, D 64,
// causal, f32) that is 6.44 GFLOP against 50.3 MB: 0.039 ms, set by the
// operations; the LSE variant at the training shape (B 8) 0.078 ms.  bf16
// runs one pass at 989 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BQ = 64;          // query rows per block
constexpr int NWARPS = 4;       // 16 rows each
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;  // the LSE of a row with no valid key
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long b, s, h;
};

// Per (type, head_dim): keys per KV tile, the padded shared-memory row
// stride in elements, and whether the Q fragments live in registers.
// head_dim is 32, 64 or 128: a multiple of 16, so the TF32 products take
// D / 8 k-steps, the bf16 ones D / 16, the bf16 P V walks the output's
// n-tiles in ldmatrix pairs, and every row copies as whole 16-byte chunks
// (at D 32 a tile is 512 f32 or 256 bf16 chunks, whole per thread).
template <typename T, int D>
struct Tile {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BK = (F32 && D == 128) ? 32 : 64;
  static constexpr int STRIDE = F32 ? D + 4 : D + 8;
  static constexpr bool Q_IN_REGS = !(F32 && D == 128);
  static constexpr int VEC = 16 / (int)sizeof(T);  // elements per 16 bytes
  static constexpr size_t SMEM = (size_t)(BQ + 4 * BK) * STRIDE * sizeof(T);
};

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(gmem), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = big + small.  big is x rounded to TF32 (10 mantissa bits) to nearest,
// ties away from zero, as `cvt.rna.tf32.f32` rounds, computed with two
// integer operations on the bits.
// small, the exact f32 residual, goes in as it is: the MMA reads only the
// TF32 bits of an operand, so small is truncated to TF32, as CUTLASS's
// fast-f32 rounds its small part.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(p);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Rows [row0, row0 + ROWS) of one (b, h) slice into a padded tile; rows at
// or past `limit` are zero.  `vec`: 16-byte asynchronous copies (aligned
// inputs), else plain loads.
template <typename T, int D, int ROWS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, Strides st,
                                          int b, int h, int row0, int limit, bool vec) {
  using TL = Tile<T, D>;
  const T* base = src + (long long)b * st.b + (long long)h * st.h;
  if (vec) {
    constexpr int CHUNKS = D / TL::VEC;  // per row, a power of two
    static_assert(ROWS * CHUNKS % NTHREADS == 0, "whole copies per thread");
#pragma unroll
    for (int it = 0; it < ROWS * CHUNKS / NTHREADS; ++it) {
      const int idx = threadIdx.x + it * NTHREADS;
      const int r = idx / CHUNKS, c = (idx % CHUNKS) * TL::VEC;
      const int row = row0 + r;
      const bool in = row < limit;
      cp_async16(dst + r * TL::STRIDE + c, base + (in ? (long long)row * st.s : 0) + c,
                 in ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < ROWS * D; idx += NTHREADS) {
      const int r = idx / D, c = idx % D;
      const int row = row0 + r;
      dst[r * TL::STRIDE + c] = row < limit ? base[(long long)row * st.s + c] : zero<T>();
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NTHREADS, 2)  // 2 blocks an SM, up to 255 registers each
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 const int* __restrict__ kv_lens, float* __restrict__ lse,
                 int H, int Sq, int Sk,
                 Strides qs, Strides ks, Strides vs, Strides os,
                 float scale_log2, int causal, int vec) {
  using TL = Tile<T, D>;
  constexpr bool F32 = TL::F32;
  constexpr int BK = TL::BK, STRIDE = TL::STRIDE;
  constexpr int NT = BK / 8;  // n-tiles of S per KV tile
  constexpr int DT = D / 8;   // n-tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sQ = reinterpret_cast<T*>(smem_raw);  // [BQ][STRIDE]
  T* sK = sQ + BQ * STRIDE;                 // [2][BK][STRIDE]
  T* sV = sK + 2 * BK * STRIDE;             // [2][BK][STRIDE]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;  // row group, lane within the quad
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int wrow = warp * 16;  // the warp's first row in the tile

  int kv_len = Sk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Sk);
  // under causal no row of this tile sees a key past its last row
  const int kv_end = causal ? min(kv_len, q0 + BQ) : kv_len;
  const int n_tiles = (kv_end + BK - 1) / BK;

  load_tile<T, D, BQ>(sQ, q, qs, b, h, q0, Sq, vec);
  if (n_tiles > 0) {
    load_tile<T, D, BK>(sK, k, ks, b, h, 0, Sk, vec);
    load_tile<T, D, BK>(sV, v, vs, b, h, 0, Sk, vec);
  }
  cp_async_commit();

  // Q fragments (A operand): f32 holds big then small per k-step of 8
  constexpr int QF = !TL::Q_IN_REGS ? 1 : (F32 ? 2 * (D / 8) : D / 16);
  uint32_t qf[QF][4];
  float acc_o[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc_o[i][j] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};  // log2-domain running max
  float l_row[2] = {0.f, 0.f};              // this lane's share of the row sum

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    const int kv0 = t * BK;
    if (t + 1 < n_tiles) {
      load_tile<T, D, BK>(sK + (buf ^ 1) * BK * STRIDE, k, ks, b, h, kv0 + BK, Sk, vec);
      load_tile<T, D, BK>(sV + (buf ^ 1) * BK * STRIDE, v, vs, b, h, kv0 + BK, Sk, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    __syncthreads();

    const T* qrow = sQ + (wrow + g) * STRIDE;
    if constexpr (TL::Q_IN_REGS) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < (F32 ? D / 8 : D / 16); ++kk) {
          if constexpr (F32) {
            const float* p = qrow + kk * 8 + t4;
            split_tf32(p[0], qf[kk][0], qf[D / 8 + kk][0]);
            split_tf32(p[8 * STRIDE], qf[kk][1], qf[D / 8 + kk][1]);
            split_tf32(p[4], qf[kk][2], qf[D / 8 + kk][2]);
            split_tf32(p[8 * STRIDE + 4], qf[kk][3], qf[D / 8 + kk][3]);
          } else {
            const T* p = qrow + kk * 16 + 2 * t4;
            qf[kk][0] = lds32(p);
            qf[kk][1] = lds32(p + 8 * STRIDE);
            qf[kk][2] = lds32(p + 8);
            qf[kk][3] = lds32(p + 8 * STRIDE + 8);
          }
        }
      }
    }

    // S = Q K^T: lane holds rows g, g + 8 and columns 2 t4, 2 t4 + 1 of
    // each n-tile
    const T* kt = sK + buf * BK * STRIDE;
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[n][j] = 0.f;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        uint32_t qb[4], qsm[4];
        if constexpr (TL::Q_IN_REGS) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            qb[j] = qf[kk][j];
            qsm[j] = qf[D / 8 + kk][j];
          }
        } else {
          const float* p = qrow + kk * 8 + t4;
          split_tf32(p[0], qb[0], qsm[0]);
          split_tf32(p[8 * STRIDE], qb[1], qsm[1]);
          split_tf32(p[4], qb[2], qsm[2]);
          split_tf32(p[8 * STRIDE + 4], qb[3], qsm[3]);
        }
        // the three passes each run over every n-tile, so that no MMA
        // waits on the one just issued to the same accumulator
        uint32_t kb[NT][2], ksm[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float* p = kt + (n * 8 + g) * STRIDE + kk * 8 + t4;
          split_tf32(p[0], kb[n][0], ksm[n][0]);
          split_tf32(p[4], kb[n][1], ksm[n][1]);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(s[n], qsm, kb[n][0], kb[n][1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(s[n], qb, ksm[n][0], ksm[n][1]);
#pragma unroll
        for (int n = 0; n < NT; ++n) mma_tf32(s[n], qb, kb[n][0], kb[n][1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const T* p = kt + (n * 8 + g) * STRIDE + kk * 16 + 2 * t4;
          mma_bf16(s[n], qf[kk], lds32(p), lds32(p + 8));
        }
      }
    }

    // online softmax in the log2 domain
    const bool masked = kv0 + BK > kv_len || (causal && kv0 + BK - 1 > q0 + wrow);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wrow + g + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * i + e] * scale_log2;
          if (masked) {
            const int col = kv0 + n * 8 + 2 * t4 + e;
            if (col >= kv_len || (causal && col > row)) x = -INFINITY;
          }
          s[n][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // no valid key yet
      const float alpha = exp2f(m_row[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[n][2 * i + e] - m_use);
          s[n][2 * i + e] = p;
          sum += p;
        }
      }
      l_row[i] = l_row[i] * alpha + sum;
      m_row[i] = m_new;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc_o[d][2 * i] *= alpha;
        acc_o[d][2 * i + 1] *= alpha;
      }
    }

    // O += P V
    const T* vt = sV + buf * BK * STRIDE;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < NT; ++kk) {
        // A = P with the K index permuted: k = t4 <-> key 2 t4, k = t4 + 4
        // <-> key 2 t4 + 1, so the accumulator pair is the A fragment
        uint32_t ab[4], asm_[4];
        split_tf32(s[kk][0], ab[0], asm_[0]);
        split_tf32(s[kk][2], ab[1], asm_[1]);
        split_tf32(s[kk][1], ab[2], asm_[2]);
        split_tf32(s[kk][3], ab[3], asm_[3]);
        const float* vrow = vt + (kk * 8 + 2 * t4) * STRIDE + g;
        uint32_t vb[DT][2], vsm[DT][2];
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          split_tf32(vrow[d * 8], vb[d][0], vsm[d][0]);
          split_tf32(vrow[STRIDE + d * 8], vb[d][1], vsm[d][1]);
        }
#pragma unroll
        for (int d = 0; d < DT; ++d) mma_tf32(acc_o[d], asm_, vb[d][0], vb[d][1]);
#pragma unroll
        for (int d = 0; d < DT; ++d) mma_tf32(acc_o[d], ab, vsm[d][0], vsm[d][1]);
#pragma unroll
        for (int d = 0; d < DT; ++d) mma_tf32(acc_o[d], ab, vb[d][0], vb[d][1]);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const T* vrow = vt + (kk * 16 + (lane & 15)) * STRIDE + (lane >> 4) * 8;
#pragma unroll
        for (int d = 0; d < DT; d += 2) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, vrow + d * 8);
          mma_bf16(acc_o[d], a, r[0], r[1]);
          mma_bf16(acc_o[d + 1], a, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // the next tile's copy reuses this buffer
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_row[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + wrow + g + 8 * i;
    if (row >= Sq) continue;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    T* dst = o + (long long)b * os.b + (long long)row * os.s + (long long)h * os.h + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      dst[d * 8] = from_f32<T>(acc_o[d][2 * i] * inv);
      dst[d * 8 + 1] = from_f32<T>(acc_o[d][2 * i + 1] * inv);
    }
    if (lse != nullptr && t4 == 0)
      lse[(long long)bh * Sq + row] = l > 0.f ? m_row[i] * LN2 + logf(l) : NEG_INF;
  }
}

template <int VEC>
bool aligned16(const void* p, Strides st) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && st.b % VEC == 0 && st.s % VEC == 0 &&
         st.h % VEC == 0;
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const int* kv_lens, float* lse, int B, int Sq, int Sk, int H, Strides qs,
           Strides ks, Strides vs, Strides os, float scale, int causal,
           cudaStream_t stream) {
  using TL = Tile<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TL::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int q_tiles = (Sq + BQ - 1) / BQ;
  if (q_tiles > 65535 || (long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int vec = aligned16<TL::VEC>(q, qs) && aligned16<TL::VEC>(k, ks) &&
                  aligned16<TL::VEC>(v, vs);
  dim3 grid(B * H, q_tiles);
  flash_fwd_kernel<T, D><<<grid, NTHREADS, TL::SMEM, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), kv_lens, lse, H, Sq, Sk, qs, ks, vs, os, scale * LOG2E, causal,
      vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns the cudaGetLastError() code of the launch (0 on success); a
// head_dim other than 32, 64 or 128 returns cudaErrorInvalidValue.  Strides are in
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
  if (D == 32) {
    return is_bf16 ? launch<__nv_bfloat16, 32>(q, k, v, o, kv_lens, lse, B, Sq, Sk, H, qs, ks, vs, os, scale, causal, st)
                   : launch<float, 32>(q, k, v, o, kv_lens, lse, B, Sq, Sk, H, qs, ks, vs, os, scale, causal, st);
  }
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

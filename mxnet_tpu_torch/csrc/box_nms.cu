// Greedy non-maximum suppression of score-sorted boxes for Hopper
// (sm_90a), CUDA C++ with a plain C entry.
//
// Replaces no TPU kernel.  The JAX package's `box_nms`
// (mxnet_tpu/ops/contrib_ops.py:135, also the last step of
// `MultiBoxDetection`, :293) is a `lax.scan` of M steps in XLA: step i
// takes the i-th box in descending score order and, if it is valid and
// still kept, clears the keep flag of every later box of the same class
// (any class under force_suppress) whose IoU with it exceeds the
// threshold.  Ported as M steps of torch ops, that is over 10^6 launches a
// call at SSD-300's 8,732 anchors and batch 32, and the whole [M, M] IoU
// matrix is 305 MB a picture.  `Proposal`'s and `MultiProposal`'s
// suppression (mxnet_tpu/ops/detection_ops.py:95, `_nms_keep`, a
// `fori_loop` of rpn_pre_nms_top_n = 6,000 steps a picture) is the same
// sweep over boxes already sorted, class-blind, every box valid, with
// the IoU of `_box_ious` (:81): pixel-inclusive widths (`+ 1`) and no
// guard on the union.  So the port's wrapper sorts (torch, stable, as the
// JAX package's argsort and top_k), and this entry runs two kernels:
//
//   mask:  one block of 64 threads per (row block, column block, picture)
//          of the sorted boxes, column block >= row block: the column
//          block's boxes, areas and classes in shared memory; thread t
//          sets bit k of its row's word when column box k comes later in
//          the order, has the row's class (or force_suppress) and an IoU
//          above the threshold.  mask[b, i, w] holds row i's bits for
//          boxes 64 w .. 64 w + 63; words left of the diagonal are 0.
//   sweep: one block per picture walks the sorted boxes in order with a
//          bitmap of removed boxes in shared memory: box i is kept when
//          its bit is clear, and a kept valid box ORs its mask row into
//          the bitmap (the block's threads share the row's words).  Only a
//          kept valid box writes, and only bits of later boxes, so a step
//          that writes ends in one barrier and the others need none.
//
// The result, keep[b, i] for the i-th sorted box of picture b, is the
// scan's keep flags before its final `& valid` and top-k masks, which the
// wrapper applies in the input order.  The IoU is the JAX package's
// `_pairwise_iou` formula (offset 0) or `_box_ious` (offset 1), with each
// product, sum and quotient rounded on its own (explicitly rounded
// intrinsics: no FMA contraction), so it equals the plain version's torch
// ops bit for bit and the keep flags agree exactly.
//
// Bound on an H100 SXM: operations.  About 13 f32 operations per IoU
// (2 max, 2 min, 2 subtractions and 2 clamps, a product, 2 additions, a
// division; offset 1 adds 2 additions), one IoU per pair of boxes i < j of
// one class (of any class under force_suppress), at 67 TFLOP/s on the
// CUDA cores.  The bytes (the sorted boxes, classes and flags in, the
// flags out) are far less; the mask scratch (8 bytes per 64 pairs) is the
// kernel's own traffic.  The sweep is sequential over a picture's boxes,
// one block per picture.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;           // boxes per mask word
constexpr int SWEEP_THREADS = 256;  // threads sharing a mask row's words
constexpr int MAX_WORDS = 6144;     // the sweep's bitmap, 48 KB of shared memory

struct Box {
  float x0, y0, x1, y1, area;
};

template <bool PLUS1>
__device__ __forceinline__ Box load_box(const float* p) {
  const float x0 = p[0], y0 = p[1], x1 = p[2], y1 = p[3];
  // offset 1: (x1 - x0 + 1) * (y1 - y0 + 1), unclamped (`_box_ious`)
  const float area =
      PLUS1 ? __fmul_rn(__fadd_rn(__fsub_rn(x1, x0), 1.f), __fadd_rn(__fsub_rn(y1, y0), 1.f))
            : __fmul_rn(fmaxf(__fsub_rn(x1, x0), 0.f), fmaxf(__fsub_rn(y1, y0), 0.f));
  return Box{x0, y0, x1, y1, area};
}

// the JAX package's _pairwise_iou for one pair: the intersection's width
// and height clamped at 0, their product over area_a + area_b - inter,
// 0 where that union is not positive.  Offset 1 is `_box_ious` of row box
// a against box b: the widths and heights take `+ 1` before the clamp and
// the quotient has no guard.
template <bool PLUS1>
__device__ __forceinline__ float iou(const Box& a, const Box& b) {
  float w = __fsub_rn(fminf(a.x1, b.x1), fmaxf(a.x0, b.x0));
  float h = __fsub_rn(fminf(a.y1, b.y1), fmaxf(a.y0, b.y0));
  if (PLUS1) {
    w = __fadd_rn(w, 1.f);
    h = __fadd_rn(h, 1.f);
  }
  const float inter = __fmul_rn(fmaxf(w, 0.f), fmaxf(h, 0.f));
  const float uni = __fsub_rn(__fadd_rn(a.area, b.area), inter);
  if (PLUS1) return __fdiv_rn(inter, uni);
  return uni > 0.f ? __fdiv_rn(inter, uni) : 0.f;
}

template <bool PLUS1>
__global__ void __launch_bounds__(BLOCK)
nms_mask_kernel(const float* __restrict__ boxes, const float* __restrict__ cls, int M,
                int n_words, float thresh, int force, unsigned long long* __restrict__ mask) {
  const int b = blockIdx.z, row_blk = blockIdx.y, col_blk = blockIdx.x;
  const int t = threadIdx.x;
  const int i = row_blk * BLOCK + t;
  const long long base = (long long)b * M;
  if (col_blk < row_blk) {  // every column box precedes every row box
    if (i < M) mask[(base + i) * n_words + col_blk] = 0ull;
    return;
  }
  __shared__ Box cb[BLOCK];
  __shared__ float cc[BLOCK];
  const int j0 = col_blk * BLOCK;
  const int n_cols = min(BLOCK, M - j0);
  if (t < n_cols) {
    cb[t] = load_box<PLUS1>(boxes + (base + j0 + t) * 4);
    cc[t] = cls[base + j0 + t];
  }
  __syncthreads();
  if (i >= M) return;
  const Box a = load_box<PLUS1>(boxes + (base + i) * 4);
  const float ca = cls[base + i];
  unsigned long long bits = 0ull;
  for (int k = col_blk == row_blk ? t + 1 : 0; k < n_cols; ++k) {
    if ((force || cc[k] == ca) && iou<PLUS1>(a, cb[k]) > thresh) bits |= 1ull << k;
  }
  mask[(base + i) * n_words + col_blk] = bits;
}

__global__ void __launch_bounds__(SWEEP_THREADS)
nms_sweep_kernel(const unsigned long long* __restrict__ mask, const uint8_t* __restrict__ valid,
                 int M, int n_words, uint8_t* __restrict__ keep) {
  extern __shared__ unsigned long long removed[];
  const int b = blockIdx.x;
  for (int w = threadIdx.x; w < n_words; w += blockDim.x) removed[w] = 0ull;
  __syncthreads();
  const unsigned long long* mb = mask + (long long)b * M * n_words;
  const uint8_t* vb = valid + (long long)b * M;
  uint8_t* kb = keep + (long long)b * M;
  for (int i = 0; i < M; ++i) {
    const int w = i / BLOCK;
    // every thread reads the same bit: the branch below is uniform
    const bool kept = !((removed[w] >> (i % BLOCK)) & 1ull);
    if (threadIdx.x == 0) kb[i] = kept;
    if (kept && vb[i]) {
      const unsigned long long* row = mb + (long long)i * n_words;
      for (int k = w + threadIdx.x; k < n_words; k += blockDim.x) removed[k] |= row[k];
      __syncthreads();
    }
  }
}

}  // namespace

// boxes: [B, M, 4] f32 corner boxes sorted by descending score; cls: [B, M]
// f32 class ids (all 0 for class-blind suppression); valid: [B, M] u8;
// mask: [B, M, ceil(M / 64)] u64 scratch; keep: [B, M] u8 out.  All
// contiguous.  offset: 0 for box_nms's IoU, 1 for Proposal's.  Returns the
// CUDA error of the launches (0 when both were accepted).
extern "C" int mxtt_box_nms(const void* boxes, const void* cls, const void* valid, void* mask,
                            void* keep, int B, int M, float thresh, int force, int offset,
                            void* stream) {
  if (B == 0 || M == 0) return 0;
  const int n_words = (M + BLOCK - 1) / BLOCK;
  if (B > 65535 || n_words > MAX_WORDS) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_words, n_words, B);
  const float* bx = static_cast<const float*>(boxes);
  const float* cl = static_cast<const float*>(cls);
  unsigned long long* mk = static_cast<unsigned long long*>(mask);
  if (offset)
    nms_mask_kernel<true><<<grid, BLOCK, 0, st>>>(bx, cl, M, n_words, thresh, force, mk);
  else
    nms_mask_kernel<false><<<grid, BLOCK, 0, st>>>(bx, cl, M, n_words, thresh, force, mk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_sweep_kernel<<<B, SWEEP_THREADS, n_words * sizeof(unsigned long long), st>>>(
      static_cast<const unsigned long long*>(mask), static_cast<const uint8_t*>(valid), M,
      n_words, static_cast<uint8_t*>(keep));
  return (int)cudaGetLastError();
}

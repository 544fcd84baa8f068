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
//        where div is the (OH, OW) divisor map (1 for sum pooling,
//        1/prod(kernel), or 1/valid-count under count_include_pad=False),
//        f32, or f64 for f64 dy.
//
// Design.  Max: one launch; each block owns a band of input rows and a
// column tile of one (n, c) plane (at ResNet-50's stem, 56 rows x 112).  It
// finds the windows covering its band once, from the band's first and last
// rows (a few divisions per block, not per element), and stages into shared
// memory, with coalesced loads, the x rows those windows read (the band
// plus a halo, -inf outside the input) and those windows' dy.  It computes
// each covering window's first maximal tap, in row-major order, as one byte
// in shared memory (the select of select-and-scatter: a strict `>` keeps
// the earlier of tied taps, a NaN routes the window's gradient nowhere).
// Then each thread owns 4 consecutive pixels of a row and sums dy over the
// windows covering each, walking them so that its tap (i, j) in each runs
// in row-major order, with the covering ranges from per-row and per-column
// tables the block built once; it writes the 4 pixels with one vector store
// where the row is aligned.  Windows in the halo are recomputed by the two
// neighbouring blocks: a little arithmetic, no global traffic.  Avg, the
// general case: each thread owns 4 consecutive pixels of a row (a gather),
// finds the windows covering the row once and each pixel's columns, and
// walks them in the same order, adding each window's dy * div.  Avg, the
// global pool (one window over the whole plane, ResNet's): a broadcast
// store, 16 bytes a thread in a grid-stride loop sized from the SM count,
// each element's plane from a multiply-high division.  Each pixel's sum is
// formed by one thread in a fixed order (no atomics, deterministic), and
// that order is the plain version's tap loop, so the two agree bit for
// bit in f32.  The avg sum uses explicitly rounded multiply and add so
// that the compiler does not contract them into an FMA the plain version
// does not make.  Pixels that no window covers get 0.
//
// Types: x, dy and dx are f32, bf16, f16 or f64, one type for all three.
// f32, bf16 and f16 compute in f32, as the TPU kernel's f32 scratch does,
// and each dx element is rounded once to its type, to nearest even, as the
// plain version's final cast.  f64 computes in f64 throughout: the max
// compares doubles (taps that differ below f32's resolution, or lie beyond
// its range, are told apart) and the sums add doubles, as the plain
// version's f64 path does.  So the kernel and the plain version agree bit
// for bit in every type.  Halves load and store 4 at a time where aligned,
// as bf16 does; f64 loads x element by element and stages it as double.
//
// Bound on an H100 SXM: bytes, over 3.35 TB/s.  Max: x read once, dy read
// once, dx written once; at ResNet-50's stem (x (32, 64, 112, 112), dy
// (32, 64, 56, 56), f32) that is 231 MB, 0.069 ms.  The banded design reads
// x once plus a halo of a few rows per band (3 per 56 at the stem, mostly
// from L2) and dy about once; there is no global argmax map.  Avg: dy, div
// and dx; at the global 7 x 7 pool (dy (32, 2048, 1, 1), dx (32, 2048, 7,
// 7), f32) 13.1 MB, 0.004 ms, about the time a launch takes: the global
// path's stores are the whole of its work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr int NTHREADS = 256;

// The type an element type computes in: double for f64, else float.
template <typename T>
using acc_t = typename std::conditional<std::is_same<T, double>::value, double, float>::type;

__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_acc(__half x) { return __half2float(x); }
__device__ __forceinline__ double to_acc(double x) { return x; }

// The computed value to the element type, rounded to nearest even (as
// torch's casts)
template <typename T> __device__ __forceinline__ T from_acc(acc_t<T> x);
template <> __device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_acc<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ double from_acc<double>(double x) { return x; }

// explicitly rounded multiply and add (never contracted into an FMA)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

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
constexpr int NWARPS = NTHREADS / 32;
constexpr int BAND_PIXELS = 8192;     // input pixels a block aims to own
constexpr int MAX_TILE_W = 256;       // widest column tile
constexpr int BAND_SMEM = 48 * 1024;  // shared memory a block may stage

// A block's share of a plane: `rows` x `cols` input pixels; the plane has
// n_bands x n_tiles of them.
struct Band {
  int rows, cols, n_bands, n_tiles;
};

__device__ __forceinline__ void store4(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&a)[4]) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(__half* p, const float (&a)[4]) {
  __half2 lo = __floats2half2_rn(a[0], a[1]);
  __half2 hi = __floats2half2_rn(a[2], a[3]);
  uint2 u;
  u.x = *reinterpret_cast<uint32_t*>(&lo);
  u.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}
__device__ __forceinline__ void store4(double* p, const double (&a)[4]) {
  reinterpret_cast<double2*>(p)[0] = make_double2(a[0], a[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(a[2], a[3]);
}

// Four staged values of one row, in the type they are computed in.
template <typename A>
struct Quad {
  A v[4];
};

// A quad into shared memory, 16 bytes a store (p is 16-byte aligned)
__device__ __forceinline__ void store_quad(float* p, const Quad<float>& q) {
  *reinterpret_cast<float4*>(p) = make_float4(q.v[0], q.v[1], q.v[2], q.v[3]);
}
__device__ __forceinline__ void store_quad(double* p, const Quad<double>& q) {
  reinterpret_cast<double2*>(p)[0] = make_double2(q.v[0], q.v[1]);
  reinterpret_cast<double2*>(p)[1] = make_double2(q.v[2], q.v[3]);
}

constexpr int ROWS_IN_FLIGHT = 4;  // staged rows a warp loads before storing

// x[gc .. gc + 3] of one row in its computing type, -inf outside the
// input.  `vec`: the row and its stride allow one aligned load of the 4
// (gc is a multiple of 4 and W too, so the 4 are all inside or all
// outside); never set for f64, which loads element by element.
template <typename T>
__device__ __forceinline__ Quad<acc_t<T>> load4(const T* __restrict__ row, int gc, int W,
                                                long long sw, bool row_in, bool vec) {
  using A = acc_t<T>;
  Quad<A> f{{-(A)INFINITY, -(A)INFINITY, -(A)INFINITY, -(A)INFINITY}};
  if (!row_in || gc >= W || gc + 3 < 0) return f;
  if constexpr (std::is_same<T, float>::value) {
    if (vec) {
      const float4 v = *reinterpret_cast<const float4*>(row + gc);
      return Quad<float>{{v.x, v.y, v.z, v.w}};
    }
  } else if constexpr (sizeof(T) == 2) {
    if (vec) {
      using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                           __nv_bfloat162>::type;
      const uint2 u = *reinterpret_cast<const uint2*>(row + gc);
      const T2 lo = *reinterpret_cast<const T2*>(&u.x);
      const T2 hi = *reinterpret_cast<const T2*>(&u.y);
      return Quad<float>{{__low2float(lo), __high2float(lo), __low2float(hi), __high2float(hi)}};
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (gc + e >= 0 && gc + e < W) f.v[e] = to_acc(row[(gc + e) * sw]);
  return f;
}

// KH, KW, SH, SW: the window and stride when known at compile time (the
// loops over taps and covering windows then unroll and the divisions by the
// stride become shifts), else 0 and read from g.
template <typename T, int KH, int KW, int SH, int SW>
__global__ void __launch_bounds__(NTHREADS, 6)
max_pool_bwd_band_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         T* __restrict__ dx, Geometry g, Strides4 xs, Strides4 ys,
                         Band band, int vec_load, int vec_store) {
  using A = acc_t<T>;
  if constexpr (KH > 0) {
    g.kh = KH;
    g.kw = KW;
    g.sh = SH;
    g.sw = SW;
  }
  // most windows covering one pixel along each axis, when known
  constexpr int MWH = KH > 0 ? (KH + SH - 1) / SH : 0;
  constexpr int MWW = KH > 0 ? (KW + SW - 1) / SW : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned int rest = blockIdx.x / band.n_tiles;
  const int tile = (int)(blockIdx.x - rest * band.n_tiles);
  const unsigned int plane = rest / band.n_bands;
  const int bnd = (int)(rest - plane * band.n_bands);
  const int n = (int)(plane / (unsigned int)g.C);
  const int c = (int)(plane - n * g.C);
  const int h0 = bnd * band.rows, nrows = min(band.rows, g.H - h0);
  const int w0 = tile * band.cols, ncols = min(band.cols, g.W - w0);

  // the windows covering the band, and the x rows and columns they read
  int oh_lo, oh_hi, ow_lo, ow_hi, unused;
  covering(h0 + g.pt, g.kh, g.sh, g.OH, &oh_lo, &unused);
  covering(h0 + nrows - 1 + g.pt, g.kh, g.sh, g.OH, &unused, &oh_hi);
  covering(w0 + g.pl, g.kw, g.sw, g.OW, &ow_lo, &unused);
  covering(w0 + ncols - 1 + g.pl, g.kw, g.sw, g.OW, &unused, &ow_hi);
  const bool any = oh_hi >= oh_lo && ow_hi >= ow_lo;
  const int nwh = any ? oh_hi - oh_lo + 1 : 0, nww = any ? ow_hi - ow_lo + 1 : 0;
  const int xrows = any ? (nwh - 1) * g.sh + g.kh : 0;
  const int xcols = any ? (nww - 1) * g.sw + g.kw : 0;
  const int xr0 = oh_lo * g.sh - g.pt, xc0 = ow_lo * g.sw - g.pl;
  // staged rows start at the multiple of 4 at or below xc0, so that each
  // 4-column chunk is one aligned load
  const int xa = xc0 & ~3, xoff = xc0 - xa;
  const int xw = any ? (xoff + xcols + 3) & ~3 : 0;

  A* sx = reinterpret_cast<A*>(smem);  // [xrows][xw]
  A* sdy = sx + xrows * xw;            // [nwh][nww]
  int* rlo = reinterpret_cast<int*>(sdy + nwh * nww);
  int* rhi = rlo + band.rows;
  int* clo = rhi + band.rows;
  int* chi = clo + band.cols;
  unsigned char* sarg = reinterpret_cast<unsigned char*>(chi + band.cols);  // [nwh][nww]

  // stage x (-inf outside the input) and dy: a warp per row, lanes along
  // it, ROWS_IN_FLIGHT rows' loads issued before their stores
  const T* xp = x + n * xs.n + c * xs.c;
  const int chunks = xw >> 2;
  for (int r0 = warp; r0 < xrows; r0 += NWARPS * ROWS_IN_FLIGHT) {
    for (int q0 = 0; q0 < chunks; q0 += 32) {
      const int q = q0 + lane;
      Quad<A> vals[ROWS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int hr = xr0 + r0 + u * NWARPS;
        const bool row_in = r0 + u * NWARPS < xrows && q < chunks && hr >= 0 && hr < g.H;
        vals[u] = load4(xp + (row_in ? (long long)hr * xs.h : 0), xa + 4 * q, g.W, xs.w,
                        row_in, vec_load);
      }
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int r = r0 + u * NWARPS;
        if (r < xrows && q < chunks) store_quad(sx + r * xw + 4 * q, vals[u]);
      }
    }
  }
  const T* yp = dy + n * ys.n + c * ys.c;
  for (int r0 = warp; r0 < nwh; r0 += NWARPS * ROWS_IN_FLIGHT) {
    for (int c0 = 0; c0 < nww; c0 += 32) {
      const int cc = c0 + lane;
      A vals[ROWS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int r = r0 + u * NWARPS;
        vals[u] = r < nwh && cc < nww
                      ? to_acc(yp[(long long)(oh_lo + r) * ys.h + (long long)(ow_lo + cc) * ys.w])
                      : (A)0;
      }
#pragma unroll
      for (int u = 0; u < ROWS_IN_FLIGHT; ++u) {
        const int r = r0 + u * NWARPS;
        if (r < nwh && cc < nww) sdy[r * nww + cc] = vals[u];
      }
    }
  }
  // each band row's and tile column's covering windows, relative to the
  // band's first
  for (int r = threadIdx.x; r < nrows; r += NTHREADS) {
    int lo, hi;
    covering(h0 + r + g.pt, g.kh, g.sh, g.OH, &lo, &hi);
    rlo[r] = lo - oh_lo;
    rhi[r] = hi - oh_lo;
  }
  for (int cc = threadIdx.x; cc < ncols; cc += NTHREADS) {
    int lo, hi;
    covering(w0 + cc + g.pl, g.kw, g.sw, g.OW, &lo, &hi);
    clo[cc] = lo - ow_lo;
    chi[cc] = hi - ow_lo;
  }
  __syncthreads();

  // each covering window's first maximal tap in row-major order
  for (int wh = warp; wh < nwh; wh += NWARPS) {
    for (int ww = lane; ww < nww; ww += 32) {
      const A* win = sx + wh * g.sh * xw + xoff + ww * g.sw;
      A best = -(A)INFINITY;
      int arg = 0;
      bool has_nan = false;
      for (int ti = 0; ti < g.kh; ++ti) {
        for (int tj = 0; tj < g.kw; ++tj) {
          const A v = win[ti * xw + tj];
          const int t = ti * g.kw + tj;
          if (v != v) has_nan = true;
          if (t == 0 || v > best) {  // strict: a tie keeps the earlier tap
            best = v;
            arg = t;
          }
        }
      }
      sarg[wh * nww + ww] = has_nan ? NO_TAP : (unsigned char)arg;
    }
  }
  __syncthreads();

  // gather: 4 consecutive pixels a lane, a warp per row
  T* dxp = dx + (long long)plane * g.H * g.W;
  for (int r = warp; r < nrows; r += NWARPS) {
    const int h = h0 + r;
    const int wlo = rlo[r], whi = rhi[r];
    const int ib = h + g.pt - oh_lo * g.sh;  // tap row in window wh: ib - wh * sh
    T* drow = dxp + (long long)h * g.W + w0;
    for (int c4 = lane * 4; c4 < ncols; c4 += 4 * 32) {
      A acc[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[e] = 0;
        const int cc = c4 + e;
        if (cc >= ncols) continue;
        const int jb = w0 + cc + g.pl - ow_lo * g.sw;
        const int vlo = clo[cc], vhi = chi[cc];
        auto take = [&](int wh, int ww) {
          const int i = ib - wh * g.sh, j = jb - ww * g.sw;
          if (sarg[wh * nww + ww] == i * g.kw + j) acc[e] += sdy[wh * nww + ww];
        };
        // taps (i, j) in row-major order: windows by descending oh, then ow
        if constexpr (KH > 0) {
#pragma unroll
          for (int a = 0; a < MWH; ++a) {
#pragma unroll
            for (int b = 0; b < MWW; ++b)
              if (whi - a >= wlo && vhi - b >= vlo) take(whi - a, vhi - b);
          }
        } else {
          for (int wh = whi; wh >= wlo; --wh)
            for (int ww = vhi; ww >= vlo; --ww) take(wh, ww);
        }
      }
      if (vec_store && c4 + 4 <= ncols) {
        store4(drow + c4, acc);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (c4 + e < ncols) drow[c4 + e] = from_acc<T>(acc[e]);
      }
    }
  }
}

// Windows along one axis that can cover `span` consecutive positions.
int windows_over(int span, int k, int s, int out) {
  return out < 1 ? 0 : std::min(out, (span + k - 2) / s + 1);
}

// Shared memory a block of `rows` x `cols` pixels stages, at most, with
// x and dy staged as `abytes`-byte values (4 for f32, 8 for f64).
size_t band_smem(const Geometry& g, int rows, int cols, int abytes) {
  const long long wh = windows_over(rows, g.kh, g.sh, g.OH);
  const long long ww = windows_over(cols, g.kw, g.sw, g.OW);
  const long long xr = wh > 0 ? (wh - 1) * g.sh + g.kh : 0;
  // + 6: the staged row starts up to 3 columns early and is padded to 4
  const long long xc = ww > 0 ? (ww - 1) * g.sw + g.kw + 6 : 0;
  return (size_t)(abytes * (xr * xc + wh * ww) + 8 * (rows + cols) + wh * ww);
}

// About BAND_PIXELS pixels a block, whole rows up to MAX_TILE_W wide,
// halved until the staged halo fits in BAND_SMEM, then evened out over
// the plane's rows.
Band choose_band(const Geometry& g, int abytes) {
  Band b;
  b.cols = std::min(g.W, MAX_TILE_W);
  b.rows = std::max(1, std::min(g.H, BAND_PIXELS / b.cols));
  while (band_smem(g, b.rows, b.cols, abytes) > BAND_SMEM) {
    if (b.rows > 1) {
      b.rows = (b.rows + 1) / 2;
    } else if (b.cols > 4) {
      b.cols = std::max(4, b.cols / 2 / 4 * 4);
    } else {
      break;  // a 64-tap window over 1 x 4 pixels stages well under the budget
    }
  }
  b.n_bands = (g.H + b.rows - 1) / b.rows;
  b.rows = (g.H + b.n_bands - 1) / b.n_bands;
  b.n_tiles = (g.W + b.cols - 1) / b.cols;
  return b;
}

template <typename T>
void launch_max(bool stem, unsigned int blocks, size_t smem, cudaStream_t st, const void* x,
                const void* dy, void* dx, const Geometry& g, const Strides4& xs,
                const Strides4& ys, const Band& band, int vec_load, int vec_store) {
  const T* xt = static_cast<const T*>(x);
  const T* yt = static_cast<const T*>(dy);
  T* dt = static_cast<T*>(dx);
  if (stem) {
    max_pool_bwd_band_kernel<T, 3, 3, 2, 2><<<blocks, NTHREADS, smem, st>>>(
        xt, yt, dt, g, xs, ys, band, vec_load, vec_store);
  } else {
    max_pool_bwd_band_kernel<T, 0, 0, 0, 0><<<blocks, NTHREADS, smem, st>>>(
        xt, yt, dt, g, xs, ys, band, vec_load, vec_store);
  }
}

// x / d for x < 2^31 by a multiply-high (the divider of PyTorch's
// IntDivider): shift is the least s with 2^s >= d.
struct Divider {
  unsigned int d, magic;
  int shift;
  __device__ __forceinline__ unsigned int div(unsigned int x) const {
    return (__umulhi(x, magic) + x) >> shift;
  }
};

Divider make_divider(unsigned int d) {
  int s = 0;
  while ((1ull << s) < d) ++s;
  const unsigned long long magic = ((1ull << 32) * ((1ull << s) - d)) / d + 1;
  return Divider{d, (unsigned int)magic, s};
}

// 16 bytes of dx: 4 f32, 8 bf16 or f16, or 2 f64, rounded as from_acc
// rounds.
__device__ __forceinline__ void store16(float* p, const float (&a)[4]) { store4(p, a); }
__device__ __forceinline__ void store16(double* p, const double (&a)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(a[0], a[1]);
}
template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&a)[8]) {
  using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                       __nv_bfloat162>::type;
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    T2 h2;
    if constexpr (std::is_same<T, __half>::value)
      h2 = __floats2half2_rn(a[2 * k], a[2 * k + 1]);
    else
      h2 = __floats2bfloat162_rn(a[2 * k], a[2 * k + 1]);
    w[k] = *reinterpret_cast<uint32_t*>(&h2);
  }
  *reinterpret_cast<uint4*>(p) = u;
}

// The global pool (one window covering the whole unpadded plane): every
// dx element of plane (n, c) is 0 + dy[n, c] * div, a broadcast store.
// Each thread writes 16 bytes of the contiguous dx per step of a
// grid-stride loop; a vector may straddle two planes (H * W = 49 is no
// multiple of 4), so each element's plane is counted on from the first's.
// The sum is rounded as the plain version's (0 + dy * div, so dy = -0
// gives +0).  `vec`: dx is 16-byte aligned; a tail of fewer than 16 bytes
// is written an element a thread.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
avg_pool_bwd_global_kernel(const T* __restrict__ dy, const acc_t<T>* __restrict__ div,
                           T* __restrict__ dx, unsigned int total, Divider by_hw,
                           Divider by_c, long long ysn, long long ysc, int vec) {
  using A = acc_t<T>;
  constexpr int VEC = 16 / sizeof(T);
  const A d = __ldg(div);
  auto value = [&](unsigned int plane) {
    const unsigned int n = by_c.div(plane), c = plane - n * by_c.d;
    return add_rn((A)0, mul_rn(to_acc(dy[n * ysn + c * ysc]), d));
  };
  const unsigned int step = gridDim.x * NTHREADS;
  const unsigned int nvec = vec ? total / VEC : 0;
  for (unsigned int q = blockIdx.x * NTHREADS + threadIdx.x; q < nvec; q += step) {
    const unsigned int p0 = q * VEC;
    unsigned int plane = by_hw.div(p0), r = p0 - plane * by_hw.d;
    A v = value(plane), vals[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (r == by_hw.d) {
        r = 0;
        v = value(++plane);
      }
      vals[e] = v;
      ++r;
    }
    store16(dx + p0, vals);
  }
  for (unsigned int p = nvec * VEC + blockIdx.x * NTHREADS + threadIdx.x; p < total; p += step)
    dx[p] = from_acc<T>(value(by_hw.div(p)));
}

// The general case: each thread owns 4 consecutive pixels of one row,
// finds the row's covering windows once, each pixel's columns, and sums
// dy * div over them in the plain version's tap order (explicitly
// rounded, no FMA contraction); one vector store where the row allows.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
avg_pool_bwd_kernel(const T* __restrict__ dy, const acc_t<T>* __restrict__ div,
                    T* __restrict__ dx, Geometry g, Strides4 ys, int vec_store) {
  // 32-bit index arithmetic: the entry refuses more than 2^31 - 1 pixels
  const unsigned int quads = (g.W + 3) / 4;
  const unsigned int idx = blockIdx.x * NTHREADS + threadIdx.x;
  if (idx >= (unsigned int)g.N * g.C * g.H * quads) return;
  const unsigned int row = idx / quads;
  const int w0 = (int)(idx - row * quads) * 4;
  const unsigned int plane = row / (unsigned int)g.H;
  const int h = (int)(row - plane * g.H);
  const int n = (int)(plane / (unsigned int)g.C);
  const int c = (int)(plane - n * g.C);
  const T* yp = dy + n * ys.n + c * ys.c;
  int oh_lo, oh_hi;
  covering(h + g.pt, g.kh, g.sh, g.OH, &oh_lo, &oh_hi);
  using A = acc_t<T>;
  A acc[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc[e] = 0;
    if (w0 + e >= g.W) continue;
    int ow_lo, ow_hi;
    covering(w0 + e + g.pl, g.kw, g.sw, g.OW, &ow_lo, &ow_hi);
    for (int oh = oh_hi; oh >= oh_lo; --oh) {
      for (int ow = ow_hi; ow >= ow_lo; --ow) {
        acc[e] = add_rn(acc[e], mul_rn(to_acc(yp[oh * ys.h + ow * ys.w]),
                                       div[oh * g.OW + ow]));
      }
    }
  }
  T* drow = dx + (long long)row * g.W;
  if (vec_store && w0 + 4 <= g.W) {
    store4(drow + w0, acc);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (w0 + e < g.W) drow[w0 + e] = from_acc<T>(acc[e]);
  }
}

unsigned int blocks_for(const Geometry& g) {
  const long long total = (long long)g.N * g.C * g.H * g.W;
  return (unsigned int)((total + NTHREADS - 1) / NTHREADS);
}

bool too_large(const Geometry& g) {
  return (long long)g.N * g.C * g.H * g.W > 0x7fffffffLL;
}

// The element types, as the wrapper codes them (`_DTYPE_CODES` in
// ops/kernels.py); each entry returns cudaErrorInvalidValue for another.
enum DType { F32 = 0, BF16 = 1, F16 = 2, F64 = 3 };
constexpr int ELEM_BYTES[4] = {4, 2, 2, 8};

// Calls fn(T()) with T the element type of `dtype`.
template <typename Fn>
void by_dtype(int dtype, Fn fn) {
  switch (dtype) {
    case BF16: fn(__nv_bfloat16()); break;
    case F16: fn(__half()); break;
    case F64: fn(double()); break;
    default: fn(float());
  }
}

}  // namespace

// Both entries return the cudaGetLastError() code of the launch (0 on
// success).  Strides are in elements; dx is a contiguous NCHW output;
// `dtype` is a DType, the type of x, dy and dx.
extern "C" int mxtt_max_pool_bwd(
    const void* x, const void* dy, void* dx,
    int N, int C, int H, int W, int OH, int OW, int kh, int kw, int sh, int sw,
    int pad_top, int pad_left,
    long long x_sn, long long x_sc, long long x_sh, long long x_sw,
    long long y_sn, long long y_sc, long long y_sh, long long y_sw,
    int dtype, void* stream) {
  const Geometry g{N, C, H, W, OH, OW, kh, kw, sh, sw, pad_top, pad_left};
  if (blocks_for(g) == 0) return 0;
  if (too_large(g) || kh * kw > NO_TAP || dtype < F32 || dtype > F64)
    return (int)cudaErrorInvalidValue;
  const Strides4 xs{x_sn, x_sc, x_sh, x_sw}, ys{y_sn, y_sc, y_sh, y_sw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int abytes = dtype == F64 ? 8 : 4;  // the staged values' size
  const Band band = choose_band(g, abytes);
  const long long blocks = (long long)N * C * band.n_bands * band.n_tiles;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t smem = band_smem(g, band.rows, band.cols, abytes);
  // 4 elements per access: aligned rows and planes, contiguous along w
  // (f64 loads element by element)
  const size_t quad = 4 * ELEM_BYTES[dtype];
  const int vec_load = dtype != F64 && W % 4 == 0 && x_sw == 1 && x_sh % 4 == 0 &&
                       x_sc % 4 == 0 && x_sn % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % quad == 0;
  const int vec_store = W % 4 == 0 && band.cols % 4 == 0 &&
                        reinterpret_cast<uintptr_t>(dx) % quad == 0;
  const bool stem = kh == 3 && kw == 3 && sh == 2 && sw == 2;  // ResNet's
  by_dtype(dtype, [&](auto t) {
    launch_max<decltype(t)>(stem, (unsigned int)blocks, smem, st, x, dy, dx, g, xs, ys, band,
                            vec_load, vec_store);
  });
  return (int)cudaGetLastError();
}

// The avg entry's arguments, as the wrapper packs them: int64s in this
// order (`_AVG_POOL_ARGS` in ops/kernels.py), one pointer through ctypes.
// `sms` sizes the global pool's grid; `dtype` is a DType; `div` is f32,
// or f64 where dtype is F64.
struct AvgArgs {
  long long dy, div, dx;
  long long N, C, H, W, OH, OW, kh, kw, sh, sw, pad_top, pad_left;
  long long y_sn, y_sc, y_sh, y_sw;
  long long sms, dtype, stream;
};
static_assert(sizeof(AvgArgs) == 22 * 8, "AvgArgs is 22 int64s");

extern "C" int mxtt_avg_pool_bwd(const AvgArgs* x) {
  const void* dy = reinterpret_cast<const void*>(x->dy);
  const void* div = reinterpret_cast<const void*>(x->div);
  void* dx = reinterpret_cast<void*>(x->dx);
  const int N = (int)x->N, C = (int)x->C, H = (int)x->H, W = (int)x->W;
  const int OH = (int)x->OH, OW = (int)x->OW, kh = (int)x->kh, kw = (int)x->kw;
  const int sh = (int)x->sh, sw = (int)x->sw, pad_top = (int)x->pad_top;
  const int pad_left = (int)x->pad_left, sms = (int)x->sms, dtype = (int)x->dtype;
  const long long y_sn = x->y_sn, y_sc = x->y_sc, y_sh = x->y_sh, y_sw = x->y_sw;
  void* stream = reinterpret_cast<void*>(x->stream);
  const Geometry g{N, C, H, W, OH, OW, kh, kw, sh, sw, pad_top, pad_left};
  if (blocks_for(g) == 0) return 0;
  if (too_large(g) || dtype < F32 || dtype > F64) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  if (OH == 1 && OW == 1 && kh == H && kw == W && pad_top == 0 && pad_left == 0) {
    const unsigned int total = (unsigned int)((long long)N * C * H * W);
    const unsigned int per_block = NTHREADS * (aligned ? 16 / ELEM_BYTES[dtype] : 1);
    const unsigned int blocks = std::min<unsigned int>((total + per_block - 1) / per_block,
                                                       (unsigned int)std::max(sms, 1) * 8);
    const Divider by_hw = make_divider((unsigned int)(H * W)), by_c = make_divider(C);
    by_dtype(dtype, [&](auto t) {
      using T = decltype(t);
      avg_pool_bwd_global_kernel<T><<<blocks, NTHREADS, 0, st>>>(
          static_cast<const T*>(dy), static_cast<const acc_t<T>*>(div), static_cast<T*>(dx),
          total, by_hw, by_c, y_sn, y_sc, aligned);
    });
    return (int)cudaGetLastError();
  }
  const Strides4 ys{y_sn, y_sc, y_sh, y_sw};
  const long long units = (long long)N * C * H * ((W + 3) / 4);
  const unsigned int blocks = (unsigned int)((units + NTHREADS - 1) / NTHREADS);
  const int vec_store = W % 4 == 0 && aligned;
  by_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    avg_pool_bwd_kernel<T><<<blocks, NTHREADS, 0, st>>>(
        static_cast<const T*>(dy), static_cast<const acc_t<T>*>(div), static_cast<T*>(dx), g,
        ys, vec_store);
  });
  return (int)cudaGetLastError();
}

// Row layer norm, forward (K3) and backward (K4).
//
// Replaces apex_tpu/ops/layer_norm_pallas.py:171 _fwd (its pallas_call at
// :185, kernel _fwd_kernel :102) and :215 _bwd_rule (pallas_call :222,
// kernel _bwd_kernel :122). Semantics are those kernels': fp32 row
// statistics (the mean, then the mean of (x - mean)^2, rstd = 1/sqrt(var +
// eps)), normalize, optional fp32 affine, y in x's dtype; the forward saves
// only the fp32 per-row mean and rstd. The backward recomputes xhat from x
// and the saved statistics and writes dx in x's dtype; the affine
// gradients (dw = sum dy*xhat, db = sum dy over the rows) are written as
// per-block fp32 partials [nblocks, hidden] and then summed over blocks by
// a second small kernel in the same call (layer_norm_partials_sum), as the
// JAX package sums its per-block partials outside the kernel (:244-245).
//
// Layout: x, y, dy, dx [rows, hidden] contiguous, one dtype (bf16, fp16 or
// fp32); w, b [hidden] fp32 or null (no affine); mean, rstd [rows] fp32.
// Any hidden >= 1. The caller's plan (ops/layer_norm_cuda.plan) names the
// body, the vector width V (elements a load: the widest of 8, 4, 2, 1 for
// the half types, of 4, 2, 1 for fp32, that divides hidden, so every row
// start is V-aligned; the wrapper checks the base pointers), the lanes or
// threads a row, and the grid.
//
// What bounds it on H100: both kernels are bandwidth-bound. At the
// training shape (rows 8192 = b*s, hidden 768, bf16) the forward moves
// 25.2 MB (x read, y written) for ~8 flops per element, 7.5 us at
// 3.35 TB/s; the backward moves 37.8 MB (x and dy read, dx written), 11 us.
// So each element is read once into registers and both statistics come
// from there, with reductions in a fixed order; what the design adds for
// this card is bytes in flight: a persistent grid (one or two blocks an SM)
// whose warps walk many rows and start the next row's loads before they
// reduce the current one.
//
// Bodies:
// * rows (widths of at most 128 vectors: 1024 bf16 columns, the main
//   path's 768 among them, and every narrow width): a team of L lanes of
//   one warp (L a power of two, 1 to 32) owns a row, each lane G <= 4
//   vectors of V; a warp runs 32 / L rows at a time, walks the rows with
//   the stride of the whole grid, and loads its next rows' vectors into
//   registers before it reduces the current ones (a register double
//   buffer; a two-stage shared-memory ring filled by cp.async.bulk
//   measured the same on an H100, so the simpler form stays). K4's
//   lanes sum dw/db in registers over all of their rows; the teams of a
//   warp combine by an xor butterfly, the 8 warps of a block by a fixed
//   pairwise tree in shared memory; one partial row a block.
// * team (the parent's body, kept for widths of 1032 to 8192 that are a
//   multiple of 8): a team of TPR threads (32..256) owns one row, each
//   thread G groups of 8 columns; one row a team, no prefetch; K4's
//   teams walk a block of rows and add their sums into shared memory one
//   team after another.
// * wide (past 8192, and widths past the rows body that are not a
//   multiple of 8): a block of TW threads (128 or 512) owns a row, each
//   thread the vectors t, t + TW, ... of it, the first few in registers
//   (the rest read again for each pass). K3 is the parent's kernel, a
//   block a row over groups of 8 (element loads where the row is not a
//   multiple of 8): rewrites over vectors of V, walking the rows or
//   not, measured slower on an H100. K4's blocks walk the rows with the stride of the
//   grid, prefetching the next row's register vectors; its threads own
//   their columns across all of the block's rows, so its partial row
//   needs no combine (vectors past the registers are added to the
//   block's partial row in place, one row after another).
//
// Determinism: no atomics. Every sum is taken in an order fixed by the
// plan, so the same inputs and plan give the same bits every run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_HIDDEN = 8192;   // the team body's widest row
constexpr int ROW_WARPS = 8;       // warps a block of the rows body
constexpr int WIDE_G = 3;          // groups of 8 a wide thread keeps in registers

enum Body { BODY_TEAM = 0, BODY_ROWS = 1, BODY_WIDE = 2 };

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// 8 consecutive elements of T: one 16-byte load/store for the half types,
// two for fp32 (the team body)
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&out)[8]) {
  if constexpr (sizeof(T) == 2) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = to_f(e[i]);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (sizeof(T) == 2) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) e[i] = from_f<T>(v[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// V consecutive elements of T as one load of V * sizeof(T) bytes (2 to 16)
template <int BYTES> struct RawOf;
template <> struct RawOf<16> { using type = uint4; };
template <> struct RawOf<8> { using type = uint2; };
template <> struct RawOf<4> { using type = unsigned int; };
template <> struct RawOf<2> { using type = unsigned short; };
template <typename T, int V> using Raw = typename RawOf<V * sizeof(T)>::type;

template <typename T, int V>
__device__ __forceinline__ Raw<T, V> load_raw(const T* p) {
  return *reinterpret_cast<const Raw<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const Raw<T, V>& r, float (&out)[V]) {
  const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_f(e[i]);
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&v)[V]) {
  Raw<T, V> r;
  T* e = reinterpret_cast<T*>(&r);
#pragma unroll
  for (int i = 0; i < V; ++i) e[i] = from_f<T>(v[i]);
  *reinterpret_cast<Raw<T, V>*>(p) = r;
}

// V fp32 parameters (w or b) at p, or `fill` where p is null
template <int V>
__device__ __forceinline__ void load_param(const float* p, int off, float fill,
                                           float (&out)[V]) {
  if (p == nullptr) {
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = fill;
    return;
  }
  p += off;
  if constexpr (V >= 4) {
#pragma unroll
    for (int k = 0; k < V / 4; ++k) {
      const float4 a = reinterpret_cast<const float4*>(p)[k];
      out[4 * k] = a.x; out[4 * k + 1] = a.y;
      out[4 * k + 2] = a.z; out[4 * k + 3] = a.w;
    }
  } else if constexpr (V == 2) {
    const float2 a = *reinterpret_cast<const float2*>(p);
    out[0] = a.x; out[1] = a.y;
  } else {
    out[0] = *p;
  }
}

// sums of (a, b) over the L lanes of a team (lanes l ^ 1, l ^ 2, ... in
// that order); every lane of the warp calls it
__device__ __forceinline__ float2 lanes_sum(float a, float b, int lanes) {
  for (int off = 1; off < lanes; off <<= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  return make_float2(a, b);
}

// Sum of (a, b) over the TPR threads of a team, in a fixed order. Every
// thread of the block must call it the same number of times (it syncs the
// block when a team spans several warps).
template <int TPR>
__device__ __forceinline__ float2 team_sum(float a, float b, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if constexpr (TPR == 32) {
    return make_float2(a, b);
  } else {
    constexpr int WPT = TPR / 32;        // warps per team
    const int warp = threadIdx.x / 32;
    __syncthreads();                     // red's previous use is over
    if ((threadIdx.x & 31) == 0) red[warp] = make_float2(a, b);
    __syncthreads();
    const int first = (warp / WPT) * WPT;
    float2 s = make_float2(0.f, 0.f);
#pragma unroll
    for (int i = 0; i < WPT; ++i) {
      s.x += red[first + i].x;
      s.y += red[first + i].y;
    }
    return s;
  }
}

// K3: one team of TPR threads per row, G groups of 8 columns per thread.
template <typename T, int TPR, int G>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      int rows, int hidden, float eps) {
  constexpr int TEAMS = THREADS / TPR;
  __shared__ float2 red[THREADS / 32];
  const int team = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int row = blockIdx.x * TEAMS + team;
  const bool row_ok = row < rows;
  const int groups = hidden / 8;
  const size_t base = (size_t)(row_ok ? row : 0) * hidden;

  float v[G][8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = t + TPR * j;
    if (row_ok && g < groups) {
      load8(x + base + 8 * g, v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[j][i];
  }
  const float inv_n = 1.f / (float)hidden;
  const float mean = team_sum<TPR>(sum, 0.f, red).x * inv_n;
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (t + TPR * j < groups) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = v[j][i] - mean;
        sq += c * c;
      }
    }
  }
  const float var = team_sum<TPR>(sq, 0.f, red).x * inv_n;
  const float rstd = 1.f / sqrtf(var + eps);
  if (!row_ok) return;                   // no block-wide sync follows
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = t + TPR * j;
    if (g >= groups) continue;
    float o[8], wv[8], bv[8];
    if (w != nullptr) {
      load8(w + 8 * g, wv);
    }
    if (b != nullptr) {
      load8(b + 8 * g, bv);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float r = (v[j][i] - mean) * rstd;
      if (w != nullptr) r = r * wv[i];
      if (b != nullptr) r = r + bv[i];
      o[i] = r;
    }
    store8(y + base + 8 * g, o);
  }
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// One partial row of the block: the teams add their register sums into
// shared memory in team order, then the block writes the row.
template <int TPR, int G>
__device__ __forceinline__ void block_partial(const float (&acc)[G][8],
                                              float* acc_s, float* out,
                                              int team, int t, int groups,
                                              int hidden) {
  constexpr int TEAMS = THREADS / TPR;
  for (int k = 0; k < TEAMS; ++k) {
    if (team == k) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = t + TPR * j;
        if (g >= groups) continue;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int c = 8 * g + i;
          acc_s[c] = (k == 0 ? 0.f : acc_s[c]) + acc[j][i];
        }
      }
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < hidden; c += THREADS) out[c] = acc_s[c];
  __syncthreads();                       // acc_s is reused by the next call
}

// K4: teams walk the block's rows [r0, r0 + rows_per_block); dx per row,
// dw/db summed per team in registers, then per block in shared memory.
template <typename T, int TPR, int G>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ mean_in,
                      const float* __restrict__ rstd_in, const T* __restrict__ dy,
                      T* __restrict__ dx, float* __restrict__ dw_part,
                      float* __restrict__ db_part, int rows, int hidden,
                      int rows_per_block) {
  constexpr int TEAMS = THREADS / TPR;
  __shared__ float2 red[THREADS / 32];
  __shared__ float acc_s[MAX_HIDDEN];
  const int team = threadIdx.x / TPR;
  const int t = threadIdx.x % TPR;
  const int groups = hidden / 8;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const float inv_n = 1.f / (float)hidden;

  float dw_acc[G][8], db_acc[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) dw_acc[j][i] = db_acc[j][i] = 0.f;

  const int iters = (rows_per_block + TEAMS - 1) / TEAMS;
  for (int it = 0; it < iters; ++it) {
    const int row = r0 + it * TEAMS + team;
    const bool row_ok = row < r1;
    const size_t base = (size_t)(row_ok ? row : 0) * hidden;
    const float mean = row_ok ? mean_in[row] : 0.f;
    const float rstd = row_ok ? rstd_in[row] : 0.f;
    float xh[G][8], gv[G][8];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = t + TPR * j;
      float xv[8], dv[8], wv[8];
      if (row_ok && g < groups) {
        load8(x + base + 8 * g, xv);
        load8(dy + base + 8 * g, dv);
        if (w != nullptr) load8(w + 8 * g, wv);
      } else {
#pragma unroll
        for (int i = 0; i < 8; ++i) xv[i] = dv[i] = wv[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float xhat = (xv[i] - mean) * rstd;
        const float wg = (w != nullptr) ? dv[i] * wv[i] : dv[i];
        xh[j][i] = xhat;
        gv[j][i] = wg;
        s1 += wg;
        s2 += wg * xhat;
        dw_acc[j][i] += dv[i] * xhat;
        db_acc[j][i] += dv[i];
      }
    }
    const float2 s = team_sum<TPR>(s1, s2, red);
    const float m1 = s.x * inv_n;
    const float m2 = s.y * inv_n;
    if (row_ok) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int g = t + TPR * j;
        if (g >= groups) continue;
        float o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          o[i] = (gv[j][i] - m1 - xh[j][i] * m2) * rstd;
        store8(dx + base + 8 * g, o);
      }
    }
  }

  block_partial<TPR, G>(dw_acc, acc_s, dw_part + (size_t)blockIdx.x * hidden,
                        team, t, groups, hidden);
  block_partial<TPR, G>(db_acc, acc_s, db_part + (size_t)blockIdx.x * hidden,
                        team, t, groups, hidden);
}

// ---------------------------------------------------------------------------
// The rows body: a team of `lanes` lanes of one warp a row; the warps walk
// the rows with the grid's stride, prefetching their next rows.

// lane t's vectors t, t + lanes, ... of `row` (zeros past the row or past
// the rows)
template <typename T, int V, int G>
__device__ __forceinline__ void load_lane(const T* src, int row, int rows,
                                          int hidden, int nvec, int t,
                                          int lanes, Raw<T, V> (&r)[G]) {
  const bool ok = row < rows;
  const T* p = src + (size_t)(ok ? row : 0) * hidden;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c = t + lanes * j;
    r[j] = (ok && c < nvec) ? load_raw<T, V>(p + (size_t)c * V) : Raw<T, V>{};
  }
}

// K3, the rows body: the next rows' vectors are loaded before the current
// rows are reduced (a register double buffer)
template <typename T, int V, int G>
__global__ void __launch_bounds__(ROW_WARPS * 32)
layer_norm_fwd_rows(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ y,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out,
                    int rows, int hidden, int lanes, float eps) {
  const int lane = threadIdx.x & 31;
  const int team = lane / lanes, t = lane % lanes, teams = 32 / lanes;
  const int first = (blockIdx.x * ROW_WARPS + threadIdx.x / 32) * teams;
  const int step = gridDim.x * ROW_WARPS * teams;
  const int nvec = hidden / V;
  const float inv_n = 1.f / (float)hidden;

  float wv[G][V], bv[G][V];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c = min(t + lanes * j, nvec - 1);
    load_param<V>(w, c * V, 1.f, wv[j]);
    load_param<V>(b, c * V, 0.f, bv[j]);
  }

  Raw<T, V> cur[G];
  load_lane<T, V, G>(x, first + team, rows, hidden, nvec, t, lanes, cur);
  for (int r0 = first; r0 < rows; r0 += step) {
    const int row = r0 + team;
    Raw<T, V> nxt[G];
    load_lane<T, V, G>(x, row + step, rows, hidden, nvec, t, lanes, nxt);

    float v[G][V];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      unpack<T, V>(cur[j], v[j]);
#pragma unroll
      for (int i = 0; i < V; ++i) sum += v[j][i];
    }
    const float mean = lanes_sum(sum, 0.f, lanes).x * inv_n;
    float sq = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      if (t + lanes * j < nvec) {
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float c = v[j][i] - mean;
          sq += c * c;
        }
      }
    }
    const float var = lanes_sum(sq, 0.f, lanes).x * inv_n;
    const float rstd = 1.f / sqrtf(var + eps);
    if (row < rows) {
      T* yr = y + (size_t)row * hidden;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = t + lanes * j;
        if (c >= nvec) continue;
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float r = (v[j][i] - mean) * rstd;
          if (w != nullptr) r = r * wv[j][i];
          if (b != nullptr) r = r + bv[j][i];
          o[i] = r;
        }
        store_vec<T, V>(yr + (size_t)c * V, o);
      }
      if (t == 0) {
        mean_out[row] = mean;
        rstd_out[row] = rstd;
      }
    }
#pragma unroll
    for (int j = 0; j < G; ++j) cur[j] = nxt[j];
  }
}

// K4, the rows body: dx a row; each lane sums dw/db of its columns over
// all of its rows in registers, the teams of a warp combine by an xor
// butterfly, the block's 8 warps by a pairwise tree in shared memory, and
// the block writes one partial row
template <typename T, int V, int G>
__global__ void __launch_bounds__(ROW_WARPS * 32)
layer_norm_bwd_rows(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ mean_in,
                    const float* __restrict__ rstd_in, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ dw_part,
                    float* __restrict__ db_part, int rows, int hidden,
                    int lanes) {
  static_assert(ROW_WARPS == 8, "the combine's tree is written for 8 warps");
  extern __shared__ float part[];      // [ROW_WARPS][hidden]
  const int lane = threadIdx.x & 31, wib = threadIdx.x / 32;
  const int team = lane / lanes, t = lane % lanes, teams = 32 / lanes;
  const int first = (blockIdx.x * ROW_WARPS + wib) * teams;
  const int step = gridDim.x * ROW_WARPS * teams;
  const int nvec = hidden / V;
  const float inv_n = 1.f / (float)hidden;

  float wv[G][V], dw_acc[G][V], db_acc[G][V];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    load_param<V>(w, min(t + lanes * j, nvec - 1) * V, 1.f, wv[j]);
#pragma unroll
    for (int i = 0; i < V; ++i) dw_acc[j][i] = db_acc[j][i] = 0.f;
  }

  Raw<T, V> cx[G], cd[G];
  int row = first + team;
  float cm = row < rows ? mean_in[row] : 0.f;
  float cr = row < rows ? rstd_in[row] : 0.f;
  load_lane<T, V, G>(x, row, rows, hidden, nvec, t, lanes, cx);
  load_lane<T, V, G>(dy, row, rows, hidden, nvec, t, lanes, cd);
  for (int r0 = first; r0 < rows; r0 += step) {
    row = r0 + team;
    const int nrow = row + step;
    const float nm = nrow < rows ? mean_in[nrow] : 0.f;
    const float nr = nrow < rows ? rstd_in[nrow] : 0.f;
    Raw<T, V> nx[G], nd[G];
    load_lane<T, V, G>(x, nrow, rows, hidden, nvec, t, lanes, nx);
    load_lane<T, V, G>(dy, nrow, rows, hidden, nvec, t, lanes, nd);

    // zeros past the row or the rows add nothing (dy is 0 there)
    float xh[G][V], g[G][V];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      float xv[V], dv[V];
      unpack<T, V>(cx[j], xv);
      unpack<T, V>(cd[j], dv);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xhat = (xv[i] - cm) * cr;
        const float wg = dv[i] * wv[j][i];
        xh[j][i] = xhat;
        g[j][i] = wg;
        s1 += wg;
        s2 += wg * xhat;
        dw_acc[j][i] += dv[i] * xhat;
        db_acc[j][i] += dv[i];
      }
    }
    const float2 s = lanes_sum(s1, s2, lanes);
    const float m1 = s.x * inv_n, m2 = s.y * inv_n;
    if (row < rows) {
      T* dxr = dx + (size_t)row * hidden;
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = t + lanes * j;
        if (c >= nvec) continue;
        float o[V];
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = (g[j][i] - m1 - xh[j][i] * m2) * cr;
        store_vec<T, V>(dxr + (size_t)c * V, o);
      }
    }
    cm = nm;
    cr = nr;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      cx[j] = nx[j];
      cd[j] = nd[j];
    }
  }

  // the warp's teams: lane l adds lane l ^ lanes, then l ^ 2 lanes, ...
  for (int off = lanes; off < 32; off <<= 1) {
#pragma unroll
    for (int j = 0; j < G; ++j)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        dw_acc[j][i] += __shfl_xor_sync(0xffffffffu, dw_acc[j][i], off);
        db_acc[j][i] += __shfl_xor_sync(0xffffffffu, db_acc[j][i], off);
      }
  }
  // the block's warps: ((w0 + w1) + (w2 + w3)) + ((w4 + w5) + (w6 + w7))
  for (int which = 0; which < 2; ++which) {
    if (which) __syncthreads();        // dw's reads of `part` are over
    if (team == 0) {
#pragma unroll
      for (int j = 0; j < G; ++j) {
        const int c = t + lanes * j;
        if (c >= nvec) continue;
#pragma unroll
        for (int i = 0; i < V; ++i)
          part[wib * hidden + c * V + i] = which ? db_acc[j][i] : dw_acc[j][i];
      }
    }
    __syncthreads();
    float* out = (which ? db_part : dw_part) + (size_t)blockIdx.x * hidden;
    for (int col = threadIdx.x; col < hidden; col += ROW_WARPS * 32) {
      const float* p = part + col;
      out[col] = ((p[0] + p[hidden]) + (p[2 * hidden] + p[3 * hidden])) +
                 ((p[4 * hidden] + p[5 * hidden]) +
                  (p[6 * hidden] + p[7 * hidden]));
    }
  }
}

// ---------------------------------------------------------------------------
// The wide body: a block of TW threads a row; the blocks walk the rows
// with the grid's stride, prefetching the next row's register vectors.

template <typename T, int V, int G, int TW>
__device__ __forceinline__ void load_block(const T* src, int row, int rows,
                                           int hidden, int nvec,
                                           Raw<T, V> (&r)[G]) {
  load_lane<T, V, G>(src, row, rows, hidden, nvec, threadIdx.x, TW, r);
}

// sum of (a, b) over the block's TW threads in a fixed order; every thread
// gets it
template <int TW>
__device__ __forceinline__ float2 block_sum(float a, float b, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  __syncthreads();                       // red's previous use is over
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = make_float2(a, b);
  __syncthreads();
  float2 s = make_float2(0.f, 0.f);
#pragma unroll
  for (int i = 0; i < TW / 32; ++i) {
    s.x += red[i].x;
    s.y += red[i].y;
  }
  return s;
}

// group g (columns 8g .. 8g + 7) of a row: one vector where VEC, else
// element by element with the columns past hidden read as 0
template <typename T, bool VEC>
__device__ __forceinline__ void load_group(const T* row, int g, int hidden,
                                           float (&out)[8]) {
  if constexpr (VEC) {
    load8(row + 8 * g, out);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * g + i;
      out[i] = c < hidden ? to_f(row[c]) : 0.f;
    }
  }
}

template <typename T, bool VEC>
__device__ __forceinline__ void store_group(T* row, int g, int hidden,
                                            const float (&v)[8]) {
  if constexpr (VEC) {
    store8(row + 8 * g, v);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (8 * g + i < hidden) row[8 * g + i] = from_f<T>(v[i]);
  }
}

// y of group g from x's values v
template <typename T, bool VEC>
__device__ __forceinline__ void norm_group(const float (&v)[8], const float* w,
                                           const float* b, T* yr, int g,
                                           int hidden, float mean,
                                           float rstd) {
  float o[8], wv[8], bv[8];
  if (w != nullptr) load_group<float, VEC>(w, g, hidden, wv);
  if (b != nullptr) load_group<float, VEC>(b, g, hidden, bv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float r = (v[i] - mean) * rstd;
    if (w != nullptr) r = r * wv[i];
    if (b != nullptr) r = r + bv[i];
    o[i] = r;
  }
  store_group<T, VEC>(yr, g, hidden, o);
}

// K3, the wide body, the parent's (a rewrite over vectors of V, and one
// walking the rows with a prefetch, measured slower on an H100): a block a
// row; the first WIDE_G groups of 8 of a thread stay in registers, later
// ones are read again for each pass; rows not a multiple of 8 load
// element by element
template <typename T, int TW, bool VEC>
__global__ void __launch_bounds__(TW)
layer_norm_fwd_wide(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ b, T* __restrict__ y,
                    float* __restrict__ mean_out, float* __restrict__ rstd_out,
                    int hidden, float eps) {
  constexpr int G = WIDE_G;
  __shared__ float2 red[TW / 32];
  const int t = threadIdx.x;
  const int groups = (hidden + 7) / 8;
  const size_t base = (size_t)blockIdx.x * hidden;
  const T* xr = x + base;

  float v[G][8];
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = t + TW * j;
    if (g < groups) {
      load_group<T, VEC>(xr, g, hidden, v[j]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[j][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += v[j][i];
  }
  for (int g = t + TW * G; g < groups; g += TW) {
    float u[8];
    load_group<T, VEC>(xr, g, hidden, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) sum += u[i];
  }
  const float inv_n = 1.f / (float)hidden;
  const float mean = block_sum<TW>(sum, 0.f, red).x * inv_n;
  // (x - mean)^2 over the row's columns only: the zeros past hidden of
  // an unaligned row are not elements
  float sq = 0.f;
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = t + TW * j;
    if (g < groups) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float c = v[j][i] - mean;
        if (VEC || 8 * g + i < hidden) sq += c * c;
      }
    }
  }
  for (int g = t + TW * G; g < groups; g += TW) {
    float u[8];
    load_group<T, VEC>(xr, g, hidden, u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float c = u[i] - mean;
      if (VEC || 8 * g + i < hidden) sq += c * c;
    }
  }
  const float var = block_sum<TW>(sq, 0.f, red).x * inv_n;
  const float rstd = 1.f / sqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = t + TW * j;
    if (g < groups) norm_group<T, VEC>(v[j], w, b, y + base, g, hidden, mean, rstd);
  }
  for (int g = t + TW * G; g < groups; g += TW) {
    float u[8];
    load_group<T, VEC>(xr, g, hidden, u);
    norm_group<T, VEC>(u, w, b, y + base, g, hidden, mean, rstd);
  }
  if (t == 0) {
    mean_out[blockIdx.x] = mean;
    rstd_out[blockIdx.x] = rstd;
  }
}

// vectors a thread of K4's wide body keeps in registers: x and dy of this
// row and the next (each element a register at least) and the fp32
// dw/db sums within about 96 registers; 24 elements for bf16/fp16
// vectors of 2 to 8, 16 for single elements, 12 for fp32
template <typename T, int V>
__host__ __device__ constexpr int wide_bwd_g() {
  return (sizeof(T) == 4 ? 12 : V == 1 ? 16 : 8 * WIDE_G) / V;
}

// xhat and the weighted gradient of one vector (x's and dy's raw values)
template <typename T, int V>
__device__ __forceinline__ void bwd_vec(const Raw<T, V>& xr, const Raw<T, V>& dr,
                                        const float* w, int c, float mean,
                                        float rstd, float (&xh)[V],
                                        float (&dv)[V], float (&wg)[V]) {
  float xv[V], wv[V];
  unpack<T, V>(xr, xv);
  unpack<T, V>(dr, dv);
  load_param<V>(w, c * V, 1.f, wv);
#pragma unroll
  for (int i = 0; i < V; ++i) {
    xh[i] = (xv[i] - mean) * rstd;
    wg[i] = dv[i] * wv[i];
  }
}

// K4, the wide body: a block walks its rows (blockIdx.x, + gridDim.x, ...);
// dx a row; the dW/dB partials of a thread's columns over all of the
// block's rows, in registers for its first G vectors and, for later ones,
// added to the block's partial row in place (the block's first row writes
// them)
template <typename T, int V, int TW>
__global__ void __launch_bounds__(TW)
layer_norm_bwd_wide(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ mean_in,
                    const float* __restrict__ rstd_in, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ dw_part,
                    float* __restrict__ db_part, int rows, int hidden) {
  constexpr int G = wide_bwd_g<T, V>();
  __shared__ float2 red[TW / 32];
  const int t = threadIdx.x;
  const int nvec = hidden / V;
  const float inv_n = 1.f / (float)hidden;
  float* dwp = dw_part + (size_t)blockIdx.x * hidden;
  float* dbp = db_part + (size_t)blockIdx.x * hidden;

  float dw_acc[G][V], db_acc[G][V];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < V; ++i) dw_acc[j][i] = db_acc[j][i] = 0.f;

  Raw<T, V> cx[G], cd[G];
  int row = blockIdx.x;
  load_block<T, V, G, TW>(x, row, rows, hidden, nvec, cx);
  load_block<T, V, G, TW>(dy, row, rows, hidden, nvec, cd);
  float cm = row < rows ? mean_in[row] : 0.f;
  float cr = row < rows ? rstd_in[row] : 0.f;
  for (; row < rows; row += gridDim.x) {
    const int nrow = row + gridDim.x;
    Raw<T, V> nx[G], nd[G];
    load_block<T, V, G, TW>(x, nrow, rows, hidden, nvec, nx);
    load_block<T, V, G, TW>(dy, nrow, rows, hidden, nvec, nd);
    const float nm = nrow < rows ? mean_in[nrow] : 0.f;
    const float nr = nrow < rows ? rstd_in[nrow] : 0.f;
    const T* xr = x + (size_t)row * hidden;
    const T* dyr = dy + (size_t)row * hidden;

    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int c = t + TW * j;
      if (c >= nvec) continue;
      float xh[V], dv[V], wg[V];
      bwd_vec<T, V>(cx[j], cd[j], w, c, cm, cr, xh, dv, wg);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1 += wg[i];
        s2 += wg[i] * xh[i];
        dw_acc[j][i] += dv[i] * xh[i];
        db_acc[j][i] += dv[i];
      }
    }
    for (int c = t + TW * G; c < nvec; c += TW) {
      float xh[V], dv[V], wg[V];
      bwd_vec<T, V>(load_raw<T, V>(xr + (size_t)c * V),
                    load_raw<T, V>(dyr + (size_t)c * V), w, c, cm, cr, xh, dv,
                    wg);
      const bool first = row == (int)blockIdx.x;
#pragma unroll
      for (int i = 0; i < V; ++i) {
        s1 += wg[i];
        s2 += wg[i] * xh[i];
        const int e = c * V + i;
        dwp[e] = (first ? 0.f : dwp[e]) + dv[i] * xh[i];
        dbp[e] = (first ? 0.f : dbp[e]) + dv[i];
      }
    }
    const float2 s = block_sum<TW>(s1, s2, red);
    const float m1 = s.x * inv_n, m2 = s.y * inv_n;
    T* dxr = dx + (size_t)row * hidden;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int c = t + TW * j;
      if (c >= nvec) continue;
      float xh[V], dv[V], wg[V], o[V];
      bwd_vec<T, V>(cx[j], cd[j], w, c, cm, cr, xh, dv, wg);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = (wg[i] - m1 - xh[i] * m2) * cr;
      store_vec<T, V>(dxr + (size_t)c * V, o);
    }
    for (int c = t + TW * G; c < nvec; c += TW) {
      float xh[V], dv[V], wg[V], o[V];
      bwd_vec<T, V>(load_raw<T, V>(xr + (size_t)c * V),
                    load_raw<T, V>(dyr + (size_t)c * V), w, c, cm, cr, xh, dv,
                    wg);
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = (wg[i] - m1 - xh[i] * m2) * cr;
      store_vec<T, V>(dxr + (size_t)c * V, o);
    }
    cm = nm;
    cr = nr;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      cx[j] = nx[j];
      cd[j] = nd[j];
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int c = t + TW * j;
    if (c >= nvec) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      dwp[c * V + i] = dw_acc[j][i];
      dbp[c * V + i] = db_acc[j][i];
    }
  }
}

// ---------------------------------------------------------------------------
// K4's second stage: dw and db [hidden] from the [nparts, hidden] partials.
// A block takes 32 columns of one of them; its SUM_SLICES warps each add
// the partial rows s, s + SUM_SLICES, ... of a column in order, then a
// pairwise tree adds the slices.

constexpr int SUM_SLICES = 16;

__global__ void __launch_bounds__(32 * SUM_SLICES)
layer_norm_partials_sum(const float* __restrict__ dw_part,
                        const float* __restrict__ db_part,
                        float* __restrict__ dw, float* __restrict__ db,
                        int nparts, int hidden) {
  __shared__ float s_part[SUM_SLICES][32];
  const int lane = threadIdx.x & 31, slice = threadIdx.x / 32;
  const int col = blockIdx.x * 32 + lane;
  const float* src = blockIdx.y ? db_part : dw_part;
  float s = 0.f;
  if (col < hidden) {
#pragma unroll 8
    for (int p = slice; p < nparts; p += SUM_SLICES)
      s += src[(size_t)p * hidden + col];
  }
  s_part[slice][lane] = s;
  __syncthreads();
  for (int n = SUM_SLICES / 2; n > 0; n >>= 1) {
    if (slice < n) s_part[slice][lane] += s_part[slice + n][lane];
    __syncthreads();
  }
  if (slice == 0 && col < hidden) (blockIdx.y ? db : dw)[col] = s_part[0][lane];
}

// ---------------------------------------------------------------------------
// Launchers

template <typename T, int V, int G>
cudaError_t launch_fwd_rows(int grid, int lanes, int rows, const void* x,
                            const void* w, const void* b, void* y, void* mean,
                            void* rstd, int hidden, float eps, cudaStream_t st) {
  layer_norm_fwd_rows<T, V, G><<<grid, ROW_WARPS * 32, 0, st>>>(
      (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mean,
      (float*)rstd, rows, hidden, lanes, eps);
  return cudaGetLastError();
}

// K4's rows body takes ROW_WARPS x hidden floats of dynamic shared memory
// for its combine (at most 32 KB)
template <typename T, int V, int G>
cudaError_t launch_bwd_rows(int grid, int lanes, int rows, const void* x,
                            const void* w, const void* mean, const void* rstd,
                            const void* dy, void* dx, void* dw, void* db,
                            int hidden, cudaStream_t st) {
  layer_norm_bwd_rows<T, V, G>
      <<<grid, ROW_WARPS * 32, ROW_WARPS * hidden * sizeof(float), st>>>(
          (const T*)x, (const float*)w, (const float*)mean, (const float*)rstd,
          (const T*)dy, (T*)dx, (float*)dw, (float*)db, rows, hidden, lanes);
  return cudaGetLastError();
}

template <typename T, int TW, bool VEC>
cudaError_t launch_fwd_wide(int rows, const void* x, const void* w,
                            const void* b, void* y, void* mean, void* rstd,
                            int hidden, float eps, cudaStream_t st) {
  layer_norm_fwd_wide<T, TW, VEC><<<rows, TW, 0, st>>>(
      (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mean,
      (float*)rstd, hidden, eps);
  return cudaGetLastError();
}

template <typename T, int V, int TW>
cudaError_t launch_bwd_wide(int grid, int rows, const void* x, const void* w,
                            const void* mean, const void* rstd, const void* dy,
                            void* dx, void* dw, void* db, int hidden,
                            cudaStream_t st) {
  layer_norm_bwd_wide<T, V, TW><<<grid, TW, 0, st>>>(
      (const T*)x, (const float*)w, (const float*)mean, (const float*)rstd,
      (const T*)dy, (T*)dx, (float*)dw, (float*)db, rows, hidden);
  return cudaGetLastError();
}

template <typename T, int TPR, int G>
cudaError_t launch_fwd(int rows, const void* x, const void* w, const void* b,
                       void* y, void* mean, void* rstd, int hidden, float eps,
                       cudaStream_t st) {
  const int teams = THREADS / TPR;
  const dim3 grid((rows + teams - 1) / teams);
  layer_norm_fwd_kernel<T, TPR, G><<<grid, THREADS, 0, st>>>(
      (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mean,
      (float*)rstd, rows, hidden, eps);
  return cudaGetLastError();
}

template <typename T, int TPR, int G>
cudaError_t launch_bwd(int nblocks, const void* x, const void* w,
                       const void* mean, const void* rstd, const void* dy,
                       void* dx, void* dw, void* db, int rows, int hidden,
                       int rows_per_block, cudaStream_t st) {
  layer_norm_bwd_kernel<T, TPR, G><<<nblocks, THREADS, 0, st>>>(
      (const T*)x, (const float*)w, (const float*)mean, (const float*)rstd,
      (const T*)dy, (T*)dx, (float*)dw, (float*)db, rows, hidden,
      rows_per_block);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Dispatch of the plan's runtime choices onto the instantiations

// G of the team body (groups of 8 a thread) or 0 where TPR does not fit
int team_g(int hidden, int tpr) {
  if (hidden % 8 || hidden > MAX_HIDDEN || tpr < 32 || tpr > THREADS ||
      (tpr & (tpr - 1)))
    return 0;
  const int g = (hidden / 8 + tpr - 1) / tpr;
  return g <= 4 ? g : 0;
}

// G of the rows body (vectors a lane) or 0 where the lanes do not fit
int rows_g(int hidden, int vec, int lanes) {
  if (lanes < 1 || lanes > 32 || (lanes & (lanes - 1))) return 0;
  const int g = (hidden / vec + lanes - 1) / lanes;
  return g <= 4 ? g : 0;
}

bool vec_ok(int vec, int elem, int hidden) {
  return (vec == 1 || vec == 2 || vec == 4 || vec == 8) && vec * elem <= 16 &&
         hidden % vec == 0;
}

// whether (body, vec, lanes, grid) is a plan the kernels take for this
// shape; G is set for the bodies that have one
bool plan_ok(int body, int vec, int lanes, int grid, int rows, int hidden,
             int dtype, bool backward, int* g) {
  if (rows < 1 || hidden < 1 || dtype < 0 || dtype > 2 || grid < 1)
    return false;
  const int elem = dtype == 2 ? 4 : 2;
  switch (body) {
    case BODY_TEAM:
      *g = team_g(hidden, lanes);
      return vec == 8 && *g > 0;
    case BODY_ROWS:
      if (!vec_ok(vec, elem, hidden)) return false;
      *g = rows_g(hidden, vec, lanes);
      return *g > 0;
    case BODY_WIDE:
      *g = 0;
      if (lanes != 128 && lanes != 512) return false;
      if (!backward)   // the parent's K3: a block a row, groups of 8 or elements
        return vec == (hidden % 8 == 0 ? 8 : 1) && grid == rows;
      return vec_ok(vec, elem, hidden) && grid <= rows;
    default:
      return false;
  }
}

// CALL(T, V, G) for the runtime (dtype, vec, g) of the rows body
#define LN_ROWS_B(T, V, CALL)                  \
  switch (g) {                                 \
    case 1: return CALL(T, V, 1);              \
    case 2: return CALL(T, V, 2);              \
    case 3: return CALL(T, V, 3);              \
    default: return CALL(T, V, 4);             \
  }
#define LN_ROWS_HALF(T, CALL)                  \
  switch (vec) {                               \
    case 8: LN_ROWS_B(T, 8, CALL)              \
    case 4: LN_ROWS_B(T, 4, CALL)              \
    case 2: LN_ROWS_B(T, 2, CALL)              \
    default: LN_ROWS_B(T, 1, CALL)             \
  }
#define LN_ROWS(CALL)                                    \
  switch (dtype) {                                       \
    case 0: LN_ROWS_HALF(__nv_bfloat16, CALL)            \
    case 1: LN_ROWS_HALF(__half, CALL)                   \
    default:                                             \
      switch (vec) {                                     \
        case 4: LN_ROWS_B(float, 4, CALL)                \
        case 2: LN_ROWS_B(float, 2, CALL)                \
        default: LN_ROWS_B(float, 1, CALL)               \
      }                                                  \
  }

// CALL(T, V, TW) for the runtime (dtype, vec, lanes) of K4's wide body
#define LN_WIDE_TW(T, V, CALL)                 \
  if (lanes == 128) return CALL(T, V, 128);    \
  return CALL(T, V, 512);
#define LN_WIDE_HALF(T, CALL)                  \
  switch (vec) {                               \
    case 8: LN_WIDE_TW(T, 8, CALL)             \
    case 4: LN_WIDE_TW(T, 4, CALL)             \
    case 2: LN_WIDE_TW(T, 2, CALL)             \
    default: LN_WIDE_TW(T, 1, CALL)            \
  }
#define LN_WIDE(CALL)                                    \
  switch (dtype) {                                       \
    case 0: LN_WIDE_HALF(__nv_bfloat16, CALL)            \
    case 1: LN_WIDE_HALF(__half, CALL)                   \
    default:                                             \
      switch (vec) {                                     \
        case 4: LN_WIDE_TW(float, 4, CALL)               \
        case 2: LN_WIDE_TW(float, 2, CALL)               \
        default: LN_WIDE_TW(float, 1, CALL)              \
      }                                                  \
  }

// CALL(T, TPR, G) for the runtime (dtype, tpr, g) of the team body
#define LN_TEAM_G(T, TPR, CALL)                \
  switch (g) {                                 \
    case 1: return CALL(T, TPR, 1);            \
    case 2: return CALL(T, TPR, 2);            \
    case 3: return CALL(T, TPR, 3);            \
    default: return CALL(T, TPR, 4);           \
  }
#define LN_TEAM_TPR(T, CALL)                   \
  switch (lanes) {                             \
    case 32: LN_TEAM_G(T, 32, CALL)            \
    case 64: LN_TEAM_G(T, 64, CALL)            \
    case 128: LN_TEAM_G(T, 128, CALL)          \
    default: LN_TEAM_G(T, 256, CALL)           \
  }
#define LN_TEAM(CALL)                                    \
  switch (dtype) {                                       \
    case 0: LN_TEAM_TPR(__nv_bfloat16, CALL)             \
    case 1: LN_TEAM_TPR(__half, CALL)                    \
    default: LN_TEAM_TPR(float, CALL)                    \
  }

cudaError_t fwd(int body, int vec, int lanes, int grid, int g, int rows,
                const void* x, const void* w, const void* b, void* y,
                void* mean, void* rstd, int hidden, float eps, int dtype,
                cudaStream_t st) {
  if (body == BODY_TEAM) {
    if ((long long)grid * (THREADS / lanes) < rows) return cudaErrorInvalidValue;
#define LN_FWD_TEAM(T, TPR_, G_) \
  launch_fwd<T, TPR_, G_>(rows, x, w, b, y, mean, rstd, hidden, eps, st)
    LN_TEAM(LN_FWD_TEAM)
#undef LN_FWD_TEAM
  }
  if (body == BODY_WIDE) {
#define LN_FWD_WIDE(T, TW_, VEC_) \
  launch_fwd_wide<T, TW_, VEC_>(rows, x, w, b, y, mean, rstd, hidden, eps, st)
#define LN_FWD_WIDE_VEC(T)                                   \
  if (vec == 8) {                                            \
    if (lanes == 128) return LN_FWD_WIDE(T, 128, true);      \
    return LN_FWD_WIDE(T, 512, true);                        \
  }                                                          \
  if (lanes == 128) return LN_FWD_WIDE(T, 128, false);       \
  return LN_FWD_WIDE(T, 512, false);
    switch (dtype) {
      case 0: LN_FWD_WIDE_VEC(__nv_bfloat16)
      case 1: LN_FWD_WIDE_VEC(__half)
      default: LN_FWD_WIDE_VEC(float)
    }
#undef LN_FWD_WIDE_VEC
#undef LN_FWD_WIDE
  }
#define LN_FWD_ROWS(T, V_, G_)                                        \
  launch_fwd_rows<T, V_, G_>(grid, lanes, rows, x, w, b, y, mean, rstd, \
                             hidden, eps, st)
  LN_ROWS(LN_FWD_ROWS)
#undef LN_FWD_ROWS
}

cudaError_t bwd(int body, int vec, int lanes, int grid, int g, int rows,
                const void* x, const void* w, const void* mean,
                const void* rstd, const void* dy, void* dx, void* dw_part,
                void* db_part, int hidden, int dtype, cudaStream_t st) {
  if (body == BODY_TEAM) {
    // the parent's partition: blocks of rows_per_block rows, none empty
    const int rpb = (rows + grid - 1) / grid;
    if ((long long)rpb * (grid - 1) >= rows) return cudaErrorInvalidValue;
#define LN_BWD_TEAM(T, TPR_, G_)                                          \
  launch_bwd<T, TPR_, G_>(grid, x, w, mean, rstd, dy, dx, dw_part, db_part, \
                          rows, hidden, rpb, st)
    LN_TEAM(LN_BWD_TEAM)
#undef LN_BWD_TEAM
  }
  if (body == BODY_WIDE) {
#define LN_BWD_WIDE(T, V_, TW_)                                            \
  launch_bwd_wide<T, V_, TW_>(grid, rows, x, w, mean, rstd, dy, dx, dw_part, \
                              db_part, hidden, st)
    LN_WIDE(LN_BWD_WIDE)
#undef LN_BWD_WIDE
  }
#define LN_BWD_ROWS(T, V_, G_)                                         \
  launch_bwd_rows<T, V_, G_>(grid, lanes, rows, x, w, mean, rstd, dy, dx, \
                             dw_part, db_part, hidden, st)
  LN_ROWS(LN_BWD_ROWS)
#undef LN_BWD_ROWS
}

}  // namespace

// K3 under the plan (body, vec, lanes, grid) of ops/layer_norm_cuda.plan
extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mean, void* rstd, int rows,
                              int hidden, float eps, int body, int vec,
                              int lanes, int grid, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int g = 0;
  if (!plan_ok(body, vec, lanes, grid, rows, hidden, dtype, false, &g))
    return (int)cudaErrorInvalidValue;
  return (int)fwd(body, vec, lanes, grid, g, rows, x, w, b, y, mean, rstd,
                  hidden, eps, dtype, (cudaStream_t)stream);
}

// K4 under the plan: dx, the [grid, hidden] partials (scratch the caller
// allocates), then dw and db [hidden] summed from them by the second stage
extern "C" int layer_norm_bwd(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* dy, void* dx,
                              void* dw_part, void* db_part, void* dw, void* db,
                              int rows, int hidden, int body, int vec,
                              int lanes, int grid, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  int g = 0;
  if (!plan_ok(body, vec, lanes, grid, rows, hidden, dtype, true, &g))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  err = bwd(body, vec, lanes, grid, g, rows, x, w, mean, rstd, dy, dx,
            dw_part, db_part, hidden, dtype, st);
  if (err != cudaSuccess) return (int)err;
  layer_norm_partials_sum<<<dim3((hidden + 31) / 32, 2), 32 * SUM_SLICES, 0,
                            st>>>((const float*)dw_part, (const float*)db_part,
                                  (float*)dw, (float*)db, grid, hidden);
  return (int)cudaGetLastError();
}

extern "C" const char* layer_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

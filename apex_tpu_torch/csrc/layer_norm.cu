// Row layer norm, forward (K3) and backward (K4).
//
// Replaces apex_tpu/ops/layer_norm_pallas.py:171 _fwd (its pallas_call at
// :185, kernel _fwd_kernel :102) and :215 _bwd_rule (pallas_call :222,
// kernel _bwd_kernel :122). Semantics are those kernels': fp32 row
// statistics (the mean, then the mean of (x - mean)^2, rstd = 1/sqrt(var +
// eps)), normalize, optional fp32 affine, y in x's dtype; the forward saves
// only the fp32 per-row mean and rstd. The backward recomputes xhat from x
// and the saved statistics, writes dx in x's dtype, and writes the affine
// gradients as per-block fp32 partials [nblocks, hidden] (dw = sum dy*xhat,
// db = sum dy over the block's rows) that the caller sums, as the JAX
// package sums its per-block partials outside the kernel (:244-245).
//
// Layout: x, y, dy, dx [rows, hidden] contiguous, one dtype (bf16, fp16 or
// fp32); w, b [hidden] fp32 or null (no affine); mean, rstd [rows] fp32.
// Any hidden >= 1. Where hidden is a multiple of 8 every row pointer is
// 16-byte aligned (the wrapper checks) and the rows move in 16-byte
// vectors; other widths (a bf16 row of 100 has a 200-byte stride) take
// scalar loads.
//
// What bounds it on H100: both kernels are bandwidth-bound. At the
// training shape (rows 8192 = b*s, hidden 768, bf16) the forward moves
// 25.2 MB (x read, y written) for ~8 flops per element, 7.5 us at
// 3.35 TB/s; the backward moves 37.8 MB (x and dy read, dx written), 11 us.
// So the design reads each element once, from registers: a team of TPR
// threads (32..256, a power of two) owns one row, each thread holding G
// groups of 8 consecutive columns (one 16-byte load per group for the
// half types), and both statistics come from those registers with team
// reductions in a fixed order. The TPU kernel's row block in VMEM becomes
// the team's registers.
//
// Determinism: no atomics. In the backward each team accumulates its own
// rows' dw/db in registers; the teams of a block add their sums into
// shared memory one team after another (a fixed order) and the block
// writes one partial row. The same inputs give the same bits every run.
//
// That body takes hidden % 8 == 0 up to 8192 (the main path, 768). Other
// widths take the row-per-block body (layer_norm_{fwd,bwd}_wide): one
// team of TW threads (a whole block, 512 for wide rows, 128 for narrow
// unaligned ones) per row, each thread owning the groups t, t + TW, ... of
// every row. The forward keeps its first G groups of x in registers and
// reads the rest again for the later passes (the mean first, then the
// mean of (x - mean)^2, then y, as the team body computes them). The
// backward's threads own their columns across all of the block's rows, so
// the dW/dB partials of the first G groups are summed in registers and
// written straight to the block's partial row in global memory (no shared
// accumulator, no atomics), and those of later groups are added to that
// row in place by their owning thread, one row after another; dx's pass
// reads x and dy again. Unaligned widths load element by element.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_HIDDEN = 8192;   // the team body's widest row

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
// two for fp32.
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
// The row-per-block body: widths past 8192 and widths that are not a
// multiple of 8.

constexpr int WIDE_G = 3;          // groups of 8 a thread keeps in registers

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

// K3, a row per block: the first WIDE_G groups of a thread stay in
// registers, later ones are read again for each pass
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

// xhat and the weighted gradient of group g of one row (zeros past hidden)
template <typename T, bool VEC>
__device__ __forceinline__ void bwd_group(const T* xr, const T* dyr,
                                          const float* w, int g, int hidden,
                                          float mean, float rstd,
                                          float (&xh)[8], float (&dv)[8],
                                          float (&wg)[8]) {
  float xv[8], wv[8];
  load_group<T, VEC>(xr, g, hidden, xv);
  load_group<T, VEC>(dyr, g, hidden, dv);
  if (w != nullptr) load_group<float, VEC>(w, g, hidden, wv);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    xh[i] = (xv[i] - mean) * rstd;
    wg[i] = (w != nullptr) ? dv[i] * wv[i] : dv[i];
  }
}

// K4, a block of TW threads walks its rows one at a time; dx per row, the
// dW/dB partials of a thread's columns over all of the block's rows
template <typename T, int TW, bool VEC>
__global__ void __launch_bounds__(TW)
layer_norm_bwd_wide(const T* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ mean_in,
                    const float* __restrict__ rstd_in, const T* __restrict__ dy,
                    T* __restrict__ dx, float* __restrict__ dw_part,
                    float* __restrict__ db_part, int rows, int hidden,
                    int rows_per_block) {
  constexpr int G = WIDE_G;
  __shared__ float2 red[TW / 32];
  const int t = threadIdx.x;
  const int groups = (hidden + 7) / 8;
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  const float inv_n = 1.f / (float)hidden;
  float* dwp = dw_part + (size_t)blockIdx.x * hidden;
  float* dbp = db_part + (size_t)blockIdx.x * hidden;

  float dw_acc[G][8], db_acc[G][8];
#pragma unroll
  for (int j = 0; j < G; ++j)
#pragma unroll
    for (int i = 0; i < 8; ++i) dw_acc[j][i] = db_acc[j][i] = 0.f;

  for (int row = r0; row < r1; ++row) {
    const size_t base = (size_t)row * hidden;
    const float mean = mean_in[row], rstd = rstd_in[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < G; ++j) {
      const int g = t + TW * j;
      if (g >= groups) continue;
      float xh[8], dv[8], wg[8];
      bwd_group<T, VEC>(x + base, dy + base, w, g, hidden, mean, rstd, xh, dv, wg);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1 += wg[i];
        s2 += wg[i] * xh[i];
        dw_acc[j][i] += dv[i] * xh[i];
        db_acc[j][i] += dv[i];
      }
    }
    // groups past the registers: this thread's columns of the block's
    // partial rows, added to in place (the first row writes them)
    for (int g = t + TW * G; g < groups; g += TW) {
      float xh[8], dv[8], wg[8];
      bwd_group<T, VEC>(x + base, dy + base, w, g, hidden, mean, rstd, xh, dv, wg);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s1 += wg[i];
        s2 += wg[i] * xh[i];
        const int c = 8 * g + i;
        if (VEC || c < hidden) {
          dwp[c] = (row == r0 ? 0.f : dwp[c]) + dv[i] * xh[i];
          dbp[c] = (row == r0 ? 0.f : dbp[c]) + dv[i];
        }
      }
    }
    const float2 s = block_sum<TW>(s1, s2, red);
    const float m1 = s.x * inv_n;
    const float m2 = s.y * inv_n;
    for (int g = t; g < groups; g += TW) {
      float xh[8], dv[8], wg[8], o[8];
      bwd_group<T, VEC>(x + base, dy + base, w, g, hidden, mean, rstd, xh, dv, wg);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = (wg[i] - m1 - xh[i] * m2) * rstd;
      store_group<T, VEC>(dx + base, g, hidden, o);
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int g = t + TW * j;
    if (g >= groups) continue;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int c = 8 * g + i;
      if (VEC || c < hidden) {
        dwp[c] = dw_acc[j][i];
        dbp[c] = db_acc[j][i];
      }
    }
  }
}

// the team body takes the row (the main path)
bool team_row(int hidden) { return hidden % 8 == 0 && hidden <= MAX_HIDDEN; }

// threads of the row-per-block body: 128 for unaligned rows whose groups
// fit 128 threads' registers, else 512
int wide_threads(int hidden) {
  return (hidden % 8 != 0 && (hidden + 7) / 8 <= 128 * WIDE_G) ? 128 : 512;
}

template <typename T>
cudaError_t launch_fwd_wide(int rows, const void* x, const void* w, const void* b,
                            void* y, void* mean, void* rstd, int hidden, float eps,
                            cudaStream_t st) {
#define LN_FWD_WIDE(TW, VEC)                                                  \
  layer_norm_fwd_wide<T, TW, VEC><<<rows, TW, 0, st>>>(                       \
      (const T*)x, (const float*)w, (const float*)b, (T*)y, (float*)mean,     \
      (float*)rstd, hidden, eps)
  if (hidden % 8 == 0) LN_FWD_WIDE(512, true);
  else if (wide_threads(hidden) == 128) LN_FWD_WIDE(128, false);
  else LN_FWD_WIDE(512, false);
#undef LN_FWD_WIDE
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_wide(int nblocks, const void* x, const void* w,
                            const void* mean, const void* rstd, const void* dy,
                            void* dx, void* dw, void* db, int rows, int hidden,
                            int rows_per_block, cudaStream_t st) {
#define LN_BWD_WIDE(TW, VEC)                                                  \
  layer_norm_bwd_wide<T, TW, VEC><<<nblocks, TW, 0, st>>>(                    \
      (const T*)x, (const float*)w, (const float*)mean, (const float*)rstd,  \
      (const T*)dy, (T*)dx, (float*)dw, (float*)db, rows, hidden,            \
      rows_per_block)
  if (hidden % 8 == 0) LN_BWD_WIDE(512, true);
  else if (wide_threads(hidden) == 128) LN_BWD_WIDE(128, false);
  else LN_BWD_WIDE(512, false);
#undef LN_BWD_WIDE
  return cudaGetLastError();
}

// threads per row: the smallest team whose G <= 4 groups cover the row
int pick_tpr(int hidden) {
  const int groups = hidden / 8;
  for (int tpr = 32; tpr <= THREADS; tpr *= 2)
    if (groups <= 4 * tpr) return tpr;
  return 0;
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

// Calls F<T, TPR, G>::run(args...) for the runtime (dtype, tpr, g).
#define LN_DISPATCH_G(T, TPR, G, CALL)          \
  switch (G) {                                   \
    case 1: return CALL(T, TPR, 1);              \
    case 2: return CALL(T, TPR, 2);              \
    case 3: return CALL(T, TPR, 3);              \
    default: return CALL(T, TPR, 4);             \
  }

#define LN_DISPATCH_TPR(T, TPR, G, CALL)         \
  switch (TPR) {                                 \
    case 32: LN_DISPATCH_G(T, 32, G, CALL)       \
    case 64: LN_DISPATCH_G(T, 64, G, CALL)       \
    case 128: LN_DISPATCH_G(T, 128, G, CALL)     \
    default: LN_DISPATCH_G(T, 256, G, CALL)      \
  }

#define LN_DISPATCH(DTYPE, TPR, G, CALL)                          \
  switch (DTYPE) {                                                \
    case 0: LN_DISPATCH_TPR(__nv_bfloat16, TPR, G, CALL)          \
    case 1: LN_DISPATCH_TPR(__half, TPR, G, CALL)                 \
    default: LN_DISPATCH_TPR(float, TPR, G, CALL)                 \
  }

bool bad_shape(int rows, int hidden, int dtype) {
  return rows < 1 || hidden < 1 || dtype < 0 || dtype > 2;
}

#define LN_DISPATCH_DTYPE(DTYPE, CALL)                     \
  switch (DTYPE) {                                         \
    case 0: return CALL(__nv_bfloat16);                    \
    case 1: return CALL(__half);                           \
    default: return CALL(float);                           \
  }

}  // namespace

extern "C" int layer_norm_fwd(const void* x, const void* w, const void* b,
                              void* y, void* mean, void* rstd, int rows,
                              int hidden, float eps, int dtype, int device,
                              void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(rows, hidden, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!team_row(hidden)) {
#define LN_FWD_WIDE_CALL(T) \
  (int)launch_fwd_wide<T>(rows, x, w, b, y, mean, rstd, hidden, eps, st)
    LN_DISPATCH_DTYPE(dtype, LN_FWD_WIDE_CALL)
#undef LN_FWD_WIDE_CALL
  }
  const int tpr = pick_tpr(hidden);
  const int g = (hidden / 8 + tpr - 1) / tpr;
#define LN_FWD_CALL(T, TPR_, G_) \
  (int)launch_fwd<T, TPR_, G_>(rows, x, w, b, y, mean, rstd, hidden, eps, st)
  LN_DISPATCH(dtype, tpr, g, LN_FWD_CALL)
#undef LN_FWD_CALL
}

extern "C" int layer_norm_bwd(const void* x, const void* w, const void* mean,
                              const void* rstd, const void* dy, void* dx,
                              void* dw_part, void* db_part, int rows,
                              int hidden, int rows_per_block, int nblocks,
                              int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_shape(rows, hidden, dtype) || rows_per_block < 1 || nblocks < 1 ||
      (long long)rows_per_block * nblocks < rows ||
      (long long)rows_per_block * (nblocks - 1) >= rows)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!team_row(hidden)) {
#define LN_BWD_WIDE_CALL(T)                                                   \
  (int)launch_bwd_wide<T>(nblocks, x, w, mean, rstd, dy, dx, dw_part, db_part, \
                          rows, hidden, rows_per_block, st)
    LN_DISPATCH_DTYPE(dtype, LN_BWD_WIDE_CALL)
#undef LN_BWD_WIDE_CALL
  }
  const int tpr = pick_tpr(hidden);
  const int g = (hidden / 8 + tpr - 1) / tpr;
#define LN_BWD_CALL(T, TPR_, G_)                                             \
  (int)launch_bwd<T, TPR_, G_>(nblocks, x, w, mean, rstd, dy, dx, dw_part, \
                               db_part, rows, hidden, rows_per_block, st)
  LN_DISPATCH(dtype, tpr, g, LN_BWD_CALL)
#undef LN_BWD_CALL
}

extern "C" const char* layer_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

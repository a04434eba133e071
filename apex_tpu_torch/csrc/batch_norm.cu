// Batch norm over rows [M, C] (channels innermost in memory), synced or
// local: K17 the forward, K18 the backward, each in one launch where no
// all-reduce sits between its stages (one rank) and in two launches with
// the all-reduce between them (a group of ranks).
//
// These replace no Pallas site: the JAX package computes
// apex_tpu/parallel/sync_batchnorm.py:23 sync_batch_norm in jnp (fp32 sums
// of x and x^2, psum between them and the normalization) and its backward
// by autodiff through psum. They are the port's counterparts of apex's
// syncbn extension (csrc/welford.cu). They were written by hand because
// eager PyTorch runs that function as ~10 passes over the activation
// forward and ~20 backward (an fp32 copy, x^2, two sums, subtract, rsqrt
// multiply, scale, bias, the cast; autograd's fp32 intermediates): ~180
// bytes an element, ~510 GB a ResNet-50 step at b = 256 against ~45 GB
// here.
//
// The numerics are JAX's, not cuDNN's: fp32 sums of x and x^2, mean = s /
// n, var = max(ss / n - mean^2, 0) (NaN kept), rstd = rsqrt(var + eps),
// y = ((x - mean) * rstd) * scale + bias (each step rounded on its own:
// every operation below is an explicit __f*_rn, so nothing contracts),
// optionally ReLU, cast to x's dtype; the running variance takes var * n
// / max(n - 1, 1). rstd is the card's rsqrtf, the function torch.rsqrt
// (the plain version) and XLA's lax.rsqrt compute on it: the correctly
// rounded __frsqrt_rn differed from it by 1 ulp in ~20% of channels, and
// on one norm of a real ResNet-50 step that moved y by 5.6e-5 relative L2
// against the plain version, past BN_L2_TOL (H100, the smoke's held
// step); with rsqrtf y and rstd equal the plain version's bit for bit.
// The backward is the closed form of autodiff through that function with
// the two per-channel sums all-reduced between its stages: with g the
// output gradient (masked where a fused ReLU's output is not positive)
// and xhat = (x - mean) * rstd, stage 1 sums g (dbias) and g * xhat
// (dscale), stage 2 writes dx = (scale * rstd) * ((g - sum_g / n) - xhat
// * (sum_gx / n)).
//
// What bounds them on H100: bytes. The one-pass bound reads x once and
// writes y once (K17: 4 bytes an element in bf16), or reads x and dy once
// and writes dx (K18: 6). A norm larger than the chip (ResNet-50's at b =
// 256 hold 13-411 MB against 50 MB of L2) is read twice, once for the
// sums and once to normalize: the two-pass floor, 6 and 10 bytes. The
// arithmetic is a few operations an element.
//
// Design. A block of 512 threads is TX x TY: TX lanes over channel vectors
// (16-byte vectors, 8 bf16/fp16 or 4 fp32 channels, where the row width
// and the pointer allow, else single channels), TY lanes over rows, so a
// warp reads whole 16-byte vectors of neighbouring channels and rows. The
// work is items, (tile of TX vectors, slab of rows); the grid is the
// blocks the card holds at once (ops/batch_norm_cuda.plan sizes it from
// cudaOccupancyMaxActiveBlocksPerMultiprocessor of the kernel it
// launches, bn_resident below), one item a block where the card holds
// them all, so every block streams one equal slab and no wave is ragged.
//
//  - Stats, shared by both forms. A block sums its item's rows in a fixed
//    per-thread order, U rows in flight a thread (8 x 16 bytes forward, 4
//    x 2 x 16 backward), then over TY by a fixed tree in shared memory,
//    and writes a [2C] partial a slab. After a grid-wide barrier
//    (cooperative launch) the final per-channel sums spread over every
//    warp of the grid: a warp a channel, lane l adding slabs l, l + 32,
//    ... in order, then a fixed xor butterfly, so two runs give the same
//    bits and no block sums alone while the card idles.
//  - One launch (bn_fwd, bn_bwd): the stats, the barrier, the channel
//    sums (the forward's warps also finish their channels: the saved mean
//    and rstd, the running stats), a second barrier, then the apply. The
//    apply walks each block's items and each thread's rows in the reverse
//    of the stats' order, so its re-read of x (and dy) starts on the rows
//    the grid read last, which L2 still holds; a norm that fits in L2 is
//    re-read from it whole. The backward still writes its [2C] sums:
//    dscale and dbias are them.
//  - Two launches (bn_*_stats, then bn_*_apply after the all-reduce): the
//    stats kernel above without its apply (one barrier, also a
//    cooperative launch); the apply kernels walk the same items in the
//    same reverse order, and the forward's first slab of each tile writes
//    the saved mean and rstd and updates the running stats.
//
// The apply stages read the per-channel values once a thread into
// registers and stream the rows, storing the output with an evict-first
// hint so it does not push the rows still to be re-read out of L2.
//
// Registers (ptxas -v) and resident blocks of 512 threads an SM
// (bn_resident) of the bf16 16-byte-vector kernels on an H100: the
// forward's stats 56 (2), apply 96 (1), one launch 96 (1); the backward's
// stats 108 (1), apply 127 (1), one launch 125 (1); no spills. Two other
// ways to put more bytes in flight were built and timed against this one
// in turns on that card (PERF.md section 6) and were slower, so neither
// is here: each thread's rows staged through a cp.async ring in shared
// memory, three stages ahead (+4-5% over the step's 53 norms), and L2
// prefetches (cp.async.bulk.prefetch) two batches ahead (+76%).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_V = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) { return __float2half_rn(x); }

// V elements at p: one 16-byte load where V * sizeof(T) == 16, else one
// load an element; LAST marks the last read of these bytes (evict first)
template <typename T, int V, bool LAST>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 q = LAST ? __ldcs(reinterpret_cast<const uint4*>(p))
                         : *reinterpret_cast<const uint4*>(p);
    T h[V];
    memcpy(h, &q, sizeof(q));
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = to_f(h[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = to_f(p[k]);
  }
}

// the output, stored with an evict-first hint
template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  T h[V];
#pragma unroll
  for (int k = 0; k < V; ++k) h[k] = from_f<T>(f[k]);
  if constexpr (V * sizeof(T) == 16) {
    uint4 q;
    memcpy(&q, h, sizeof(q));
    __stcs(reinterpret_cast<uint4*>(p), q);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = h[k];
  }
}

// one element of a per-channel parameter of dtype code 0 bf16, 1 fp16, 2
// fp32 (the scale and bias may differ from x's dtype), or `absent` if null
__device__ __forceinline__ float load_param(const void* p, int code, int c, float absent) {
  if (!p) return absent;
  if (code == 0) return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[c]);
  if (code == 1) return __half2float(reinterpret_cast<const __half*>(p)[c]);
  return reinterpret_cast<const float*>(p)[c];
}

struct BnArgs {
  long long rows;           // M
  long long rows_per_slab;
  int C, tx;                // channels; lanes over channel vectors
  int tiles, slabs;         // items: tiles x slabs
  const void* x;
  const void* dy;
  void* out;                // y (forward) or dx (backward)
  float* partials;          // [slabs][2C] stats partials
  float* stats;             // [2C + 1]: sum x, sum x^2, n (forward)
  float* sums;              // [2C]: sum g, sum g xhat (backward)
  const void* w;            // scale (null: 1)
  const void* b;            // bias (null: 0)
  float* rmean;             // running stats (null: not tracked)
  float* rvar;
  float* mean;              // saved mean and rstd: written by the forward,
  float* rstd;              // read by the backward
  float eps, momentum, one_minus_momentum;
  int w_dtype, b_dtype, training, fuse_relu;
};

// this thread's place in an item: lane over channel vectors, lane over
// rows, the first channel of its vector, whether it has one, and the
// item's rows [r0, r1)
struct Lane {
  int tx, ty, ty_n, c, slab;
  bool in_block, active;
  long long r0, r1;
};

template <int V>
__device__ __forceinline__ Lane lane_of(const BnArgs& a, long long item) {
  Lane l;
  const int tile = (int)(item % a.tiles);
  l.slab = (int)(item / a.tiles);
  l.tx = threadIdx.x % a.tx;
  l.ty = threadIdx.x / a.tx;
  l.ty_n = THREADS / a.tx;
  l.in_block = l.ty < l.ty_n;
  l.c = (tile * a.tx + l.tx) * V;
  l.active = l.in_block && l.c < a.C;
  l.r0 = (long long)l.slab * a.rows_per_slab;
  l.r1 = l.r0 + a.rows_per_slab < a.rows ? l.r0 + a.rows_per_slab : a.rows;
  return l;
}

// the number of rows this thread takes in its item: r0 + ty + k ty_n
__device__ __forceinline__ long long rows_of(const Lane& l) {
  const long long first = l.r0 + l.ty;
  return first < l.r1 ? (l.r1 - first + l.ty_n - 1) / l.ty_n : 0;
}

__device__ __forceinline__ int pow2_ceil(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// the block's two sums of V channels over its TY lanes, by a fixed tree in
// shared memory; valid in the lanes with ty == 0
template <int V>
__device__ void reduce_over_rows(const Lane& l, int tx_n, float* a0, float* a1) {
  __shared__ float red[2 * THREADS * MAX_V];
  const int width = tx_n * V;
  float* r0 = red;
  float* r1 = red + THREADS * MAX_V;
  if (l.in_block) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      r0[l.ty * width + l.tx * V + k] = a0[k];
      r1[l.ty * width + l.tx * V + k] = a1[k];
    }
  }
  __syncthreads();
  for (int stride = pow2_ceil(l.ty_n) >> 1; stride > 0; stride >>= 1) {
    if (l.in_block && l.ty < stride && l.ty + stride < l.ty_n) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const int i = l.ty * width + l.tx * V + k, j = (l.ty + stride) * width + l.tx * V + k;
        r0[i] = __fadd_rn(r0[i], r0[j]);
        r1[i] = __fadd_rn(r1[i], r1[j]);
      }
    }
    __syncthreads();
  }
  if (l.in_block && l.ty == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      a0[k] = r0[l.tx * V + k];
      a1[k] = r1[l.tx * V + k];
    }
  }
  __syncthreads();
}

// (x - mean) * rstd, then the affine: each rounding explicit, the same in
// every kernel, so the backward's ReLU mask is the forward's
__device__ __forceinline__ float normalize(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}
__device__ __forceinline__ float affine(float xhat, float w, bool has_w, float b, bool has_b) {
  float y = has_w ? __fmul_rn(xhat, w) : xhat;
  return has_b ? __fadd_rn(y, b) : y;
}

// a channel's mean, biased variance and rstd from its sums s and ss over n
// rows
__device__ __forceinline__ void from_sums(float s, float ss, float n, float eps, float& mean,
                                          float& var, float& rstd) {
  mean = __fdiv_rn(s, n);
  var = __fsub_rn(__fdiv_rn(ss, n), __fmul_rn(mean, mean));
  var = var < 0.0f ? 0.0f : var;  // a NaN stays, as jnp.maximum keeps it
  rstd = rsqrtf(__fadd_rn(var, eps));
}

// the saved mean and rstd of a channel and, in training, its running stats
// from their old values rm and rv (n the rows the statistics cover)
__device__ __forceinline__ void save_channel(const BnArgs& a, int c, float mean, float var,
                                             float rstd, float n, float rm, float rv) {
  a.mean[c] = mean;
  a.rstd[c] = rstd;
  if (a.training && a.rmean) {
    const float unbiased = __fdiv_rn(__fmul_rn(var, n), fmaxf(__fsub_rn(n, 1.0f), 1.0f));
    a.rmean[c] = __fadd_rn(__fmul_rn(a.one_minus_momentum, rm), __fmul_rn(a.momentum, mean));
    a.rvar[c] = __fadd_rn(__fmul_rn(a.one_minus_momentum, rv), __fmul_rn(a.momentum, unbiased));
  }
}

// the per-channel values of the apply stages and of the backward's stats
struct Chan {
  float mean[MAX_V], rstd[MAX_V], w[MAX_V], b[MAX_V];
};

template <int V>
__device__ __forceinline__ void load_saved(const BnArgs& a, const Lane& l, Chan& ch) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = l.c + k;
    ch.mean[k] = __ldcg(a.mean + c);
    ch.rstd[k] = __ldcg(a.rstd + c);
    ch.w[k] = load_param(a.w, a.w_dtype, c, 1.0f);
    ch.b[k] = load_param(a.b, a.b_dtype, c, 0.0f);
  }
}

// ------------------------------------------------------------------ stats

// BWD = false (K17): a0 = sum x, a1 = sum x^2. BWD = true (K18): a0 = sum
// g, a1 = sum g xhat.
template <int V, bool BWD>
__device__ __forceinline__ void accumulate(const BnArgs& a, const Chan& ch, const float* xv,
                                           const float* gv, float* a0, float* a1) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    if (!BWD) {
      a0[k] = __fadd_rn(a0[k], xv[k]);
      a1[k] = __fadd_rn(a1[k], __fmul_rn(xv[k], xv[k]));
    } else {
      const float xhat = normalize(xv[k], ch.mean[k], ch.rstd[k]);
      float g = gv[k];
      if (a.fuse_relu && !(affine(xhat, ch.w[k], a.w != nullptr, ch.b[k], a.b != nullptr) > 0.0f))
        g = 0.0f;
      a0[k] = __fadd_rn(a0[k], g);
      a1[k] = __fadd_rn(a1[k], __fmul_rn(g, xhat));
    }
  }
}

// one item's [2C] partial: its rows in order, U in flight a thread, then
// the tree over TY
template <typename T, int V, bool BWD>
__device__ __forceinline__ void stats_item(const BnArgs& a, long long item) {
  const Lane l = lane_of<V>(a, item);
  const int C = a.C;
  Chan ch;
  if (BWD && l.active) load_saved<V>(a, l, ch);
  float a0[V], a1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a0[k] = a1[k] = 0.0f;
  if (l.active) {
    const T* x = reinterpret_cast<const T*>(a.x) + l.c;
    const T* dy = BWD ? reinterpret_cast<const T*>(a.dy) + l.c : nullptr;
    const long long step = l.ty_n, n = rows_of(l);
    constexpr int U = BWD ? 4 : 8;  // rows in flight a thread
    long long r = l.r0 + l.ty, k = 0;
    for (; k + U <= n; k += U, r += U * step) {
      float xv[U][V], gv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        load_vec<T, V, false>(x + (r + u * step) * C, xv[u]);
        if (BWD) load_vec<T, V, false>(dy + (r + u * step) * C, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) accumulate<V, BWD>(a, ch, xv[u], gv[u], a0, a1);
    }
    for (; k < n; ++k, r += step) {
      float xv[V], gv[V];
      load_vec<T, V, false>(x + r * C, xv);
      if (BWD) load_vec<T, V, false>(dy + r * C, gv);
      accumulate<V, BWD>(a, ch, xv, gv, a0, a1);
    }
  }
  reduce_over_rows<V>(l, a.tx, a0, a1);
  if (l.active && l.ty == 0) {
    float* part = a.partials + (long long)l.slab * 2 * C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      part[l.c + k] = a0[k];
      part[C + l.c + k] = a1[k];
    }
  }
}

// after the barrier: the slabs' partials of each channel summed by one
// warp (lane l: slabs l, l + 32, ... in order; then a fixed xor
// butterfly) into stats[0, 2C) and n into stats[2C] (forward) or into
// sums[0, 2C) (backward); with FINISH the forward's warp also writes the
// channel's saved mean and rstd and updates its running stats
template <bool BWD, bool FINISH>
__device__ __forceinline__ void reduce_slabs(const BnArgs& a) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * WARPS;
  const int C = a.C;
  float* out = BWD ? a.sums : a.stats;
  for (long long c = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5); c < C; c += warps) {
    // the running stats' old values are read while the partials come in
    float rm = 0.0f, rv = 0.0f;
    if (!BWD && FINISH && lane == 0 && a.rmean) {
      rm = a.rmean[c];
      rv = a.rvar[c];
    }
    float s0 = 0.0f, s1 = 0.0f;
    for (int j = lane; j < a.slabs; j += 32) {
      const float* part = a.partials + (long long)j * 2 * C;
      s0 = __fadd_rn(s0, __ldcg(part + c));
      s1 = __fadd_rn(s1, __ldcg(part + C + c));
    }
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) {
      s0 = __fadd_rn(s0, __shfl_xor_sync(0xffffffffu, s0, m));
      s1 = __fadd_rn(s1, __shfl_xor_sync(0xffffffffu, s1, m));
    }
    if (lane == 0) {
      out[c] = s0;
      out[C + c] = s1;
      if (!BWD && FINISH) {
        const float n = (float)a.rows;
        float mean, var, rstd;
        from_sums(s0, s1, n, a.eps, mean, var, rstd);
        save_channel(a, (int)c, mean, var, rstd, n, rm, rv);
      }
    }
  }
  if (!BWD && blockIdx.x == 0 && threadIdx.x == 0) a.stats[2 * C] = (float)a.rows;
}

// ------------------------------------------------------------------ apply

// K17's apply of one item: y for its rows, in reverse order
template <typename T, int V>
__device__ __forceinline__ void fwd_apply_item(const BnArgs& a, const Lane& l, const Chan& ch) {
  if (!l.active) return;
  const int C = a.C;
  const bool has_w = a.w != nullptr, has_b = a.b != nullptr;
  const T* x = reinterpret_cast<const T*>(a.x) + l.c;
  T* y = reinterpret_cast<T*>(a.out) + l.c;
  const long long step = l.ty_n, base = l.r0 + l.ty;
  auto one = [&](float* v) {  // x in, y out
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float t =
          affine(normalize(v[k], ch.mean[k], ch.rstd[k]), ch.w[k], has_w, ch.b[k], has_b);
      v[k] = a.fuse_relu ? (t > 0.0f ? t : 0.0f) : t;
    }
  };
  constexpr int U = 8;  // rows in flight a thread
  long long k = rows_of(l);
  for (; k >= U; k -= U) {
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) load_vec<T, V, true>(x + (base + (k - 1 - u) * step) * C, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      one(v[u]);
      store_vec<T, V>(y + (base + (k - 1 - u) * step) * C, v[u]);
    }
  }
  for (; k > 0; --k) {
    float v[V];
    load_vec<T, V, true>(x + (base + (k - 1) * step) * C, v);
    one(v);
    store_vec<T, V>(y + (base + (k - 1) * step) * C, v);
  }
}

// K18's apply of one item: dx = (scale rstd) ((g - sum_g / n) - xhat
// (sum_gx / n)) in training (the sums all-reduced, n the forward's count),
// (scale rstd) g in eval; its rows in reverse order
template <typename T, int V>
__device__ __forceinline__ void bwd_apply_item(const BnArgs& a, const Lane& l) {
  if (!l.active) return;
  const int C = a.C;
  Chan ch;
  load_saved<V>(a, l, ch);
  float k_[V], ga[V], gb[V];
  const bool has_w = a.w != nullptr, has_b = a.b != nullptr;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = l.c + k;
    k_[k] = has_w ? __fmul_rn(ch.w[k], ch.rstd[k]) : ch.rstd[k];
    if (a.training) {
      const float n = __ldcg(a.stats + 2 * C);
      ga[k] = __fdiv_rn(__ldcg(a.sums + c), n);
      gb[k] = __fdiv_rn(__ldcg(a.sums + C + c), n);
    } else {
      ga[k] = gb[k] = 0.0f;
    }
  }
  const T* x = reinterpret_cast<const T*>(a.x) + l.c;
  const T* dy = reinterpret_cast<const T*>(a.dy) + l.c;
  T* dx = reinterpret_cast<T*>(a.out) + l.c;
  const long long step = l.ty_n, base = l.r0 + l.ty;
  auto one = [&](const float* xv, float* g) {  // g in, dx out
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xhat = normalize(xv[k], ch.mean[k], ch.rstd[k]);
      float gk = g[k];
      if (a.fuse_relu && !(affine(xhat, ch.w[k], has_w, ch.b[k], has_b) > 0.0f)) gk = 0.0f;
      const float t = a.training ? __fsub_rn(__fsub_rn(gk, ga[k]), __fmul_rn(xhat, gb[k])) : gk;
      g[k] = __fmul_rn(k_[k], t);
    }
  };
  constexpr int U = 4;  // rows in flight a thread
  long long k = rows_of(l);
  for (; k >= U; k -= U) {
    float xv[U][V], gv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long r = base + (k - 1 - u) * step;
      load_vec<T, V, true>(x + r * C, xv[u]);
      load_vec<T, V, true>(dy + r * C, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      one(xv[u], gv[u]);
      store_vec<T, V>(dx + (base + (k - 1 - u) * step) * C, gv[u]);
    }
  }
  for (; k > 0; --k) {
    const long long r = base + (k - 1) * step;
    float xv[V], gv[V];
    load_vec<T, V, true>(x + r * C, xv);
    load_vec<T, V, true>(dy + r * C, gv);
    one(xv, gv);
    store_vec<T, V>(dx + r * C, gv);
  }
}

// the forward's per-channel values of one item: the saved mean and rstd
// (SAVED: the one-launch form, whose reducing warps wrote them), or
// computed here from the stats or the running stats, the first slab
// writing them and updating the running stats
template <int V, bool SAVED>
__device__ __forceinline__ Chan fwd_channels(const BnArgs& a, const Lane& l) {
  Chan ch;
  if (!l.active) return ch;
  if (SAVED) {
    load_saved<V>(a, l, ch);
    return ch;
  }
  const float n = a.training ? __ldcg(a.stats + 2 * a.C) : 0.0f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = l.c + k;
    float var;
    if (a.training) {
      from_sums(__ldcg(a.stats + c), __ldcg(a.stats + a.C + c), n, a.eps, ch.mean[k], var,
                ch.rstd[k]);
    } else {
      ch.mean[k] = a.rmean[c];
      var = a.rvar[c];
      ch.rstd[k] = rsqrtf(__fadd_rn(var, a.eps));
    }
    ch.w[k] = load_param(a.w, a.w_dtype, c, 1.0f);
    ch.b[k] = load_param(a.b, a.b_dtype, c, 0.0f);
    if (l.slab == 0 && l.ty == 0)
      save_channel(a, c, ch.mean[k], var, ch.rstd[k], n, a.rmean ? a.rmean[c] : 0.0f,
                   a.rvar ? a.rvar[c] : 0.0f);
  }
  return ch;
}

// ---------------------------------------------------------------- kernels

// a block's items: blockIdx.x, + gridDim.x, ...; the apply walks them
// backwards
__device__ __forceinline__ long long items_of(const BnArgs& a) {
  return (long long)a.tiles * a.slabs;
}
__device__ __forceinline__ long long last_item(const BnArgs& a) {
  const long long n = items_of(a), g = gridDim.x, b = blockIdx.x;
  return b < n ? b + (n - 1 - b) / g * g : -1;
}

// the stats of the two-launch form (cooperative): K17 stage 1 (stats [2C
// + 1] = sum x, sum x^2, n) or K18 stage 1 (sums [2C] = sum g, sum g xhat)
template <typename T, int V, bool BWD>
__global__ void __launch_bounds__(THREADS) bn_stats_kernel(const BnArgs a) {
  for (long long i = blockIdx.x; i < items_of(a); i += gridDim.x) stats_item<T, V, BWD>(a, i);
  __threadfence();
  cg::this_grid().sync();
  reduce_slabs<BWD, false>(a);
}

// K17 stage 2 of the two-launch form: y, the saved mean and rstd, the
// running stats; also the eval forward (one launch, no stats)
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bn_fwd_apply_kernel(const BnArgs a) {
  for (long long i = last_item(a); i >= 0; i -= gridDim.x) {
    const Lane l = lane_of<V>(a, i);
    fwd_apply_item<T, V>(a, l, fwd_channels<V, false>(a, l));
  }
}

// K18 stage 2 of the two-launch form: dx
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bn_bwd_apply_kernel(const BnArgs a) {
  for (long long i = last_item(a); i >= 0; i -= gridDim.x)
    bwd_apply_item<T, V>(a, lane_of<V>(a, i));
}

// K17 in one launch (cooperative): the stats, the channels finished by
// the reducing warps, then y in reverse order
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bn_fwd_kernel(const BnArgs a) {
  for (long long i = blockIdx.x; i < items_of(a); i += gridDim.x) stats_item<T, V, false>(a, i);
  __threadfence();
  cg::this_grid().sync();
  reduce_slabs<false, true>(a);
  __threadfence();
  cg::this_grid().sync();
  for (long long i = last_item(a); i >= 0; i -= gridDim.x) {
    const Lane l = lane_of<V>(a, i);
    fwd_apply_item<T, V>(a, l, fwd_channels<V, true>(a, l));
  }
}

// K18 in one launch (cooperative): the sums, then dx in reverse order
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bn_bwd_kernel(const BnArgs a) {
  for (long long i = blockIdx.x; i < items_of(a); i += gridDim.x) stats_item<T, V, true>(a, i);
  __threadfence();
  cg::this_grid().sync();
  reduce_slabs<true, false>(a);
  __threadfence();
  cg::this_grid().sync();
  for (long long i = last_item(a); i >= 0; i -= gridDim.x)
    bwd_apply_item<T, V>(a, lane_of<V>(a, i));
}

// the kernels by kind (0 fwd stats, 1 fwd apply, 2 bwd stats, 3 bwd
// apply, 4 fwd one launch, 5 bwd one launch) and whether each is
// cooperative
template <typename T, int V>
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (const void*)bn_stats_kernel<T, V, false>;
    case 1: return (const void*)bn_fwd_apply_kernel<T, V>;
    case 2: return (const void*)bn_stats_kernel<T, V, true>;
    case 3: return (const void*)bn_bwd_apply_kernel<T, V>;
    case 4: return (const void*)bn_fwd_kernel<T, V>;
    default: return (const void*)bn_bwd_kernel<T, V>;
  }
}
constexpr bool cooperative(int kind) { return kind != 1 && kind != 3; }

// dims: rows, C, V, tx, slabs, rows_per_slab, grid; ptrs: x, dy, out,
// partials, stats, sums, w, b, running_mean, running_var, mean, rstd (0 =
// null); hyper: eps, momentum, 1 - momentum; flags: dtype, w_dtype,
// b_dtype, training, fuse_relu
cudaError_t args_of(BnArgs& a, int& dtype, int& V, int& grid, const long long* dims,
                    const long long* ptrs, const float* hyper, const int* flags) {
  memset(&a, 0, sizeof(a));
  a.rows = dims[0];
  const long long C = dims[1];
  V = (int)dims[2];
  a.tx = (int)dims[3];
  const long long slabs = dims[4];
  a.rows_per_slab = dims[5];
  const long long g = dims[6];
  dtype = flags[0];
  if (a.rows < 1 || C < 1 || C > (1 << 24) || a.tx < 1 || a.tx > 32 || slabs < 1 ||
      slabs > (1 << 24) || a.rows_per_slab < 1 || slabs * a.rows_per_slab < a.rows ||
      (slabs - 1) * a.rows_per_slab >= a.rows || g < 1 || g > (1 << 24) || dtype < 0 ||
      dtype > 2 || (V != 1 && V != (dtype == 2 ? 4 : 8)) || C % V != 0)
    return cudaErrorInvalidValue;
  a.C = (int)C;
  a.slabs = (int)slabs;
  a.tiles = (a.C / V + a.tx - 1) / a.tx;
  grid = (int)g;
  a.x = reinterpret_cast<const void*>(ptrs[0]);
  a.dy = reinterpret_cast<const void*>(ptrs[1]);
  a.out = reinterpret_cast<void*>(ptrs[2]);
  a.partials = reinterpret_cast<float*>(ptrs[3]);
  a.stats = reinterpret_cast<float*>(ptrs[4]);
  a.sums = reinterpret_cast<float*>(ptrs[5]);
  a.w = reinterpret_cast<const void*>(ptrs[6]);
  a.b = reinterpret_cast<const void*>(ptrs[7]);
  a.rmean = reinterpret_cast<float*>(ptrs[8]);
  a.rvar = reinterpret_cast<float*>(ptrs[9]);
  a.mean = reinterpret_cast<float*>(ptrs[10]);
  a.rstd = reinterpret_cast<float*>(ptrs[11]);
  a.eps = hyper[0];
  a.momentum = hyper[1];
  a.one_minus_momentum = hyper[2];
  a.w_dtype = flags[1];
  a.b_dtype = flags[2];
  a.training = flags[3];
  a.fuse_relu = flags[4];
  if (!a.x || (a.w && (a.w_dtype < 0 || a.w_dtype > 2)) ||
      (a.b && (a.b_dtype < 0 || a.b_dtype > 2)) || ((a.rmean == nullptr) != (a.rvar == nullptr)))
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

}  // namespace

// runs the statement with T the element type of a dtype code (0 bf16, 1
// fp16, 2 fp32) and V its vector width (16 bytes, or 1)
#define BN_DISPATCH(code, vec, ...)                                   \
  switch (code) {                                                     \
    case 0: {                                                         \
      using T = __nv_bfloat16;                                        \
      if (vec == 8) {                                                 \
        constexpr int V = 8;                                          \
        __VA_ARGS__;                                                  \
      } else {                                                        \
        constexpr int V = 1;                                          \
        __VA_ARGS__;                                                  \
      }                                                               \
    } break;                                                          \
    case 1: {                                                         \
      using T = __half;                                               \
      if (vec == 8) {                                                 \
        constexpr int V = 8;                                          \
        __VA_ARGS__;                                                  \
      } else {                                                        \
        constexpr int V = 1;                                          \
        __VA_ARGS__;                                                  \
      }                                                               \
    } break;                                                          \
    default: {                                                        \
      using T = float;                                                \
      if (vec == 4) {                                                 \
        constexpr int V = 4;                                          \
        __VA_ARGS__;                                                  \
      } else {                                                        \
        constexpr int V = 1;                                          \
        __VA_ARGS__;                                                  \
      }                                                               \
    } break;                                                          \
  }

namespace {

// launch kernel `kind` on the plan in dims, cooperatively where it has a
// grid-wide barrier (the grid is then at most what the card holds at once:
// the launch refuses it otherwise)
cudaError_t launch(int kind, const long long* dims, const long long* ptrs, const float* hyper,
                   const int* flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  BnArgs a;
  int dtype, V, grid;
  err = args_of(a, dtype, V, grid, dims, ptrs, hyper, flags);
  if (err != cudaSuccess) return err;
  const bool fwd = kind == 0 || kind == 1 || kind == 4;
  if (kind != 0 && (!a.mean || !a.rstd)) return cudaErrorInvalidValue;
  if ((kind == 0 || kind == 4) && (!a.partials || !a.stats)) return cudaErrorInvalidValue;
  if ((kind == 1 || kind == 4) && !a.out) return cudaErrorInvalidValue;
  if (kind == 1 && ((a.training && !a.stats) || (!a.training && !a.rmean)))
    return cudaErrorInvalidValue;
  if (kind == 4 && !a.training) return cudaErrorInvalidValue;
  if (!fwd && !a.dy) return cudaErrorInvalidValue;
  if ((kind == 2 || kind == 5) && (!a.partials || !a.sums)) return cudaErrorInvalidValue;
  if ((kind == 3 || kind == 5) && (!a.out || (a.training && (!a.sums || !a.stats))))
    return cudaErrorInvalidValue;
  const void* fn = nullptr;
  BN_DISPATCH(dtype, V, fn = kernel_of<T, V>(kind))
  void* args[] = {&a};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)grid);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cooperative(kind) ? 1 : 0;
  err = cudaLaunchKernelExC(&cfg, fn, args);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// K17 stage 1 of the two-launch form: stats [2C + 1] = sum x, sum x^2, n
extern "C" int bn_fwd_stats(const long long* dims, const long long* ptrs, const float* hyper,
                            const int* flags, int device, void* stream) {
  return (int)launch(0, dims, ptrs, hyper, flags, device, stream);
}

// K17 stage 2: y, the saved mean and rstd, the running stats in place
// (training, from the all-reduced stats), or y from the running stats
// (eval: the whole forward)
extern "C" int bn_fwd_apply(const long long* dims, const long long* ptrs, const float* hyper,
                            const int* flags, int device, void* stream) {
  return (int)launch(1, dims, ptrs, hyper, flags, device, stream);
}

// K18 stage 1 of the two-launch form: sums [2C] = sum g, sum g xhat
extern "C" int bn_bwd_stats(const long long* dims, const long long* ptrs, const float* hyper,
                            const int* flags, int device, void* stream) {
  return (int)launch(2, dims, ptrs, hyper, flags, device, stream);
}

// K18 stage 2 of the two-launch form: dx
extern "C" int bn_bwd_apply(const long long* dims, const long long* ptrs, const float* hyper,
                            const int* flags, int device, void* stream) {
  return (int)launch(3, dims, ptrs, hyper, flags, device, stream);
}

// K17 in one launch (training on one rank): stats, the saved mean and
// rstd, the running stats, y
extern "C" int bn_fwd(const long long* dims, const long long* ptrs, const float* hyper,
                      const int* flags, int device, void* stream) {
  return (int)launch(4, dims, ptrs, hyper, flags, device, stream);
}

// K18 in one launch (one rank): sums and dx
extern "C" int bn_bwd(const long long* dims, const long long* ptrs, const float* hyper,
                      const int* flags, int device, void* stream) {
  return (int)launch(5, dims, ptrs, hyper, flags, device, stream);
}

// the blocks of kernel `kind` (bn_* above: 0 fwd stats, 1 fwd apply, 2 bwd
// stats, 3 bwd apply, 4 fwd, 5 bwd) for dtype code `dtype` and vector
// width `vec` that one SM holds at once, into *blocks
extern "C" int bn_resident(int kind, int dtype, int vec, int* blocks, int device,
                           void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!blocks || kind < 0 || kind > 5 || dtype < 0 || dtype > 2 ||
      (vec != 1 && vec != (dtype == 2 ? 4 : 8)))
    return (int)cudaErrorInvalidValue;
  const void* fn = nullptr;
  BN_DISPATCH(dtype, vec, fn = kernel_of<T, V>(kind))
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS, 0);
}

extern "C" const char* batch_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

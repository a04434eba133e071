// Batch norm over rows [M, C] (channels innermost in memory), synced or
// local: K17 the forward in two stages, K18 the backward in two stages.
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
// n, var = max(ss / n - mean^2, 0) (NaN kept), y = ((x - mean) * rstd) *
// scale + bias (each step rounded on its own: every operation below is an
// explicit __f*_rn, so nothing contracts), optionally ReLU, cast to x's
// dtype; the running variance takes var * n / max(n - 1, 1). The backward
// is the closed form of autodiff through that function with the two
// per-channel sums all-reduced between its stages: with g the output
// gradient (masked where a fused ReLU's output is not positive) and xhat =
// (x - mean) * rstd, stage 1 sums g (dbias) and g * xhat (dscale), stage 2
// writes dx = (scale * rstd) * ((g - sum_g / n) - xhat * (sum_gx / n)).
//
// What bounds them on H100: bytes. K17 reads x twice (stage 1's sums,
// stage 2's normalization) and writes y once: 6 bytes an element in bf16.
// K18 reads x and dy twice and writes dx: 10. The arithmetic is a few
// operations an element.
//
// Design. A block of 512 threads is TX x TY: TX lanes over channel vectors
// (16-byte vectors, 8 bf16/fp16 or 4 fp32 channels, where the row width
// and the pointer allow, else single channels), TY lanes over rows, so a
// warp reads whole 16-byte vectors of neighbouring channels and rows. The
// grid is (slabs of rows, tiles of TX vectors); the wrapper
// (ops/batch_norm_cuda.py plan) sizes it to one full wave of the card. In
// each stats stage a block sums its slab's rows in a fixed per-thread
// order (rows in flight a thread), then over TY by a fixed tree in
// shared memory, and writes a [2C] partial; the block that takes its
// tile's last ticket (an integer per tile, reset by that block) sums the
// slabs' partials in a fixed order, the same order whichever block it is,
// so two runs give the same bits, and writes the stage's [2C] result (and
// the row count, stats[2C]). The apply stages read the per-channel values
// once a thread into registers and stream the rows; the forward's first
// slab also writes the saved mean and rstd and updates the running stats
// in place.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int THREADS = 512;
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
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float* f) {
  if constexpr (V * sizeof(T) == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    T h[V];
    memcpy(h, &q, sizeof(q));
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = to_f(h[k]);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) f[k] = to_f(p[k]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float* f) {
  if constexpr (V * sizeof(T) == 16) {
    T h[V];
#pragma unroll
    for (int k = 0; k < V; ++k) h[k] = from_f<T>(f[k]);
    uint4 q;
    memcpy(&q, h, sizeof(q));
    *reinterpret_cast<uint4*>(p) = q;
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) p[k] = from_f<T>(f[k]);
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
  long long rows_per_slab;  // rows a block of the grid's x dimension
  int C, tx;                // channels; lanes over channel vectors
  const void* x;
  const void* dy;
  void* out;                // y (forward) or dx (backward)
  float* partials;          // [slabs][2C] stats-stage partials
  float* stats;             // [2C + 1]: sum x, sum x^2, n (forward)
  float* sums;              // [2C]: sum g, sum g xhat (backward)
  int* tickets;             // a ticket per channel tile, zero between launches
  const void* w;            // scale (null: 1)
  const void* b;            // bias (null: 0)
  float* rmean;             // running stats (null: not tracked)
  float* rvar;
  float* mean;              // saved mean and rstd: written by the forward's
  float* rstd;              // apply stage, read by the backward
  float eps, momentum, one_minus_momentum;
  int w_dtype, b_dtype, training, fuse_relu;
};

// this thread's place: lane over channel vectors, lane over rows, the
// first channel of its vector, and whether it has one
struct Lane {
  int tx, ty, ty_n, c;
  bool in_block, active;
};

template <int V>
__device__ __forceinline__ Lane lane_of(const BnArgs& a) {
  Lane l;
  l.tx = threadIdx.x % a.tx;
  l.ty = threadIdx.x / a.tx;
  l.ty_n = THREADS / a.tx;
  l.in_block = l.ty < l.ty_n;
  const int cv = blockIdx.y * a.tx + l.tx;
  l.c = cv * V;
  l.active = l.in_block && l.c < a.C;
  return l;
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

// the per-channel values of the backward and of the eval forward
struct Chan {
  float mean[MAX_V], rstd[MAX_V], w[MAX_V], b[MAX_V];
};

template <int V>
__device__ __forceinline__ void load_saved(const BnArgs& a, const Lane& l, Chan& ch) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = l.c + k;
    ch.mean[k] = a.mean[c];
    ch.rstd[k] = a.rstd[c];
    ch.w[k] = load_param(a.w, a.w_dtype, c, 1.0f);
    ch.b[k] = load_param(a.b, a.b_dtype, c, 0.0f);
  }
}

// stats stages. BWD = false (K17 stage 1): a0 = sum x, a1 = sum x^2 into
// stats[0, 2C) and n into stats[2C]. BWD = true (K18 stage 1): a0 = sum g,
// a1 = sum g xhat into sums[0, 2C).
template <typename T, int V, bool BWD>
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

template <typename T, int V, bool BWD>
__global__ void __launch_bounds__(THREADS) bn_stats_kernel(const BnArgs a) {
  const Lane l = lane_of<V>(a);
  const int C = a.C;
  Chan ch;
  if (BWD && l.active) load_saved<V>(a, l, ch);
  float a0[V], a1[V];
#pragma unroll
  for (int k = 0; k < V; ++k) a0[k] = a1[k] = 0.0f;
  const long long r0 = (long long)blockIdx.x * a.rows_per_slab;
  const long long r1 = r0 + a.rows_per_slab < a.rows ? r0 + a.rows_per_slab : a.rows;
  if (l.active) {
    const T* x = reinterpret_cast<const T*>(a.x) + l.c;
    const T* dy = BWD ? reinterpret_cast<const T*>(a.dy) + l.c : nullptr;
    const long long step = l.ty_n;
    constexpr int U = BWD ? 2 : 4;  // rows in flight a thread
    long long r = r0 + l.ty;
    for (; r + (U - 1) * step < r1; r += U * step) {
      float xv[U][V], gv[U][V];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        load_vec<T, V>(x + (r + u * step) * C, xv[u]);
        if (BWD) load_vec<T, V>(dy + (r + u * step) * C, gv[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) accumulate<T, V, BWD>(a, ch, xv[u], gv[u], a0, a1);
    }
    for (; r < r1; r += step) {
      float xv[V], gv[V];
      load_vec<T, V>(x + r * C, xv);
      if (BWD) load_vec<T, V>(dy + r * C, gv);
      accumulate<T, V, BWD>(a, ch, xv, gv, a0, a1);
    }
  }
  reduce_over_rows<V>(l, a.tx, a0, a1);
  if (l.active && l.ty == 0) {
    float* part = a.partials + (long long)blockIdx.x * 2 * C;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      part[l.c + k] = a0[k];
      part[C + l.c + k] = a1[k];
    }
  }
  // the tile's last block sums every slab's partial in slab order
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(a.tickets + blockIdx.y, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int k = 0; k < V; ++k) a0[k] = a1[k] = 0.0f;
  if (l.active) {
    for (int j = l.ty; j < (int)gridDim.x; j += l.ty_n) {
      const float* part = a.partials + (long long)j * 2 * C;
#pragma unroll
      for (int k = 0; k < V; ++k) {
        a0[k] = __fadd_rn(a0[k], __ldcg(part + l.c + k));
        a1[k] = __fadd_rn(a1[k], __ldcg(part + C + l.c + k));
      }
    }
  }
  reduce_over_rows<V>(l, a.tx, a0, a1);
  float* out = BWD ? a.sums : a.stats;
  if (l.active && l.ty == 0) {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      out[l.c + k] = a0[k];
      out[C + l.c + k] = a1[k];
    }
  }
  if (threadIdx.x == 0) {
    if (!BWD && blockIdx.y == 0) a.stats[2 * C] = (float)a.rows;
    a.tickets[blockIdx.y] = 0;
  }
}

// K17 stage 2: the per-channel mean and rstd (from the stats in training,
// the running stats in eval), the saved mean / rstd and the running-stat
// update (the first slab), then y for every row of the slab
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bn_fwd_apply_kernel(const BnArgs a) {
  const Lane l = lane_of<V>(a);
  if (!l.active) return;
  const int C = a.C;
  Chan ch;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const int c = l.c + k;
    float mean, var;
    float n = 0.0f;
    if (a.training) {
      n = a.stats[2 * C];
      mean = __fdiv_rn(a.stats[c], n);
      var = __fsub_rn(__fdiv_rn(a.stats[C + c], n), __fmul_rn(mean, mean));
      var = var < 0.0f ? 0.0f : var;  // a NaN stays, as jnp.maximum keeps it
    } else {
      mean = a.rmean[c];
      var = a.rvar[c];
    }
    ch.mean[k] = mean;
    ch.rstd[k] = __frsqrt_rn(__fadd_rn(var, a.eps));
    ch.w[k] = load_param(a.w, a.w_dtype, c, 1.0f);
    ch.b[k] = load_param(a.b, a.b_dtype, c, 0.0f);
    if (blockIdx.x == 0 && l.ty == 0) {
      a.mean[c] = mean;
      a.rstd[c] = ch.rstd[k];
      if (a.training && a.rmean) {
        const float unbiased = __fdiv_rn(__fmul_rn(var, n), fmaxf(__fsub_rn(n, 1.0f), 1.0f));
        a.rmean[c] = __fadd_rn(__fmul_rn(a.one_minus_momentum, a.rmean[c]),
                               __fmul_rn(a.momentum, mean));
        a.rvar[c] = __fadd_rn(__fmul_rn(a.one_minus_momentum, a.rvar[c]),
                              __fmul_rn(a.momentum, unbiased));
      }
    }
  }
  const bool has_w = a.w != nullptr, has_b = a.b != nullptr;
  const long long r0 = (long long)blockIdx.x * a.rows_per_slab;
  const long long r1 = r0 + a.rows_per_slab < a.rows ? r0 + a.rows_per_slab : a.rows;
  const T* x = reinterpret_cast<const T*>(a.x) + l.c;
  T* y = reinterpret_cast<T*>(a.out) + l.c;
  const long long step = l.ty_n;
  long long r = r0 + l.ty;
  auto one = [&](float* v) {  // x in, y out
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float t =
          affine(normalize(v[k], ch.mean[k], ch.rstd[k]), ch.w[k], has_w, ch.b[k], has_b);
      v[k] = a.fuse_relu ? (t > 0.0f ? t : 0.0f) : t;
    }
  };
  constexpr int U = 4;  // rows in flight a thread
  for (; r + (U - 1) * step < r1; r += U * step) {
    float v[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) load_vec<T, V>(x + (r + u * step) * C, v[u]);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      one(v[u]);
      store_vec<T, V>(y + (r + u * step) * C, v[u]);
    }
  }
  for (; r < r1; r += step) {
    float v[V];
    load_vec<T, V>(x + r * C, v);
    one(v);
    store_vec<T, V>(y + r * C, v);
  }
}

// K18 stage 2: dx = (scale rstd) ((g - sum_g / n) - xhat (sum_gx / n)) in
// training (the sums all-reduced, n the forward's count), (scale rstd) g
// in eval
template <typename T, int V>
__global__ void __launch_bounds__(THREADS) bn_bwd_apply_kernel(const BnArgs a) {
  const Lane l = lane_of<V>(a);
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
      const float n = a.stats[2 * C];
      ga[k] = __fdiv_rn(a.sums[c], n);
      gb[k] = __fdiv_rn(a.sums[C + c], n);
    } else {
      ga[k] = gb[k] = 0.0f;
    }
  }
  const long long r0 = (long long)blockIdx.x * a.rows_per_slab;
  const long long r1 = r0 + a.rows_per_slab < a.rows ? r0 + a.rows_per_slab : a.rows;
  const T* x = reinterpret_cast<const T*>(a.x) + l.c;
  const T* dy = reinterpret_cast<const T*>(a.dy) + l.c;
  T* dx = reinterpret_cast<T*>(a.out) + l.c;
  const long long step = l.ty_n;
  long long r = r0 + l.ty;
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
  constexpr int U = 2;  // rows in flight a thread
  for (; r + (U - 1) * step < r1; r += U * step) {
    float xv[U][V], gv[U][V];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      load_vec<T, V>(x + (r + u * step) * C, xv[u]);
      load_vec<T, V>(dy + (r + u * step) * C, gv[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      one(xv[u], gv[u]);
      store_vec<T, V>(dx + (r + u * step) * C, gv[u]);
    }
  }
  for (; r < r1; r += step) {
    float xv[V], gv[V];
    load_vec<T, V>(x + r * C, xv);
    load_vec<T, V>(dy + r * C, gv);
    one(xv, gv);
    store_vec<T, V>(dx + r * C, gv);
  }
}

// dims: rows, C, V, tx, slabs, rows_per_slab; ptrs: x, dy, out, partials,
// stats, sums, tickets, w, b, running_mean, running_var, mean, rstd (0 =
// null); hyper: eps, momentum, 1 - momentum; flags: dtype, w_dtype,
// b_dtype, training, fuse_relu
cudaError_t args_of(BnArgs& a, int& dtype, int& V, int& slabs, int& tiles,
                    const long long* dims, const long long* ptrs, const float* hyper,
                    const int* flags) {
  memset(&a, 0, sizeof(a));
  a.rows = dims[0];
  const long long C = dims[1];
  V = (int)dims[2];
  a.tx = (int)dims[3];
  slabs = (int)dims[4];
  a.rows_per_slab = dims[5];
  dtype = flags[0];
  if (a.rows < 1 || C < 1 || C > (1 << 24) || a.tx < 1 || a.tx > 32 || slabs < 1 ||
      slabs > 65535 * 16 || a.rows_per_slab < 1 ||
      (long long)slabs * a.rows_per_slab < a.rows || dtype < 0 || dtype > 2 ||
      (V != 1 && V != (dtype == 2 ? 4 : 8)) || C % V != 0)
    return cudaErrorInvalidValue;
  a.C = (int)C;
  const int cvec = a.C / V;
  tiles = (cvec + a.tx - 1) / a.tx;
  if (tiles > 65535) return cudaErrorInvalidValue;
  a.x = reinterpret_cast<const void*>(ptrs[0]);
  a.dy = reinterpret_cast<const void*>(ptrs[1]);
  a.out = reinterpret_cast<void*>(ptrs[2]);
  a.partials = reinterpret_cast<float*>(ptrs[3]);
  a.stats = reinterpret_cast<float*>(ptrs[4]);
  a.sums = reinterpret_cast<float*>(ptrs[5]);
  a.tickets = reinterpret_cast<int*>(ptrs[6]);
  a.w = reinterpret_cast<const void*>(ptrs[7]);
  a.b = reinterpret_cast<const void*>(ptrs[8]);
  a.rmean = reinterpret_cast<float*>(ptrs[9]);
  a.rvar = reinterpret_cast<float*>(ptrs[10]);
  a.mean = reinterpret_cast<float*>(ptrs[11]);
  a.rstd = reinterpret_cast<float*>(ptrs[12]);
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

// K17 stage 1: stats [2C + 1] = sum x, sum x^2, n
extern "C" int bn_fwd_stats(const long long* dims, const long long* ptrs, const float* hyper,
                            const int* flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BnArgs a;
  int dtype, V, slabs, tiles;
  err = args_of(a, dtype, V, slabs, tiles, dims, ptrs, hyper, flags);
  if (err != cudaSuccess) return (int)err;
  if (!a.partials || !a.stats || !a.tickets) return (int)cudaErrorInvalidValue;
  const dim3 grid(slabs, tiles);
  cudaStream_t st = (cudaStream_t)stream;
  BN_DISPATCH(dtype, V, bn_stats_kernel<T, V, false><<<grid, THREADS, 0, st>>>(a))
  return (int)cudaGetLastError();
}

// K17 stage 2: y, the saved mean and rstd, the running stats in place
extern "C" int bn_fwd_apply(const long long* dims, const long long* ptrs, const float* hyper,
                            const int* flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BnArgs a;
  int dtype, V, slabs, tiles;
  err = args_of(a, dtype, V, slabs, tiles, dims, ptrs, hyper, flags);
  if (err != cudaSuccess) return (int)err;
  if (!a.out || !a.mean || !a.rstd || (a.training && !a.stats) || (!a.training && !a.rmean))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(slabs, tiles);
  cudaStream_t st = (cudaStream_t)stream;
  BN_DISPATCH(dtype, V, bn_fwd_apply_kernel<T, V><<<grid, THREADS, 0, st>>>(a))
  return (int)cudaGetLastError();
}

// K18 stage 1: sums [2C] = sum g, sum g xhat
extern "C" int bn_bwd_stats(const long long* dims, const long long* ptrs, const float* hyper,
                            const int* flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BnArgs a;
  int dtype, V, slabs, tiles;
  err = args_of(a, dtype, V, slabs, tiles, dims, ptrs, hyper, flags);
  if (err != cudaSuccess) return (int)err;
  if (!a.dy || !a.partials || !a.sums || !a.tickets || !a.mean || !a.rstd)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(slabs, tiles);
  cudaStream_t st = (cudaStream_t)stream;
  BN_DISPATCH(dtype, V, bn_stats_kernel<T, V, true><<<grid, THREADS, 0, st>>>(a))
  return (int)cudaGetLastError();
}

// K18 stage 2: dx
extern "C" int bn_bwd_apply(const long long* dims, const long long* ptrs, const float* hyper,
                            const int* flags, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  BnArgs a;
  int dtype, V, slabs, tiles;
  err = args_of(a, dtype, V, slabs, tiles, dims, ptrs, hyper, flags);
  if (err != cudaSuccess) return (int)err;
  if (!a.dy || !a.out || !a.mean || !a.rstd || (a.training && (!a.sums || !a.stats)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid(slabs, tiles);
  cudaStream_t st = (cudaStream_t)stream;
  BN_DISPATCH(dtype, V, bn_bwd_apply_kernel<T, V><<<grid, THREADS, 0, st>>>(a))
  return (int)cudaGetLastError();
}

extern "C" const char* batch_norm_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

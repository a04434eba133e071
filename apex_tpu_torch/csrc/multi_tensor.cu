// Multi-tensor kernels over lists of tensors: K12 scale / axpby with a
// found-inf flag, K13 per-tensor and global L2 norms (or largest
// magnitudes), K14 Adam/AdamW in place, K15 LAMB in two stages, K16 SGD
// with momentum in place (and the master-to-model copy in the same pass),
// and the ZeRO optimizers' shard updates: K21 Adam and K22 LAMB over one
// rank's fp32 shard of the flat parameters, each writing the update the
// ranks all-gather.
//
// These replace no Pallas site: the JAX package computes them in jnp, as
// whole-pytree elementwise passes that XLA fuses into the step program.
// They are the port's counterparts of apex's amp_C (multi_tensor_scale,
// multi_tensor_axpby, multi_tensor_l2norm, multi_tensor_adam,
// multi_tensor_lamb): K12 of apex_tpu/multi_tensor_apply/
// multi_tensor_apply.py:70 multi_tensor_scale, :85 multi_tensor_axpby and
// apex_tpu/amp/scaler.py:68 LossScaler.unscale; K13 of :99
// multi_tensor_l2norm and :111 multi_tensor_l2norm_per_tensor; K14 of
// apex_tpu/optimizers/fused_adam.py:41 _adam_flat with bench.py:240-245's
// skip selects; K15 of apex_tpu/optimizers/fused_lamb.py:111
// update_two_pass (and :145 update_one_pass, the same function in another
// structure); K16 of apex_tpu/optimizers/fused_sgd.py:41 update (the leaf
// function) with apex_tpu/amp/amp_optimizer.py:119-134's skip selects and
// master-to-model copy, apex's multi_tensor_sgd in its four-list form;
// K21 of apex_tpu/contrib/optimizers/distributed_fused_adam.py:101-126
// (_adam_flat on the shard, master + update) and K22 of
// distributed_fused_lamb.py:117-149 (the shard's clipped moments, the
// direction, per-tensor sums of p^2 and u^2 over the shard, then, after
// the caller's all-reduce of those sums, the trust ratio and the update).
// They were written by hand because eager PyTorch spends one launch per
// op per leaf there: ~1,350 launches a GPT-2-small step (148 leaves) and
// ~170 bytes a parameter; ~1,300 a ResNet-50 SGD step (161 leaves).
//
// What bounds them on H100: bytes. K12 reads a gradient and writes its
// fp32 unscaled copy (8 bytes a parameter for fp32), K13 reads it once
// (4), K14 reads g, p, m, v and writes p, m, v (28), K15 the same (28,
// plus one more read of p, m, v in its second stage: 40), K16 reads g, p,
// buf and writes p, buf and the model's half copy (22 under amp O2), K21
// reads g, master, m, v and writes master, m, v and the update (32), K22
// reads g, master, m, v and writes m, v and the direction (28), then
// reads the direction and master and writes both (16). K14's and K15's
// IEEE divisions and roots take about half the time their bytes do.
//
// Design. K12, K13 and K16: a launch covers a group of tensors whose
// pointers and sizes travel in the kernel's parameters (a Table, kept
// under the 4 KB parameter limit, as apex's TensorListMetadata), so
// gradients that are new tensors every step need no device table and no
// host sync; the wrapper (ops/multi_tensor_cuda.py) splits longer lists
// into groups of capacity(depth) tensors. Each tensor is cut into chunks
// of CHUNK elements, one block a chunk; a block finds its tensor by a
// binary search over the table's chunk prefix. Inside a chunk each thread
// walks 4-element vectors (16 bytes of fp32, 8 of bf16/fp16) where every
// operand's pointer allows it (the chunk offset is a multiple of CHUNK,
// so it does), else elements; the ragged tail of a tensor takes elements.
// K14 and K15 take a whole list in one launch (a ListTable of up to
// LIST_CAP tensors in parameters of up to 32,764 bytes) on a grid of every
// block the card holds (two of 512 threads an SM, 64 registers: 32 warps
// to overlap one warp's math with another's loads). K14 walks tiles of
// TILE elements grid-stride, each thread's next vector loaded before its
// current one's math. K15's stage 1 runs a block a chunk (a chunk's 512
// threads each summing its vectors in order, then the block reduction),
// a fixed order, so its bits depend on neither the grid nor the walk. It
// is one cooperative launch: every chunk through stage 1, grid-stride; a
// grid barrier; each tensor's step (a warp a tensor sums its chunks in a
// fixed order); a barrier; then every tile through stage 2, from the
// list's last back (the lines stage 1 touched last are the likeliest to
// be in L2). Waves of tensors small enough to re-read from the 50 MB L2
// were measured and dropped: a chunk is one block's, so a wave that fits
// L2 fills ~20 of the 264 blocks, and every split of the list measured
// slower on an H100 than one pass (PERF.md).
// Math is fp32 with every rounding explicit (__fmul_rn, __fadd_rn,
// __fdiv_rn, __fsqrt_rn; the source also builds with --fmad=false), in the
// order of the plain versions, so that K12 and K14 equal them bit for bit.
// Step-dependent scalars (1 / loss scale, the bias corrections, the
// learning rate, the found-inf flag, the step count) are read from 0-d
// device tensors the wrapper passes: the plain versions compute them with
// the same torch ops, and the step never waits on the host. K14 and K15
// read the found-inf flag first and write nothing when it is set. The
// found-inf flag of K12 is written with plain stores of 1 (no atomics).
// Reductions (K13, K15's per-tensor norms) have a fixed order: a block's
// chunk sum (a fixed per-thread order, an xor butterfly a warp, a fixed
// tree over the warps), then a tensor's chunks summed in order (K13: a
// second launch, whose last group's launch also sums the tensors in
// order). No atomic touches a value, so two runs give the same bits. K21
// walks its flat shard in 4-element vectors, grid-stride. K22 walks
// pieces: the shard's part of each tensor (and of the padding, segment N)
// cut into CHUNK elements at most, one block a piece, listed by the
// wrapper once per layout; a piece's block sum is a partial, and a second
// launch sums a segment's partials in order, so the per-tensor sums have
// a fixed order.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK = 65536;   // elements a block
constexpr int THREADS = 512;
constexpr int REDUCE_THREADS = 1024;
// bytes of a table in the kernel parameters; the rest of the 4096 holds
// the scalar arguments
constexpr int TABLE_BYTES = 3840;

constexpr int capacity(int depth) { return (TABLE_BYTES - 16) / (8 * depth + 8); }

// K14 and K15 take a whole list a launch: its table rides in parameters of
// up to 32,764 bytes (CUDA 12.1 and later on Volta and later, with a driver
// of R530 or later), else in the 4 KB of older toolkits. K14's items and
// K15's stage-2 items are tiles of TILE elements; K15's stage 1 keeps
// chunks of CHUNK elements, one block of THREADS each
#if CUDART_VERSION >= 12010
constexpr int LIST_PARAM_BYTES = 32764;
#else
constexpr int LIST_PARAM_BYTES = 4096;
#endif
constexpr int LIST_CAP = (LIST_PARAM_BYTES - 320) / 44;
constexpr int TILE = 32768;
constexpr int VWARPS = THREADS / 32;

// a group of tensors: D operand pointers each, sizes, the chunk prefix
template <int D>
struct Table {
  static constexpr int CAP = capacity(D);
  void* ptr[D][CAP];
  int numel[CAP];
  int chunk_start[CAP + 1];
  int ntensors;
  int chunk_base;    // the group's first chunk over the whole list
  int tensor_base;   // the group's first tensor over the whole list
};

struct ScaleArgs {
  const float* scale_ptr;  // the scale from a 0-d device tensor, or null
  float scale;             // else this value
  float a, b;              // axpby
  void* flag;              // found-inf flag: a bool or an int32
  int flag_bytes;
  int check_input;         // 1: flag non-finite inputs (the loss scaler)
};

struct AdamArgs {
  float beta1, beta1c, beta2, beta2c, eps, wd;  // beta1c = fp32(1 - beta1)
  float beta3;             // LAMB: fp32(1 - beta1), or 1 without averaging
  float max_grad_norm;     // LAMB: <= 0 for no clipping
  float neg_lr;            // -lr when neg_lr_ptr is null
  int adam_w_mode, bias_correction, decay, trust;  // trust: LAMB's ratio on
  const float* bc1;
  const float* bc2;
  const float* neg_lr_ptr;
  const float* global_sq;  // LAMB: the gradients' global sum of squares
  const unsigned char* skip;  // found-inf: write nothing when set
  int* count;
  const int* count_new;
};

struct SgdArgs {
  float wd, momentum, one_minus_damp;  // one_minus_damp = fp32(1 - dampening)
  float neg_lr;            // -lr when neg_lr_ptr is null
  int decay, use_momentum, nesterov, copy;  // copy: write the model copy
  const float* neg_lr_ptr;
  const unsigned char* skip;  // found-inf: write nothing when set
  int* count;
  const int* count_new;    // the first step is count_new == 1
};

static_assert(sizeof(Table<4>) + sizeof(AdamArgs) <= 4096, "params");
static_assert(sizeof(Table<4>) + sizeof(SgdArgs) <= 4096, "params");
static_assert(sizeof(Table<3>) + sizeof(ScaleArgs) <= 4096, "params");
static_assert(sizeof(Table<1>) + 64 <= 4096, "params");

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

// four elements: one 16-byte load of fp32, one 8-byte load of bf16/fp16
__device__ __forceinline__ void load4(const float* p, float* f) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  f[0] = q.x;
  f[1] = q.y;
  f[2] = q.z;
  f[3] = q.w;
}
template <typename H>
__device__ __forceinline__ void load4h(const H* p, float* f) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  H h[4];
  memcpy(h, &q, sizeof(q));
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = to_f(h[i]);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* f) { load4h(p, f); }
__device__ __forceinline__ void load4(const __half* p, float* f) { load4h(p, f); }

__device__ __forceinline__ void store4(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}
template <typename H>
__device__ __forceinline__ void store4h(H* p, const float* f) {
  H h[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = from_f<H>(f[i]);
  uint2 q;
  memcpy(&q, h, sizeof(q));
  *reinterpret_cast<uint2*>(p) = q;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* f) { store4h(p, f); }
__device__ __forceinline__ void store4(__half* p, const float* f) { store4h(p, f); }

template <typename T>
__device__ __forceinline__ bool aligned4(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & (4 * sizeof(T) - 1)) == 0;
}

// the tensor of chunk b: the last whose chunk range starts at or before b
template <int D>
__device__ __forceinline__ int find_tensor(const Table<D>& tb, int b) {
  int lo = 0, hi = tb.ntensors - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (tb.chunk_start[mid] <= b)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// a block's chunk: its tensor, first element and length
struct Span {
  int t;
  long long start;
  int len;
};
template <int D>
__device__ __forceinline__ Span chunk_span(const Table<D>& tb, int b) {
  Span s;
  s.t = find_tensor(tb, b);
  s.start = (long long)(b - tb.chunk_start[s.t]) * CHUNK;
  const long long left = tb.numel[s.t] - s.start;
  s.len = left < CHUNK ? (int)left : CHUNK;
  return s;
}

// NaN-propagating max of magnitudes (jnp.max keeps a NaN)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (b > a || b != b) ? b : a;
}

template <bool MAX>
__device__ __forceinline__ float combine(float a, float b) {
  return MAX ? max_nan(a, b) : __fadd_rn(a, b);
}

// the block's sum (or max): an xor butterfly a warp (every lane gets the
// same bits), a fixed tree over the warps; valid in every thread
template <bool MAX>
__device__ float block_reduce(float x) {
  __shared__ float warp_vals[32];
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = combine<MAX>(x, __shfl_xor_sync(0xffffffffu, x, m));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  if (lane == 0) warp_vals[warp] = x;
  __syncthreads();
  x = lane < warps ? warp_vals[lane] : 0.0f;
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = combine<MAX>(x, __shfl_xor_sync(0xffffffffu, x, m));
  __syncthreads();
  return x;
}

template <bool MAX>
__device__ __forceinline__ float warp_reduce(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x = combine<MAX>(x, __shfl_xor_sync(0xffffffffu, x, m));
  return x;
}

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }

__device__ __forceinline__ void set_flag(const ScaleArgs& a) {
  if (a.flag_bytes == 1)
    *reinterpret_cast<unsigned char*>(a.flag) = 1;
  else
    *reinterpret_cast<int*>(a.flag) = 1;
}

// K12: out = in * scale in fp32, cast to out's dtype; the flag set when an
// input (check_input) or an fp32 product is not finite
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) scale_kernel(const Table<2> tb, const ScaleArgs a) {
  const Span s = chunk_span(tb, blockIdx.x);
  const TI* in = reinterpret_cast<const TI*>(tb.ptr[0][s.t]) + s.start;
  TO* out = reinterpret_cast<TO*>(tb.ptr[1][s.t]) + s.start;
  const float scale = a.scale_ptr ? *a.scale_ptr : a.scale;
  bool bad = false;
  int done = 0;
  if (aligned4<TI>(in) && aligned4<TO>(out)) {
    const int n4 = s.len >> 2;
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      float x[4], y[4];
      load4(in + 4 * i, x);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        y[k] = __fmul_rn(x[k], scale);
        bad |= !finite(a.check_input ? x[k] : y[k]);
      }
      store4(out + 4 * i, y);
    }
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < s.len; e += THREADS) {
    const float x = to_f(in[e]);
    const float y = __fmul_rn(x, scale);
    bad |= !finite(a.check_input ? x : y);
    out[e] = from_f<TO>(y);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) set_flag(a);
}

// K12, axpby: out = a x + b y in fp32 (two products, one sum), cast to
// out's dtype; the flag set when a sum is not finite
template <typename TI, typename TO>
__global__ void __launch_bounds__(THREADS) axpby_kernel(const Table<3> tb, const ScaleArgs a) {
  const Span s = chunk_span(tb, blockIdx.x);
  const TI* x = reinterpret_cast<const TI*>(tb.ptr[0][s.t]) + s.start;
  const TI* y = reinterpret_cast<const TI*>(tb.ptr[1][s.t]) + s.start;
  TO* out = reinterpret_cast<TO*>(tb.ptr[2][s.t]) + s.start;
  bool bad = false;
  int done = 0;
  if (aligned4<TI>(x) && aligned4<TI>(y) && aligned4<TO>(out)) {
    const int n4 = s.len >> 2;
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      float xv[4], yv[4], o[4];
      load4(x + 4 * i, xv);
      load4(y + 4 * i, yv);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[k] = __fadd_rn(__fmul_rn(a.a, xv[k]), __fmul_rn(a.b, yv[k]));
        bad |= !finite(o[k]);
      }
      store4(out + 4 * i, o);
    }
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < s.len; e += THREADS) {
    const float o = __fadd_rn(__fmul_rn(a.a, to_f(x[e])), __fmul_rn(a.b, to_f(y[e])));
    bad |= !finite(o);
    out[e] = from_f<TO>(o);
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) set_flag(a);
}

// K13, first stage: a chunk's sum of squares (or largest magnitude)
template <typename T, bool MAX>
__global__ void __launch_bounds__(THREADS) norm_partials_kernel(const Table<1> tb,
                                                                float* partials) {
  const Span s = chunk_span(tb, blockIdx.x);
  const T* x = reinterpret_cast<const T*>(tb.ptr[0][s.t]) + s.start;
  float acc = 0.0f;
  int done = 0;
  if (aligned4<T>(x)) {
    const int n4 = s.len >> 2;
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      float v[4];
      load4(x + 4 * i, v);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        acc = MAX ? max_nan(acc, fabsf(v[k])) : __fadd_rn(acc, __fmul_rn(v[k], v[k]));
    }
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < s.len; e += THREADS) {
    const float v = to_f(x[e]);
    acc = MAX ? max_nan(acc, fabsf(v)) : __fadd_rn(acc, __fmul_rn(v, v));
  }
  acc = block_reduce<MAX>(acc);
  if (threadIdx.x == 0) partials[tb.chunk_base + blockIdx.x] = acc;
}

// K13, second stage (one block): each tensor's chunks summed in order, a
// warp a tensor; then, in the last group's launch (final_n > 0), the
// tensors summed in order
template <bool MAX>
__global__ void __launch_bounds__(REDUCE_THREADS)
    norm_reduce_kernel(const Table<1> tb, const float* partials, float* per_val,
                       float* per_norm, int final_n, float* total_val, float* total_norm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int t = warp; t < tb.ntensors; t += warps) {
    float acc = 0.0f;
    for (int c = tb.chunk_start[t] + lane; c < tb.chunk_start[t + 1]; c += 32)
      acc = combine<MAX>(acc, partials[tb.chunk_base + c]);
    acc = warp_reduce<MAX>(acc);
    if (lane == 0) {
      per_val[tb.tensor_base + t] = acc;
      per_norm[tb.tensor_base + t] = MAX ? acc : __fsqrt_rn(acc);
    }
  }
  if (final_n <= 0) return;
  __syncthreads();
  if (warp != 0) return;
  float acc = 0.0f;
  for (int t = lane; t < final_n; t += 32) acc = combine<MAX>(acc, per_val[t]);
  acc = warp_reduce<MAX>(acc);
  if (lane == 0) {
    *total_val = acc;
    *total_norm = MAX ? acc : __fsqrt_rn(acc);
  }
}

// Adam's moments and update direction for one element, in the plain
// version's order (optimizers/fused_adam.py _adam_flat); g is the
// gradient (LAMB: already clipped), p the parameter
__device__ __forceinline__ float adam_moments(const AdamArgs& a, float g, float p, float beta_g,
                                              float& m, float& v) {
  if (!a.adam_w_mode && a.decay) g = __fadd_rn(g, __fmul_rn(p, a.wd));
  m = __fadd_rn(__fmul_rn(m, a.beta1), __fmul_rn(g, beta_g));
  v = __fadd_rn(__fmul_rn(v, a.beta2), __fmul_rn(__fmul_rn(g, a.beta2c), g));
  return g;
}

__device__ __forceinline__ float adam_direction(const AdamArgs& a, float m, float v, float p,
                                                float bc1, float bc2) {
  float upd;
  if (a.bias_correction)
    upd = __fdiv_rn(__fdiv_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, bc2)), a.eps));
  else
    upd = __fdiv_rn(m, __fadd_rn(__fsqrt_rn(v), a.eps));
  if (a.adam_w_mode && a.decay) upd = __fadd_rn(upd, __fmul_rn(p, a.wd));
  return upd;
}

// the new parameter: the update cast to the gradient's dtype, then to the
// parameter's, added in the parameter's dtype
template <typename TG, typename TP>
__device__ __forceinline__ float apply_update(float p, float u) {
  const float ug = to_f(from_f<TG>(u));
  const float up = to_f(from_f<TP>(ug));
  return __fadd_rn(p, up);
}

__device__ __forceinline__ void write_count(const AdamArgs& a) {
  if (a.count && blockIdx.x == 0 && threadIdx.x == 0) *a.count = *a.count_new;
}

// LAMB's clip factor: max(||g|| / max_grad_norm, 1), or 1 without clipping
__device__ __forceinline__ float lamb_clip(const AdamArgs& a) {
  if (a.max_grad_norm <= 0.0f) return 1.0f;
  const float c = __fdiv_rn(__fsqrt_rn(*a.global_sq), a.max_grad_norm);
  return c < 1.0f ? 1.0f : c;  // a NaN stays, as torch.clamp and jnp.maximum keep it
}

// ------------------------------------------- K14 and K15: a whole list a launch

// the list's table: 4 operand pointers a tensor (g, p, m, v), sizes, the
// prefix of chunks (K15's stage-1 items) and the prefix of tiles (K14's
// items and K15's stage-2 items)
struct ListTable {
  void* ptr[4][LIST_CAP];
  int numel[LIST_CAP];
  int chunk_start[LIST_CAP + 1];
  int tile_start[LIST_CAP + 1];
  int ntensors;
};

// K15's scratch: each chunk's sums of p * p and u * u and each tensor's
// step, -lr * ratio
struct ListScratch {
  float* pw;
  float* pu;
  float* steps;
};

static_assert(sizeof(ListTable) + sizeof(AdamArgs) + sizeof(ListScratch) <= LIST_PARAM_BYTES,
              "list params");

// blocks of THREADS an SM that the list kernels' registers leave room for
// (64 registers a thread): 32 warps an SM to overlap the math of some with
// the loads of others
constexpr int LIST_MIN_BLOCKS = 2;

// the last index in [lo, hi) whose prefix value is at or below x
__device__ __forceinline__ int last_at_or_below(const int* prefix, int lo, int hi, int x) {
  --hi;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (prefix[mid] <= x)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

// loads through L2 only (ld.global.cg): K15's stage 2 reads values other
// blocks wrote in the same launch, which this SM's L1 may hold stale
__device__ __forceinline__ void load4cg(const float* p, float* f) {
  const float4 q = __ldcg(reinterpret_cast<const float4*>(p));
  f[0] = q.x;
  f[1] = q.y;
  f[2] = q.z;
  f[3] = q.w;
}
template <typename H>
__device__ __forceinline__ void load4cg(const H* p, float* f) {
  const uint2 q = __ldcg(reinterpret_cast<const uint2*>(p));
  H h[4];
  memcpy(h, &q, sizeof(q));
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = to_f(h[i]);
}
__device__ __forceinline__ float load1cg(const float* p) { return __ldcg(p); }
template <typename H>
__device__ __forceinline__ float load1cg(const H* p) {
  const unsigned short q = __ldcg(reinterpret_cast<const unsigned short*>(p));
  H h;
  memcpy(&h, &q, sizeof(q));
  return to_f(h);
}

// the vector walk of the list kernels: this thread's 4-element vectors
// i = threadIdx.x, + THREADS, ... below n4 (load(i, r) fills NOP operands'
// 4 floats, body(i, r) does the math and the stores). With PREFETCH the
// next vector's loads are issued before the current one's math, so they
// are in flight while it computes (Adam's IEEE divisions and roots take
// about half the time its bytes do); K15's kernel, whose stages share its
// 64 registers, spills with the second set and walks without
template <int NOP, bool PREFETCH, typename Load, typename Body>
__device__ __forceinline__ void walk_vectors(int n4, Load load, Body body) {
  float cur[NOP][4], nxt[NOP][4];
  int i = threadIdx.x;
  if (PREFETCH && i < n4) load(i, cur);
  for (; i < n4; i += THREADS) {
    if (!PREFETCH)
      load(i, cur);
    else if (i + THREADS < n4)
      load(i + THREADS, nxt);
    body(i, cur);
    if (PREFETCH) {
#pragma unroll
      for (int o = 0; o < NOP; ++o)
#pragma unroll
        for (int k = 0; k < 4; ++k) cur[o][k] = nxt[o][k];
    }
  }
}

// K14: Adam/AdamW in place on p, m, v (fp32 moments) and the step count,
// over the whole list: a grid-stride walk of TILE-element tiles
template <typename TG, typename TP>
__global__ void __launch_bounds__(THREADS, LIST_MIN_BLOCKS)
    adam_list_kernel(const ListTable tb, const AdamArgs a) {
  if (a.skip && *a.skip) return;
  write_count(a);
  const float bc1 = a.bias_correction ? *a.bc1 : 1.0f;
  const float bc2 = a.bias_correction ? *a.bc2 : 1.0f;
  const float neg_lr = a.neg_lr_ptr ? *a.neg_lr_ptr : a.neg_lr;
  const int total = tb.tile_start[tb.ntensors];
  int t = 0;
  for (int item = blockIdx.x; item < total; item += gridDim.x) {
    while (tb.tile_start[t + 1] <= item) ++t;   // a block's tiles only move on
    const long long start = (long long)(item - tb.tile_start[t]) * TILE;
    const int len = (int)min((long long)TILE, tb.numel[t] - start);
    const TG* __restrict__ g = reinterpret_cast<const TG*>(tb.ptr[0][t]) + start;
    TP* __restrict__ p = reinterpret_cast<TP*>(tb.ptr[1][t]) + start;
    float* __restrict__ m = reinterpret_cast<float*>(tb.ptr[2][t]) + start;
    float* __restrict__ v = reinterpret_cast<float*>(tb.ptr[3][t]) + start;
    int done = 0;
    if (aligned4<TG>(g) && aligned4<TP>(p) && aligned4<float>(m) && aligned4<float>(v)) {
      const int n4 = len >> 2;
      walk_vectors<4, true>(
          n4,
          [&](int i, float (&r)[4][4]) {
            load4(g + 4 * i, r[0]);
            load4(p + 4 * i, r[1]);
            load4(m + 4 * i, r[2]);
            load4(v + 4 * i, r[3]);
          },
          [&](int i, float (&r)[4][4]) {
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              adam_moments(a, r[0][k], r[1][k], a.beta1c, r[2][k], r[3][k]);
              const float upd = adam_direction(a, r[2][k], r[3][k], r[1][k], bc1, bc2);
              r[1][k] = apply_update<TG, TP>(r[1][k], __fmul_rn(upd, neg_lr));
            }
            store4(p + 4 * i, r[1]);
            store4(m + 4 * i, r[2]);
            store4(v + 4 * i, r[3]);
          });
      done = n4 << 2;
    }
    for (int e = done + threadIdx.x; e < len; e += THREADS) {
      float mv = m[e], vv = v[e];
      const float pv = to_f(p[e]);
      adam_moments(a, to_f(g[e]), pv, a.beta1c, mv, vv);
      const float upd = adam_direction(a, mv, vv, pv, bc1, bc2);
      p[e] = from_f<TP>(apply_update<TG, TP>(pv, __fmul_rn(upd, neg_lr)));
      m[e] = mv;
      v[e] = vv;
    }
  }
}

// K15 stage 1 of chunk c (of tensor t), a block of THREADS: the
// clipped gradient's moments written in place, and the chunk's sums of p *
// p and u * u (each thread's vectors i, i + 512, ... in order, then the
// ragged tail's elements; block_reduce) into pw[c], pu[c]
template <typename TG, typename TP>
__device__ __forceinline__ void lamb_stage1_chunk(const ListTable& tb, const AdamArgs& a,
                                                  const ListScratch& sc, int t, int c,
                                                  float bc1, float bc2, float clip) {
  const long long start = (long long)(c - tb.chunk_start[t]) * CHUNK;
  const int len = (int)min((long long)CHUNK, tb.numel[t] - start);
  const TG* __restrict__ g = reinterpret_cast<const TG*>(tb.ptr[0][t]) + start;
  const TP* __restrict__ p = reinterpret_cast<const TP*>(tb.ptr[1][t]) + start;
  float* __restrict__ m = reinterpret_cast<float*>(tb.ptr[2][t]) + start;
  float* __restrict__ v = reinterpret_cast<float*>(tb.ptr[3][t]) + start;
  const bool clipping = a.max_grad_norm > 0.0f;
  float w_sq = 0.0f, u_sq = 0.0f;
  int done = 0;
  if (aligned4<TG>(g) && aligned4<TP>(p) && aligned4<float>(m) && aligned4<float>(v)) {
    const int n4 = len >> 2;
    walk_vectors<4, false>(
        n4,
        [&](int i, float (&r)[4][4]) {
          load4(g + 4 * i, r[0]);
          load4(p + 4 * i, r[1]);
          load4(m + 4 * i, r[2]);
          load4(v + 4 * i, r[3]);
        },
        [&](int i, float (&r)[4][4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float gc = clipping ? __fdiv_rn(r[0][e], clip) : r[0][e];
            adam_moments(a, gc, r[1][e], a.beta3, r[2][e], r[3][e]);
            const float upd = adam_direction(a, r[2][e], r[3][e], r[1][e], bc1, bc2);
            w_sq = __fadd_rn(w_sq, __fmul_rn(r[1][e], r[1][e]));
            u_sq = __fadd_rn(u_sq, __fmul_rn(upd, upd));
          }
          store4(m + 4 * i, r[2]);
          store4(v + 4 * i, r[3]);
        });
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < len; e += THREADS) {
    float mv = m[e], vv = v[e];
    const float pv = to_f(p[e]);
    const float gv = to_f(g[e]);
    const float gc = clipping ? __fdiv_rn(gv, clip) : gv;
    adam_moments(a, gc, pv, a.beta3, mv, vv);
    const float upd = adam_direction(a, mv, vv, pv, bc1, bc2);
    w_sq = __fadd_rn(w_sq, __fmul_rn(pv, pv));
    u_sq = __fadd_rn(u_sq, __fmul_rn(upd, upd));
    m[e] = mv;
    v[e] = vv;
  }
  w_sq = block_reduce<false>(w_sq);
  u_sq = block_reduce<false>(u_sq);
  if (threadIdx.x == 0) {
    sc.pw[c] = w_sq;
    sc.pu[c] = u_sq;
  }
}

// K15: tensor t's step -lr * ratio, by one warp, from its chunks' sums in
// the order a block of 512 threads sums them: virtual thread vt = 32 j +
// lane adds chunks vt, vt + 512, ... in order; the xor butterfly of each
// virtual warp j; then block_reduce's second stage over the 16 warp values
__device__ void lamb_tensor_step(const ListTable& tb, const AdamArgs& a, const ListScratch& sc,
                                 int t, float neg_lr) {
  const int lane = threadIdx.x & 31;
  const int c0 = tb.chunk_start[t], nch = tb.chunk_start[t + 1] - c0;
  float wl = 0.0f, ul = 0.0f;   // lane j: virtual warp j's sums
  for (int j = 0; j < VWARPS; ++j) {
    float w = 0.0f, u = 0.0f;
    for (int c = 32 * j + lane; c < nch; c += THREADS) {
      w = __fadd_rn(w, __ldcg(sc.pw + c0 + c));
      u = __fadd_rn(u, __ldcg(sc.pu + c0 + c));
    }
    w = warp_reduce<false>(w);
    u = warp_reduce<false>(u);
    if (lane == j) {
      wl = w;
      ul = u;
    }
  }
  const float w = __fsqrt_rn(warp_reduce<false>(wl));
  const float u = __fsqrt_rn(warp_reduce<false>(ul));
  if (lane == 0) {
    float ratio = (w > 0.0f && u > 0.0f) ? __fdiv_rn(w, __fadd_rn(u, 1e-38f)) : 1.0f;
    if (!a.trust) ratio = 1.0f;
    sc.steps[t] = __fmul_rn(neg_lr, ratio);
  }
}

// K15 stage 2 of tile k of tensor t: p += step u, the direction recomputed
// from the new moments
template <typename TG, typename TP>
__device__ __forceinline__ void lamb_stage2_tile(const ListTable& tb, const AdamArgs& a,
                                                 const ListScratch& sc, int t, int k, float bc1,
                                                 float bc2) {
  const float step = __ldcg(sc.steps + t);
  const long long start = (long long)k * TILE;
  const int len = (int)min((long long)TILE, tb.numel[t] - start);
  TP* __restrict__ p = reinterpret_cast<TP*>(tb.ptr[1][t]) + start;
  const float* __restrict__ m = reinterpret_cast<const float*>(tb.ptr[2][t]) + start;
  const float* __restrict__ v = reinterpret_cast<const float*>(tb.ptr[3][t]) + start;
  int done = 0;
  if (aligned4<TP>(p) && aligned4<float>(m) && aligned4<float>(v)) {
    const int n4 = len >> 2;
    walk_vectors<3, false>(
        n4,
        [&](int i, float (&r)[3][4]) {
          load4cg(p + 4 * i, r[0]);
          load4cg(m + 4 * i, r[1]);
          load4cg(v + 4 * i, r[2]);
        },
        [&](int i, float (&r)[3][4]) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float upd = adam_direction(a, r[1][e], r[2][e], r[0][e], bc1, bc2);
            r[0][e] = apply_update<TG, TP>(r[0][e], __fmul_rn(step, upd));
          }
          store4(p + 4 * i, r[0]);
        });
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < len; e += THREADS) {
    const float pv = load1cg(p + e);
    const float upd = adam_direction(a, load1cg(m + e), load1cg(v + e), pv, bc1, bc2);
    p[e] = from_f<TP>(apply_update<TG, TP>(pv, __fmul_rn(step, upd)));
  }
}

// K15: LAMB in place over the whole list in one cooperative launch (every
// block resident): every chunk through stage 1, grid-stride; a grid
// barrier; each tensor's step, a warp a tensor; a grid barrier; every tile
// through stage 2, grid-stride from the list's last tile back.
template <typename TG, typename TP>
__global__ void __launch_bounds__(THREADS, LIST_MIN_BLOCKS)
    lamb_list_kernel(const ListTable tb, const AdamArgs a, const ListScratch sc) {
  if (a.skip && *a.skip) return;
  write_count(a);
  const float bc1 = a.bias_correction ? *a.bc1 : 1.0f;
  const float bc2 = a.bias_correction ? *a.bc2 : 1.0f;
  const float neg_lr = a.neg_lr_ptr ? *a.neg_lr_ptr : a.neg_lr;
  const float clip = lamb_clip(a);
  const int n = tb.ntensors;
  for (int c = blockIdx.x; c < tb.chunk_start[n]; c += gridDim.x) {
    const int t = last_at_or_below(tb.chunk_start, 0, n, c);
    lamb_stage1_chunk<TG, TP>(tb, a, sc, t, c, bc1, bc2, clip);
  }
  cg::this_grid().sync();
  const int gw = (int)((blockIdx.x * THREADS + threadIdx.x) >> 5);
  for (int t = gw; t < n; t += (int)gridDim.x * VWARPS) lamb_tensor_step(tb, a, sc, t, neg_lr);
  cg::this_grid().sync();
  const int last = tb.tile_start[n] - 1;
  for (int i = blockIdx.x; i <= last; i += gridDim.x) {
    const int t = last_at_or_below(tb.tile_start, 0, n, last - i);
    lamb_stage2_tile<TG, TP>(tb, a, sc, t, last - i - tb.tile_start[t], bc1, bc2);
  }
}

// the list kernel of form 0 (K14) or 1 (K15) for these dtypes
template <typename TG, typename TP>
const void* list_kernel_of(int form) {
  return form == 0 ? (const void*)adam_list_kernel<TG, TP>
                   : (const void*)lamb_list_kernel<TG, TP>;
}

// SGD's new parameter for one element, in the plain version's order
// (optimizers/fused_sgd.py update, then apply_plain's add): weight decay
// folded into g, buf = g on the first step and mu buf + (1 - dampening) g
// after, Nesterov's g + mu buf, -lr d cast to the gradient's dtype and then
// to the parameter's; buf is updated in place
template <typename TG, typename TP>
__device__ __forceinline__ float sgd_elem(const SgdArgs& a, float g, float p, float& b,
                                          bool first, float neg_lr) {
  if (a.decay) g = __fadd_rn(g, __fmul_rn(a.wd, p));
  float d = g;
  if (a.use_momentum) {
    b = first ? g : __fadd_rn(__fmul_rn(a.momentum, b), __fmul_rn(a.one_minus_damp, g));
    d = a.nesterov ? __fadd_rn(g, __fmul_rn(a.momentum, b)) : b;
  }
  return apply_update<TG, TP>(p, __fmul_rn(neg_lr, d));
}

// K16: SGD in place on p and its fp32 momentum buffer, the step count, and
// (copy) the parameter written again in the model's dtype TM
template <typename TG, typename TP, typename TM>
__global__ void __launch_bounds__(THREADS) sgd_kernel(const Table<4> tb, const SgdArgs a) {
  if (a.skip && *a.skip) return;
  if (blockIdx.x == 0 && threadIdx.x == 0) *a.count = *a.count_new;
  if ((int)blockIdx.x >= tb.chunk_start[tb.ntensors]) return;
  const Span s = chunk_span(tb, blockIdx.x);
  const TG* g = reinterpret_cast<const TG*>(tb.ptr[0][s.t]) + s.start;
  TP* p = reinterpret_cast<TP*>(tb.ptr[1][s.t]) + s.start;
  float* buf = reinterpret_cast<float*>(tb.ptr[2][s.t]) + s.start;
  TM* mdl = a.copy ? reinterpret_cast<TM*>(tb.ptr[3][s.t]) + s.start : nullptr;
  const float neg_lr = a.neg_lr_ptr ? *a.neg_lr_ptr : a.neg_lr;
  const bool first = *a.count_new == 1;
  int done = 0;
  if (aligned4<TG>(g) && aligned4<TP>(p) && aligned4<float>(buf) &&
      (!a.copy || aligned4<TM>(mdl))) {
    const int n4 = s.len >> 2;
    for (int i = threadIdx.x; i < n4; i += THREADS) {
      float gv[4], pv[4], bv[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      load4(g + 4 * i, gv);
      load4(p + 4 * i, pv);
      if (a.use_momentum) load4(buf + 4 * i, bv);
#pragma unroll
      for (int k = 0; k < 4; ++k)
        pv[k] = to_f(from_f<TP>(sgd_elem<TG, TP>(a, gv[k], pv[k], bv[k], first, neg_lr)));
      store4(p + 4 * i, pv);
      if (a.use_momentum) store4(buf + 4 * i, bv);
      if (a.copy) store4(mdl + 4 * i, pv);
    }
    done = n4 << 2;
  }
  for (int e = done + threadIdx.x; e < s.len; e += THREADS) {
    float bv = a.use_momentum ? buf[e] : 0.0f;
    const TP pn = from_f<TP>(sgd_elem<TG, TP>(a, to_f(g[e]), to_f(p[e]), bv, first, neg_lr));
    p[e] = pn;
    if (a.use_momentum) buf[e] = bv;
    if (a.copy) mdl[e] = from_f<TM>(to_f(pn));
  }
}

// ---------------------------------------------------------------- host side

// a table from the host arrays: ptrs [D][n] device addresses, numels [n];
// the group's chunks in *chunks
template <int D>
cudaError_t fill(Table<D>& tb, const long long* ptrs, const long long* numels, int n,
                 long long chunk_base, long long tensor_base, int* chunks) {
  if (n < 1 || n > Table<D>::CAP || chunk_base < 0 || chunk_base > 0x7fffffffLL ||
      tensor_base < 0 || tensor_base > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  memset(&tb, 0, sizeof(tb));
  long long c = 0;
  for (int i = 0; i < n; ++i) {
    if (numels[i] < 0 || numels[i] > 0x7fffffffLL) return cudaErrorInvalidValue;
    for (int d = 0; d < D; ++d) tb.ptr[d][i] = reinterpret_cast<void*>(ptrs[d * n + i]);
    tb.numel[i] = (int)numels[i];
    tb.chunk_start[i] = (int)c;
    c += (numels[i] + CHUNK - 1) / CHUNK;
  }
  if (c + chunk_base > 0x7fffffffLL) return cudaErrorInvalidValue;
  tb.chunk_start[n] = (int)c;
  tb.ntensors = n;
  tb.chunk_base = (int)chunk_base;
  tb.tensor_base = (int)tensor_base;
  *chunks = (int)c;
  return cudaSuccess;
}

bool dtype_ok(int d) { return d >= 0 && d <= 2; }

}  // namespace

// runs the statement with T the element type of a dtype code (0 bf16, 1
// fp16, 2 fp32); a call may nest in another's statement (arguments expand
// first)
#define MT_DISPATCH(code, T, ...)       \
  switch (code) {                       \
    case 0: {                           \
      using T = __nv_bfloat16;          \
      __VA_ARGS__;                      \
    } break;                            \
    case 1: {                           \
      using T = __half;                 \
      __VA_ARGS__;                      \
    } break;                            \
    default: {                          \
      using T = float;                  \
      __VA_ARGS__;                      \
    } break;                            \
  }

extern "C" int multi_tensor_capacity(int depth) {
  return depth >= 1 && depth <= 4 ? capacity(depth) : 0;
}

extern "C" int multi_tensor_chunk() { return CHUNK; }

// K12: outs = ins * scale (hyper: scale, a, b unused), dtypes of the
// group's inputs and outputs; flag_bytes 1 (bool) or 4 (int32)
extern "C" int multi_tensor_scale(const long long* ptrs, const long long* numels, int n,
                                  int in_dtype, int out_dtype, const float* scale_ptr,
                                  float scale, void* flag, int flag_bytes, int check_input,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dtype_ok(in_dtype) || !dtype_ok(out_dtype) || !flag ||
      (flag_bytes != 1 && flag_bytes != 4))
    return (int)cudaErrorInvalidValue;
  Table<2> tb;
  int chunks = 0;
  err = fill(tb, ptrs, numels, n, 0, 0, &chunks);
  if (err != cudaSuccess) return (int)err;
  if (chunks == 0) return (int)cudaErrorInvalidValue;
  ScaleArgs a{scale_ptr, scale, 0.0f, 0.0f, flag, flag_bytes, check_input};
  cudaStream_t st = (cudaStream_t)stream;
  MT_DISPATCH(in_dtype, TI,
                MT_DISPATCH(out_dtype, TO,
                              scale_kernel<TI, TO><<<chunks, THREADS, 0, st>>>(tb, a)))
  return (int)cudaGetLastError();
}

// K12, axpby: outs = a xs + b ys (xs and ys of one dtype); flag on outputs
extern "C" int multi_tensor_axpby(const long long* ptrs, const long long* numels, int n,
                                  int in_dtype, int out_dtype, float a_, float b_, void* flag,
                                  int flag_bytes, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dtype_ok(in_dtype) || !dtype_ok(out_dtype) || !flag ||
      (flag_bytes != 1 && flag_bytes != 4))
    return (int)cudaErrorInvalidValue;
  Table<3> tb;
  int chunks = 0;
  err = fill(tb, ptrs, numels, n, 0, 0, &chunks);
  if (err != cudaSuccess) return (int)err;
  if (chunks == 0) return (int)cudaErrorInvalidValue;
  ScaleArgs a{nullptr, 0.0f, a_, b_, flag, flag_bytes, 0};
  cudaStream_t st = (cudaStream_t)stream;
  MT_DISPATCH(in_dtype, TI,
                MT_DISPATCH(out_dtype, TO,
                              axpby_kernel<TI, TO><<<chunks, THREADS, 0, st>>>(tb, a)))
  return (int)cudaGetLastError();
}

// K13, first stage: one partial a chunk into partials[chunk_base + ...]
extern "C" int multi_tensor_norm_partials(const long long* ptrs, const long long* numels,
                                          int n, int dtype, int max_mode, float* partials,
                                          long long chunk_base, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!dtype_ok(dtype) || !partials) return (int)cudaErrorInvalidValue;
  Table<1> tb;
  int chunks = 0;
  err = fill(tb, ptrs, numels, n, chunk_base, 0, &chunks);
  if (err != cudaSuccess) return (int)err;
  if (chunks == 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (max_mode) {
    MT_DISPATCH(dtype, T, norm_partials_kernel<T, true><<<chunks, THREADS, 0, st>>>(tb, partials))
  } else {
    MT_DISPATCH(dtype, T, norm_partials_kernel<T, false><<<chunks, THREADS, 0, st>>>(tb, partials))
  }
  return (int)cudaGetLastError();
}

// K13, second stage over one group (sizes only); final_n > 0 in the last
// group's launch: the total over per_val[0, final_n)
extern "C" int multi_tensor_norm_reduce(const long long* numels, int n, int max_mode,
                                        const float* partials, long long chunk_base,
                                        long long tensor_base, float* per_val,
                                        float* per_norm, int final_n, float* total_val,
                                        float* total_norm, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!partials || !per_val || !per_norm || (final_n > 0 && (!total_val || !total_norm)))
    return (int)cudaErrorInvalidValue;
  Table<1> tb;
  int chunks = 0;
  // the pointers are unused here: the sizes alone give the chunk ranges
  long long zeros[Table<1>::CAP] = {};
  err = fill(tb, zeros, numels, n, chunk_base, tensor_base, &chunks);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (max_mode)
    norm_reduce_kernel<true><<<1, REDUCE_THREADS, 0, st>>>(tb, partials, per_val, per_norm,
                                                          final_n, total_val, total_norm);
  else
    norm_reduce_kernel<false><<<1, REDUCE_THREADS, 0, st>>>(tb, partials, per_val, per_norm,
                                                           final_n, total_val, total_norm);
  return (int)cudaGetLastError();
}

namespace {

// hyper: beta1, beta1c, beta2, beta2c, eps, wd, beta3, max_grad_norm,
// neg_lr; flags: adam_w_mode, bias_correction, decay, trust; devptrs:
// bc1, bc2, neg_lr, global_sq, skip, count, count_new (0 = null)
AdamArgs adam_args(const float* hyper, const int* flags, const long long* devptrs) {
  AdamArgs a;
  a.beta1 = hyper[0];
  a.beta1c = hyper[1];
  a.beta2 = hyper[2];
  a.beta2c = hyper[3];
  a.eps = hyper[4];
  a.wd = hyper[5];
  a.beta3 = hyper[6];
  a.max_grad_norm = hyper[7];
  a.neg_lr = hyper[8];
  a.adam_w_mode = flags[0];
  a.bias_correction = flags[1];
  a.decay = flags[2];
  a.trust = flags[3];
  a.bc1 = reinterpret_cast<const float*>(devptrs[0]);
  a.bc2 = reinterpret_cast<const float*>(devptrs[1]);
  a.neg_lr_ptr = reinterpret_cast<const float*>(devptrs[2]);
  a.global_sq = reinterpret_cast<const float*>(devptrs[3]);
  a.skip = reinterpret_cast<const unsigned char*>(devptrs[4]);
  a.count = reinterpret_cast<int*>(devptrs[5]);
  a.count_new = reinterpret_cast<const int*>(devptrs[6]);
  return a;
}

// the gradient's dtype is the parameter's or fp32 (the wrapper casts others)
bool pair_ok(int g_dtype, int p_dtype) {
  return dtype_ok(g_dtype) && dtype_ok(p_dtype) && (g_dtype == p_dtype || g_dtype == 2);
}

}  // namespace

namespace {

// a list's table from the host arrays: ptrs [4][n] device addresses,
// numels [n]
cudaError_t fill_list(ListTable& tb, const long long* ptrs, const long long* numels, int n) {
  if (n < 1 || n > LIST_CAP) return cudaErrorInvalidValue;
  memset(&tb, 0, sizeof(tb));
  long long chunks = 0, tiles = 0;
  for (int i = 0; i < n; ++i) {
    if (numels[i] < 0 || numels[i] > 0x7fffffffLL) return cudaErrorInvalidValue;
    for (int d = 0; d < 4; ++d) tb.ptr[d][i] = reinterpret_cast<void*>(ptrs[d * n + i]);
    tb.numel[i] = (int)numels[i];
    tb.chunk_start[i] = (int)chunks;
    tb.tile_start[i] = (int)tiles;
    chunks += (numels[i] + CHUNK - 1) / CHUNK;
    tiles += (numels[i] + TILE - 1) / TILE;
  }
  if (chunks + tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  tb.chunk_start[n] = (int)chunks;
  tb.tile_start[n] = (int)tiles;
  tb.ntensors = n;
  return cudaSuccess;
}

// the list kernel of form 0 (K14) or 1 (K15), or null for dtypes it is
// not built for
const void* list_kernel(int form, int g_dtype, int p_dtype) {
  if (!pair_ok(g_dtype, p_dtype) || (form != 0 && form != 1)) return nullptr;
  const void* fn = nullptr;
  if (g_dtype == p_dtype) {
    MT_DISPATCH(p_dtype, TP, fn = list_kernel_of<TP, TP>(form))
  } else {
    MT_DISPATCH(p_dtype, TP, fn = list_kernel_of<float, TP>(form))
  }
  return fn;
}

}  // namespace

extern "C" int multi_tensor_list_capacity() { return LIST_CAP; }

extern "C" int multi_tensor_tile() { return TILE; }

// the blocks of the K14 (form 0) or K15 (form 1) instantiation for these
// dtypes that one SM holds at once, into *blocks
extern "C" int multi_tensor_list_resident(int form, int g_dtype, int p_dtype, int* blocks,
                                          int device, void* stream) {
  (void)stream;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = list_kernel(form, g_dtype, p_dtype);
  if (!fn || !blocks) return (int)cudaErrorInvalidValue;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, THREADS, 0);
}

// K14 over a list of n tensors in one launch of `grid` blocks: ptrs [4][n]
// = g, p, m, v
extern "C" int multi_tensor_adam(const long long* ptrs, const long long* numels, int n,
                                 int g_dtype, int p_dtype, int grid, const float* hyper,
                                 const int* flags, const long long* devptrs, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = list_kernel(0, g_dtype, p_dtype);
  if (!fn || grid < 1) return (int)cudaErrorInvalidValue;
  ListTable tb;
  err = fill_list(tb, ptrs, numels, n);
  if (err != cudaSuccess) return (int)err;
  AdamArgs a = adam_args(hyper, flags, devptrs);
  if ((a.bias_correction && (!a.bc1 || !a.bc2)) || (a.count && !a.count_new))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&tb, &a};
  err = cudaLaunchKernel(fn, dim3((unsigned)grid), dim3(THREADS), args, 0, (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error too
  return (int)(err != cudaSuccess ? err : last);
}

// K15 over a list of n tensors in one cooperative launch of `grid` blocks
// (at most what the card holds at once, or the launch is refused): ptrs
// [4][n] = g, p, m, v; devptrs as multi_tensor_adam's, then the fp32
// scratch: the chunks' sums of p * p and of u * u [chunks each] and the
// steps [n]
extern "C" int multi_tensor_lamb(const long long* ptrs, const long long* numels, int n,
                                 int g_dtype, int p_dtype, int grid, const float* hyper,
                                 const int* flags, const long long* devptrs, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* fn = list_kernel(1, g_dtype, p_dtype);
  if (!fn || grid < 1) return (int)cudaErrorInvalidValue;
  ListTable tb;
  err = fill_list(tb, ptrs, numels, n);
  if (err != cudaSuccess) return (int)err;
  AdamArgs a = adam_args(hyper, flags, devptrs);
  ListScratch sc;
  sc.pw = reinterpret_cast<float*>(devptrs[7]);
  sc.pu = reinterpret_cast<float*>(devptrs[8]);
  sc.steps = reinterpret_cast<float*>(devptrs[9]);
  if ((a.bias_correction && (!a.bc1 || !a.bc2)) || (a.count && !a.count_new) || !sc.pw ||
      !sc.pu || !sc.steps || (a.max_grad_norm > 0.0f && !a.global_sq))
    return (int)cudaErrorInvalidValue;
  void* args[] = {&tb, &a, &sc};
  err = cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid), dim3(THREADS), args, 0,
                                    (cudaStream_t)stream);
  const cudaError_t last = cudaGetLastError();  // clears a refused launch's error too
  return (int)(err != cudaSuccess ? err : last);
}

// K16 over one group: ptrs [4][n] = g, p, buf, model copy (the last row
// unused unless m_dtype >= 0); hyper: wd, momentum, 1 - dampening, neg_lr;
// flags: decay, use_momentum, nesterov; devptrs: neg_lr, skip, count,
// count_new (0 = null; count and count_new are required)
extern "C" int multi_tensor_sgd(const long long* ptrs, const long long* numels, int n,
                                int g_dtype, int p_dtype, int m_dtype, const float* hyper,
                                const int* flags, const long long* devptrs, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!pair_ok(g_dtype, p_dtype) || (m_dtype != -1 && !dtype_ok(m_dtype)))
    return (int)cudaErrorInvalidValue;
  Table<4> tb;
  int chunks = 0;
  err = fill(tb, ptrs, numels, n, 0, 0, &chunks);
  if (err != cudaSuccess) return (int)err;
  SgdArgs a;
  a.wd = hyper[0];
  a.momentum = hyper[1];
  a.one_minus_damp = hyper[2];
  a.neg_lr = hyper[3];
  a.decay = flags[0];
  a.use_momentum = flags[1];
  a.nesterov = flags[2];
  a.copy = m_dtype >= 0;
  a.neg_lr_ptr = reinterpret_cast<const float*>(devptrs[0]);
  a.skip = reinterpret_cast<const unsigned char*>(devptrs[1]);
  a.count = reinterpret_cast<int*>(devptrs[2]);
  a.count_new = reinterpret_cast<const int*>(devptrs[3]);
  if (!a.count || !a.count_new) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = chunks > 0 ? chunks : 1;
  const int m_code = a.copy ? m_dtype : 2;
  if (g_dtype == p_dtype) {
    MT_DISPATCH(p_dtype, TP,
                  MT_DISPATCH(m_code, TM,
                                sgd_kernel<TP, TP, TM><<<blocks, THREADS, 0, st>>>(tb, a)))
  } else {
    MT_DISPATCH(p_dtype, TP,
                  MT_DISPATCH(m_code, TM,
                                sgd_kernel<float, TP, TM><<<blocks, THREADS, 0, st>>>(tb, a)))
  }
  return (int)cudaGetLastError();
}

namespace {

// K21: Adam on one rank's fp32 shard (g already reduced and averaged):
// u = -lr * update in _adam_flat's order, written always (the ranks gather
// it on a skipped step too); m, v, master (+= u) and the count written
// unless skip is set
__global__ void __launch_bounds__(THREADS)
    zero_adam_kernel(const float* g, float* p, float* m, float* v, float* u, long long n,
                     const AdamArgs a) {
  const bool keep = a.skip && *a.skip;
  if (!keep) write_count(a);
  const float bc1 = a.bias_correction ? *a.bc1 : 1.0f;
  const float bc2 = a.bias_correction ? *a.bc2 : 1.0f;
  const float neg_lr = a.neg_lr_ptr ? *a.neg_lr_ptr : a.neg_lr;
  const long long quads = n >> 2;
  const long long stride = (long long)gridDim.x * THREADS;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < quads; i += stride) {
    float gv[4], pv[4], mv[4], vv[4], uv[4];
    load4(g + 4 * i, gv);
    load4(p + 4 * i, pv);
    load4(m + 4 * i, mv);
    load4(v + 4 * i, vv);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      adam_moments(a, gv[k], pv[k], a.beta1c, mv[k], vv[k]);
      uv[k] = __fmul_rn(adam_direction(a, mv[k], vv[k], pv[k], bc1, bc2), neg_lr);
      pv[k] = __fadd_rn(pv[k], uv[k]);
    }
    store4(u + 4 * i, uv);
    if (!keep) {
      store4(p + 4 * i, pv);
      store4(m + 4 * i, mv);
      store4(v + 4 * i, vv);
    }
  }
  for (long long e = (quads << 2) + (long long)blockIdx.x * THREADS + threadIdx.x; e < n;
       e += stride) {
    float mv = m[e], vv = v[e];
    const float pv = p[e];
    adam_moments(a, g[e], pv, a.beta1c, mv, vv);
    const float uv = __fmul_rn(adam_direction(a, mv, vv, pv, bc1, bc2), neg_lr);
    u[e] = uv;
    if (!keep) {
      p[e] = __fadd_rn(pv, uv);
      m[e] = mv;
      v[e] = vv;
    }
  }
}

struct Pieces {
  const long long* start;   // first element of each piece in the shard
  const int* len;           // its length, at most CHUNK
  const int* seg;           // its segment: a tensor, or N for the padding
  int count;
};

// K22, stage 1: a piece's clipped moments (written unless skip), the
// direction u, and the piece's sums of p * p and u * u into
// partials[piece] and partials[count + piece]
__global__ void __launch_bounds__(THREADS)
    zero_lamb_stage1_kernel(const float* g, const float* p, float* m, float* v, float* u,
                            const Pieces pc, float* partials, const AdamArgs a) {
  const bool keep = a.skip && *a.skip;
  if (!keep) write_count(a);
  const long long s0 = pc.start[blockIdx.x];
  const int len = pc.len[blockIdx.x];
  const float bc1 = a.bias_correction ? *a.bc1 : 1.0f;
  const float bc2 = a.bias_correction ? *a.bc2 : 1.0f;
  const float clip = lamb_clip(a);
  const bool clipping = a.max_grad_norm > 0.0f;
  float w_sq = 0.0f, u_sq = 0.0f;
  for (int e = threadIdx.x; e < len; e += THREADS) {
    const long long i = s0 + e;
    float mv = m[i], vv = v[i];
    const float pv = p[i];
    const float gc = clipping ? __fdiv_rn(g[i], clip) : g[i];
    adam_moments(a, gc, pv, a.beta3, mv, vv);
    const float uv = adam_direction(a, mv, vv, pv, bc1, bc2);
    u[i] = uv;
    if (!keep) {
      m[i] = mv;
      v[i] = vv;
    }
    w_sq = __fadd_rn(w_sq, __fmul_rn(pv, pv));
    u_sq = __fadd_rn(u_sq, __fmul_rn(uv, uv));
  }
  w_sq = block_reduce<false>(w_sq);
  u_sq = block_reduce<false>(u_sq);
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = w_sq;
    partials[pc.count + blockIdx.x] = u_sq;
  }
}

// K22, stage 1's second launch (one block): each segment's pieces summed
// in order, a warp a segment: sums[s] (p * p) and sums[nseg + s] (u * u)
__global__ void __launch_bounds__(REDUCE_THREADS)
    zero_lamb_segments_kernel(const float* partials, const int* seg_first, int nseg,
                              int count, float* sums) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int s = warp; s < nseg; s += warps) {
    float w = 0.0f, uu = 0.0f;
    for (int c = seg_first[s] + lane; c < seg_first[s + 1]; c += 32) {
      w = __fadd_rn(w, partials[c]);
      uu = __fadd_rn(uu, partials[count + c]);
    }
    w = warp_reduce<false>(w);
    uu = warp_reduce<false>(uu);
    if (lane == 0) {
      sums[s] = w;
      sums[nseg + s] = uu;
    }
  }
}

// K22, stage 2: the piece's trust ratio from the all-reduced sums (1 for
// the padding segment, or everywhere unless trust), u = (-lr ratio) u, and
// master += u unless skip
__global__ void __launch_bounds__(THREADS)
    zero_lamb_stage2_kernel(float* p, float* u, const Pieces pc, const float* sums, int nseg,
                            const AdamArgs a) {
  const bool keep = a.skip && *a.skip;
  const long long s0 = pc.start[blockIdx.x];
  const int len = pc.len[blockIdx.x];
  const int seg = pc.seg[blockIdx.x];
  const float neg_lr = a.neg_lr_ptr ? *a.neg_lr_ptr : a.neg_lr;
  float ratio = 1.0f;
  if (a.trust && seg < nseg - 1) {
    const float w = __fsqrt_rn(sums[seg]);
    const float un = __fsqrt_rn(sums[nseg + seg]);
    ratio = (w > 0.0f && un > 0.0f) ? __fdiv_rn(w, __fadd_rn(un, 1e-38f)) : 1.0f;
  }
  const float step = __fmul_rn(neg_lr, ratio);
  for (int e = threadIdx.x; e < len; e += THREADS) {
    const long long i = s0 + e;
    const float upd = __fmul_rn(step, u[i]);
    u[i] = upd;
    if (!keep) p[i] = __fadd_rn(p[i], upd);
  }
}

}  // namespace

// K21 over one shard of n fp32 elements: g, master p, m, v, and the
// update u written; hyper, flags and devptrs as multi_tensor_adam's
extern "C" int multi_tensor_zero_adam(const float* g, float* p, float* m, float* v, float* u,
                                      long long n, const float* hyper, const int* flags,
                                      const long long* devptrs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!g || !p || !m || !v || !u || n < 1) return (int)cudaErrorInvalidValue;
  const AdamArgs a = adam_args(hyper, flags, devptrs);
  if ((a.bias_correction && (!a.bc1 || !a.bc2)) || (a.count && !a.count_new))
    return (int)cudaErrorInvalidValue;
  long long blocks = (n / 4 + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  if (blocks > 8192) blocks = 8192;
  zero_adam_kernel<<<(int)blocks, THREADS, 0, (cudaStream_t)stream>>>(g, p, m, v, u, n, a);
  return (int)cudaGetLastError();
}

// K22 over one shard: stage 1 (two launches: the pieces, then the
// segments' sums into sums [2, nseg]) or stage 2 (the update); the
// pieces' arrays and seg_first [nseg + 1] are device arrays
extern "C" int multi_tensor_zero_lamb(int stage, const float* g, float* p, float* m, float* v,
                                      float* u, const long long* piece_start,
                                      const int* piece_len, const int* piece_seg, int count,
                                      const int* seg_first, int nseg, float* partials,
                                      float* sums, const float* hyper, const int* flags,
                                      const long long* devptrs, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((stage != 1 && stage != 2) || !p || !u || !piece_start || !piece_len || !piece_seg ||
      count < 1 || nseg < 1 || !sums)
    return (int)cudaErrorInvalidValue;
  const AdamArgs a = adam_args(hyper, flags, devptrs);
  const Pieces pc{piece_start, piece_len, piece_seg, count};
  cudaStream_t st = (cudaStream_t)stream;
  if (stage == 1) {
    if (!g || !m || !v || !partials || !seg_first ||
        (a.bias_correction && (!a.bc1 || !a.bc2)) || (a.count && !a.count_new) ||
        (a.max_grad_norm > 0.0f && !a.global_sq))
      return (int)cudaErrorInvalidValue;
    zero_lamb_stage1_kernel<<<count, THREADS, 0, st>>>(g, p, m, v, u, pc, partials, a);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    zero_lamb_segments_kernel<<<1, REDUCE_THREADS, 0, st>>>(partials, seg_first, nseg, count,
                                                           sums);
  } else {
    zero_lamb_stage2_kernel<<<count, THREADS, 0, st>>>(p, u, pc, sums, nseg, a);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* multi_tensor_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

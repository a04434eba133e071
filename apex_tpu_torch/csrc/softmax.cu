// Fused scale + mask + softmax over the last axis, forward (K10) and
// backward (K11).
//
// Replaces apex_tpu/ops/softmax_pallas.py:185 (_fwd :159, kernel
// _fwd_kernel :106) and :212 (_bwd_rule :204, kernel _bwd_kernel :130).
// K10 computes softmax(scale * x) in fp32 with masked positions at
// -FLT_MAX before the row max (jnp.finfo(float32).min) and exactly 0 after
// the exponential; a row whose positions are all masked gives 0; the
// output is in x's dtype. The mask is the causal triangle (column > row,
// from the indices) and/or an explicit bool/int8 mask [b|1, np|1, sq|1,
// sk] (nonzero = masked), read at a stride of 0 along each axis of size
// 1, so a [b, 1, sq, sk] mask is broadcast over heads and a key-padding
// [b, 1, 1, sk] mask over heads and queries by index, never expanded. K11
// computes the VJP on the saved output, dx = scale * y * (g - sum(g * y))
// in fp32, output in y's dtype; masked positions have y == 0, so it needs
// no mask.
//
// Layout: x, y, g, dx [rows, sk] contiguous, rows = b * np * sq in
// (b, head, query) order; mask rows sk contiguous bytes, at the batch,
// head and query strides the wrapper passes (multiples of sk, or 0).
//
// What bounds them on H100: bytes. K10 reads x and writes y (at [8, 12,
// 1024, 1024] bf16, 201 MB each: 0.120 ms at 3.35 TB/s; a causal row
// reads only its live half, 0.090 ms), K11 reads y and g and writes dx
// (0.180 ms); the arithmetic is a few operations per element. The TPU
// kernels hold a block of whole rows in VMEM; here one warp owns one row
// and holds it in registers: each lane loads its share in 16-byte vectors
// (a lane's vectors are 32 vectors apart, so a warp's load is 512
// contiguous bytes), one shuffle reduction gives the row max and one the
// sum, and the row is written from the same registers. At sk = 1024 in
// bf16 that is four 16-byte loads and 32 fp32 values a lane (K11 keeps y
// and g so up to 32 values a lane and reads longer rows twice). Under the
// causal mask K10 does not read x in vectors that lie wholly above the
// diagonal and writes zeros there. In bf16 and fp16 K10 takes the
// exponential as ex2 of (v - max) log2 e and scales the row by one
// reciprocal of its sum (fp32 keeps expf and the division: its band is a
// few fp32 ulps). The per-element expf and IEEE division had held K10 at
// 0.36 of its byte bound at the scores path's shape, where K11, with the
// same layout, reads 0.89; without them it reads ~0.7 (PERF.md, §6).
// Issuing all of a lane's loads before using any was slower there (it
// holds more registers a lane), and 32-bit row-index arithmetic gained
// nothing. Rows whose length is not a multiple of the vector (or whose
// start is not 16-byte aligned) take element loads instead (the SCALAR
// instantiations). A block of four warps takes four rows; each kernel is
// instantiated for up to 8, 32 and 128 elements a lane (sk <= 256, 1024,
// 4096).
//
// Longer rows (K10L and K11L, sk > 4096) do not fit one warp's registers.
// There one block owns a row. K11L walks it in 16-byte vectors of
// LONG_THREADS threads, neighbouring threads on neighbouring vectors,
// reading y and g twice (the dot, then dx written), its block-wide sum
// reduced through shared memory. K10L (redesigned for Hopper) reads x from
// device memory once wherever the row fits on chip, in one of three bodies
// that softmax_cuda.long_plan(sk, itemsize) names from the row's length and
// the dtype's size (the fastest an H100 measured):
//  - regs (bf16/fp16, up to 8192 keys): the row in registers,
//    LONG_REG_VALUES fp32 values (4 vectors) a thread, the fewest warps
//    that cover it (8192 keys take 256 threads): every load issued before
//    any is used, a max and a sum reduced over the block, y written from
//    the registers;
//  - smem (to LONG_SMEM_MAX bytes of stage, 49152 bf16/fp16 or 24576 fp32
//    keys; fp32 from the first long row, where it beat an fp32 register
//    body, which is not built):
//    the row staged in dynamic shared memory in x's own dtype, a byte of
//    mask bits a vector, about 8 vectors a thread; the max taken as it is
//    staged, the sum and y from shared memory;
//  - walk: past that, each thread carries an online (max, sum) pair over
//    its vectors (the sum rescaled where the max moves), the pairs
//    combined over the block, then a second read writes y: two reads of
//    x where the parent's body made three.
// Vectors wholly past the causal diagonal are written as zeros before the
// reductions, under their latency.
// In bf16 and fp16 each body takes the exponential as ex2 of (v - max)
// log2 e and scales by one reciprocal of the sum, as K10 does; fp32 keeps
// expf and the division. The parent's K10L (one body of 256 threads
// reading x three times, expf and a division an element) read 0.41 of
// its byte bound at [1, 12, 1024, 8192] bf16 (PERF.md). Masks, the causal
// skip (vectors wholly above the diagonal are neither read nor computed,
// only written as zeros), the sum > 0 guard of a fully masked row and the
// stride-0 mask axes are K10's; the fixed thread-to-element map and the
// fixed reduction order give the same bits on every run.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;            // rows per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_SK = 4096;
constexpr int MAX_DEVICES = 64;

template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// EPV elements of a row starting at column c0 (every one < sk when VEC):
// one 16-byte load, or element loads masked at sk
template <typename T, int EPV, bool VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p, int c0, int sk,
                                         float (&out)[EPV]) {
  if constexpr (VEC) {
    const Pack<T, EPV> pk = *reinterpret_cast<const Pack<T, EPV>*>(p + c0);
#pragma unroll
    for (int e = 0; e < EPV; ++e) out[e] = to_f(pk.v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < EPV; ++e) out[e] = c0 + e < sk ? to_f(p[c0 + e]) : 0.f;
  }
}

template <typename T, int EPV, bool VEC>
__device__ __forceinline__ void store_row(T* __restrict__ p, int c0, int sk,
                                          const float (&in)[EPV]) {
  if constexpr (VEC) {
    Pack<T, EPV> pk;
#pragma unroll
    for (int e = 0; e < EPV; ++e) pk.v[e] = from_f<T>(in[e]);
    *reinterpret_cast<Pack<T, EPV>*>(p + c0) = pk;
  } else {
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      if (c0 + e < sk) p[c0 + e] = from_f<T>(in[e]);
  }
}

// 2^x on the SFU (MUFU.EX2), subnormal results kept as expf keeps them
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

// NV vectors of EPV elements a lane; lane l's vector v starts at column
// (v * 32 + l) * EPV. For bf16 and fp16 the exponential is ex2 of (v - max)
// log2 e and the row is scaled by one reciprocal of its sum; fp32 keeps
// expf and the division, since its band is a few fp32 ulps.
template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(THREADS)
softmax_fwd_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                   T* __restrict__ y, long long rows, int sq, int sk, int np,
                   long long mask_sb, long long mask_sh, long long mask_sq,
                   float scale, int causal) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr bool HALF = sizeof(T) == 2;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;                     // warp-uniform
  const int lane = threadIdx.x % 32;
  const int i = (int)(row % sq);               // the query index
  const long long bh = row / sq;
  const long long b = bh / np;
  const int h = (int)(bh % np);
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const uint8_t* mr =
      mask ? mask + b * mask_sb + (long long)h * mask_sh + (long long)i * mask_sq
           : nullptr;

  float val[NV][EPV];
  unsigned masked[NV];                         // bit e: element e is masked
  float mx = -INFINITY;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * 32 + lane) * EPV;
    masked[v] = (1u << EPV) - 1;
#pragma unroll
    for (int e = 0; e < EPV; ++e) val[v][e] = -FLT_MAX;
    if (c0 >= sk) continue;                    // past the row: no element
    if (causal && c0 > i) {                    // wholly above the diagonal
      mx = fmaxf(mx, -FLT_MAX);
      continue;
    }
    float xv[EPV];
    load_row<T, EPV, VEC>(xr, c0, sk, xv);
    uint8_t mk[EPV];
#pragma unroll
    for (int e = 0; e < EPV; ++e) mk[e] = 0;
    if (mr) {
      if constexpr (VEC) {
        const Pack<uint8_t, EPV> pk = *reinterpret_cast<const Pack<uint8_t, EPV>*>(mr + c0);
#pragma unroll
        for (int e = 0; e < EPV; ++e) mk[e] = pk.v[e];
      } else {
#pragma unroll
        for (int e = 0; e < EPV; ++e) mk[e] = c0 + e < sk ? mr[c0 + e] : 0;
      }
    }
    unsigned bits = 0;
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const int col = c0 + e;
      if (col >= sk) {                         // element loads only
        bits |= 1u << e;
        continue;
      }
      if (mk[e] != 0 || (causal && col > i)) {
        bits |= 1u << e;
        mx = fmaxf(mx, -FLT_MAX);
      } else {
        val[v][e] = xv[e] * scale;
        mx = fmaxf(mx, val[v][e]);
      }
    }
    masked[v] = bits;
  }
  mx = warp_max(mx);

  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v)
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      const float d = val[v][e] - mx;
      val[v][e] = (masked[v] >> e) & 1u ? 0.f : (HALF ? ex2(d * LOG2E) : expf(d));
      sum += val[v][e];
    }
  sum = warp_sum(sum);
  // a row with every position masked has sum 0 and gives 0
  const float inv = sum > 0.f ? 1.f / sum : 0.f;

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * 32 + lane) * EPV;
    if (c0 >= sk) continue;
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      val[v][e] = HALF ? val[v][e] * inv : (sum > 0.f ? val[v][e] / sum : 0.f);
    store_row<T, EPV, VEC>(yr, c0, sk, val[v]);
  }
}

template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(THREADS)
softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ g,
                   T* __restrict__ dx, long long rows, int sk, float scale) {
  constexpr int EPV = 16 / sizeof(T);
  // up to 32 elements a lane, y and g stay in registers between the two
  // passes; longer rows read them again (from L1/L2) in the second
  constexpr bool KEEP = NV * EPV <= 32;
  constexpr int NK = KEEP ? NV : 1;
  const long long row = (long long)blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;                     // warp-uniform
  const int lane = threadIdx.x % 32;
  const T* yr = y + row * sk;
  const T* gr = g + row * sk;
  T* dr = dx + row * sk;

  float yv[NK][EPV], gv[NK][EPV];
  float dot = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * 32 + lane) * EPV;
    if (c0 >= sk) continue;
    float a[EPV], c[EPV];
    load_row<T, EPV, VEC>(yr, c0, sk, a);
    load_row<T, EPV, VEC>(gr, c0, sk, c);
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      dot = fmaf(a[e], c[e], dot);
      if constexpr (KEEP) {
        yv[v][e] = a[e];
        gv[v][e] = c[e];
      }
    }
  }
  dot = warp_sum(dot);

#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = (v * 32 + lane) * EPV;
    if (c0 >= sk) continue;
    float a[EPV], c[EPV];
    if constexpr (KEEP) {
#pragma unroll
      for (int e = 0; e < EPV; ++e) {
        a[e] = yv[v][e];
        c[e] = gv[v][e];
      }
    } else {
      load_row<T, EPV, VEC>(yr, c0, sk, a);
      load_row<T, EPV, VEC>(gr, c0, sk, c);
    }
    float out[EPV];
#pragma unroll
    for (int e = 0; e < EPV; ++e) out[e] = scale * a[e] * (c[e] - dot);
    store_row<T, EPV, VEC>(dr, c0, sk, out);
  }
}

// ---- K10L / K11L: one block per row, any length ---------------------------
constexpr int LONG_THREADS = 256;
constexpr int LONG_WARPS = LONG_THREADS / 32;

// the block's max (IS_MAX) or sum of v, the same value in every thread
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* red) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();                             // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < LONG_WARPS ? red[lane] : (IS_MAX ? -INFINITY : 0.f);
  return IS_MAX ? warp_max(v) : warp_sum(v);
}

// the EPV elements of x at c0 as scaled fp32 values, with bit e of the
// result set where element e is masked (or past the row)
template <typename T, int EPV, bool VEC>
__device__ __forceinline__ unsigned load_scaled(const T* __restrict__ xr,
                                                const uint8_t* __restrict__ mr,
                                                int c0, int sk, int i, int causal,
                                                float scale, float (&val)[EPV]) {
  float xv[EPV];
  load_row<T, EPV, VEC>(xr, c0, sk, xv);
  uint8_t mk[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) mk[e] = 0;
  if (mr) {
    if constexpr (VEC) {
      const Pack<uint8_t, EPV> pk = *reinterpret_cast<const Pack<uint8_t, EPV>*>(mr + c0);
#pragma unroll
      for (int e = 0; e < EPV; ++e) mk[e] = pk.v[e];
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) mk[e] = c0 + e < sk ? mr[c0 + e] : 0;
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    const int col = c0 + e;
    if (col >= sk || mk[e] != 0 || (causal && col > i)) {
      bits |= 1u << e;
      val[e] = -FLT_MAX;
    } else {
      val[e] = xv[e] * scale;
    }
  }
  return bits;
}

// ---- K10L: the redesigned long-row forward, three bodies ------------------
constexpr int LONG_MAX_THREADS = 512;
constexpr int LONG_REG_VALUES = 32;          // fp32 values a regs thread holds
constexpr int LONG_SMEM_MAX = 102 * 1024;    // the smem body's largest row stage
enum LongBody { BODY_REGS = 0, BODY_SMEM = 1, BODY_WALK = 2 };

// the block's max (IS_MAX) or sum of v over nwarps warps, in a fixed order,
// the same value in every thread
template <bool IS_MAX>
__device__ __forceinline__ float block_reduce_n(float v, float* red, int nwarps) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  v = IS_MAX ? warp_max(v) : warp_sum(v);
  __syncthreads();                             // red is free again
  if (lane == 0) red[warp] = v;
  __syncthreads();
  v = lane < nwarps ? red[lane] : (IS_MAX ? -INFINITY : 0.f);
  return IS_MAX ? warp_max(v) : warp_sum(v);
}

// the row a block owns: its query index, x and y rows, its mask row, and
// `live`, the first column at or past which no vector holds an unmasked
// element (past the row, or wholly above the causal diagonal)
template <typename T>
struct LongRow {
  int i, live;
  const T* xr;
  T* yr;
  const uint8_t* mr;
  __device__ LongRow(const T* x, const uint8_t* mask, T* y, int sq, int sk, int np,
                     long long msb, long long msh, long long msq, int causal) {
    const long long row = blockIdx.x;
    i = (int)(row % sq);
    const long long bh = row / sq;
    const long long b = bh / np;
    const int h = (int)(bh % np);
    xr = x + row * sk;
    yr = y + row * sk;
    mr = mask ? mask + b * msb + (long long)h * msh + (long long)i * msq : nullptr;
    live = causal ? min(sk, i + 1) : sk;
  }
};

// exp(d) as K10 takes it: ex2 of d log2 e in bf16/fp16, expf in fp32
template <bool HALF>
__device__ __forceinline__ float row_exp(float d) {
  return HALF ? ex2(d * LOG2E) : expf(d);
}

// y = e / sum: one reciprocal in bf16/fp16, the division in fp32; a fully
// masked row (sum 0) gives 0
template <bool HALF>
__device__ __forceinline__ float row_div(float e, float sum, float inv) {
  return HALF ? e * inv : (sum > 0.f ? e / sum : 0.f);
}

// regs: NV vectors a thread, the row in registers; thread t's vector v
// starts at column (v * blockDim.x + t) * EPV
template <typename T, int NV, bool VEC>
__global__ void __launch_bounds__(LONG_MAX_THREADS)
softmax_fwd_long_regs(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                      T* __restrict__ y, int sq, int sk, int np, long long mask_sb,
                      long long mask_sh, long long mask_sq, float scale, int causal) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr bool HALF = sizeof(T) == 2;
  __shared__ float red[LONG_MAX_THREADS / 32];
  const LongRow<T> r(x, mask, y, sq, sk, np, mask_sb, mask_sh, mask_sq, causal);
  const int stride = blockDim.x * EPV, nwarps = blockDim.x / 32;
  float val[NV][EPV];
  unsigned masked[NV];
  float mx = -INFINITY;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = threadIdx.x * EPV + v * stride;
    masked[v] = (1u << EPV) - 1;
#pragma unroll
    for (int e = 0; e < EPV; ++e) val[v][e] = -FLT_MAX;
    if (c0 < r.live)
      masked[v] = load_scaled<T, EPV, VEC>(r.xr, r.mr, c0, sk, r.i, causal, scale,
                                           val[v]);
  }
  // the vectors at or past `live` (the causal tail) are zeros: written now,
  // under the reductions' latency, and skipped below
  const float zero[EPV] = {};
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = threadIdx.x * EPV + v * stride;
    if (c0 >= r.live && c0 < sk) store_row<T, EPV, VEC>(r.yr, c0, sk, zero);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = threadIdx.x * EPV + v * stride;
    if (c0 >= r.live) continue;
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      if (c0 + e < sk) mx = fmaxf(mx, val[v][e]);  // masked: -FLT_MAX
  }
  if (r.live < sk) mx = fmaxf(mx, -FLT_MAX);     // a skipped vector is masked
  mx = block_reduce_n<true>(mx, red, nwarps);
  float sum = 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = threadIdx.x * EPV + v * stride;
    if (c0 >= r.live) continue;
#pragma unroll
    for (int e = 0; e < EPV; ++e) {
      val[v][e] = (masked[v] >> e) & 1u ? 0.f : row_exp<HALF>(val[v][e] - mx);
      sum += val[v][e];
    }
  }
  sum = block_reduce_n<false>(sum, red, nwarps);
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const int c0 = threadIdx.x * EPV + v * stride;
    if (c0 >= r.live) continue;
#pragma unroll
    for (int e = 0; e < EPV; ++e) val[v][e] = row_div<HALF>(val[v][e], sum, inv);
    store_row<T, EPV, VEC>(r.yr, c0, sk, val[v]);
  }
}

// bit e set where element e of the vector at c0 is masked or past the row
template <int EPV, bool VEC>
__device__ __forceinline__ unsigned mask_bits(const uint8_t* __restrict__ mr, int c0,
                                              int sk, int i, int causal) {
  uint8_t mk[EPV];
#pragma unroll
  for (int e = 0; e < EPV; ++e) mk[e] = 0;
  if (mr) {
    if constexpr (VEC) {
      const Pack<uint8_t, EPV> pk = *reinterpret_cast<const Pack<uint8_t, EPV>*>(mr + c0);
#pragma unroll
      for (int e = 0; e < EPV; ++e) mk[e] = pk.v[e];
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) mk[e] = c0 + e < sk ? mr[c0 + e] : 0;
    }
  }
  unsigned bits = 0;
#pragma unroll
  for (int e = 0; e < EPV; ++e) {
    const int col = c0 + e;
    if (col >= sk || mk[e] != 0 || (causal && col > i)) bits |= 1u << e;
  }
  return bits;
}

// the EPV raw elements of x at c0 (zeros past the row)
template <typename T, int EPV, bool VEC>
__device__ __forceinline__ Pack<T, EPV> load_raw(const T* __restrict__ p, int c0, int sk) {
  Pack<T, EPV> pk;
  if constexpr (VEC) {
    pk = *reinterpret_cast<const Pack<T, EPV>*>(p + c0);
  } else {
#pragma unroll
    for (int e = 0; e < EPV; ++e) pk.v[e] = c0 + e < sk ? p[c0 + e] : from_f<T>(0.f);
  }
  return pk;
}

// smem: the row's live vectors staged in dynamic shared memory in x's
// dtype (one 16-byte slot a vector), their mask bits a byte each behind them
template <typename T, bool VEC>
__global__ void __launch_bounds__(LONG_MAX_THREADS)
softmax_fwd_long_smem(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                      T* __restrict__ y, int sq, int sk, int np, long long mask_sb,
                      long long mask_sh, long long mask_sq, float scale, int causal) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr bool HALF = sizeof(T) == 2;
  extern __shared__ __align__(16) unsigned char stage[];
  __shared__ float red[LONG_MAX_THREADS / 32];
  const LongRow<T> r(x, mask, y, sq, sk, np, mask_sb, mask_sh, mask_sq, causal);
  const int nvec = (sk + EPV - 1) / EPV, live_vec = (r.live + EPV - 1) / EPV;
  Pack<T, EPV>* xs = reinterpret_cast<Pack<T, EPV>*>(stage);
  uint8_t* bits_s = stage + (size_t)nvec * 16;
  const int nwarps = blockDim.x / 32;
  // the vectors at or past `live` (the causal tail) are zeros: written first
  const float zero[EPV] = {};
  for (int v = live_vec + threadIdx.x; v < nvec; v += blockDim.x)
    store_row<T, EPV, VEC>(r.yr, v * EPV, sk, zero);
  float mx = -INFINITY;
#pragma unroll 4
  for (int v = threadIdx.x; v < live_vec; v += blockDim.x) {
    const int c0 = v * EPV;
    const Pack<T, EPV> pk = load_raw<T, EPV, VEC>(r.xr, c0, sk);
    const unsigned bits = mask_bits<EPV, VEC>(r.mr, c0, sk, r.i, causal);
    xs[v] = pk;
    bits_s[v] = (uint8_t)bits;
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      if (c0 + e < sk) mx = fmaxf(mx, (bits >> e) & 1u ? -FLT_MAX : to_f(pk.v[e]) * scale);
  }
  if (r.live < sk) mx = fmaxf(mx, -FLT_MAX);
  mx = block_reduce_n<true>(mx, red, nwarps);  // its barriers order the stage
  float sum = 0.f;
  for (int v = threadIdx.x; v < live_vec; v += blockDim.x) {
    const Pack<T, EPV> pk = xs[v];
    const unsigned bits = bits_s[v];
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      sum += (bits >> e) & 1u ? 0.f : row_exp<HALF>(to_f(pk.v[e]) * scale - mx);
  }
  sum = block_reduce_n<false>(sum, red, nwarps);
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
  for (int v = threadIdx.x; v < live_vec; v += blockDim.x) {
    const Pack<T, EPV> pk = xs[v];
    const unsigned bits = bits_s[v];
    float out[EPV];
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      out[e] = (bits >> e) & 1u
                   ? 0.f
                   : row_div<HALF>(row_exp<HALF>(to_f(pk.v[e]) * scale - mx), sum, inv);
    store_row<T, EPV, VEC>(r.yr, v * EPV, sk, out);
  }
}

// walk: an online (max, sum) pair a thread over one read of its vectors,
// the pairs combined over the block, then a second read writes y
template <typename T, bool VEC>
__global__ void __launch_bounds__(LONG_MAX_THREADS)
softmax_fwd_long_walk(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                      T* __restrict__ y, int sq, int sk, int np, long long mask_sb,
                      long long mask_sh, long long mask_sq, float scale, int causal) {
  constexpr int EPV = 16 / sizeof(T);
  constexpr bool HALF = sizeof(T) == 2;
  __shared__ float red[LONG_MAX_THREADS / 32];
  const LongRow<T> r(x, mask, y, sq, sk, np, mask_sb, mask_sh, mask_sq, causal);
  const int stride = blockDim.x * EPV, nwarps = blockDim.x / 32;
  // the vectors at or past `live` (the causal tail) are zeros: written first
  const float zero[EPV] = {};
  for (int v = (r.live + EPV - 1) / EPV + threadIdx.x; v * EPV < sk; v += blockDim.x)
    store_row<T, EPV, VEC>(r.yr, v * EPV, sk, zero);
  float m = -INFINITY, s = 0.f;
  for (int c0 = threadIdx.x * EPV; c0 < r.live; c0 += stride) {
    float v[EPV];
    const unsigned bits = load_scaled<T, EPV, VEC>(r.xr, r.mr, c0, sk, r.i, causal,
                                                   scale, v);
    float vm = m;
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      if (c0 + e < sk) vm = fmaxf(vm, v[e]);   // a masked element: -FLT_MAX
    if (vm != m) {
      s *= expf(m - vm);                       // 0 while m is -inf
      m = vm;
    }
#pragma unroll
    for (int e = 0; e < EPV; ++e) s += (bits >> e) & 1u ? 0.f : row_exp<HALF>(v[e] - m);
  }
  // a skipped vector is masked; a thread's sum moves onto the block's max
  const float mx = block_reduce_n<true>(r.live < sk ? fmaxf(m, -FLT_MAX) : m, red,
                                        nwarps);
  const float sum =
      block_reduce_n<false>(s > 0.f ? s * expf(m - mx) : 0.f, red, nwarps);
  const float inv = sum > 0.f ? 1.f / sum : 0.f;
  for (int c0 = threadIdx.x * EPV; c0 < r.live; c0 += stride) {
    float v[EPV];
    const unsigned bits = load_scaled<T, EPV, VEC>(r.xr, r.mr, c0, sk, r.i, causal,
                                                   scale, v);
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      v[e] = (bits >> e) & 1u ? 0.f : row_div<HALF>(row_exp<HALF>(v[e] - mx), sum, inv);
    store_row<T, EPV, VEC>(r.yr, c0, sk, v);
  }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(LONG_THREADS)
softmax_bwd_long_kernel(const T* __restrict__ y, const T* __restrict__ g,
                        T* __restrict__ dx, int sk, float scale) {
  constexpr int EPV = 16 / sizeof(T);
  __shared__ float red[LONG_WARPS];
  const long long row = blockIdx.x;
  const T* yr = y + row * sk;
  const T* gr = g + row * sk;
  T* dr = dx + row * sk;
  const int stride = LONG_THREADS * EPV;
  float dot = 0.f;
  for (int c0 = threadIdx.x * EPV; c0 < sk; c0 += stride) {
    float a[EPV], c[EPV];
    load_row<T, EPV, VEC>(yr, c0, sk, a);
    load_row<T, EPV, VEC>(gr, c0, sk, c);
#pragma unroll
    for (int e = 0; e < EPV; ++e) dot = fmaf(a[e], c[e], dot);
  }
  dot = block_reduce<false>(dot, red);
  for (int c0 = threadIdx.x * EPV; c0 < sk; c0 += stride) {
    float a[EPV], c[EPV], out[EPV];
    load_row<T, EPV, VEC>(yr, c0, sk, a);
    load_row<T, EPV, VEC>(gr, c0, sk, c);
#pragma unroll
    for (int e = 0; e < EPV; ++e) out[e] = scale * a[e] * (c[e] - dot);
    store_row<T, EPV, VEC>(dr, c0, sk, out);
  }
}

// elements a lane holds: up to 8, 32 or 128 (sk <= 256, 1024, 4096)
int lane_bucket(int sk) { return sk <= 256 ? 8 : (sk <= 1024 ? 32 : 128); }

template <typename T, int EL, bool VEC>
void fwd_launch(unsigned blocks, cudaStream_t st, const void* x, const void* mask,
                void* y, long long rows, int sq, int sk, int np, long long msb,
                long long msh, long long msq, float scale, int causal) {
  constexpr int NV = EL / (16 / (int)sizeof(T));
  softmax_fwd_kernel<T, NV, VEC><<<blocks, THREADS, 0, st>>>(
      (const T*)x, (const uint8_t*)mask, (T*)y, rows, sq, sk, np, msb, msh, msq,
      scale, causal);
}

template <typename T>
void fwd_dispatch(bool vec, unsigned blocks, cudaStream_t st, const void* x,
                  const void* mask, void* y, long long rows, int sq, int sk, int np,
                  long long msb, long long msh, long long msq, float scale,
                  int causal) {
  const int el = lane_bucket(sk);
#define APEX_SM_FWD(EL, VEC)                                                  \
  fwd_launch<T, EL, VEC>(blocks, st, x, mask, y, rows, sq, sk, np, msb, msh, \
                         msq, scale, causal)
  if (vec) {
    if (el == 8) APEX_SM_FWD(8, true);
    else if (el == 32) APEX_SM_FWD(32, true);
    else APEX_SM_FWD(128, true);
  } else {
    if (el == 8) APEX_SM_FWD(8, false);
    else if (el == 32) APEX_SM_FWD(32, false);
    else APEX_SM_FWD(128, false);
  }
#undef APEX_SM_FWD
}

template <typename T, int EL, bool VEC>
void bwd_launch(unsigned blocks, cudaStream_t st, const void* y, const void* g,
                void* dx, long long rows, int sk, float scale) {
  constexpr int NV = EL / (16 / (int)sizeof(T));
  softmax_bwd_kernel<T, NV, VEC><<<blocks, THREADS, 0, st>>>(
      (const T*)y, (const T*)g, (T*)dx, rows, sk, scale);
}

template <typename T>
void bwd_dispatch(bool vec, unsigned blocks, cudaStream_t st, const void* y,
                  const void* g, void* dx, long long rows, int sk, float scale) {
  const int el = lane_bucket(sk);
#define APEX_SM_BWD(EL, VEC) bwd_launch<T, EL, VEC>(blocks, st, y, g, dx, rows, sk, scale)
  if (vec) {
    if (el == 8) APEX_SM_BWD(8, true);
    else if (el == 32) APEX_SM_BWD(32, true);
    else APEX_SM_BWD(128, true);
  } else {
    if (el == 8) APEX_SM_BWD(8, false);
    else if (el == 32) APEX_SM_BWD(32, false);
    else APEX_SM_BWD(128, false);
  }
#undef APEX_SM_BWD
}

// 16-byte vectors need every row to start on a 16-byte boundary
bool vec_ok(int sk, int itemsize, const void* a, const void* b, const void* c,
            const void* mask) {
  const int epv = 16 / itemsize;
  bool ok = sk % epv == 0 && ((uintptr_t)a % 16 == 0) && ((uintptr_t)b % 16 == 0) &&
            ((uintptr_t)c % 16 == 0);
  // then every EPV-byte mask vector sits on an EPV-byte boundary too
  if (mask) ok = ok && ((uintptr_t)mask % 16 == 0);
  return ok;
}

template <typename T, bool VEC>
cudaError_t fwd_long_launch(int body, int threads, int smem, unsigned blocks,
                            cudaStream_t st, const void* x, const void* mask, void* y,
                            int sq, int sk, int np, long long msb, long long msh,
                            long long msq, float scale, int causal) {
  constexpr int NV = LONG_REG_VALUES / (16 / (int)sizeof(T));
  const T* xt = (const T*)x;
  const uint8_t* mt = (const uint8_t*)mask;
  T* yt = (T*)y;
  if (body == BODY_REGS) {
    // bf16/fp16 only (the C entry refuses it for fp32): no fp32 instantiation
    if constexpr (sizeof(T) == 2)
      softmax_fwd_long_regs<T, NV, VEC><<<blocks, threads, 0, st>>>(
          xt, mt, yt, sq, sk, np, msb, msh, msq, scale, causal);
  } else if (body == BODY_SMEM) {
    auto kernel = softmax_fwd_long_smem<T, VEC>;
    // the shared memory this instantiation was granted, by device: a host
    // call the launch would otherwise make every time
    static int granted[MAX_DEVICES] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= MAX_DEVICES || granted[device] < smem) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 LONG_SMEM_MAX);
      if (err != cudaSuccess) return err;
      if (device < MAX_DEVICES) granted[device] = LONG_SMEM_MAX;
    }
    kernel<<<blocks, threads, smem, st>>>(xt, mt, yt, sq, sk, np, msb, msh, msq, scale,
                                         causal);
  } else {
    softmax_fwd_long_walk<T, VEC><<<blocks, threads, 0, st>>>(
        xt, mt, yt, sq, sk, np, msb, msh, msq, scale, causal);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t fwd_long_dispatch(bool vec, int body, int threads, int smem,
                              unsigned blocks, cudaStream_t st, const void* x,
                              const void* mask, void* y, int sq, int sk, int np,
                              long long msb, long long msh, long long msq, float scale,
                              int causal) {
  return vec ? fwd_long_launch<T, true>(body, threads, smem, blocks, st, x, mask, y, sq,
                                        sk, np, msb, msh, msq, scale, causal)
             : fwd_long_launch<T, false>(body, threads, smem, blocks, st, x, mask, y, sq,
                                         sk, np, msb, msh, msq, scale, causal);
}

template <typename T>
void bwd_long_dispatch(bool vec, unsigned blocks, cudaStream_t st, const void* y,
                       const void* g, void* dx, int sk, float scale) {
  if (vec)
    softmax_bwd_long_kernel<T, true><<<blocks, LONG_THREADS, 0, st>>>(
        (const T*)y, (const T*)g, (T*)dx, sk, scale);
  else
    softmax_bwd_long_kernel<T, false><<<blocks, LONG_THREADS, 0, st>>>(
        (const T*)y, (const T*)g, (T*)dx, sk, scale);
}

}  // namespace

extern "C" int softmax_fwd(const void* x, const void* mask, void* y, long long rows,
                           int sq, int sk, int np, long long mask_sb,
                           long long mask_sh, long long mask_sq, float scale,
                           int causal, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || sq < 1 || sk < 1 || sk > MAX_SK || np < 1 || dtype < 0 ||
      dtype > 2 || (rows + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  const int itemsize = dtype == 2 ? 4 : 2;
  const bool vec = vec_ok(sk, itemsize, x, y, x, mask);
  if (dtype == 0)
    fwd_dispatch<__nv_bfloat16>(vec, blocks, st, x, mask, y, rows, sq, sk, np,
                                mask_sb, mask_sh, mask_sq, scale, causal);
  else if (dtype == 1)
    fwd_dispatch<__half>(vec, blocks, st, x, mask, y, rows, sq, sk, np, mask_sb,
                         mask_sh, mask_sq, scale, causal);
  else
    fwd_dispatch<float>(vec, blocks, st, x, mask, y, rows, sq, sk, np, mask_sb,
                        mask_sh, mask_sq, scale, causal);
  return (int)cudaGetLastError();
}

extern "C" int softmax_bwd(const void* y, const void* g, void* dx, long long rows,
                           int sk, float scale, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || sk < 1 || sk > MAX_SK || dtype < 0 || dtype > 2 ||
      (rows + WARPS - 1) / WARPS > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((rows + WARPS - 1) / WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  const int itemsize = dtype == 2 ? 4 : 2;
  const bool vec = vec_ok(sk, itemsize, y, g, dx, nullptr);
  if (dtype == 0)
    bwd_dispatch<__nv_bfloat16>(vec, blocks, st, y, g, dx, rows, sk, scale);
  else if (dtype == 1)
    bwd_dispatch<__half>(vec, blocks, st, y, g, dx, rows, sk, scale);
  else
    bwd_dispatch<float>(vec, blocks, st, y, g, dx, rows, sk, scale);
  return (int)cudaGetLastError();
}

// K10L: one block per row, any sk >= 1, in the body softmax_cuda.long_plan
// names (body 0 regs, 1 smem, 2 walk; threads a block; the smem body's
// dynamic shared bytes)
extern "C" int softmax_fwd_long(const void* x, const void* mask, void* y,
                                long long rows, int sq, int sk, int np,
                                long long mask_sb, long long mask_sh,
                                long long mask_sq, float scale, int causal, int body,
                                int threads, int smem, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || rows > 0x7fffffffLL || sq < 1 || sk < 1 || np < 1 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  const int itemsize = dtype == 2 ? 4 : 2;
  const long long epv = 16 / itemsize;
  const long long nvec = (sk + epv - 1) / epv;
  // the plan must cover the row: regs (bf16/fp16 only) threads x their
  // vectors, smem a 16-byte slot and a mask byte a vector
  if (threads < 32 || threads > LONG_MAX_THREADS || threads % 32 != 0 || body < 0 ||
      body > 2 ||
      (body == BODY_REGS &&
       (itemsize != 2 || (long long)threads * (LONG_REG_VALUES / epv) < nvec)) ||
      (body == BODY_SMEM && (smem > LONG_SMEM_MAX || (long long)smem < nvec * 17)))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)rows;
  cudaStream_t st = (cudaStream_t)stream;
  const bool vec = vec_ok(sk, itemsize, x, y, x, mask);
  if (dtype == 0)
    return (int)fwd_long_dispatch<__nv_bfloat16>(vec, body, threads, smem, blocks, st, x,
                                                 mask, y, sq, sk, np, mask_sb, mask_sh,
                                                 mask_sq, scale, causal);
  if (dtype == 1)
    return (int)fwd_long_dispatch<__half>(vec, body, threads, smem, blocks, st, x, mask,
                                          y, sq, sk, np, mask_sb, mask_sh, mask_sq, scale,
                                          causal);
  return (int)fwd_long_dispatch<float>(vec, body, threads, smem, blocks, st, x, mask, y,
                                       sq, sk, np, mask_sb, mask_sh, mask_sq, scale,
                                       causal);
}

// K11L: one block per row, any sk >= 1
extern "C" int softmax_bwd_long(const void* y, const void* g, void* dx, long long rows,
                                int sk, float scale, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || rows > 0x7fffffffLL || sk < 1 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)rows;
  cudaStream_t st = (cudaStream_t)stream;
  const int itemsize = dtype == 2 ? 4 : 2;
  const bool vec = vec_ok(sk, itemsize, y, g, dx, nullptr);
  if (dtype == 0)
    bwd_long_dispatch<__nv_bfloat16>(vec, blocks, st, y, g, dx, sk, scale);
  else if (dtype == 1)
    bwd_long_dispatch<__half>(vec, blocks, st, y, g, dx, sk, scale);
  else
    bwd_long_dispatch<float>(vec, blocks, st, y, g, dx, sk, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* softmax_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

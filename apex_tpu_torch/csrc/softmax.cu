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
// There one block of LONG_THREADS threads owns a row and walks it in
// 16-byte vectors, neighbouring threads on neighbouring vectors: K10L
// reads x three times (the row max, the sum of exponentials, then y
// written), K11L reads y and g twice (the dot, then dx written), each
// block-wide max and sum reduced through shared memory. A row of 8192
// bf16 keys is 16 KB, so the later passes find it in L1/L2; the bytes from
// device memory are those of the one-pass kernels. Masks, the causal skip
// (vectors wholly above the diagonal are not read and are written as
// zeros), the s > 0 guard of a fully masked row and the stride-0 mask
// axes are K10's; the fixed thread-to-element map and the fixed reduction
// order give the same bits on every run.

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

template <typename T, bool VEC>
__global__ void __launch_bounds__(LONG_THREADS)
softmax_fwd_long_kernel(const T* __restrict__ x, const uint8_t* __restrict__ mask,
                        T* __restrict__ y, int sq, int sk, int np, long long mask_sb,
                        long long mask_sh, long long mask_sq, float scale, int causal) {
  constexpr int EPV = 16 / sizeof(T);
  __shared__ float red[LONG_WARPS];
  const long long row = blockIdx.x;
  const int i = (int)(row % sq);
  const long long bh = row / sq;
  const long long b = bh / np;
  const int h = (int)(bh % np);
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const uint8_t* mr =
      mask ? mask + b * mask_sb + (long long)h * mask_sh + (long long)i * mask_sq
           : nullptr;
  // vectors at or past `live` hold no unmasked element: past the row, or
  // (causal) wholly above the diagonal
  const int live = causal ? min(sk, i + 1) : sk;
  const int stride = LONG_THREADS * EPV;
  const bool skipped = live < sk;              // a skipped vector is masked
  float mx = -INFINITY;
  for (int c0 = threadIdx.x * EPV; c0 < live; c0 += stride) {
    float v[EPV];
    load_scaled<T, EPV, VEC>(xr, mr, c0, sk, i, causal, scale, v);
#pragma unroll
    for (int e = 0; e < EPV; ++e)
      if (c0 + e < sk) mx = fmaxf(mx, v[e]);   // a masked element: -FLT_MAX
  }
  if (skipped) mx = fmaxf(mx, -FLT_MAX);
  mx = block_reduce<true>(mx, red);
  float sum = 0.f;
  for (int c0 = threadIdx.x * EPV; c0 < live; c0 += stride) {
    float v[EPV];
    const unsigned bits = load_scaled<T, EPV, VEC>(xr, mr, c0, sk, i, causal, scale, v);
#pragma unroll
    for (int e = 0; e < EPV; ++e) sum += (bits >> e) & 1u ? 0.f : expf(v[e] - mx);
  }
  sum = block_reduce<false>(sum, red);
  for (int c0 = threadIdx.x * EPV; c0 < sk; c0 += stride) {
    float v[EPV];
    if (c0 < live) {
      const unsigned bits = load_scaled<T, EPV, VEC>(xr, mr, c0, sk, i, causal, scale, v);
#pragma unroll
      for (int e = 0; e < EPV; ++e)
        v[e] = (bits >> e) & 1u || !(sum > 0.f) ? 0.f : expf(v[e] - mx) / sum;
    } else {
#pragma unroll
      for (int e = 0; e < EPV; ++e) v[e] = 0.f;
    }
    store_row<T, EPV, VEC>(yr, c0, sk, v);
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

template <typename T>
void fwd_long_dispatch(bool vec, unsigned blocks, cudaStream_t st, const void* x,
                       const void* mask, void* y, int sq, int sk, int np,
                       long long msb, long long msh, long long msq, float scale,
                       int causal) {
  if (vec)
    softmax_fwd_long_kernel<T, true><<<blocks, LONG_THREADS, 0, st>>>(
        (const T*)x, (const uint8_t*)mask, (T*)y, sq, sk, np, msb, msh, msq, scale,
        causal);
  else
    softmax_fwd_long_kernel<T, false><<<blocks, LONG_THREADS, 0, st>>>(
        (const T*)x, (const uint8_t*)mask, (T*)y, sq, sk, np, msb, msh, msq, scale,
        causal);
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

// K10L: one block per row, any sk >= 1
extern "C" int softmax_fwd_long(const void* x, const void* mask, void* y,
                                long long rows, int sq, int sk, int np,
                                long long mask_sb, long long mask_sh,
                                long long mask_sq, float scale, int causal, int dtype,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (rows < 1 || rows > 0x7fffffffLL || sq < 1 || sk < 1 || np < 1 || dtype < 0 ||
      dtype > 2)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)rows;
  cudaStream_t st = (cudaStream_t)stream;
  const int itemsize = dtype == 2 ? 4 : 2;
  const bool vec = vec_ok(sk, itemsize, x, y, x, mask);
  if (dtype == 0)
    fwd_long_dispatch<__nv_bfloat16>(vec, blocks, st, x, mask, y, sq, sk, np, mask_sb,
                                     mask_sh, mask_sq, scale, causal);
  else if (dtype == 1)
    fwd_long_dispatch<__half>(vec, blocks, st, x, mask, y, sq, sk, np, mask_sb, mask_sh,
                              mask_sq, scale, causal);
  else
    fwd_long_dispatch<float>(vec, blocks, st, x, mask, y, sq, sk, np, mask_sb, mask_sh,
                             mask_sq, scale, causal);
  return (int)cudaGetLastError();
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

// The int8 block codec of the collectives layer: K19 quantizes a
// compensated fp32 payload into int8 blocks with one bf16 scale each and
// writes the error-feedback residual; K20 dequantizes the gathered
// payloads of W ranks and sums them in rank order (or concatenates them).
//
// They replace no Pallas site: the JAX package computes the codec in jnp
// (apex_tpu/parallel/collectives.py:269 quantize_blocks, :304
// dequantize_blocks, :311 _compensate, and the fp32 sums of :354-360 and
// :384-387), which XLA fuses into the step program. In eager PyTorch the
// same codec is about twelve passes over the flat gradient (pad, abs,
// amax, where, divide, round, clip, cast, dequantize, subtract, isfinite,
// where), each with its own allocation.
//
// What bounds them on H100: bytes. K19 reads x and the residual and
// writes q and the residual, ~13 bytes an element (the scales are 2 bytes
// a block); K20 reads W int8 payloads and writes one fp32 sum, ~4 + W
// bytes an output. A few operations an element.
//
// Design. K19: one warp a 128-element block, four consecutive elements a
// lane (one 16-byte load where the row and pointer allow it, else four
// scalar loads); the block's largest magnitude and its non-finite flag by
// an xor butterfly, so every lane has the same scale; q is written as one
// 32-bit word a lane. K20: one thread four outputs, the ranks summed in
// rank order. Every rounding is explicit (__fdiv_rn, __fmul_rn, __fadd_rn,
// __fsub_rn, rintf, and the source builds with --fmad=false), in the
// plain versions' order (ops/collectives.py), so both kernels equal them
// bit for bit: the scale is fp32(amax / 127) rounded to bf16 to nearest
// even, the element is divided by that bf16 scale widened to fp32 (a true
// division), rintf rounds half to even as jnp.round does, a NaN quotient
// casts to 0 as XLA casts it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 128;       // elements a scale
constexpr int THREADS = 256;

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }

struct QuantArgs {
  const float* x;          // [R, n]
  const float* res_in;     // [R, n] or null
  float* res_out;          // [R, n], given with res_in (may alias it)
  int8_t* q;               // [R, nb, BLOCK]
  __nv_bfloat16* scales;   // [R, nb]
  long long rows, n, nb;
};

// K19: one warp a (row, block)
__global__ void __launch_bounds__(THREADS) quantize_kernel(const QuantArgs a) {
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= a.rows * a.nb) return;  // whole warps leave together
  const long long row = warp / a.nb, blk = warp % a.nb;
  const long long e0 = blk * BLOCK + lane * 4;   // first element in the row
  const long long g0 = row * a.n + e0;           // and in the tensor
  float c[4];
  const bool vec = e0 + 4 <= a.n && (g0 & 3) == 0;
  if (vec) {
    const float4 xv = *reinterpret_cast<const float4*>(a.x + g0);
    c[0] = xv.x; c[1] = xv.y; c[2] = xv.z; c[3] = xv.w;
    if (a.res_in) {
      const float4 rv = *reinterpret_cast<const float4*>(a.res_in + g0);
      c[0] = __fadd_rn(c[0], rv.x);
      c[1] = __fadd_rn(c[1], rv.y);
      c[2] = __fadd_rn(c[2], rv.z);
      c[3] = __fadd_rn(c[3], rv.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = 0.0f;
      if (e0 + k < a.n) {
        c[k] = a.x[g0 + k];
        if (a.res_in) c[k] = __fadd_rn(c[k], a.res_in[g0 + k]);
      }
    }
  }
  float amax = 0.0f;
  bool bad = false;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bad |= !finite(c[k]);
    amax = fmaxf(amax, fabsf(c[k]));
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  bad = __any_sync(0xffffffffu, bad);
  float sf = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  if (bad) sf = __int_as_float(0x7f800000);  // +inf
  const __nv_bfloat16 sb = __float2bfloat16_rn(sf);
  const float s = __bfloat162float(sb);
  const long long qb = (row * a.nb + blk) * BLOCK + lane * 4;
  int8_t qv[4];
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float t = rintf(__fdiv_rn(c[k], s));
    if (t != t) t = 0.0f;
    t = fminf(fmaxf(t, -127.0f), 127.0f);
    qv[k] = (int8_t)(int)t;
    const float dq = __fmul_rn((float)qv[k], s);
    r[k] = finite(dq) ? __fsub_rn(c[k], dq) : 0.0f;
  }
  uint32_t word = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) word |= (uint32_t)(uint8_t)qv[k] << (8 * k);
  *reinterpret_cast<uint32_t*>(a.q + qb) = word;
  if (lane == 0) a.scales[row * a.nb + blk] = sb;
  if (!a.res_out) return;
  if (vec) {
    *reinterpret_cast<float4*>(a.res_out + g0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (e0 + k < a.n) a.res_out[g0 + k] = r[k];
  }
}

struct SumArgs {
  const int8_t* q;               // [W, nb, BLOCK]
  const __nv_bfloat16* scales;   // [W, nb]
  float* out;                    // [n] (sum) or [W, n] (gather)
  long long world, nb, n;
  float divisor;                 // 0: none
};

__device__ __forceinline__ void load_q4(const int8_t* p, float* f) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
#pragma unroll
  for (int k = 0; k < 4; ++k) f[k] = (float)(int8_t)(uint8_t)(w >> (8 * k));
}

// K20, sum: out[e] = sum over w in rank order of q[w, e] * scale[w, e / BLOCK]
__global__ void __launch_bounds__(THREADS) dequantize_sum_kernel(const SumArgs a) {
  const long long quads = (a.n + 3) >> 2;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < quads;
       i += (long long)gridDim.x * THREADS) {
    const long long e0 = i << 2;
    const long long blk = e0 / BLOCK;  // four elements never straddle a block
    float acc[4];
    for (long long w = 0; w < a.world; ++w) {
      float f[4];
      load_q4(a.q + w * a.nb * BLOCK + e0, f);
      const float s = __bfloat162float(a.scales[w * a.nb + blk]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float d = __fmul_rn(f[k], s);
        acc[k] = w == 0 ? d : __fadd_rn(acc[k], d);
      }
    }
    if (a.divisor != 0.0f) {
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = __fdiv_rn(acc[k], a.divisor);
    }
    if (e0 + 4 <= a.n) {
      *reinterpret_cast<float4*>(a.out + e0) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      for (int k = 0; k < 4 && e0 + k < a.n; ++k) a.out[e0 + k] = acc[k];
    }
  }
}

// K20, gather: out[w, e] = q[w, e] * scale[w, e / BLOCK] for e < n
__global__ void __launch_bounds__(THREADS) dequantize_gather_kernel(const SumArgs a) {
  const long long quads = (a.n + 3) >> 2;
  const bool vec = (a.n & 3) == 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.world * quads;
       i += (long long)gridDim.x * THREADS) {
    const long long w = i / quads, e0 = (i % quads) << 2;
    float f[4];
    load_q4(a.q + w * a.nb * BLOCK + e0, f);
    const float s = __bfloat162float(a.scales[w * a.nb + e0 / BLOCK]);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = __fmul_rn(f[k], s);
    float* dst = a.out + w * a.n + e0;
    if (vec) {
      *reinterpret_cast<float4*>(dst) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
      for (int k = 0; k < 4 && e0 + k < a.n; ++k) dst[k] = f[k];
    }
  }
}

int grid_for(long long threads) {
  long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks < 1) blocks = 1;
  return blocks > 1048576 ? 1048576 : (int)blocks;
}

}  // namespace

// K19 over rows [rows, n] of fp32 x (and the residual, when res_in is
// given, the new residual into res_out); q [rows, nb, 128], scales [rows, nb]
extern "C" int collectives_quantize(const float* x, const float* res_in, float* res_out,
                                    int8_t* q, void* scales, long long rows, long long n,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!x || !q || !scales || rows < 1 || n < 1 || !res_out != !res_in)
    return (int)cudaErrorInvalidValue;
  const long long nb = (n + BLOCK - 1) / BLOCK;
  const long long warps = rows * nb;
  const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  QuantArgs a{x, res_in, res_out, q, reinterpret_cast<__nv_bfloat16*>(scales), rows, n, nb};
  quantize_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K20 over q [world, nb, 128] and scales [world, nb]: the sum over the
// ranks of the first n values into out [n] (divided by divisor unless it
// is 0), or with gather their concatenation into out [world, n]
extern "C" int collectives_dequantize(const int8_t* q, const void* scales, float* out,
                                      long long world, long long nb, long long n, int gather,
                                      float divisor, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!q || !scales || !out || world < 1 || n < 1 || n > nb * BLOCK)
    return (int)cudaErrorInvalidValue;
  SumArgs a{q, reinterpret_cast<const __nv_bfloat16*>(scales), out, world, nb, n, divisor};
  const long long quads = (n + 3) / 4;
  cudaStream_t st = (cudaStream_t)stream;
  if (gather)
    dequantize_gather_kernel<<<grid_for(world * quads), THREADS, 0, st>>>(a);
  else
    dequantize_sum_kernel<<<grid_for(quads), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* collectives_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

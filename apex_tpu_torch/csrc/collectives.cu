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
// Design. K19: one warp a block of `block` elements (any block, as JAX's
// quantize_blocks takes any), four consecutive elements a lane (one
// 16-byte load where the row and pointer allow it, else four scalar
// loads), the warp's 128 elements at a time; the block's largest
// magnitude and its non-finite flag by an xor butterfly, so every lane has
// the same scale; q is written as one 32-bit word a lane where the block
// is a multiple of 4, else a byte at a time. A block of at most 128 keeps
// its elements in registers between the two passes (amax, then the
// quantization); a longer one reads them again. K20: one thread four
// outputs, the ranks summed in rank order; each output takes the scale of
// its own block: where the block is a multiple of 4 (128, the default)
// four consecutive elements share a block and an aligned word of the
// payload, one word load and one scale; else they are read a byte and a
// scale at a time (they may straddle blocks).
// Every rounding is explicit (__fdiv_rn, __fmul_rn, __fadd_rn,
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

constexpr int SPAN = 128;        // elements a warp takes at a time
constexpr int THREADS = 256;

__device__ __forceinline__ bool finite(float x) { return fabsf(x) <= FLT_MAX; }

struct QuantArgs {
  const float* x;          // [R, n]
  const float* res_in;     // [R, n] or null
  float* res_out;          // [R, n], given with res_in (may alias it)
  int8_t* q;               // [R, nb, block]
  __nv_bfloat16* scales;   // [R, nb]
  long long rows, n, nb, block;
};

// the compensated values of the four elements at offset o of a block whose
// first element is e_blk in the row and g_blk in the tensor: 0 past the
// block or the row; `vec` says whether one 16-byte load took them
__device__ __forceinline__ void load_quad(const QuantArgs& a, long long e_blk, long long g_blk,
                                          long long o, float (&c)[4], bool& vec) {
  const long long e0 = e_blk + o, g0 = g_blk + o;
  vec = o + 4 <= a.block && e0 + 4 <= a.n && (g0 & 3) == 0;
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
      if (o + k < a.block && e0 + k < a.n) {
        c[k] = a.x[g0 + k];
        if (a.res_in) c[k] = __fadd_rn(c[k], a.res_in[g0 + k]);
      }
    }
  }
}

// the four elements at offset o of the block quantized with scale s: q (a
// word where the block is a multiple of 4, else bytes) and the residual
__device__ __forceinline__ void quantize_quad(const QuantArgs& a, long long e_blk,
                                              long long g_blk, long long q_blk, long long o,
                                              const float (&c)[4], bool vec, float s) {
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
  if ((a.block & 3) == 0) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) word |= (uint32_t)(uint8_t)qv[k] << (8 * k);
    *reinterpret_cast<uint32_t*>(a.q + q_blk + o) = word;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (o + k < a.block) a.q[q_blk + o + k] = qv[k];
  }
  if (!a.res_out) return;
  const long long e0 = e_blk + o, g0 = g_blk + o;
  if (vec) {
    *reinterpret_cast<float4*>(a.res_out + g0) = make_float4(r[0], r[1], r[2], r[3]);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (o + k < a.block && e0 + k < a.n) a.res_out[g0 + k] = r[k];
  }
}

// K19: one warp a (row, block). SHORT: the block is at most SPAN elements,
// one quad a lane kept in registers; else each lane walks its quads twice
template <bool SHORT>
__global__ void __launch_bounds__(THREADS) quantize_kernel(const QuantArgs a) {
  const long long warp = ((long long)blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (warp >= a.rows * a.nb) return;  // whole warps leave together
  const long long row = warp / a.nb, blk = warp % a.nb;
  const long long e_blk = blk * a.block;           // the block's first element in the row
  const long long g_blk = row * a.n + e_blk;       // and in the tensor
  const long long q_blk = (row * a.nb + blk) * a.block;
  float amax = 0.0f;
  bool bad = false;
  float c[4];
  bool vec = false;
  for (long long o = lane * 4; o < (SHORT ? 4 * 32 : a.block); o += SPAN) {
    load_quad(a, e_blk, g_blk, o, c, vec);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      bad |= !finite(c[k]);
      amax = fmaxf(amax, fabsf(c[k]));
    }
  }
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, m));
  bad = __any_sync(0xffffffffu, bad);
  float sf = amax > 0.0f ? __fdiv_rn(amax, 127.0f) : 1.0f;
  if (bad) sf = __int_as_float(0x7f800000);  // +inf
  const __nv_bfloat16 sb = __float2bfloat16_rn(sf);
  const float s = __bfloat162float(sb);
  if (lane == 0) a.scales[row * a.nb + blk] = sb;
  if (SHORT) {
    const long long o = lane * 4;
    if (o < a.block) quantize_quad(a, e_blk, g_blk, q_blk, o, c, vec, s);
    return;
  }
  for (long long o = lane * 4; o < a.block; o += SPAN) {
    load_quad(a, e_blk, g_blk, o, c, vec);
    quantize_quad(a, e_blk, g_blk, q_blk, o, c, vec, s);
  }
}

struct SumArgs {
  const int8_t* q;               // [W, nb, block]
  const __nv_bfloat16* scales;   // [W, nb]
  float* out;                    // [n] (sum) or [W, n] (gather)
  long long world, nb, n, block;
  int shift;                     // log2(block) where block is a power of 2, else -1
  float divisor;                 // 0: none
};

// the block of element e: a shift where the block is a power of 2 (128,
// the default), else a division
__device__ __forceinline__ long long block_of(const SumArgs& a, long long e) {
  return a.shift >= 0 ? e >> a.shift : e / a.block;
}

// the four int8 values at p dequantized by the scales of their blocks, e0
// the first one's place in its rank's payload and blk0 its block. WORD:
// the block is a multiple of 4, so the four share a block and lie in one
// aligned word of the padded payload; else each is read as a byte (those
// at or past `valid` zero) and takes its own block's scale
template <bool WORD>
__device__ __forceinline__ void dequant4(const SumArgs& a, const int8_t* p,
                                         const __nv_bfloat16* sc, long long e0, long long blk0,
                                         long long valid, float* f) {
  if constexpr (WORD) {
    const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
    const float s = __bfloat162float(sc[blk0]);
#pragma unroll
    for (int k = 0; k < 4; ++k) f[k] = __fmul_rn((float)(int8_t)(uint8_t)(w >> (8 * k)), s);
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long blk = block_of(a, e0 + k);
      f[k] = k < valid ? __fmul_rn((float)p[k], __bfloat162float(sc[blk])) : 0.0f;
    }
  }
}

// K20, sum: out[e] = sum over w in rank order of q[w, e] * scale[w, e / block]
template <bool WORD>
__global__ void __launch_bounds__(THREADS) dequantize_sum_kernel(const SumArgs a) {
  const long long quads = (a.n + 3) >> 2;
  const long long stride = a.nb * a.block;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < quads;
       i += (long long)gridDim.x * THREADS) {
    const long long e0 = i << 2, blk0 = block_of(a, e0);
    float acc[4];
    for (long long w = 0; w < a.world; ++w) {
      float f[4];
      dequant4<WORD>(a, a.q + w * stride + e0, a.scales + w * a.nb, e0, blk0, a.n - e0, f);
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[k] = w == 0 ? f[k] : __fadd_rn(acc[k], f[k]);
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

// K20, gather: out[w, e] = q[w, e] * scale[w, e / block] for e < n
template <bool WORD>
__global__ void __launch_bounds__(THREADS) dequantize_gather_kernel(const SumArgs a) {
  const long long quads = (a.n + 3) >> 2;
  const bool vec = (a.n & 3) == 0;
  for (long long i = (long long)blockIdx.x * THREADS + threadIdx.x; i < a.world * quads;
       i += (long long)gridDim.x * THREADS) {
    const long long w = i / quads, e0 = (i % quads) << 2;
    float f[4];
    dequant4<WORD>(a, a.q + w * a.nb * a.block + e0, a.scales + w * a.nb, e0,
                   block_of(a, e0), a.n - e0, f);
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
// given, the new residual into res_out); q [rows, nb, block], scales [rows,
// nb], block any positive size
extern "C" int collectives_quantize(const float* x, const float* res_in, float* res_out,
                                    int8_t* q, void* scales, long long rows, long long n,
                                    long long block, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!x || !q || !scales || rows < 1 || n < 1 || block < 1 || !res_out != !res_in)
    return (int)cudaErrorInvalidValue;
  const long long nb = (n + block - 1) / block;
  const long long warps = rows * nb;
  const long long blocks = (warps * 32 + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  QuantArgs a{x, res_in, res_out, q, reinterpret_cast<__nv_bfloat16*>(scales), rows, n, nb,
              block};
  cudaStream_t st = (cudaStream_t)stream;
  if (block <= SPAN)
    quantize_kernel<true><<<(unsigned)blocks, THREADS, 0, st>>>(a);
  else
    quantize_kernel<false><<<(unsigned)blocks, THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// K20 over q [world, nb, block] and scales [world, nb]: the sum over the
// ranks of the first n values into out [n] (divided by divisor unless it
// is 0), or with gather their concatenation into out [world, n]
extern "C" int collectives_dequantize(const int8_t* q, const void* scales, float* out,
                                      long long world, long long nb, long long n,
                                      long long block, int gather, float divisor, int device,
                                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!q || !scales || !out || world < 1 || block < 1 || n < 1 || n > nb * block)
    return (int)cudaErrorInvalidValue;
  int shift = -1;
  if ((block & (block - 1)) == 0) {
    shift = 0;
    while ((1LL << shift) < block) ++shift;
  }
  SumArgs a{q, reinterpret_cast<const __nv_bfloat16*>(scales), out, world, nb, n, block,
            shift, divisor};
  const long long quads = (n + 3) / 4;
  cudaStream_t st = (cudaStream_t)stream;
  const bool word = (block & 3) == 0;
  if (gather && word)
    dequantize_gather_kernel<true><<<grid_for(world * quads), THREADS, 0, st>>>(a);
  else if (gather)
    dequantize_gather_kernel<false><<<grid_for(world * quads), THREADS, 0, st>>>(a);
  else if (word)
    dequantize_sum_kernel<true><<<grid_for(quads), THREADS, 0, st>>>(a);
  else
    dequantize_sum_kernel<false><<<grid_for(quads), THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* collectives_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

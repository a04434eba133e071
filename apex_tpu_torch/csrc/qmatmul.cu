// K23, the W8A16 decode matmul: y [B, N] = (x [B, K] @ wq [N, K]^T) *
// scale [N], with int8 weights, one fp32 scale an output channel, fp32
// accumulation, and one rounding to x's dtype at the end.
//
// It replaces no Pallas site: the JAX package contracts the int8 weight in
// XLA (apex_tpu/serving/quant.py:77 qmatmul: the int8 operand widened in
// the dot's operand stream, the scale applied to the fp32 output columns).
// In eager PyTorch the same function is a dequantized copy of every
// weight on every decode step, or a library kernel; this is the port's
// hand-written kernel for it.
//
// What bounds it on H100: bytes. At decode the batch is a few rows (8
// slots), so each weight byte meets B multiply-adds: 2 B operations a
// byte, far below the ~295 a byte where the tensor cores would become the
// limit. The weight, N K bytes, is nearly all the traffic; x (B K) and y
// (B N) are small.
//
// Design. A block of 4 warps takes 16 output channels (four a warp) and
// a tile of up to 8 activation rows (grid.y walks further tiles). It walks
// K in chunks of 512 columns. Lane l of every warp only ever reads columns
// [16 l, 16 l + 16) of a chunk, for its four weight rows and for every x
// row, so: each lane holds its 16 bytes of each of its four rows (one
// 16-byte load each, issued a chunk ahead, so the next chunk's weights are
// in flight while this one's are used); the block stages the chunk of its
// x rows in shared memory as fp32 (exact for bf16/fp16), a warp a row at a
// time, lane l loading its own 16 columns with 16-byte loads and writing
// them at [row][j][lane] (a 33-float pitch: the 32 lanes of a warp touch
// 32 banks, writing and reading); then each lane widens its weight bytes
// (a byte permute into an fp32 bit pattern and one exact subtraction) and
// multiply-adds them into 4 x 8 fp32 accumulators, each staged x value
// read once and used against the four rows (8 shared-memory bytes a
// weight byte). After the last chunk each accumulator is summed over the
// warp by an xor butterfly; lane b writes row b's output, scaled in fp32
// and rounded once. Every weight byte is read once and no dequantized
// weight is written. The summation order differs from the plain
// version's (torch.matmul on fp32 operands), so the two agree within a
// measured relative L2 (tests/port/kernel_l2_errors.py), not bit for bit.
//
// Measured (PERF.md): well under the memory rate, and slower than cuBLAS
// over a bf16 copy. At 8 rows each weight byte costs 8 fp32 multiply-adds
// plus its share of a widening and a shared-memory read, ~12 instructions
// a byte on the CUDA cores, which by count caps it near 2 TB/s before any
// latency; a tensor-core body (mma.sync with the 8 rows as n) is the next
// design.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;            // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int RPW = 4;              // output channels a warp
constexpr int COLS = WARPS * RPW;   // output channels a block
constexpr int ROWS = 8;             // activation rows a block
constexpr int VEC = 16;             // columns a lane a chunk
constexpr int CHUNK = 32 * VEC;     // K columns a chunk
constexpr int PITCH = 33;           // floats between a row-column's lanes

template <typename T>
__device__ __forceinline__ float to_f(T v);
template <>
__device__ __forceinline__ float to_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f<__half>(__half v) { return __half2float(v); }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the two 16-bit elements of a word as floats (exact)
__device__ __forceinline__ void unpack2(unsigned w, const __nv_bfloat16*, float& lo,
                                        float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void unpack2(unsigned w, const __half*, float& lo, float& hi) {
  lo = __half2float(__ushort_as_half((unsigned short)(w & 0xffffu)));
  hi = __half2float(__ushort_as_half((unsigned short)(w >> 16)));
}

// 16 consecutive elements from src as floats: 16-byte loads where src is
// 16-byte aligned, else element loads
template <typename T>
__device__ __forceinline__ void load16(const T* src, float (&v)[VEC]) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(src) + q);
        v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
      }
    } else {
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const uint4 u = __ldg(reinterpret_cast<const uint4*>(src) + q);
        unpack2(u.x, src, v[8 * q], v[8 * q + 1]);
        unpack2(u.y, src, v[8 * q + 2], v[8 * q + 3]);
        unpack2(u.z, src, v[8 * q + 4], v[8 * q + 5]);
        unpack2(u.w, src, v[8 * q + 6], v[8 * q + 7]);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = to_f<T>(src[j]);
  }
}

// the k-th signed byte of a word whose sign bits were flipped (each byte
// then holds value + 128), as a float: the byte is placed under the
// exponent of 2^23, and 2^23 + 128 is taken off (both steps exact)
__device__ __forceinline__ float byte_f(unsigned biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | k)) - 8388736.0f;
}

// this lane's 16 bytes of each of the warp's four rows in the chunk at c0
__device__ __forceinline__ void load_w(const int8_t* wq, int n0, int N, int K, int c0,
                                       int lane, unsigned (&w)[RPW][4]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    // a channel past N reads the last row again; its sums are not written
    const int8_t* src = wq + (long long)min(n0 + r, N - 1) * K + c0 + lane * VEC;
    const int4 v = __ldcs(reinterpret_cast<const int4*>(src));
    w[r][0] = (unsigned)v.x ^ 0x80808080u;
    w[r][1] = (unsigned)v.y ^ 0x80808080u;
    w[r][2] = (unsigned)v.z ^ 0x80808080u;
    w[r][3] = (unsigned)v.w ^ 0x80808080u;
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scale, T* __restrict__ y, int B, int N, int K) {
  __shared__ float xs[ROWS * VEC * PITCH];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * COLS + warp * RPW;   // this warp's first channel
  const int b0 = blockIdx.y * ROWS;
  const int nb = min(ROWS, B - b0);
  const bool live = n0 < N;
  float acc[RPW][ROWS];
#pragma unroll
  for (int r = 0; r < RPW; ++r)
#pragma unroll
    for (int b = 0; b < ROWS; ++b) acc[r][b] = 0.0f;

  unsigned w[RPW][4], next[RPW][4];
  if (live && lane * VEC < K) load_w(wq, n0, N, K, 0, lane, next);
  for (int c0 = 0; c0 < K; c0 += CHUNK) {
    const bool mine = lane * VEC < min(CHUNK, K - c0);   // this lane's columns
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[r][q] = next[r][q];
    if (mine) {
      for (int b = warp; b < nb; b += WARPS) {
        float v[VEC];
        load16(x + (long long)(b0 + b) * K + c0 + lane * VEC, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) xs[(b * VEC + j) * PITCH + lane] = v[j];
      }
    }
    const int c1 = c0 + CHUNK;
    if (live && c1 < K && lane * VEC < K - c1) load_w(wq, n0, N, K, c1, lane, next);
    __syncthreads();
    if (live && mine) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float xv[ROWS];
#pragma unroll
        for (int b = 0; b < ROWS; ++b)
          xv[b] = b < nb ? xs[(b * VEC + j) * PITCH + lane] : 0.0f;
#pragma unroll
        for (int r = 0; r < RPW; ++r) {
          const float wf = byte_f(w[r][j / 4], j % 4);
#pragma unroll
          for (int b = 0; b < ROWS; ++b) acc[r][b] = fmaf(xv[b], wf, acc[r][b]);
        }
      }
    }
    __syncthreads();  // the chunk's readers are done before it is restaged
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int n = n0 + r;
#pragma unroll
    for (int b = 0; b < ROWS; ++b) {
      float v = acc[r][b];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == b && b < nb && n < N)
        y[(long long)(b0 + b) * N + n] = from_f<T>(__fmul_rn(v, scale[n]));
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* wq, const float* scale, void* y, int B,
                   int N, int K, cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS, (B + ROWS - 1) / ROWS);
  qmatmul_kernel<T><<<grid, THREADS, 0, stream>>>(
      static_cast<const T*>(x), wq, scale, static_cast<T*>(y), B, N, K);
  return cudaGetLastError();
}

}  // namespace

// K23: x [B, K] (dtype 0 bf16, 1 fp16, 2 fp32; 16-byte aligned rows are
// read with 16-byte loads), wq [N, K] int8 with K a multiple of 16 and
// 16-byte aligned rows, scale [N] fp32, y [B, N] in x's
// dtype; all contiguous
extern "C" int qmatmul_w8a16(const void* x, const int8_t* wq, const float* scale, void* y,
                             int B, int N, int K, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!x || !wq || !scale || !y || B < 1 || N < 1 || K < VEC || K % VEC ||
      (reinterpret_cast<uintptr_t>(wq) & 15) || (B + ROWS - 1) / ROWS > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0: return (int)launch<__nv_bfloat16>(x, wq, scale, y, B, N, K, st);
    case 1: return (int)launch<__half>(x, wq, scale, y, B, N, K, st);
    case 2: return (int)launch<float>(x, wq, scale, y, B, N, K, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* qmatmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Packed prefill attention, forward: softmax(scale * Q K^T + mask) V.
//
// Replaces apex_tpu/ops/attention_pallas.py:230 _fwd_kernel and :262
// _fwd_kernel_chunked (the VMEM-row kernel under fused_attention_rows), and
// the library flash kernel that apex_tpu/ops/attention.py:203 dispatches to
// on the TPU. Semantics are those of apex_tpu/ops/attention.py:25
// _dense_attention: fp32 scores; a key is masked where it lies above the
// causal diagonal (key index > query index) or where its segment id differs
// from the query's; masked keys are excluded from the softmax; a fully
// masked row gives 0.
//
// The DROPOUT instantiation (K1d) is the dropout branch of _fwd_kernel
// (:252-256): inverted dropout on the normalized probabilities, P * mscale
// with mscale = 1/(1-p) where a score is kept and 0 where it is dropped.
// The mask is _dropout_mscale :198 bit for bit, a chained murmur3 fmix32
// hash of the seed and the score's global (b*H + h, row, column): the seed
// (an int32 read through a pointer, so that the caller never syncs to pass
// it) gives s = fmix32(0x9E3779B9 ^ seed), the block s_bh = fmix32(s ^ bh),
// each row rowkey = fmix32(s_bh ^ row) once, and each live (row, column)
// one more fmix32 compared with the threshold p * 2^32. Tiles the causal
// mask skips draw nothing. The mask scales the normalized P, so the
// running sum l takes the unmasked exp(s - m) and only the numerator sum
// of exp(s - m) * mscale * v takes the mask; a row whose keys are all
// dropped gives 0 * (1/l) = 0. Serving runs the no-dropout instantiation,
// which compiles to the kernel without the hash.
//
// Layout: q [B, H, Sq, D], k and v [B, H, Sk, D], out [B, H, Sq, D], all
// contiguous, one dtype (bf16, fp16 or fp32); segment ids [B, Sq] and
// [B, Sk] int32, or null for none; the dropout seed one int32, or null for
// no dropout. D is 64 or 128.
//
// What bounds it on H100: at the serving shape (B=1, H=12, S=512, D=64)
// the function moves ~3.1 MB and does ~0.4 GFLOP of causal work, so the
// memory side bounds it (~0.94 us at 3.35 TB/s). The TPU kernel keeps a
// whole [bq, sk] score row in VMEM; 227 KB of shared memory cannot, so
// this kernel streams K/V tiles of BK keys through shared memory and keeps
// an online max and sum per query row in fp32 registers (flash style).
// Tiles wholly above the causal diagonal of the block are never loaded
// (the idea of _fwd_kernel_chunked). One block owns one (batch*head,
// 64-row q tile); blocks share nothing, so there is no ordering hazard.
//
// This first version computes with fp32 FMAs on the CUDA cores: four
// threads per query row, each scoring BK/4 keys of a tile and owning D/4
// output columns. Tensor-core products (wgmma), TMA loads and a split of
// long rows across blocks are later work; at S=512 the grid is
// 8 x 12 = 96 blocks, under one wave of the card's 132 SMs.
//
// With dropout the hash is integer work on the CUDA cores: about 11
// operations per live pair (an xor, fmix32's 8, a compare and a select)
// against about 4 * D = 256 fp32 operations of the scores and the value
// product, so K1d costs a few percent over K1 here. A tensor-core version
// would be bound by the hash instead (50.4 M live pairs at the training
// shape, ~0.55 G integer operations, ~33 us on 132 x 64 INT32 lanes),
// unless the mask were stored.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int TPR = 4;              // threads per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr int KPT = BK / TPR;       // keys scored per thread per tile

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

// murmur3's 32-bit finalizer (attention_pallas.py:188 _fmix32). Each source
// keeps its own copy: the build hashes one source alone.
__device__ __forceinline__ unsigned fmix32(unsigned x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
prefill_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const int* __restrict__ seg_q,
                         const int* __restrict__ seg_kv,
                         const int* __restrict__ seed, T* __restrict__ out,
                         int H, int Sq, int Sk, float scale, int causal,
                         unsigned thresh, float mscale) {
  static_assert(D % TPR == 0, "D must split over the threads of a row");
  __shared__ float ks[BK][D + 1];   // +1: row stride off the bank period
  __shared__ float vs[BK][D + 1];
  __shared__ float ps[BQ][BK + 1];
  __shared__ int segk[BK];

  const int bh = blockIdx.y;        // b * H + h
  const int b = bh / H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x;
  const int r = tid / TPR;          // query row within the tile
  const int sub = tid % TPR;        // this thread's share of the row
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const bool has_seg = seg_kv != nullptr;

  const size_t qbase = (size_t)bh * Sq * D;
  const size_t kbase = (size_t)bh * Sk * D;

  float qr[D];
#pragma unroll
  for (int c = 0; c < D; ++c)
    qr[c] = row_ok ? to_f(q[qbase + (size_t)qi * D + c]) : 0.f;
  const int seg_row = (has_seg && row_ok) ? seg_q[(size_t)b * Sq + qi] : 0;
  unsigned rowkey = 0;
  if constexpr (DROPOUT) {
    const unsigned s = fmix32(0x9E3779B9u ^ (unsigned)__ldg(seed));
    rowkey = fmix32(fmix32(s ^ (unsigned)bh) ^ (unsigned)qi);
  }

  float m = -INFINITY;              // running max of the row's live scores
  float l = 0.f;                    // running sum of exp(score - m)
  float acc[D / TPR];
#pragma unroll
  for (int i = 0; i < D / TPR; ++i) acc[i] = 0.f;

  // causal: keys past the block's last query row are masked for every row
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;

  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();                // the previous tile is fully consumed
    for (int e = tid; e < BK * D; e += THREADS) {
      const int j = e / D, c = e % D;
      const int kj = k0 + j;
      float kv = 0.f, vv = 0.f;
      if (kj < Sk) {
        kv = to_f(k[kbase + (size_t)kj * D + c]);
        vv = to_f(v[kbase + (size_t)kj * D + c]);
      }
      ks[j][c] = kv;
      vs[j][c] = vv;
    }
    if (tid < BK)
      segk[tid] = (has_seg && k0 + tid < Sk) ? seg_kv[(size_t)b * Sk + k0 + tid] : 0;
    __syncthreads();

    float s[KPT];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const int j = sub + TPR * t;
      const int kj = k0 + j;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], ks[j][c], dot);
      const bool masked = !row_ok || kj >= Sk || (causal && kj > qi) ||
                          (has_seg && segk[j] != seg_row);
      s[t] = masked ? -INFINITY : dot * scale;
      tmax = fmaxf(tmax, s[t]);
    }
    // the TPR threads of a row are adjacent lanes of one warp
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m, tmax);
    // m_new == -inf: every key so far is masked for this row
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int t = 0; t < KPT; ++t) {
      const bool live = s[t] != -INFINITY;
      const float p = live ? expf(s[t] - m_new) : 0.f;
      float pv = p;
      if constexpr (DROPOUT) {
        // only live scores draw; l takes the unmasked p
        const unsigned kj = (unsigned)(k0 + sub + TPR * t);
        pv = (live && fmix32(rowkey ^ kj) >= thresh) ? p * mscale : 0.f;
      }
      ps[r][sub + TPR * t] = pv;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();                   // the row's p values are all written
#pragma unroll
    for (int i = 0; i < D / TPR; ++i) {
      const int c = sub + TPR * i;
      float a = acc[i] * alpha;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(ps[r][j], vs[j][c], a);
      acc[i] = a;
    }
  }

  if (row_ok) {
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < D / TPR; ++i)
      out[qbase + (size_t)qi * D + sub + TPR * i] = from_f<T>(acc[i] * inv);
  }
}

template <typename T, int D, bool DROPOUT>
void launch_one(dim3 grid, cudaStream_t st, const void* q, const void* k,
                const void* v, const void* seg_q, const void* seg_kv,
                const void* seed, void* out, int H, int Sq, int Sk,
                float scale, int causal, unsigned thresh, float mscale) {
  prefill_attention_kernel<T, D, DROPOUT><<<grid, THREADS, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)seg_q,
      (const int*)seg_kv, (const int*)seed, (T*)out, H, Sq, Sk, scale,
      causal, thresh, mscale);
}

template <typename T>
void launch(int D, dim3 grid, cudaStream_t st, const void* q, const void* k,
            const void* v, const void* seg_q, const void* seg_kv,
            const void* seed, void* out, int H, int Sq, int Sk, float scale,
            int causal, unsigned thresh, float mscale) {
#define K1_ARGS grid, st, q, k, v, seg_q, seg_kv, seed, out, H, Sq, Sk, scale, causal, thresh, mscale
  if (seed == nullptr) {
    if (D == 64) launch_one<T, 64, false>(K1_ARGS);
    else launch_one<T, 128, false>(K1_ARGS);
  } else {
    if (D == 64) launch_one<T, 64, true>(K1_ARGS);
    else launch_one<T, 128, true>(K1_ARGS);
  }
#undef K1_ARGS
}

}  // namespace

// seed == nullptr: no dropout (thresh and mscale unread)
extern "C" int prefill_attention_fwd(const void* q, const void* k, const void* v,
                                     const void* seg_q, const void* seg_kv,
                                     const void* seed, void* out, int B, int H,
                                     int Sq, int Sk, int D, float scale,
                                     int causal, unsigned thresh, float mscale,
                                     int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((D != 64 && D != 128) || dtype < 0 || dtype > 2 || B < 1 || H < 1 ||
      Sq < 1 || Sk < 1 || (seg_q == nullptr) != (seg_kv == nullptr))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  cudaStream_t st = (cudaStream_t)stream;
#define FWD_ARGS D, grid, st, q, k, v, seg_q, seg_kv, seed, out, H, Sq, Sk, scale, causal, thresh, mscale
  if (dtype == 0)
    launch<__nv_bfloat16>(FWD_ARGS);
  else if (dtype == 1)
    launch<__half>(FWD_ARGS);
  else
    launch<float>(FWD_ARGS);
#undef FWD_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* prefill_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

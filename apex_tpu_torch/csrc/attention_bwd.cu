// Attention backward with the split structure: the dq pass (K5) and the
// dk/dv pass (K6).
//
// Replaces apex_tpu/ops/attention_pallas.py:850 _bwd_split: its q-major dq
// pass (pallas_call :869; kernels _bwd_dq_kernel :435 and
// _bwd_dq_kernel_chunked :475) and its k-major dk/dv pass (pallas_call
// :899; kernel _bwd_dkv_kernel :532). Semantics are theirs: fp32 scores
// scale * Q K^T; a key is masked where it lies above the causal diagonal
// (key index > query index) or where its segment id differs from the
// query's; the softmax statistics are the row max m (of the live scores;
// -FLT_MAX, the JAX finfo.min, for a fully masked row) and the row sum l of
// exp(s - m); P = exp(min(s - m, 0)) / l with masked entries and l == 0
// giving 0 (_p_from_stats :156); dS = P (dP - D) scale with dP = dO V^T;
// dS and P are rounded to the input dtype before the dq, dk and dv
// products, which accumulate in fp32; dq, dk and dv are written in the
// input dtype. One difference: D = rowsum(dO * O) from the saved forward
// output, where the TPU kernel forms rowsum(P * dP) from its whole score
// row. The two agree in exact arithmetic, and this saves a third sweep.
//
// The DROPOUT instantiations (K5d, K6d) compute the function of the
// monolithic backward's dropout replay (_bwd_kernel :303, :331-346, under
// pallas_call :834) in this split structure: the mask M (mscale = 1/(1-p)
// where kept, 0 where dropped) is regenerated from the seed, never read:
// _dropout_mscale :198's chained fmix32 hash of the seed and the score's
// global (b*H + h, row, column), the same bits the forward K1d drew. K5d
// uses dP * mscale in dS = P (dP mscale - D) scale; K6d uses P * mscale,
// rounded to the input dtype, for dv and the same dS for dk. Because the
// mask is a function of global coordinates, K6's k-major walk regenerates
// exactly the bits of the q-major forward. D = rowsum(dO * O) is unchanged:
// O = (P M) V, so it equals the TPU kernel's rowsum(P M * dP). The hash
// costs ~11 integer operations per live pair against ~384-512 fp32 ones
// here; a tensor-core version would be bound by it unless the mask were
// stored.
//
// Layout: q, o, dO, dq [B, H, Sq, D]; k, v, dk, dv [B, H, Sk, D]; all
// contiguous, one dtype (bf16, fp16 or fp32); segment ids [B, Sq] and
// [B, Sk] int32 or null; m, l, D [B, H, Sq] fp32, written by K5 and read by
// K6; the dropout seed one int32, or null for no dropout. D (head dim) is 64
// or 128.
//
// What bounds it on H100: at the training shape (B 8, H 12, S 1024, D 64,
// bf16, causal) the two passes move ~102 MB (q, k, v, o, dO read; dq, dk,
// dv written; the row statistics), 30 us at 3.35 TB/s. The causal mask
// leaves 50.4 M live (query, key) pairs; K5 needs three products over them
// (S, dP, dq) and K6 four (S, dP, dk, dv), 2 x 64 flops each per pair:
// 19 and 26 GFLOP, 20 and 26 us at 989 TFLOP/s on the tensor cores. So a
// tensor-core kernel would be bound by operations. This first version
// computes with fp32 FMAs on the CUDA cores (67 TFLOP/s), which puts it far
// above either line; wgmma is later work.
//
// The TPU kernel holds a whole [bq, sk] fp32 score row in VMEM. A 64 x 1024
// row is 256 KB, more than a block's 227 KB of shared memory, so:
//  - K5 runs one block per (batch*head, 64-row q tile) and sweeps the key
//    tiles at or below the causal diagonal twice: sweep 1 computes (m, l)
//    online, sweep 2 forms P, dP and dS and accumulates dq = dS K in fp32
//    registers. It writes m, l and D for K6.
//  - K6 runs one block per (batch*head, 64-row k tile), walks the q tiles
//    from the diagonal down (tiles wholly above it are skipped, the rule of
//    _bwd_dkv_kernel :585-588), rebuilds P from (m, l), and accumulates
//    dk += dS^T Q and dv += P^T dO in fp32 registers. Each block owns its
//    dk/dv rows outright: no atomics, no ordering between blocks (the
//    monolithic TPU backward's cross-block dk/dv accumulation relies on the
//    TPU's sequential grid and would be a race here).
// Four threads share a row; each owns D/4 interleaved columns. A tile's 32
// dot products per row are summed over the four threads with a two-step
// butterfly that leaves each thread 8 finished dots.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int TPR = 4;                // threads per row
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / TPR;   // 64: q rows of a K5 block, k rows of a K6 block
constexpr int TILE = 32;              // keys (K5) or queries (K6) per tile
constexpr int OWN = TILE / TPR;       // finished dots per thread per tile
constexpr unsigned FULL = 0xffffffffu;

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

// the per-(batch, head) key of _dropout_mscale: fmix32(fmix32(0x9E3779B9 ^
// seed) ^ (b * H + h))
__device__ __forceinline__ unsigned head_key(const int* seed, int bh) {
  return fmix32(fmix32(0x9E3779B9u ^ (unsigned)__ldg(seed)) ^ (unsigned)bh);
}

// x rounded to T and back: the TPU kernel's .astype(q.dtype) on dS and P
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// a[j]: this thread's partial dot (over its D/4 columns) with tile row j.
// out[i]: the full dot with tile row own_row(sub, i), summed over the four
// threads of the row (adjacent lanes) in a fixed order.
__device__ __forceinline__ void butterfly(const float (&a)[TILE],
                                          float (&out)[OWN], int sub) {
  const bool hi1 = sub & 1;
  float b[TILE / 2];
#pragma unroll
  for (int i = 0; i < TILE / 2; ++i) {
    const float send = hi1 ? a[i] : a[i + TILE / 2];
    const float keep = hi1 ? a[i + TILE / 2] : a[i];
    b[i] = keep + __shfl_xor_sync(FULL, send, 1);
  }
  const bool hi2 = (sub >> 1) & 1;
#pragma unroll
  for (int i = 0; i < OWN; ++i) {
    const float send = hi2 ? b[i] : b[i + OWN];
    const float keep = hi2 ? b[i + OWN] : b[i];
    out[i] = keep + __shfl_xor_sync(FULL, send, 2);
  }
}

__device__ __forceinline__ int own_row(int sub, int i) {
  return (sub & 1) * (TILE / 2) + ((sub >> 1) & 1) * OWN + i;
}

__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}

// rows [r0, r0 + TILE) of a [S, D] slab into an fp32 shared tile (zeros
// past S)
template <typename T, int D>
__device__ __forceinline__ void load_tile(float (*dst)[D + 1], const T* src,
                                          int r0, int S) {
  for (int e = threadIdx.x; e < TILE * D; e += THREADS) {
    const int j = e / D, c = e % D;
    dst[j][c] = (r0 + j < S) ? to_f(src[(size_t)(r0 + j) * D + c]) : 0.f;
  }
}

// partial dots of this thread's columns (c = sub + TPR * i) with every row
// of a shared tile
template <int D>
__device__ __forceinline__ void partial_dots(const float (&own)[D / TPR],
                                             const float (*tile)[D + 1],
                                             int sub, float (&a)[TILE]) {
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < D / TPR; ++i) s = fmaf(own[i], tile[j][sub + TPR * i], s);
    a[j] = s;
  }
}

// K5: dq plus the row statistics (m, l, D)
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const int* __restrict__ seg_q,
                        const int* __restrict__ seg_kv,
                        const int* __restrict__ seed, T* __restrict__ dq,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ d_out, int H, int Sq, int Sk,
                        float scale, int causal, unsigned thresh,
                        float mscale) {
  constexpr int DC = D / TPR;
  __shared__ float ks[TILE][D + 1];   // +1: row stride off the bank period
  __shared__ float vs[TILE][D + 1];
  __shared__ float ps[ROWS][TILE + 1];
  __shared__ int segk[TILE];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int q0 = blockIdx.x * ROWS;
  const int r = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int qi = q0 + r;
  const bool row_ok = qi < Sq;
  const bool has_seg = seg_kv != nullptr;
  const size_t qrow = ((size_t)bh * Sq + (row_ok ? qi : 0)) * D;
  const T* kb = k + (size_t)bh * Sk * D;
  const T* vb = v + (size_t)bh * Sk * D;

  float qr[DC], dor[DC], acc[DC];
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < DC; ++i) {
    const int c = sub + TPR * i;
    qr[i] = row_ok ? to_f(q[qrow + c]) : 0.f;
    dor[i] = row_ok ? to_f(dout[qrow + c]) : 0.f;
    dsum = fmaf(dor[i], row_ok ? to_f(o[qrow + c]) : 0.f, dsum);
    acc[i] = 0.f;
  }
  const float drow = row_sum4(dsum);
  const int seg_row = (has_seg && row_ok) ? seg_q[(size_t)b * Sq + qi] : 0;
  const int k_end = causal ? min(Sk, q0 + ROWS) : Sk;
  unsigned rowkey = 0;
  if constexpr (DROPOUT) rowkey = fmix32(head_key(seed, bh) ^ (unsigned)qi);

  // sweep 1: online row max and sum
  float m = -INFINITY, l = 0.f;
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, Sk);
    if (threadIdx.x < TILE)
      segk[threadIdx.x] = (has_seg && k0 + threadIdx.x < Sk)
                              ? seg_kv[(size_t)b * Sk + k0 + threadIdx.x] : 0;
    __syncthreads();
    float a[TILE], s[OWN];
    partial_dots<D>(qr, ks, sub, a);
    butterfly(a, s, sub);
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int j = own_row(sub, i);
      const int kj = k0 + j;
      const bool masked = !row_ok || kj >= Sk || (causal && kj > qi) ||
                          (has_seg && segk[j] != seg_row);
      s[i] = masked ? -INFINITY : s[i] * scale;
      tmax = fmaxf(tmax, s[i]);
    }
    const float m_new = fmaxf(m, row_max4(tmax));
    const float alpha = (m_new == -INFINITY) ? 1.f : expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int i = 0; i < OWN; ++i)
      psum += (s[i] == -INFINITY) ? 0.f : expf(s[i] - m_new);
    l = l * alpha + row_sum4(psum);
    m = m_new;
  }
  if (l == 0.f) m = -FLT_MAX;            // fully masked row: finfo.min

  // sweep 2: P, dP, dS; dq += dS K
  for (int k0 = 0; k0 < k_end; k0 += TILE) {
    __syncthreads();
    load_tile<T, D>(ks, kb, k0, Sk);
    load_tile<T, D>(vs, vb, k0, Sk);
    if (threadIdx.x < TILE)
      segk[threadIdx.x] = (has_seg && k0 + threadIdx.x < Sk)
                              ? seg_kv[(size_t)b * Sk + k0 + threadIdx.x] : 0;
    __syncthreads();
    float a[TILE], s[OWN], dp[OWN];
    partial_dots<D>(qr, ks, sub, a);
    butterfly(a, s, sub);
    partial_dots<D>(dor, vs, sub, a);
    butterfly(a, dp, sub);
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int j = own_row(sub, i);
      const int kj = k0 + j;
      const bool masked = !row_ok || kj >= Sk || (causal && kj > qi) ||
                          (has_seg && segk[j] != seg_row);
      const float e = masked ? 0.f : expf(fminf(s[i] * scale - m, 0.f));
      const float p = l > 0.f ? e / l : 0.f;
      float dpm = dp[i];
      if constexpr (DROPOUT)   // the replayed mask on dP; masked pairs draw nothing
        dpm = (!masked && fmix32(rowkey ^ (unsigned)kj) >= thresh)
                  ? dpm * mscale : dpm * 0.f;
      ps[r][j] = round_to<T>(p * (dpm - drow) * scale);
    }
    __syncwarp();                        // the row's dS values are all written
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int c = sub + TPR * i;
      float x = acc[i];
#pragma unroll 8
      for (int j = 0; j < TILE; ++j) x = fmaf(ps[r][j], ks[j][c], x);
      acc[i] = x;
    }
  }

  if (row_ok) {
#pragma unroll
    for (int i = 0; i < DC; ++i) dq[qrow + sub + TPR * i] = from_f<T>(acc[i]);
    if (sub == 0) {
      const size_t si = (size_t)bh * Sq + qi;
      m_out[si] = m;
      l_out[si] = l;
      d_out[si] = drow;
    }
  }
}

// K6: dk and dv of one 64-row k tile
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const int* __restrict__ seg_q,
                         const int* __restrict__ seg_kv,
                         const float* __restrict__ m_in,
                         const float* __restrict__ l_in,
                         const float* __restrict__ d_in,
                         const int* __restrict__ seed, T* __restrict__ dk,
                         T* __restrict__ dv, int H, int Sq, int Sk, float scale,
                         int causal, unsigned thresh, float mscale) {
  constexpr int DC = D / TPR;
  __shared__ float qs[TILE][D + 1];
  __shared__ float dos[TILE][D + 1];
  __shared__ float pt[ROWS][TILE + 1];   // P, then dS, of this block's keys
  __shared__ float ms[TILE], ls[TILE], dsm[TILE];
  __shared__ int segq[TILE];
  __shared__ unsigned rks[TILE];          // dropout row keys of the q tile

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int k0 = blockIdx.x * ROWS;
  const int r = threadIdx.x / TPR;
  const int sub = threadIdx.x % TPR;
  const int kj = k0 + r;
  const bool key_ok = kj < Sk;
  const bool has_seg = seg_kv != nullptr;
  const size_t krow = ((size_t)bh * Sk + (key_ok ? kj : 0)) * D;
  const T* qb = q + (size_t)bh * Sq * D;
  const T* db = dout + (size_t)bh * Sq * D;
  const size_t sbase = (size_t)bh * Sq;

  float kr[DC], vr[DC], dk_acc[DC], dv_acc[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) {
    const int c = sub + TPR * i;
    kr[i] = key_ok ? to_f(k[krow + c]) : 0.f;
    vr[i] = key_ok ? to_f(v[krow + c]) : 0.f;
    dk_acc[i] = dv_acc[i] = 0.f;
  }
  const int seg_key = (has_seg && key_ok) ? seg_kv[(size_t)b * Sk + kj] : 0;
  unsigned hkey = 0;
  if constexpr (DROPOUT) hkey = head_key(seed, bh);
  // causal: query rows below k0 see none of this block's keys
  const int q_begin = causal ? (k0 / TILE) * TILE : 0;

  for (int q0 = q_begin; q0 < Sq; q0 += TILE) {
    __syncthreads();
    load_tile<T, D>(qs, qb, q0, Sq);
    load_tile<T, D>(dos, db, q0, Sq);
    if (threadIdx.x < TILE) {
      const int qi = q0 + threadIdx.x;
      const bool ok = qi < Sq;
      ms[threadIdx.x] = ok ? m_in[sbase + qi] : 0.f;
      ls[threadIdx.x] = ok ? l_in[sbase + qi] : 0.f;
      dsm[threadIdx.x] = ok ? d_in[sbase + qi] : 0.f;
      segq[threadIdx.x] = (has_seg && ok) ? seg_q[(size_t)b * Sq + qi] : 0;
      if constexpr (DROPOUT) rks[threadIdx.x] = fmix32(hkey ^ (unsigned)qi);
    }
    __syncthreads();
    float a[TILE], s[OWN], dp[OWN], ds[OWN];
    partial_dots<D>(kr, qs, sub, a);
    butterfly(a, s, sub);
    partial_dots<D>(vr, dos, sub, a);
    butterfly(a, dp, sub);
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int ii = own_row(sub, i);
      const int qi = q0 + ii;
      const bool masked = !key_ok || qi >= Sq || (causal && kj > qi) ||
                          (has_seg && segq[ii] != seg_key);
      const float e = masked ? 0.f : expf(fminf(s[i] * scale - ms[ii], 0.f));
      const float p = ls[ii] > 0.f ? e / ls[ii] : 0.f;
      float dpm = dp[i], pd = p;
      if constexpr (DROPOUT) {  // the replayed mask; masked pairs draw nothing
        const float msc =
            (!masked && fmix32(rks[ii] ^ (unsigned)kj) >= thresh) ? mscale : 0.f;
        dpm *= msc;
        pd = p * msc;
      }
      ds[i] = round_to<T>(p * (dpm - dsm[ii]) * scale);
      pt[r][ii] = round_to<T>(pd);
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int c = sub + TPR * i;
      float x = dv_acc[i];
#pragma unroll 8
      for (int ii = 0; ii < TILE; ++ii) x = fmaf(pt[r][ii], dos[ii][c], x);
      dv_acc[i] = x;
    }
    __syncwarp();                        // the row's P reads are done
#pragma unroll
    for (int i = 0; i < OWN; ++i) pt[r][own_row(sub, i)] = ds[i];
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      const int c = sub + TPR * i;
      float x = dk_acc[i];
#pragma unroll 8
      for (int ii = 0; ii < TILE; ++ii) x = fmaf(pt[r][ii], qs[ii][c], x);
      dk_acc[i] = x;
    }
  }

  if (key_ok) {
#pragma unroll
    for (int i = 0; i < DC; ++i) {
      dk[krow + sub + TPR * i] = from_f<T>(dk_acc[i]);
      dv[krow + sub + TPR * i] = from_f<T>(dv_acc[i]);
    }
  }
}

template <typename T, int D>
void launch_dq(dim3 grid, cudaStream_t st, const void* q, const void* k,
               const void* v, const void* o, const void* dout,
               const void* seg_q, const void* seg_kv, const void* seed,
               void* dq, void* m, void* l, void* d, int H, int Sq, int Sk,
               float scale, int causal, unsigned thresh, float mscale) {
#define DQ_KERNEL_ARGS                                                        \
  (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,         \
      (const int*)seg_q, (const int*)seg_kv, (const int*)seed, (T*)dq,        \
      (float*)m, (float*)l, (float*)d, H, Sq, Sk, scale, causal, thresh, mscale
  if (seed == nullptr)
    attention_bwd_dq_kernel<T, D, false><<<grid, THREADS, 0, st>>>(DQ_KERNEL_ARGS);
  else
    attention_bwd_dq_kernel<T, D, true><<<grid, THREADS, 0, st>>>(DQ_KERNEL_ARGS);
#undef DQ_KERNEL_ARGS
}

template <typename T, int D>
void launch_dkv(dim3 grid, cudaStream_t st, const void* q, const void* k,
                const void* v, const void* dout, const void* seg_q,
                const void* seg_kv, const void* m, const void* l,
                const void* d, const void* seed, void* dk, void* dv, int H,
                int Sq, int Sk, float scale, int causal, unsigned thresh,
                float mscale) {
#define DKV_KERNEL_ARGS                                                       \
  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const int*)seg_q,   \
      (const int*)seg_kv, (const float*)m, (const float*)l, (const float*)d,  \
      (const int*)seed, (T*)dk, (T*)dv, H, Sq, Sk, scale, causal, thresh,     \
      mscale
  if (seed == nullptr)
    attention_bwd_dkv_kernel<T, D, false><<<grid, THREADS, 0, st>>>(DKV_KERNEL_ARGS);
  else
    attention_bwd_dkv_kernel<T, D, true><<<grid, THREADS, 0, st>>>(DKV_KERNEL_ARGS);
#undef DKV_KERNEL_ARGS
}

bool bad_args(int B, int H, int Sq, int Sk, int D, int dtype,
              const void* seg_q, const void* seg_kv) {
  return (D != 64 && D != 128) || dtype < 0 || dtype > 2 || B < 1 || H < 1 ||
         Sq < 1 || Sk < 1 || B * H > 65535 ||
         (seg_q == nullptr) != (seg_kv == nullptr);
}

}  // namespace

// seed == nullptr: no dropout (thresh and mscale unread)
extern "C" int attention_bwd_dq(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const void* seg_q, const void* seg_kv,
                                const void* seed, void* dq, void* m, void* l,
                                void* d, int B, int H, int Sq, int Sk, int D,
                                float scale, int causal, unsigned thresh,
                                float mscale, int dtype, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(B, H, Sq, Sk, D, dtype, seg_q, seg_kv))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + ROWS - 1) / ROWS, B * H);
  cudaStream_t st = (cudaStream_t)stream;
#define DQ_ARGS grid, st, q, k, v, o, dout, seg_q, seg_kv, seed, dq, m, l, d, H, Sq, Sk, scale, causal, thresh, mscale
  if (dtype == 0) {
    if (D == 64) launch_dq<__nv_bfloat16, 64>(DQ_ARGS);
    else launch_dq<__nv_bfloat16, 128>(DQ_ARGS);
  } else if (dtype == 1) {
    if (D == 64) launch_dq<__half, 64>(DQ_ARGS);
    else launch_dq<__half, 128>(DQ_ARGS);
  } else {
    if (D == 64) launch_dq<float, 64>(DQ_ARGS);
    else launch_dq<float, 128>(DQ_ARGS);
  }
#undef DQ_ARGS
  return (int)cudaGetLastError();
}

// seed == nullptr: no dropout (thresh and mscale unread)
extern "C" int attention_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* seg_q,
                                 const void* seg_kv, const void* m,
                                 const void* l, const void* d,
                                 const void* seed, void* dk, void* dv, int B,
                                 int H, int Sq, int Sk, int D, float scale,
                                 int causal, unsigned thresh, float mscale,
                                 int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(B, H, Sq, Sk, D, dtype, seg_q, seg_kv))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sk + ROWS - 1) / ROWS, B * H);
  cudaStream_t st = (cudaStream_t)stream;
#define DKV_ARGS grid, st, q, k, v, dout, seg_q, seg_kv, m, l, d, seed, dk, dv, H, Sq, Sk, scale, causal, thresh, mscale
  if (dtype == 0) {
    if (D == 64) launch_dkv<__nv_bfloat16, 64>(DKV_ARGS);
    else launch_dkv<__nv_bfloat16, 128>(DKV_ARGS);
  } else if (dtype == 1) {
    if (D == 64) launch_dkv<__half, 64>(DKV_ARGS);
    else launch_dkv<__half, 128>(DKV_ARGS);
  } else {
    if (D == 64) launch_dkv<float, 64>(DKV_ARGS);
    else launch_dkv<float, 128>(DKV_ARGS);
  }
#undef DKV_ARGS
  return (int)cudaGetLastError();
}

extern "C" const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

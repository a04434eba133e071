// Paged decode attention (one query row per sequence slot) over the KV cache.
//
// Replaces apex_tpu/ops/decode_attention_pallas.py:142 _kernel: K2, its bf16,
// fp16 and fp32 branch, and K2q, its int8 dequantizing branch (:163-168, the
// int8 KV tier of apex_tpu/serving/kv_tier.py), as the QUANT instantiation
// of the same kernel with its own entry point. Semantics are those of
// decode_attention_pallas.py:264 decode_attention_reference: fp32 scores of
// (q * scale) against every key position below the slot's length; positions
// at or past the length are masked; exact softmax; a slot of length 0
// gives 0. K2q reads int8 codes and multiplies each page's K and V rows by
// that page's per-head bf16 scale in fp32 before the same arithmetic.
//
// Layout: q [B, H, D]; k_pages and v_pages [H, P, ps, D] (int8 for K2q);
// k_scale and v_scale [H, P] bf16 (K2q only); page_table [B, max_pages]
// int32 (padded with null page 0); lengths [B] int32, the length including
// the current token; out [B, H, D]. D is 64 or 128.
//
// What bounds it on H100: the bytes of the live K and V rows (at 8 slots
// of 1024 tokens, 12 heads, D=64 in bf16: 25.2 MB, ~7.5 us at 3.35 TB/s;
// int8 codes halve that); the arithmetic is ~2 FLOP per byte (4 for
// K2q). The TPU kernel prefetched the page table as scalars and let
// BlockSpec index maps gather whole pages; here each block loads its own
// page indices, walks only the ceil(length/ps) pages the slot holds (it
// never reads a padded table entry and never materialises the gathered
// cache), and keeps many independent row loads in flight: the slot's
// positions are cut into chunks of KB rows that never cross a page, one
// page-table load (and, for K2q, one load of the page's two scales) per
// chunk, after which a warp issues the chunk's 2*KB row loads at once,
// reduces the KB dot products with warp shuffles and folds them into its
// own fp32 online softmax. K2 gives each lane one aligned vector of D/32
// dims, so a 128-byte row per key and warp at D=64 bf16, every load
// coalesced. An int8 row is half as wide (64 B at D=64), and D/32 int8
// dims would be 2-byte loads, so K2q splits the warp in two: 16 lanes a
// row, each lane 4 bytes at D=64 (8 at D=128), the two halves on the
// chunk's even and odd rows; one shuffle gives every lane the other
// half's scores, so the online softmax stays warp-wide, and the halves'
// value sums add at the end. The WARPS warps of a block stride over the
// chunks and combine their (max, sum, acc) states through shared memory
// at the end. One block per (slot, head): 8 x 12 = 96 blocks at the
// serving shape, under one wave of 132 SMs, and the longest slot's blocks
// set the time; splitting a slot's pages across blocks with a combine
// pass is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 16;
constexpr int KB = 16;              // keys per warp iteration
constexpr int THREADS = WARPS * 32;

// EPL contiguous head dims of one lane, loaded as one aligned vector
template <typename T, int N>
struct alignas(sizeof(T) * N) Pack {
  T v[N];
};

__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// T: q and out; KV: the pages (T, or int8 codes when QUANT)
template <typename T, typename KV, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k_pages,
                        const KV* __restrict__ v_pages,
                        const __nv_bfloat16* __restrict__ k_scale,
                        const __nv_bfloat16* __restrict__ v_scale,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int P, int ps, int max_pages, float scale) {
  constexpr int RPL = QUANT ? 2 : 1;  // rows one warp-wide load covers
  constexpr int LPR = 32 / RPL;       // lanes per row
  constexpr int EPL = D / LPR;        // head dims per lane
  constexpr int KR = KB / RPL;        // rows of a chunk one lane loads
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];

  const int bh = blockIdx.x;        // b * H + h
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane / LPR;      // K2q: 0 on even rows, 1 on odd rows
  const int sub = lane % LPR;
  // a length past the table's reach is cut to it (no read past the table)
  const int length = min(lengths[b], max_pages * ps);
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t head_off = (size_t)h * P * ps * D;

  float qv[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    qv[e] = to_f(q[(size_t)bh * D + sub * EPL + e]) * scale;

  float m = -INFINITY, l = 0.f;
  float acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  // the slot's positions in chunks of KB keys that never cross a page:
  // chunk c is page c / chunks, rows (c % chunks) * KB ... of that page.
  // Warps stride over the chunks, so each iteration loads ONE page-table
  // entry and then issues all 2*KB row loads of the chunk at once.
  const int chunks = (ps + KB - 1) / KB;
  const int n_pages = (length + ps - 1) / ps;
  for (int c = warp; c < n_pages * chunks; c += WARPS) {
    const int j = c / chunks;
    const int off0 = (c % chunks) * KB;
    const int pos0 = j * ps + off0;
    if (pos0 >= length) continue;     // warp-uniform: the chunk is dead
    // out-of-range table entries clamp, as the JAX gather does
    const int page = min(max(pt[j], 0), P - 1);
    const size_t page_off = head_off + (size_t)page * ps * D + sub * EPL;
    float ks = 1.f, vs = 1.f;
    if constexpr (QUANT) {
      // dequantize at read: one bf16 scale per head for THIS page
      ks = to_f(k_scale[(size_t)h * P + page]);
      vs = to_f(v_scale[(size_t)h * P + page]);
    }
    float s[KR];
    float vr[KR][EPL];
#pragma unroll
    for (int t = 0; t < KR; ++t) {
      // rows past the page end re-read the chunk's first row (in bounds,
      // masked below): every load is unconditional and independent
      const int r = t * RPL + half;
      const int row = (off0 + r < ps) ? off0 + r : off0;
      const Pack<KV, EPL> kk =
          *reinterpret_cast<const Pack<KV, EPL>*>(k_pages + page_off + (size_t)row * D);
      const Pack<KV, EPL> vv =
          *reinterpret_cast<const Pack<KV, EPL>*>(v_pages + page_off + (size_t)row * D);
      s[t] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        s[t] = fmaf(qv[e], to_f(kk.v[e]) * ks, s[t]);
        vr[t][e] = to_f(vv.v[e]) * vs;
      }
    }
#pragma unroll
    for (int t = 0; t < KR; ++t)
#pragma unroll
      for (int off = LPR / 2; off > 0; off >>= 1)
        s[t] += __shfl_xor_sync(0xffffffffu, s[t], off);
    // every lane takes the scores of all KB rows of the chunk
    float sa[KB];
#pragma unroll
    for (int t = 0; t < KR; ++t) {
      if constexpr (QUANT) {
        const float other = __shfl_xor_sync(0xffffffffu, s[t], 16);
        sa[2 * t] = half ? other : s[t];
        sa[2 * t + 1] = half ? s[t] : other;
      } else {
        sa[t] = s[t];
      }
    }
    bool live[KB];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      live[t] = off0 + t < ps && pos0 + t < length;
      if (live[t]) tmax = fmaxf(tmax, sa[t]);
    }
    const float m_new = fmaxf(m, tmax);   // finite: position pos0 is live
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float p[KB];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      p[t] = live[t] ? expf(sa[t] - m_new) : 0.f;
      psum += p[t];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int t = 0; t < KR; ++t) {
      float pm;
      if constexpr (QUANT) {
        pm = half ? p[2 * t + 1] : p[2 * t];
      } else {
        pm = p[t];
      }
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pm, vr[t][e], acc[e]);
    }
    l = l * alpha + psum;
    m = m_new;
  }
  if constexpr (QUANT) {
    // the two halves summed the same dims over the even and odd rows
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], 16);
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
  if (half == 0) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) sm_acc[warp][sub * EPL + e] = acc[e];
  }
  __syncthreads();

  for (int c = threadIdx.x; c < D; c += THREADS) {
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) M = fmaxf(M, sm_m[w]);
    float L = 0.f, o = 0.f;
    if (M != -INFINITY) {           // -inf: the slot has no live position
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float f = (sm_m[w] == -INFINITY) ? 0.f : expf(sm_m[w] - M);
        L = fmaf(sm_l[w], f, L);
        o = fmaf(sm_acc[w][c], f, o);
      }
    }
    out[(size_t)bh * D + c] = from_f<T>(L > 0.f ? o / L : 0.f);
  }
}

template <typename T, typename KV, bool QUANT>
void launch(int D, int blocks, cudaStream_t st, const void* q, const void* kp,
            const void* vp, const void* ks, const void* vs, const void* pt,
            const void* len, void* out, int H, int P, int ps, int max_pages,
            float scale) {
  if (D == 64)
    decode_attention_kernel<T, KV, 64, QUANT><<<blocks, THREADS, 0, st>>>(
        (const T*)q, (const KV*)kp, (const KV*)vp, (const __nv_bfloat16*)ks,
        (const __nv_bfloat16*)vs, (const int*)pt, (const int*)len, (T*)out, H,
        P, ps, max_pages, scale);
  else
    decode_attention_kernel<T, KV, 128, QUANT><<<blocks, THREADS, 0, st>>>(
        (const T*)q, (const KV*)kp, (const KV*)vp, (const __nv_bfloat16*)ks,
        (const __nv_bfloat16*)vs, (const int*)pt, (const int*)len, (T*)out, H,
        P, ps, max_pages, scale);
}

bool bad_args(int B, int H, int P, int ps, int max_pages, int D, int dtype) {
  return (D != 64 && D != 128) || dtype < 0 || dtype > 2 || B < 1 || H < 1 ||
         P < 1 || ps < 1 || max_pages < 1;
}

}  // namespace

// K2: pages in q's dtype
extern "C" int decode_attention_fwd(const void* q, const void* k_pages,
                                    const void* v_pages, const void* page_table,
                                    const void* lengths, void* out, int B, int H,
                                    int P, int ps, int max_pages, int D,
                                    float scale, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(B, H, P, ps, max_pages, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch<__nv_bfloat16, __nv_bfloat16, false>(D, B * H, st, q, k_pages, v_pages,
                                                nullptr, nullptr, page_table,
                                                lengths, out, H, P, ps,
                                                max_pages, scale);
  else if (dtype == 1)
    launch<__half, __half, false>(D, B * H, st, q, k_pages, v_pages, nullptr,
                                  nullptr, page_table, lengths, out, H, P, ps,
                                  max_pages, scale);
  else
    launch<float, float, false>(D, B * H, st, q, k_pages, v_pages, nullptr,
                                nullptr, page_table, lengths, out, H, P, ps,
                                max_pages, scale);
  return (int)cudaGetLastError();
}

// K2q: int8 pages with [H, P] bf16 scales; q and out in `dtype`
extern "C" int decode_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* page_table, const void* lengths, void* out,
    int B, int H, int P, int ps, int max_pages, int D, float scale, int dtype,
    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(B, H, P, ps, max_pages, D, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch<__nv_bfloat16, int8_t, true>(D, B * H, st, q, k_pages, v_pages, k_scale,
                                        v_scale, page_table, lengths, out, H, P,
                                        ps, max_pages, scale);
  else if (dtype == 1)
    launch<__half, int8_t, true>(D, B * H, st, q, k_pages, v_pages, k_scale,
                                 v_scale, page_table, lengths, out, H, P, ps,
                                 max_pages, scale);
  else
    launch<float, int8_t, true>(D, B * H, st, q, k_pages, v_pages, k_scale,
                                v_scale, page_table, lengths, out, H, P, ps,
                                max_pages, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

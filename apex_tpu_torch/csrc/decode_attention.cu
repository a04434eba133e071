// Paged decode attention (one query row per sequence slot) over the KV cache.
//
// Replaces apex_tpu/ops/decode_attention_pallas.py:142 _kernel (its bf16 and
// fp32 branch; the int8 dequantizing branch comes with the KV-tier work).
// Semantics are those of decode_attention_pallas.py:264
// decode_attention_reference: fp32 scores of (q * scale) against every key
// position below the slot's length; positions at or past the length are
// masked; exact softmax; a slot of length 0 gives 0.
//
// Layout: q [B, H, D]; k_pages and v_pages [H, P, ps, D]; page_table
// [B, max_pages] int32 (padded with null page 0); lengths [B] int32, the
// length including the current token; out [B, H, D]. D is 64 or 128.
//
// What bounds it on H100: the bytes of the live K and V rows (at 8 slots
// of 1024 tokens, 12 heads, D=64 in bf16: 25.2 MB, ~7.5 us at 3.35 TB/s);
// the arithmetic is ~2 FLOP per byte. The TPU kernel prefetched the page
// table as scalars and let BlockSpec index maps gather whole pages; here
// each block loads its own page indices, walks only the ceil(length/ps)
// pages the slot holds (it never reads a padded table entry and never
// materialises the gathered cache), and keeps many independent row loads
// in flight: the slot's positions are cut into chunks of KB rows that
// never cross a page, one page-table load per chunk, after which a warp
// issues the chunk's 2*KB row loads at once (each lane one aligned vector
// of D/32 dims, so a 128-byte row per key and warp at D=64 bf16, every
// load coalesced), reduces the KB dot products with warp shuffles and
// folds them into its own fp32 online softmax. The WARPS warps of a block
// stride over the chunks and combine their (max, sum, acc) states through
// shared memory at the end. One block per (slot, head): 8 x 12 = 96
// blocks at the serving shape, under one wave of 132 SMs, and the longest
// slot's blocks set the time; splitting a slot's pages across blocks with
// a combine pass is later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

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

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half(x);
}
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                        const T* __restrict__ v_pages,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths, T* __restrict__ out,
                        int H, int P, int ps, int max_pages, float scale) {
  constexpr int EPL = D / 32;       // head dims per lane
  __shared__ float sm_m[WARPS];
  __shared__ float sm_l[WARPS];
  __shared__ float sm_acc[WARPS][D];

  const int bh = blockIdx.x;        // b * H + h
  const int b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // a length past the table's reach is cut to it (no read past the table)
  const int length = min(lengths[b], max_pages * ps);
  const int* pt = page_table + (size_t)b * max_pages;
  const size_t head_off = (size_t)h * P * ps * D;

  float qv[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e)
    qv[e] = to_f(q[(size_t)bh * D + lane * EPL + e]) * scale;

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
    const size_t page_off = head_off + (size_t)page * ps * D + lane * EPL;
    float s[KB];
    float vr[KB][EPL];
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      // rows past the page end re-read the chunk's first row (in bounds,
      // masked below): every load is unconditional and independent
      const int row = (off0 + t < ps) ? off0 + t : off0;
      const Pack<T, EPL> kk =
          *reinterpret_cast<const Pack<T, EPL>*>(k_pages + page_off + (size_t)row * D);
      const Pack<T, EPL> vv =
          *reinterpret_cast<const Pack<T, EPL>*>(v_pages + page_off + (size_t)row * D);
      s[t] = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) {
        s[t] = fmaf(qv[e], to_f(kk.v[e]), s[t]);
        vr[t][e] = to_f(vv.v[e]);
      }
    }
#pragma unroll
    for (int t = 0; t < KB; ++t)
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s[t] += __shfl_xor_sync(0xffffffffu, s[t], off);
    bool live[KB];
    float tmax = -INFINITY;
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      live[t] = off0 + t < ps && pos0 + t < length;
      if (live[t]) tmax = fmaxf(tmax, s[t]);
    }
    const float m_new = fmaxf(m, tmax);   // finite: position pos0 is live
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
#pragma unroll
    for (int t = 0; t < KB; ++t) {
      const float p = live[t] ? expf(s[t] - m_new) : 0.f;
      psum += p;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(p, vr[t][e], acc[e]);
    }
    l = l * alpha + psum;
    m = m_new;
  }

  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int e = 0; e < EPL; ++e) sm_acc[warp][lane * EPL + e] = acc[e];
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

template <typename T>
void launch(int D, int blocks, cudaStream_t st, const void* q, const void* kp,
            const void* vp, const void* pt, const void* len, void* out, int H,
            int P, int ps, int max_pages, float scale) {
  if (D == 64)
    decode_attention_kernel<T, 64><<<blocks, THREADS, 0, st>>>(
        (const T*)q, (const T*)kp, (const T*)vp, (const int*)pt,
        (const int*)len, (T*)out, H, P, ps, max_pages, scale);
  else
    decode_attention_kernel<T, 128><<<blocks, THREADS, 0, st>>>(
        (const T*)q, (const T*)kp, (const T*)vp, (const int*)pt,
        (const int*)len, (T*)out, H, P, ps, max_pages, scale);
}

}  // namespace

extern "C" int decode_attention_fwd(const void* q, const void* k_pages,
                                    const void* v_pages, const void* page_table,
                                    const void* lengths, void* out, int B, int H,
                                    int P, int ps, int max_pages, int D,
                                    float scale, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if ((D != 64 && D != 128) || dtype < 0 || dtype > 2 || B < 1 || H < 1 ||
      P < 1 || ps < 1 || max_pages < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    launch<__nv_bfloat16>(D, B * H, st, q, k_pages, v_pages, page_table, lengths,
                          out, H, P, ps, max_pages, scale);
  else if (dtype == 1)
    launch<__half>(D, B * H, st, q, k_pages, v_pages, page_table, lengths, out,
                   H, P, ps, max_pages, scale);
  else
    launch<float>(D, B * H, st, q, k_pages, v_pages, page_table, lengths, out,
                  H, P, ps, max_pages, scale);
  return (int)cudaGetLastError();
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Paged decode attention (one query row per sequence slot) over the KV cache,
// as a split-KV kernel for Hopper.
//
// Replaces apex_tpu/ops/decode_attention_pallas.py:142 _kernel: K2, its bf16,
// fp16 and fp32 branch, and K2q, its int8 dequantizing branch (:163-168, the
// int8 KV tier of apex_tpu/serving/kv_tier.py), as the QUANT instantiation
// of the same kernels with its own entry point. Semantics are those of
// decode_attention_pallas.py:264 decode_attention_reference: fp32 scores of
// (q * scale) against every key position below the slot's length; positions
// at or past the length are masked; exact softmax; a slot of length 0
// gives 0. K2q reads int8 codes and dequantizes each page's K and V rows by
// that page's per-head bf16 scale, in fp32, at read. Page-table entries
// clamp to [0, P); a length past max_pages * ps is cut to it.
//
// Layout: q [B, H, d]; k_pages and v_pages [H, P, ps, d] (int8 for K2q);
// k_scale and v_scale [H, P] bf16 (K2q only); page_table [B, max_pages]
// int32 (padded with null page 0); lengths [B] int32, the length including
// the current token; out [B, H, d]. Any head dim d <= 512: the kernels are
// built for the buckets D = 64, 128, 256 and 512 and take a runtime d <= D
// (the cache is the engine's and is never padded or copied), guarding the
// tail columns; part [B * H, n_splits, D + 2] fp32 scratch (the wrapper's).
//
// What bounds it on H100: the bytes of the live K and V rows (at the
// serving shape, 8 slots of lengths 0-1024, 12 heads, D = 64 in bf16: 6.8
// MB, ~2 us at 3.35 TB/s; int8 codes halve that); the arithmetic is ~2
// FLOP per byte (4 for K2q). One query row meets only keys of its own head,
// so the tensor cores do not apply. The earlier kernel gave each (slot,
// head) one block: 96 blocks at the serving shape, under one wave of 132
// SMs, and the longest slot's blocks walked its 1024 keys alone while the
// rest of the card idled (0.0199 ms against the 0.0021 bound).
//
// The design splits the grid over (split, slot * head), a split being a
// fixed range of sk keys inside one page (the whole page where K and V of
// ps keys fit 64 KB of shared memory: one page of 128 keys at the serving
// shape, so 252 live blocks there instead of 96); blocks of dead splits
// (at or past the slot's length) exit at once. A live block
//  - loads its page-table entry (and, for K2q, the page's two scales), and
//    brings the split's live K and V rows, each a contiguous run of the
//    [H, P, ps, d] layout, into shared memory with two 1-D bulk copies
//    (cp.async.bulk, the TMA without a tensor map) completing on one
//    mbarrier; where the page's bytes are not a multiple of 16 (an odd
//    head dim in a small page) the threads copy element by element;
//  - takes the scores from shared memory: a thread a key, reading its
//    row's 16-byte chunks from a rotated start against q in fp32 (an odd
//    head dim: a warp a key, lanes over the head dims, eight keys in
//    flight, a shuffle tree each);
//  - forms the split's max m, p = exp(s - m) and l = sum p, and the value
//    sum acc[D] = sum p v (threads over head dims, four independent
//    accumulators a thread, for D = 64 two key groups, all summed in a
//    fixed order), K2q multiplying by the page's V scale once at the end;
//  - writes (acc, m, l) to its row of the fp32 scratch.
// The block that takes a slot-head's last integer ticket (each live block
// takes one after writing its partial) then combines the live splits'
// partials: M = max m, L = sum l e^(m - M), out = sum acc e^(m - M) / L in
// q's dtype, 0 where the slot is empty, in two passes over the partials
// (they sit in L2), each pass's loads issued at once, and resets the
// ticket to 0 for the next launch (the wrapper keeps one ticket array a
// stream, so launches that share one never overlap). One launch: a second,
// combining kernel was measured slower on an H100 (PERF.md). There are no
// floating-point atomics, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;               // four warps a split block
constexpr int WARPS = THREADS / 32;
constexpr int KEYS_IN_FLIGHT = 8;          // keys a warp scores at once
constexpr int SPLIT_KV_BYTES = 64 * 1024;  // K and V of one split, at most
constexpr int MAX_DEVICES = 64;

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// an mbarrier of one arrival with the bytes of the bulk copies that
// complete on it: thread 0 arrives and states the bytes, the copies land,
// and the phase flips for the threads waiting on its parity
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar));
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}
// bytes (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// the bytes of a split block's shared memory, and where each part starts:
// K, V (each sk x D elements, 128-byte aligned), the scores [sk], q [D],
// the value sums of the second key group [D], the reductions [2 * WARPS],
// the mbarrier
struct SplitSmem {
  int k, v, s, q, acc, red, bar, total;
  __host__ __device__ SplitSmem(int sk, int D, int elem) {
    const int kv = ((sk * D * elem) + 127) & ~127;
    k = 0;
    v = kv;
    s = 2 * kv;
    q = s + 4 * sk;
    acc = q + 4 * D;
    red = acc + 4 * D;
    bar = (red + 4 * 2 * WARPS + 7) & ~7;
    total = bar + 8;
  }
};

// live splits of a slot of `length` keys: splits run in position order,
// spp of them a page, each sk keys (the last of a page possibly fewer)
__device__ __forceinline__ int live_splits(int length, int ps, int sk, int spp) {
  return (length / ps) * spp + (length % ps + sk - 1) / sk;
}

// max / sum over the block in a fixed order; every thread gets it (red:
// 2 * WARPS floats, max in the first half, sum in the second)
__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x / 32] = x;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) r = fmaxf(r, red[w]);
  return r;
}
__device__ __forceinline__ float block_sum(float x, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  if ((threadIdx.x & 31) == 0) red[WARPS + threadIdx.x / 32] = x;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) r += red[WARPS + w];
  return r;
}

// The combine of one slot-head's n_live partials (rows of D + 2 floats:
// acc, m, l) into out[0 .. d) by the THREADS threads of a block: a split a
// thread, its m and l loaded together, M = max m and L = sum l e^(m - M)
// by two block reductions; then each thread's head dims summed over the
// splits with the weights e^(m - M) from shared memory, THREADS splits at
// a time, every load of a pass issued at once. Reads go to L2 (__ldcg):
// other blocks wrote them. The assignment and the orders are fixed: the
// same bits every run.
template <typename T, int D>
__device__ __forceinline__ void combine(const float* part, int n_live, T* out,
                                       int d) {
  constexpr int EPT = D >= THREADS ? D / THREADS : 1;
  __shared__ float w[THREADS];
  __shared__ float red[2 * WARPS];
  const int tid = threadIdx.x;
  float m_own = -INFINITY, l_own = 0.f;      // this thread's first split
  if (tid < n_live) {
    m_own = __ldcg(part + (size_t)tid * (D + 2) + D);
    l_own = __ldcg(part + (size_t)tid * (D + 2) + D + 1);
  }
  float mx = m_own;
  for (int s = tid + THREADS; s < n_live; s += THREADS)
    mx = fmaxf(mx, __ldcg(part + (size_t)s * (D + 2) + D));
  const float M = block_max(mx, red);        // -inf for an empty slot
  float ls = tid < n_live ? l_own * expf(m_own - M) : 0.f;
  for (int s = tid + THREADS; s < n_live; s += THREADS) {
    const float* row = part + (size_t)s * (D + 2);
    ls = fmaf(__ldcg(row + D + 1), expf(__ldcg(row + D) - M), ls);
  }
  const float L = block_sum(ls, red);
  const float inv = L > 0.f ? 1.f / L : 0.f;
  float o[EPT];
#pragma unroll
  for (int i = 0; i < EPT; ++i) o[i] = 0.f;
  for (int c = 0; c < n_live; c += THREADS) {
    __syncthreads();                         // the last chunk's weights are read
    if (c + tid < n_live)
      w[tid] = expf((c == 0 ? m_own : __ldcg(part + (size_t)(c + tid) * (D + 2) + D)) - M);
    __syncthreads();
    const int n = min(THREADS, n_live - c);
#pragma unroll 8
    for (int s = 0; s < n; ++s) {
      const float* row = part + (size_t)(c + s) * (D + 2);
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int e = tid + THREADS * i;
        if (e < d) o[i] = fmaf(__ldcg(row + e), w[s], o[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i) {
    const int e = tid + THREADS * i;
    if (e < d) out[e] = from_f<T>(o[i] * inv);
  }
}

// T: q and out; KV: the pages (T, or int8 codes when QUANT); tickets: int32
// [B * H], zero before the launch and after it.
template <typename T, typename KV, int D, bool QUANT>
__global__ void __launch_bounds__(THREADS)
decode_attention_split(const T* __restrict__ q, const KV* __restrict__ k_pages,
                       const KV* __restrict__ v_pages,
                       const __nv_bfloat16* __restrict__ k_scale,
                       const __nv_bfloat16* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, float* __restrict__ part,
                       int* __restrict__ tickets, T* __restrict__ out, int H,
                       int P, int ps, int max_pages, int d, int sk, int spp,
                       float scale, int bulk) {
  // key groups of the value sum: two at D = 64 (128 threads over 64 dims)
  constexpr int KG = D >= THREADS ? 1 : THREADS / D;
  constexpr int EPT = D >= THREADS ? D / THREADS : 1;   // dims a thread sums
  static_assert(KG <= 2, "one extra key group's sums in shared memory");
  extern __shared__ __align__(128) unsigned char smem[];
  const SplitSmem lay(sk, D, (int)sizeof(KV));
  KV* sK = reinterpret_cast<KV*>(smem + lay.k);
  KV* sV = reinterpret_cast<KV*>(smem + lay.v);
  float* sS = reinterpret_cast<float*>(smem + lay.s);
  float* sQ = reinterpret_cast<float*>(smem + lay.q);
  float* sAcc = reinterpret_cast<float*>(smem + lay.acc);
  float* red = reinterpret_cast<float*>(smem + lay.red);
  const uint32_t bar = smem_u32(smem + lay.bar);

  const int split = blockIdx.x, bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_splits = gridDim.x;
  const int j = split / spp;                 // the page of the slot
  const int r0 = (split % spp) * sk;         // first key within the page
  // the slot's length and this split's table entry, both loads in flight
  // at once (j < max_pages: the entry is in the table)
  const int length_in = lengths[b];
  const int entry = page_table[(size_t)b * max_pages + j];
  // a length past the table's reach is cut to it (no read past the table)
  const int length = min(length_in, max_pages * ps);
  const int n_live = live_splits(length, ps, sk, spp);
  if (split >= n_live) {
    // dead split; split 0 of an empty slot writes its zeros (the combine
    // of no partials)
    if (n_live == 0 && split == 0)
      for (int e = tid; e < d; e += THREADS) out[(size_t)bh * d + e] = from_f<T>(0.f);
    return;
  }
  const int n = min(min(sk, ps - r0), length - (j * ps + r0));   // live keys
  // out-of-range table entries clamp, as the JAX gather does
  const int page = min(max(entry, 0), P - 1);
  const size_t row0 = ((size_t)h * P + page) * ps + r0;

  if (bulk) {
    if (tid == 0) {
      mbar_init(bar);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      // the rows are contiguous; a multiple of 16 bytes past the live rows
      // stays inside the page (the wrapper checks ps * d * elem % 16 == 0)
      const uint32_t bytes = round16(n * d * (int)sizeof(KV));
      mbar_expect(bar, 2 * bytes);
      bulk_load(smem_u32(sK), k_pages + row0 * d, bytes, bar);
      bulk_load(smem_u32(sV), v_pages + row0 * d, bytes, bar);
    }
  } else {
    for (int e = tid; e < n * d; e += THREADS) {
      sK[e] = k_pages[row0 * d + e];
      sV[e] = v_pages[row0 * d + e];
    }
  }
  for (int e = tid; e < d; e += THREADS) sQ[e] = to_f(q[(size_t)bh * d + e]) * scale;
  float ks = 1.f, vs = 1.f;
  if constexpr (QUANT) {
    // dequantize at read: one bf16 scale per head for THIS page
    ks = to_f(k_scale[(size_t)h * P + page]);
    vs = to_f(v_scale[(size_t)h * P + page]);
  }
  __syncthreads();
  if (bulk) mbar_wait(bar, 0);

  // scores. Rows of whole 16-byte chunks: a thread a key, its chunks read
  // from a rotated start (the rows of neighbouring keys then hit other
  // banks) against q in fp32; other head dims: a warp a key, lanes over
  // the head dims, KEYS_IN_FLIGHT keys at once, a shuffle tree each
  constexpr int VE = 16 / (int)sizeof(KV);   // elements of a 16-byte chunk
  if (d % VE == 0) {
    const int C = d / VE;
    for (int t = tid; t < n; t += THREADS) {
      const uint4* kr = reinterpret_cast<const uint4*>(sK + (size_t)t * d);
      int c = t % C;
      // a sum a chunk, the chunks into four running sums in turn, those
      // added pairwise: the error of a short tree, not of d terms in a row
      float dot4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < C; i += 4) {
#pragma unroll
        for (int k4 = 0; k4 < 4; ++k4) {
          if (i + k4 < C) {
            const uint4 raw = kr[c];
            const KV* e = reinterpret_cast<const KV*>(&raw);
            const float* qc = sQ + c * VE;
            float cs = 0.f;
#pragma unroll
            for (int u = 0; u < VE; ++u) cs = fmaf(qc[u], to_f(e[u]), cs);
            dot4[k4] += cs;
            c = c + 1 == C ? 0 : c + 1;
          }
        }
      }
      sS[t] = ((dot4[0] + dot4[1]) + (dot4[2] + dot4[3])) * ks;
    }
  } else {
    for (int t0 = warp * KEYS_IN_FLIGHT; t0 < n; t0 += WARPS * KEYS_IN_FLIGHT) {
      float dot[KEYS_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < KEYS_IN_FLIGHT; ++u) {
        dot[u] = 0.f;
        const int t = min(t0 + u, n - 1);      // in bounds; stored only if live
        const KV* kr = sK + (size_t)t * d;
#pragma unroll
        for (int i = 0; i < D / 32; ++i) {
          const int e = lane + 32 * i;
          if (e < d) dot[u] = fmaf(sQ[e], to_f(kr[e]), dot[u]);
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int u = 0; u < KEYS_IN_FLIGHT; ++u)
          dot[u] += __shfl_xor_sync(0xffffffffu, dot[u], off);
      if (lane == 0)
#pragma unroll
        for (int u = 0; u < KEYS_IN_FLIGHT; ++u)
          if (t0 + u < n) sS[t0 + u] = dot[u] * ks;
    }
  }
  __syncthreads();

  float mx = -INFINITY;
  for (int t = tid; t < n; t += THREADS) mx = fmaxf(mx, sS[t]);
  const float m = block_max(mx, red);        // finite: n >= 1
  float psum = 0.f;
  for (int t = tid; t < n; t += THREADS) {
    const float p = expf(sS[t] - m);
    sS[t] = p;
    psum += p;
  }
  const float l = block_sum(psum, red);      // its barrier publishes p

  // acc = sum_t p_t v_t: thread (g, e) sums the keys t = g, g + KG, ...
  // into four accumulators (keys in turn), added in a fixed order
  const int g = tid / (THREADS / KG), e0 = tid % (THREADS / KG);
  float acc[EPT], part4[4][EPT];
#pragma unroll
  for (int u = 0; u < 4; ++u)
#pragma unroll
    for (int i = 0; i < EPT; ++i) part4[u][i] = 0.f;
  int t = g;
  for (; t + 3 * KG < n; t += 4 * KG) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float p = sS[t + u * KG];
      const KV* vr = sV + (size_t)(t + u * KG) * d;
#pragma unroll
      for (int i = 0; i < EPT; ++i) {
        const int e = e0 + (THREADS / KG) * i;
        if (e < d) part4[u][i] = fmaf(p, to_f(vr[e]), part4[u][i]);
      }
    }
  }
  for (; t < n; t += KG) {
    const float p = sS[t];
    const KV* vr = sV + (size_t)t * d;
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = e0 + (THREADS / KG) * i;
      if (e < d) part4[0][i] = fmaf(p, to_f(vr[e]), part4[0][i]);
    }
  }
#pragma unroll
  for (int i = 0; i < EPT; ++i)
    acc[i] = (part4[0][i] + part4[1][i]) + (part4[2][i] + part4[3][i]);
  float* prow = part + ((size_t)bh * n_splits + split) * (D + 2);
  if constexpr (KG > 1) {
    // the key groups' sums, in group order
    if (g > 0) sAcc[e0] = acc[0];
    __syncthreads();
    if (g == 0 && e0 < d) prow[e0] = (acc[0] + sAcc[e0]) * vs;
  } else {
#pragma unroll
    for (int i = 0; i < EPT; ++i) {
      const int e = e0 + THREADS * i;
      if (e < d) prow[e] = acc[i] * vs;
    }
  }
  if (tid == 0) {
    prow[D] = m;
    prow[D + 1] = l;
  }

  // the block that takes the slot-head's last ticket combines its partials
  __shared__ int last;
  __threadfence();                           // the partial, device-wide
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + bh, 1) == n_live - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  combine<T, D>(part + (size_t)bh * n_splits * (D + 2), n_live, out + (size_t)bh * d, d);
  if (tid == 0) tickets[bh] = 0;             // ready for the next launch
}

// the bucket D a head dim runs at (0: none)
int bucket(int d) {
  return d <= 64 ? 64 : d <= 128 ? 128 : d <= 256 ? 256 : d <= 512 ? 512 : 0;
}

template <typename T, typename KV, int D, bool QUANT>
cudaError_t launch_d(int B, int H, cudaStream_t st, const void* q, const void* kp,
                     const void* vp, const void* ks, const void* vs,
                     const void* pt, const void* len, void* out, void* part,
                     void* tickets, int P, int ps, int max_pages, int d,
                     int sk, float scale, int bulk) {
  const int spp = (ps + sk - 1) / sk;
  const int n_splits = max_pages * spp;
  const SplitSmem lay(sk, D, (int)sizeof(KV));
  auto kernel = decode_attention_split<T, KV, D, QUANT>;
  // the shared-memory limit this instantiation was granted, by device: a
  // host call the decode step would otherwise make every launch
  static int granted[MAX_DEVICES] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= MAX_DEVICES || granted[device] < lay.total) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               lay.total);
    if (err != cudaSuccess) return err;
    if (device < MAX_DEVICES) granted[device] = lay.total;
  }
  kernel<<<dim3(n_splits, B * H), THREADS, lay.total, st>>>(
      (const T*)q, (const KV*)kp, (const KV*)vp, (const __nv_bfloat16*)ks,
      (const __nv_bfloat16*)vs, (const int*)pt, (const int*)len, (float*)part,
      (int*)tickets, (T*)out, H, P, ps, max_pages, d, sk, spp, scale, bulk);
  return cudaGetLastError();
}

template <typename T, typename KV, bool QUANT>
cudaError_t launch(int B, int H, cudaStream_t st, const void* q, const void* kp,
                   const void* vp, const void* ks, const void* vs, const void* pt,
                   const void* len, void* out, void* part, void* tickets, int P,
                   int ps, int max_pages, int d, int sk, float scale, int bulk) {
#define K2_ARGS B, H, st, q, kp, vp, ks, vs, pt, len, out, part, tickets, P, ps, max_pages, d, sk, scale, bulk
  switch (bucket(d)) {
    case 64: return launch_d<T, KV, 64, QUANT>(K2_ARGS);
    case 128: return launch_d<T, KV, 128, QUANT>(K2_ARGS);
    case 256: return launch_d<T, KV, 256, QUANT>(K2_ARGS);
    default: return launch_d<T, KV, 512, QUANT>(K2_ARGS);
  }
#undef K2_ARGS
}

// sk: keys a split stages, all of a page (sk == ps) or a multiple of 16,
// with K and V of sk keys at the bucket's width within SPLIT_KV_BYTES
bool bad_args(int B, int H, int P, int ps, int max_pages, int d, int sk,
              int elem, int dtype) {
  const int D = bucket(d);
  return D == 0 || d < 1 || dtype < 0 || dtype > 2 || B < 1 || H < 1 || B * H > 65535 ||
         P < 1 || ps < 1 || max_pages < 1 || sk < 1 || sk > ps ||
         (sk != ps && sk % 16 != 0) || 2LL * sk * D * elem > SPLIT_KV_BYTES;
}

}  // namespace

// K2: pages in q's dtype. part: [B * H, max_pages * ceil(ps / sk), D + 2]
// fp32 scratch; tickets: int32 [B * H] zeros, left zero, that no other
// launch uses at the same time; bulk: the pages may be copied in 16-byte
// multiples (ps * d * elem % 16 == 0, 16-byte aligned bases).
extern "C" int decode_attention_fwd(const void* q, const void* k_pages,
                                    const void* v_pages, const void* page_table,
                                    const void* lengths, void* out, void* part,
                                    void* tickets, int B, int H, int P, int ps,
                                    int max_pages, int d, int sk, float scale,
                                    int bulk, int dtype, int device,
                                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const int elem = dtype == 2 ? 4 : 2;
  if (tickets == nullptr || bad_args(B, H, P, ps, max_pages, d, sk, elem, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define K2_FWD_ARGS B, H, st, q, k_pages, v_pages, nullptr, nullptr, page_table, lengths, out, part, tickets, P, ps, max_pages, d, sk, scale, bulk
  if (dtype == 0)
    err = launch<__nv_bfloat16, __nv_bfloat16, false>(K2_FWD_ARGS);
  else if (dtype == 1)
    err = launch<__half, __half, false>(K2_FWD_ARGS);
  else
    err = launch<float, float, false>(K2_FWD_ARGS);
#undef K2_FWD_ARGS
  return (int)err;
}

// K2q: int8 pages with [H, P] bf16 scales; q and out in `dtype`; the other
// arguments as K2's
extern "C" int decode_attention_quant_fwd(
    const void* q, const void* k_pages, const void* v_pages, const void* k_scale,
    const void* v_scale, const void* page_table, const void* lengths, void* out,
    void* part, void* tickets, int B, int H, int P, int ps, int max_pages, int d,
    int sk, float scale, int bulk, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (tickets == nullptr || bad_args(B, H, P, ps, max_pages, d, sk, 1, dtype))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define K2Q_ARGS B, H, st, q, k_pages, v_pages, k_scale, v_scale, page_table, lengths, out, part, tickets, P, ps, max_pages, d, sk, scale, bulk
  if (dtype == 0)
    err = launch<__nv_bfloat16, int8_t, true>(K2Q_ARGS);
  else if (dtype == 1)
    err = launch<__half, int8_t, true>(K2Q_ARGS);
  else
    err = launch<float, int8_t, true>(K2Q_ARGS);
#undef K2Q_ARGS
  return (int)err;
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

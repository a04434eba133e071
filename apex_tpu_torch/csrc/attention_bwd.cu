// Attention backward with the split structure: the dq pass (K5) and the
// dk/dv pass (K6).
//
// Replaces apex_tpu/ops/attention_pallas.py:850 _bwd_split: its q-major dq
// pass (pallas_call :869; kernels _bwd_dq_kernel :435 and
// _bwd_dq_kernel_chunked :475) and its k-major dk/dv pass (pallas_call
// :899; kernel _bwd_dkv_kernel :532). Semantics are theirs: fp32 scores
// scale * Q K^T from input-dtype operands; a key is masked where it lies
// above the causal diagonal (key index > query index) or where its segment
// id differs from the query's; the softmax statistics are the row max m (of
// the live scores; -FLT_MAX, the JAX finfo.min, for a fully masked row) and
// the row sum l of exp(s - m); P = exp(min(s - m, 0)) / l with masked
// entries and l == 0 giving 0 (_p_from_stats :156; the clamp matters
// because K6 rebuilds S in another summation order than K5); dS = P (dP -
// D) scale with dP = dO V^T; dS and P are rounded to the input dtype
// before the dq, dk and dv products, which accumulate in fp32; dq, dk and
// dv are written in the input dtype. One difference: D = rowsum(dO * O)
// from the saved forward output, where the TPU kernel forms rowsum(P * dP)
// from its whole score row. The two agree in exact arithmetic, and this
// saves a third sweep.
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
// O = (P M) V, so it equals the TPU kernel's rowsum(P M * dP).
//
// Layout: q, o, dO, dq [B, H, Sq, D]; k, v, dk, dv [B, H, Sk, D]; all
// contiguous and 16-byte aligned, one dtype (bf16, fp16 or fp32); segment
// ids [B, Sq] and [B, Sk] int32 or null; m, l, D [B, H, Sq] fp32, written
// by K5 and read by K6; the dropout seed one int32, or null for no
// dropout. D (head dim) is 64, 128 or 256; the wrapper zero-pads a head
// dim between two of them up to the next (exact: the padded columns of
// dq, dk and dv are zero and sliced away, and the scale comes from the
// true head dim).
//
// What bounds it on H100: at the training shape (B 8, H 12, S 1024, D 64,
// bf16, causal) the two passes move ~102 MB (q, k, v, o, dO read; dq, dk,
// dv written; the row statistics), 30 us at 3.35 TB/s. The causal mask
// leaves 50.4 M live (query, key) pairs; K5 needs three products over them
// (S, dP, dq) and K6 four (S, dP, dk, dv), 2 x 64 flops each per pair:
// 19 and 26 GFLOP, 20 and 26 us at 989 TFLOP/s on the tensor cores. With
// dropout each pass also hashes every live pair (~11 integer operations):
// 33 us over the 132 x 64 INT32 lanes, which then sets the bound.
//
// bf16 and fp16 run on the tensor cores, by Hopper's wgmma (sm_90a): every
// product is wgmma.mma_async m64nNk16 with fp32 accumulators, issued by one
// warpgroup (a block of four warps, each holding 16 of the block's 64 rows).
//  - K5 (q-major) owns a 64-row Q/dO tile and walks the 64-key tiles at or
//    below the causal diagonal twice: sweep 1 forms S = Q K^T for the
//    online (m, l); sweep 2 forms S and dP = dO V^T, then dS, and adds
//    dq += dS K. It writes m, l and D for K6.
//  - K6 (k-major) owns a 64-row K/V tile and walks the q tiles from the
//    diagonal to the end (tiles wholly above it are skipped, the rule of
//    _bwd_dkv_kernel :585-588): S^T = K Q^T, dP^T = V dO^T, then dv +=
//    (P^T mscale) dO and dk += dS^T Q. Its q tiles are 64 rows at D = 64
//    and 32 at D = 128, so the four accumulators stay in registers. The
//    next q tile's row statistics are read into registers a tile ahead.
//  - At D = 256 a 64 x 256 fp32 accumulator takes 128 registers a thread
//    of a warpgroup, so one warpgroup holds one, and a block takes ~190
//    KB of shared memory: one block an SM, of two warpgroups. K5 gives
//    each warpgroup 64 q rows over shared 32-key tiles (S and dP 16
//    registers each beside dq) and adds dS K as two m64n128 halves; K6
//    (attention_bwd_dkv_tc2) walks 64-row q tiles, warpgroup 0 forming
//    S^T, P and dv, warpgroup 1 S^T, dP^T, dS and dk (244-252 registers,
//    no spills; 12% faster than 32-row tiles, PERF.md section 6).
// The score products read both operands from shared memory, K-major. P and
// dS go from the accumulators straight into the A registers of the next
// product: wgmma's accumulator layout is, element for element, its register
// A fragment, so the rounding to the input dtype is the packing. The
// products that contract over rows (dq, dk, dv) read Q, K and dO MN-major
// through wgmma's transpose bit. Q, K, V and dO tiles come in by cp.async
// into a two-stage ring (the next tile loads while this one computes;
// zero-filled past the ragged edge), laid out in wgmma's 128-byte swizzle
// (a D = 64 row is exactly 128 bytes). Only the diagonal, ragged or
// segmented tiles have masked pairs, and only they evaluate the mask;
// exp(y) is ex2 of one FMA. Every block owns its output rows outright: no
// atomics, and two runs give the same bits. The grid puts the blocks with
// the most tiles first (the last q tiles for K5, the first k tiles for K6),
// so the causal tail does not idle the card; at D = 64 three blocks share
// an SM, so one block's products overlap another's exponentials and hash.
// Not yet done (later work): a producer warp with TMA, and products issued
// ahead of the element-wise work of the tile before.
//
// fp32 stays on the CUDA cores (the *_simt kernels below, 64-row blocks,
// four threads a row, fp32 FMAs, tiles in dynamic shared memory), at every
// head dim; they are instantiated for fp32 only. On the tensor cores fp32
// would run as TF32, which keeps 10 mantissa bits and cannot hold fp32's
// 5e-6 relative L2 against the plain version; no training window runs
// attention in fp32. At D = 256 a block keeps its own 64 rows (Q and dO
// for K5, K and V for K6) in shared memory rather than registers.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

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

// x rounded to T and back (the identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}


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


// ---------------------------------------------------------------------------
// fp32: the CUDA cores

constexpr int TPR = 4;                // threads per row
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / TPR;   // 64: q rows of a K5 block, k rows of a K6 block
constexpr int TILE = 32;              // keys (K5) or queries (K6) per tile
constexpr int OWN = TILE / TPR;       // finished dots per thread per tile
constexpr unsigned FULL = 0xffffffffu;

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

// the same, with this thread's row in shared memory (its columns c = sub +
// TPR * i of `own`)
template <int D>
__device__ __forceinline__ void partial_dots(const float* own,
                                             const float (*tile)[D + 1],
                                             int sub, float (&a)[TILE]) {
#pragma unroll
  for (int j = 0; j < TILE; ++j) {
    float s = 0.f;
#pragma unroll 16
    for (int i = 0; i < D / TPR; ++i)
      s = fmaf(own[sub + TPR * i], tile[j][sub + TPR * i], s);
    a[j] = s;
  }
}

// a block keeps its own rows in shared memory where a thread's registers
// cannot hold them
template <int D> __host__ __device__ constexpr bool own_smem() { return D > 128; }

// dynamic shared memory of K5 and K6 on the CUDA cores, in bytes: two
// [TILE][D + 1] tiles, a [ROWS][TILE + 1] score tile, K6's five per-row
// vectors (K5 uses one), and the own rows
template <int D> constexpr int simt_smem() {
  return 4 * (2 * TILE * (D + 1) + ROWS * (TILE + 1) + 5 * TILE +
              (own_smem<D>() ? 2 * ROWS * (D + 1) : 0));
}

// K5 on the CUDA cores (fp32, so dS and P need no rounding): dq plus the
// row statistics (m, l, D)
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dq_simt(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ o,
                        const T* __restrict__ dout, const int* __restrict__ seg_q,
                        const int* __restrict__ seg_kv,
                        const int* __restrict__ seed, T* __restrict__ dq,
                        float* __restrict__ m_out, float* __restrict__ l_out,
                        float* __restrict__ d_out, int H, int Sq, int Sk,
                        float scale, int causal, unsigned thresh,
                        float mscale) {
  constexpr int DC = D / TPR;
  constexpr bool OS = own_smem<D>();
  extern __shared__ float simt_smem_f[];
  // +1: row stride off the bank period
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(simt_smem_f);
  float (*vs)[D + 1] = ks + TILE;
  float (*ps)[TILE + 1] = reinterpret_cast<float (*)[TILE + 1]>(vs + TILE);
  int* segk = reinterpret_cast<int*>(ps + ROWS);
  // the own Q and dO rows (OS), after K6's five per-row vectors
  float (*qsm)[D + 1] = reinterpret_cast<float (*)[D + 1]>(segk + 5 * TILE);
  float (*dosm)[D + 1] = qsm + ROWS;

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

  float qr[OS ? 1 : DC], dor[OS ? 1 : DC], acc[DC];
  float dsum = 0.f;
#pragma unroll
  for (int i = 0; i < DC; ++i) {
    const int c = sub + TPR * i;
    const float qv = row_ok ? to_f(q[qrow + c]) : 0.f;
    const float dv = row_ok ? to_f(dout[qrow + c]) : 0.f;
    if constexpr (OS) {   // each thread reads back only its own columns
      qsm[r][c] = qv;
      dosm[r][c] = dv;
    } else {
      qr[i] = qv;
      dor[i] = dv;
    }
    dsum = fmaf(dv, row_ok ? to_f(o[qrow + c]) : 0.f, dsum);
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
    if constexpr (OS) partial_dots<D>(&qsm[r][0], ks, sub, a);
    else partial_dots<D>(qr, ks, sub, a);
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
    if constexpr (OS) partial_dots<D>(&qsm[r][0], ks, sub, a);
    else partial_dots<D>(qr, ks, sub, a);
    butterfly(a, s, sub);
    if constexpr (OS) partial_dots<D>(&dosm[r][0], vs, sub, a);
    else partial_dots<D>(dor, vs, sub, a);
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
      ps[r][j] = round_to<T>(p * (dpm - drow) * scale);   // dS in T
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

// K6 on the CUDA cores (fp32): dk and dv of one 64-row k tile
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
attention_bwd_dkv_simt(const T* __restrict__ q, const T* __restrict__ k,
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
  constexpr bool OS = own_smem<D>();
  extern __shared__ float simt_smem_f[];
  float (*qs)[D + 1] = reinterpret_cast<float (*)[D + 1]>(simt_smem_f);
  float (*dos)[D + 1] = qs + TILE;
  // P, then dS, of this block's keys
  float (*pt)[TILE + 1] = reinterpret_cast<float (*)[TILE + 1]>(dos + TILE);
  float* ms = reinterpret_cast<float*>(pt + ROWS);
  float* ls = ms + TILE;
  float* dsm = ls + TILE;
  int* segq = reinterpret_cast<int*>(dsm + TILE);
  unsigned* rks = reinterpret_cast<unsigned*>(segq + TILE);   // dropout row keys
  // the own K and V rows (OS)
  float (*ksm)[D + 1] = reinterpret_cast<float (*)[D + 1]>(rks + TILE);
  float (*vsm)[D + 1] = ksm + ROWS;

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

  float kr[OS ? 1 : DC], vr[OS ? 1 : DC], dk_acc[DC], dv_acc[DC];
#pragma unroll
  for (int i = 0; i < DC; ++i) {
    const int c = sub + TPR * i;
    const float kv = key_ok ? to_f(k[krow + c]) : 0.f;
    const float vv = key_ok ? to_f(v[krow + c]) : 0.f;
    if constexpr (OS) {   // each thread reads back only its own columns
      ksm[r][c] = kv;
      vsm[r][c] = vv;
    } else {
      kr[i] = kv;
      vr[i] = vv;
    }
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
    if constexpr (OS) partial_dots<D>(&ksm[r][0], qs, sub, a);
    else partial_dots<D>(kr, qs, sub, a);
    butterfly(a, s, sub);
    if constexpr (OS) partial_dots<D>(&vsm[r][0], dos, sub, a);
    else partial_dots<D>(vr, dos, sub, a);
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
      ds[i] = round_to<T>(p * (dpm - dsm[ii]) * scale);   // dS and P in T
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

// ---------------------------------------------------------------------------
// bf16 and fp16: the tensor cores (wgmma, fp32 accumulators)

constexpr int TC_THREADS = 128;   // four warps; warp w owns rows 16w..16w+15
constexpr int TC_ROWS = 64;       // q rows of a K5 block, k rows of a K6 block
static_assert(TC_ROWS == ROWS, "both bodies tile 64 rows: one grid size");
// keys per K5 tile: 32 at D = 256 keeps S and dP at 16 registers a thread
// beside dq's 128
template <int D> __host__ __device__ constexpr int k5_keys() {
  return D == 256 ? 32 : 64;
}
// queries per K6 tile: 32 at D = 128 keeps dk, dv, S^T and dP^T in registers
template <int D> __host__ __device__ constexpr int k6_queries() {
  return D == 64 ? 64 : 32;
}
// K6 at D = 256: two warpgroups, dv in one and dk in the other (each 128
// registers a thread), over 64-row q tiles
constexpr int K6W_THREADS = 2 * TC_THREADS;
constexpr int K6W_QUERIES = 64;

// wgmma.mma_async m64nNk16 with fp32 accumulators: d (64 x N) += a b. The
// four warps of the warpgroup each hold 16 rows of d in the m16n8 C layout:
// thread (g = lane / 4, t = lane % 4) of warp w has rows 16w + g and
// 16w + g + 8, columns 8j + 2t and 8j + 2t + 1, as d[j][0..1] and
// d[j][2..3]. SS: a and b from shared memory, both K-major. RS: a from
// registers (the A fragment of the warp's 16 rows, the layout of mma.sync
// m16n8k16), b from shared memory MN-major (the transpose bit). acc = 0
// writes d = a b, ignoring d's old contents; acc = 1 adds.
#define WGMMA_SS_N32(TY)                                                      \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15 " \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                      \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),           \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),           \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),           \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])            \
      : "l"(da), "l"(db), "r"(acc))

#define WGMMA_SS_N64(TY)                                                                \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 " \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),                     \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),                     \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),                     \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),                     \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),                     \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),                     \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),                     \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])                      \
      : "l"(da), "l"(db), "r"(acc))

#define WGMMA_RS_N64(TY)                                                                \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 " \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                  \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),                     \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),                     \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),                     \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),                     \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),                     \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),                     \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),                     \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

#define WGMMA_RS_N128(TY)                                                                \
  asm volatile(                                                                          \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                       \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "           \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "  \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                   \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),                      \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),                      \
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),                      \
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),                      \
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),                      \
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),                      \
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),                      \
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),                      \
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),                      \
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),                      \
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),                  \
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),                  \
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),                  \
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),                  \
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),                  \
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

// the products and the packing of one 16-bit input type (bf16 or fp16)
template <typename T> struct Tc {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  template <int N>
  static __device__ __forceinline__ void ss(float (&d)[N / 8][4], uint64_t da,
                                            uint64_t db, int acc) {
    static_assert(N == 32 || N == 64, "wgmma SS width");
    if constexpr (N == 32 && BF16) WGMMA_SS_N32("bf16");
    else if constexpr (N == 32) WGMMA_SS_N32("f16");
    else if constexpr (BF16) WGMMA_SS_N64("bf16");
    else WGMMA_SS_N64("f16");
  }
  template <int N>
  static __device__ __forceinline__ void rs(float (&d)[N / 8][4],
                                            const uint32_t (&a)[4], uint64_t db,
                                            int acc) {
    static_assert(N == 64 || N == 128, "wgmma RS width");
    if constexpr (N == 64 && BF16) WGMMA_RS_N64("bf16");
    else if constexpr (N == 64) WGMMA_RS_N64("f16");
    else if constexpr (BF16) WGMMA_RS_N128("bf16");
    else WGMMA_RS_N128("f16");
  }
  // lo in the low half: the lower column index
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    uint32_t r;
    if constexpr (BF16) {
      __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
      r = *reinterpret_cast<uint32_t*>(&h);
    } else {
      __half2 h = __floats2half2_rn(lo, hi);
      r = *reinterpret_cast<uint32_t*>(&h);
    }
    return r;
  }
};

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// the generic proxy's shared-memory writes (cp.async, stores) made visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// pins the compiler's reads and writes of an accumulator to this point: the
// asm of an asynchronous product does not finish where it stands
template <int N>
__device__ __forceinline__ void fence_acc(float (&acc)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(acc[j][e]) :: "memory");
}

constexpr float LOG2E = 1.4426950408889634f;

// 2^x on the SFU (MUFU.EX2); exp(y) is ex2(y * log2 e), with the scale
// folded into one FMA
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zeros where !ok
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Shared tiles of R rows x D 16-bit columns are D/64 panels of R rows x 128
// bytes; in each row the 16-byte chunk c sits at c ^ (row & 7): wgmma's
// canonical 128-byte-swizzled layout (eight-row groups of 1024 bytes), with
// no bank conflicts. Byte offset of chunk c (columns 8c..8c+7) of row r:
template <int R>
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (uint32_t)((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// rows [r0, r0 + R) of a [S, D] slab into a swizzled tile, zeros past S,
// by the NT threads of the block
template <int R, int D, int NT = TC_THREADS, typename T>
__device__ __forceinline__ void tile_async(uint32_t dst, const T* slab, int r0,
                                           int S) {
  constexpr int C = D / 8;
  static_assert(R * C % NT == 0, "tile split");
#pragma unroll
  for (int i = 0; i < R * C / NT; ++i) {
    const int e = threadIdx.x + i * NT;
    const int r = e / C, c = e % C;
    const bool ok = r0 + r < S;
    cp_async16(dst + sw<R>(r, c), slab + (size_t)(ok ? r0 + r : 0) * D + 8 * c,
               ok);
  }
}

// a wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile:
// start address, leading byte offset (LBO), stride byte offset (SBO, 1024:
// from one eight-row group to the next), layout 1 (128-byte swizzle), each
// offset in 16-byte units. Tiles start on 1024-byte boundaries.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// issue out (64 x N) = A B^T over k = D: A an [64, D] tile, B an [N, D]
// tile, both K-major (k step kk is 32 bytes into panel kk / 4; LBO unused).
// The first k step overwrites out, so it needs no zeroing.
template <typename T, int N, int D>
__device__ __forceinline__ void wg_abt(float (&out)[N / 8][4], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Tc<T>::template ss<N>(
        out, desc128(a + (kk >> 2) * (TC_ROWS * 128) + (kk & 3) * 32, 16),
        desc128(b + (kk >> 2) * (N * 128) + (kk & 3) * 32, 16), kk > 0);
}

// issue acc (64 x D) += F B over k = K: F register fragments (the warp's 16
// rows x K), B a [K, D] tile read MN-major (k step kk is 16 rows, 2048
// bytes, on; LBO the panel stride, from columns 0-63 to 64-127). At D = 256
// two m64n128 halves: columns 0-127 from panels 0-1, 128-255 from 2-3.
template <typename T, int K, int D>
__device__ __forceinline__ void wg_fb(float (&acc)[D / 8][4],
                                      const uint32_t (&f)[K / 16][4],
                                      uint32_t b) {
  if constexpr (D == 256) {
    auto& lo = *reinterpret_cast<float (*)[16][4]>(&acc[0][0]);
    auto& hi = *reinterpret_cast<float (*)[16][4]>(&acc[16][0]);
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk) {
      Tc<T>::template rs<128>(lo, f[kk], desc128(b + kk * 2048, K * 128), 1);
      Tc<T>::template rs<128>(
          hi, f[kk], desc128(b + 2 * K * 128 + kk * 2048, K * 128), 1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < K / 16; ++kk)
      Tc<T>::template rs<D>(acc, f[kk], desc128(b + kk * 2048, K * 128), 1);
  }
}

// an accumulator (16 x N, fp32) rounded to T as the A fragments of the next
// product: the C layout of n8 blocks 2kk and 2kk+1 is the A layout of k step kk
template <typename T, int N>
__device__ __forceinline__ void to_frags(const float (&x)[N / 8][4],
                                         uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    f[kk][0] = Tc<T>::pack(x[2 * kk][0], x[2 * kk][1]);
    f[kk][1] = Tc<T>::pack(x[2 * kk][2], x[2 * kk][3]);
    f[kk][2] = Tc<T>::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    f[kk][3] = Tc<T>::pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// the warp's 16 x D accumulator rows to a [S, D] slab (rows past S dropped);
// thread (g, t) holds rows g and g + 8, columns 8j + 2t and 8j + 2t + 1
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* slab, const float (&acc)[D / 8][4],
                                           const int (&row)[2], int S, int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= S) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(slab + (size_t)row[i] * D +
                                                2 * (lane & 3));
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dst[4 * j] = Tc<T>::pack(acc[j][2 * i], acc[j][2 * i + 1]);
  }
}

// blocks an SM holds: three at D = 64 (at most 168 registers a thread), two
// at D = 128, whose accumulators would spill under that cap, one at D = 256
// (~190 KB of tiles)
template <int D> __host__ __device__ constexpr int tc_blocks() {
  return D == 64 ? 3 : D == 128 ? 2 : 1;
}

// warpgroups of a K5 block, each owning 64 q rows: two at D = 256, where
// one block fills an SM, so that one's exponentials overlap the other's
// products on the K and V tiles they share
template <int D> __host__ __device__ constexpr int k5_warpgroups() {
  return D == 256 ? 2 : 1;
}

template <int D> constexpr int k5_smem() {
  // Q and dO a warpgroup, K x 2, V x 2; key segment ids x 2; D per row; 1
  // KB of alignment
  return k5_warpgroups<D>() * (2 * TC_ROWS * D * 2 + TC_ROWS * 4) +
         4 * k5_keys<D>() * D * 2 + 2 * k5_keys<D>() * 4 + 1024;
}
template <int D> constexpr int k6_smem() {
  // K, V, Q x 2, dO x 2; per query m, 1/l, D, segment id, dropout key x 2
  return 2 * TC_ROWS * D * 2 + 4 * k6_queries<D>() * D * 2 +
         2 * 5 * k6_queries<D>() * 4 + 1024;
}

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// K5: dq plus the row statistics (m, l, D) of one 64-row q tile a
// warpgroup
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(TC_THREADS * k5_warpgroups<D>(),
                                  tc_blocks<D>())
attention_bwd_dq_tc(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ o,
                    const T* __restrict__ dout, const int* __restrict__ seg_q,
                    const int* __restrict__ seg_kv,
                    const int* __restrict__ seed, T* __restrict__ dq,
                    float* __restrict__ m_out, float* __restrict__ l_out,
                    float* __restrict__ d_out, int H, int Sq, int Sk,
                    float scale, int causal, unsigned thresh, float mscale) {
  constexpr int BK = k5_keys<D>(), WGS = k5_warpgroups<D>();
  constexpr int NT = TC_THREADS * WGS, ROWS_B = TC_ROWS * WGS;
  constexpr uint32_t TB = TC_ROWS * D * 2, KB = BK * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  // Q and dO: one 64-row tile a warpgroup
  const uint32_t sQ = smem_u32(smem), sDO = sQ + WGS * TB,
                 sK = sDO + WGS * TB, sV = sK + 2 * KB;
  int* segk = reinterpret_cast<int*>(smem + 2 * WGS * TB + 4 * KB);  // [2][BK]
  float* drow_s = reinterpret_cast<float*>(segk + 2 * BK);  // [ROWS_B]

  const int bh = blockIdx.x, b = bh / H;
  // the q tiles with the most keys under the causal mask go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS_B;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup, made warp-uniform for the compiler, and its rows
  const int wg = WGS == 1 ? 0 : __shfl_sync(FULL, tid / TC_THREADS, 0);
  const int r0 = ((tid % TC_THREADS) >> 5) * 16, q0w = q0 + wg * TC_ROWS;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const bool has_seg = seg_kv != nullptr;
  const int n_kt = ((causal ? min(Sk, q0 + ROWS_B) : Sk) + BK - 1) / BK;
  const int n_it = 2 * n_kt;   // sweep 1 (m, l), then sweep 2 (dq)
  const uint32_t sq = sQ + wg * TB, sdo = sDO + wg * TB;

#pragma unroll
  for (int w = 0; w < WGS; ++w) {
    tile_async<TC_ROWS, D, NT>(sQ + w * TB, q + qoff, q0 + w * TC_ROWS, Sq);
    tile_async<TC_ROWS, D, NT>(sDO + w * TB, dout + qoff, q0 + w * TC_ROWS,
                               Sq);
  }
  tile_async<BK, D, NT>(sK, k + koff, 0, Sk);
  if (tid < BK)
    segk[tid] = (has_seg && tid < Sk) ? seg_kv[(size_t)b * Sk + tid] : 0;
  cp_async_commit();
  {  // D = rowsum(dO * O), two threads a row, while the copies fly
    const int qi = q0 + (tid >> 1);
    float s = 0.f;
    if (qi < Sq) {
      const size_t at = qoff + (size_t)qi * D + (tid & 1) * (D / 2);
      const uint4* a4 = reinterpret_cast<const uint4*>(dout + at);
      const uint4* b4 = reinterpret_cast<const uint4*>(o + at);
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 x = a4[c], y = b4[c];
        const T* xe = reinterpret_cast<const T*>(&x);
        const T* ye = reinterpret_cast<const T*>(&y);
#pragma unroll
        for (int e = 0; e < 8; ++e) s = fmaf(to_f(xe[e]), to_f(ye[e]), s);
      }
    }
    s += __shfl_xor_sync(FULL, s, 1);
    if ((tid & 1) == 0) drow_s[tid >> 1] = s;
  }

  int qi[2];
  int seg_row[2] = {0, 0};
  unsigned rowkey[2] = {0u, 0u};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float drow[2] = {0.f, 0.f};
  // after sweep 1, m and l are written out and their registers hold m log2 e
  // and 1 / l (or 0): the D = 256 body has no registers to spare
  float (&mlog2)[2] = m;
  float (&linv)[2] = l;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = q0w + r0 + (lane >> 2) + 8 * i;
    if (has_seg && qi[i] < Sq) seg_row[i] = seg_q[(size_t)b * Sq + qi[i]];
    if constexpr (DROPOUT) rowkey[i] = fmix32(head_key(seed, bh) ^ (unsigned)qi[i]);
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_it; ++it) {
    const int st = it & 1;
    if (it + 1 < n_it) {   // the next tile into the other stage
      const bool nx2 = it + 1 >= n_kt;
      const int nk0 = (nx2 ? it + 1 - n_kt : it + 1) * BK;
      tile_async<BK, D, NT>(sK + (st ^ 1) * KB, k + koff, nk0, Sk);
      if (nx2) tile_async<BK, D, NT>(sV + (st ^ 1) * KB, v + koff, nk0, Sk);
      if (tid < BK)
        segk[(st ^ 1) * BK + tid] = (has_seg && nk0 + tid < Sk)
                                        ? seg_kv[(size_t)b * Sk + nk0 + tid] : 0;
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const bool sweep2 = it >= n_kt;
    const int k0 = (sweep2 ? it - n_kt : it) * BK;
    const int* sg = segk + st * BK;
    // a key tile wholly above a warpgroup's diagonal holds no live pair of
    // its rows (the lower warpgroup's last tiles): it skips it, and its
    // rows take the tiles the one-warpgroup body would, in the same order
    const bool live = WGS == 1 || !causal || k0 < q0w + TC_ROWS;
    if (live) {
      // S = Q K^T; in sweep 2 also dP = dO V^T
      float s[BK / 8][4], dp[BK / 8][4];
      wg_fence();
      wg_abt<T, BK, D>(s, sq, sK + st * KB);
      if (sweep2) wg_abt<T, BK, D>(dp, sdo, sV + st * KB);
      wg_commit();
      wg_wait();
      fence_acc(s);
      fence_acc(dp);
      // only the diagonal, ragged or segmented tiles have masked pairs
      const bool edge = has_seg || k0 + BK > Sk || q0w + TC_ROWS > Sq ||
                        (causal && k0 + BK - 1 > q0w);
      auto elementwise = [&](auto edge_tag) {
        constexpr bool EDGE = decltype(edge_tag)::value;
        auto masked = [&](int i, int j, int e) {
          if constexpr (!EDGE) {
            return false;
          } else {
            const int c = 8 * j + 2 * (lane & 3) + (e & 1), kj = k0 + c;
            return qi[i] >= Sq || kj >= Sk || (causal && kj > qi[i]) ||
                   (has_seg && sg[c] != seg_row[i]);
          }
        };
        if (!sweep2) {   // online row max and sum
  #pragma unroll
          for (int i = 0; i < 2; ++i) {
            float tmax = -INFINITY;
  #pragma unroll
            for (int j = 0; j < BK / 8; ++j)
  #pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int e = 2 * i + h;
                s[j][e] = masked(i, j, e) ? -INFINITY : s[j][e] * scale;
                tmax = fmaxf(tmax, s[j][e]);
              }
            const float m_new = fmaxf(m[i], row_max4(tmax));
            const float alpha =
                (m_new == -INFINITY) ? 1.f : ex2((m[i] - m_new) * LOG2E);
            const float mlog = m_new * LOG2E;
            float psum = 0.f;
  #pragma unroll
            for (int j = 0; j < BK / 8; ++j)
  #pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float x = s[j][2 * i + h];
                if (EDGE && x == -INFINITY) continue;
                psum += ex2(fmaf(x, LOG2E, -mlog));
              }
            l[i] = l[i] * alpha + row_sum4(psum);
            m[i] = m_new;
          }
        } else {   // P, dS
          const float c2 = scale * LOG2E;
  #pragma unroll
          for (int j = 0; j < BK / 8; ++j)
  #pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              const bool mk = masked(i, j, e);
              const float p =
                  mk ? 0.f : ex2(fminf(fmaf(s[j][e], c2, -mlog2[i]), 0.f)) * linv[i];
              float dpm = dp[j][e];
              if constexpr (DROPOUT) {   // the replayed mask; masked pairs draw nothing
                const unsigned kj = (unsigned)(k0 + 8 * j + 2 * (lane & 3) + (e & 1));
                dpm *= (!mk && fmix32(rowkey[i] ^ kj) >= thresh) ? mscale : 0.f;
              }
              dp[j][e] = p * (dpm - drow[i]) * scale;
            }
        }
      };
      if (edge) elementwise(std::true_type());
      else elementwise(std::false_type());

      if (sweep2) {   // dq += dS K
        uint32_t f[BK / 16][4];
        to_frags<T, BK>(dp, f);            // dS rounded to T
        wg_fence();
        wg_fb<T, BK, D>(acc, f, sK + st * KB);
        wg_commit();
        wg_wait();
        fence_acc(acc);
      }
    }

    if (it == n_kt - 1) {   // the end of sweep 1
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (l[i] == 0.f) m[i] = -FLT_MAX;    // fully masked row: finfo.min
        drow[i] = drow_s[wg * TC_ROWS + r0 + (lane >> 2) + 8 * i];
        if ((lane & 3) == 0 && qi[i] < Sq) {
          const size_t si = (size_t)bh * Sq + qi[i];
          m_out[si] = m[i];
          l_out[si] = l[i];
          d_out[si] = drow[i];
        }
        linv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
        mlog2[i] = m[i] * LOG2E;
      }
    }
    __syncthreads();   // this stage is free for the tile after next
  }

  store_rows<T, D>(dq + qoff, acc, qi, Sq, lane);
}

// K6: dk and dv of one 64-row k tile
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(TC_THREADS, tc_blocks<D>())
attention_bwd_dkv_tc(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv,
                     const float* __restrict__ m_in,
                     const float* __restrict__ l_in,
                     const float* __restrict__ d_in,
                     const int* __restrict__ seed, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Sq, int Sk, float scale,
                     int causal, unsigned thresh, float mscale) {
  constexpr int BQ = k6_queries<D>();
  constexpr uint32_t KB = TC_ROWS * D * 2, QB = BQ * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + KB, sQ = sV + KB,
                 sDO = sQ + 2 * QB;
  float* ms = reinterpret_cast<float*>(smem + 2 * KB + 4 * QB);  // [2][BQ]
  float* lis = ms + 2 * BQ;                                      // 1/l or 0
  float* dcs = lis + 2 * BQ;
  int* sgq = reinterpret_cast<int*>(dcs + 2 * BQ);
  unsigned* rks = reinterpret_cast<unsigned*>(sgq + 2 * BQ);

  const int bh = blockIdx.x, b = bh / H;
  // k tile 0 sees the most q tiles under the causal mask: it goes first
  const int k0 = blockIdx.y * TC_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const bool has_seg = seg_kv != nullptr;
  // causal: query rows below k0 see none of this block's keys
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  unsigned hkey = 0;
  if constexpr (DROPOUT) hkey = head_key(seed, bh);

  // a q tile's row statistics (threads < BQ, one query each) are read into
  // registers one tile ahead, so no iteration waits on a global load
  float m_nx = 0.f, l_nx = 0.f, d_nx = 0.f;
  int seg_nx = 0;
  auto fetch_stats = [&](int it) {
    const int qi = q_begin + it * BQ + tid;
    const bool ok = tid < BQ && it < n_qt && qi < Sq;
    const size_t si = (size_t)bh * Sq + (ok ? qi : 0);
    m_nx = ok ? m_in[si] : 0.f;
    l_nx = ok ? l_in[si] : 0.f;
    d_nx = ok ? d_in[si] : 0.f;
    seg_nx = (ok && has_seg) ? seg_q[(size_t)b * Sq + qi] : 0;
  };
  // q tile it and the statistics fetched for it into stage st; then fetch
  // tile it + 1's
  auto stage_q = [&](int it, int st) {
    const int q0 = q_begin + it * BQ;
    tile_async<BQ, D>(sQ + st * QB, q + qoff, q0, Sq);
    tile_async<BQ, D>(sDO + st * QB, dout + qoff, q0, Sq);
    if (tid < BQ) {
      ms[st * BQ + tid] = m_nx * LOG2E;   // m log2 e
      lis[st * BQ + tid] = l_nx > 0.f ? 1.f / l_nx : 0.f;
      dcs[st * BQ + tid] = d_nx;
      sgq[st * BQ + tid] = seg_nx;
      rks[st * BQ + tid] = DROPOUT ? fmix32(hkey ^ (unsigned)(q0 + tid)) : 0u;
    }
    fetch_stats(it + 1);
  };

  if (n_qt > 0) {   // else dk = dv = 0
    tile_async<TC_ROWS, D>(sK, k + koff, k0, Sk);
    tile_async<TC_ROWS, D>(sV, v + koff, k0, Sk);
    fetch_stats(0);
    stage_q(0, 0);
  }
  cp_async_commit();

  int kj[2];
  int seg_key[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kj[i] = k0 + r0 + (lane >> 2) + 8 * i;
    if (has_seg && kj[i] < Sk) seg_key[i] = seg_kv[(size_t)b * Sk + kj[i]];
  }
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_qt) stage_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int q0 = q_begin + it * BQ;
    const uint32_t sq = sQ + st * QB, sdo = sDO + st * QB;

    // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
    float s[BQ / 8][4], dp[BQ / 8][4];
    wg_fence();
    wg_abt<T, BQ, D>(s, sK, sq);
    wg_abt<T, BQ, D>(dp, sV, sdo);
    wg_commit();
    wg_wait();
    fence_acc(s);
    fence_acc(dp);
    // only the diagonal, ragged or segmented tiles have masked pairs
    const bool edge = has_seg || k0 + TC_ROWS > Sk || q0 + BQ > Sq ||
                      (causal && k0 + TC_ROWS - 1 > q0);
    auto elementwise = [&](auto edge_tag) {
      constexpr bool EDGE = decltype(edge_tag)::value;
      const float c2 = scale * LOG2E;
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, c = 8 * j + 2 * (lane & 3) + (e & 1);
          const int x = st * BQ + c, qi = q0 + c;
          bool mk = false;
          if constexpr (EDGE)
            mk = kj[i] >= Sk || qi >= Sq || (causal && kj[i] > qi) ||
                 (has_seg && sgq[x] != seg_key[i]);
          const float p =
              mk ? 0.f : ex2(fminf(fmaf(s[j][e], c2, -ms[x]), 0.f)) * lis[x];
          float dpm = dp[j][e], pd = p;
          if constexpr (DROPOUT) {   // the replayed mask; masked pairs draw nothing
            const float msc =
                (!mk && fmix32(rks[x] ^ (unsigned)kj[i]) >= thresh) ? mscale : 0.f;
            dpm *= msc;
            pd = p * msc;
          }
          dp[j][e] = p * (dpm - dcs[x]) * scale;
          s[j][e] = pd;
        }
    };
    if (edge) elementwise(std::true_type());
    else elementwise(std::false_type());
    uint32_t fp[BQ / 16][4], fd[BQ / 16][4];
    to_frags<T, BQ>(s, fp);              // P (P * mscale) rounded to T
    to_frags<T, BQ>(dp, fd);             // dS rounded to T
    wg_fence();
    wg_fb<T, BQ, D>(dv_acc, fp, sdo);
    wg_fb<T, BQ, D>(dk_acc, fd, sq);
    wg_commit();
    wg_wait();
    fence_acc(dv_acc);
    fence_acc(dk_acc);
    __syncthreads();   // this stage is free for the tile after next
  }

  store_rows<T, D>(dk + koff, dk_acc, kj, Sk, lane);
  store_rows<T, D>(dv + koff, dv_acc, kj, Sk, lane);
}

template <int D> constexpr int k6w_smem() {
  // K, V, Q x 2, dO x 2; per query m, 1/l, D, segment id, dropout key x 2;
  // 1 KB of alignment
  return 2 * TC_ROWS * D * 2 + 4 * K6W_QUERIES * D * 2 +
         2 * 5 * K6W_QUERIES * 4 + 1024;
}

// K6 at D = 256: dk and dv of one 64-row k tile by two warpgroups, since
// one warpgroup cannot hold both 64 x 256 fp32 accumulators (128 registers
// a thread each). A q tile is 64 rows. Both warpgroups form S^T = K Q^T
// and P; warpgroup 0 adds dv += (P^T mscale) dO, warpgroup 1 forms dP^T =
// V dO^T and dS^T and adds dk += dS^T Q. Warpgroup 0 recomputes S^T rather
// than take P from warpgroup 1 through shared memory: five products a q
// tile instead of four, but neither warpgroup waits on the other's
// exponentials (the hand-off form was 7% slower, PERF.md section 6).
template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(K6W_THREADS, 1)
attention_bwd_dkv_tc2(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const int* __restrict__ seg_q,
                      const int* __restrict__ seg_kv,
                      const float* __restrict__ m_in,
                      const float* __restrict__ l_in,
                      const float* __restrict__ d_in,
                      const int* __restrict__ seed, T* __restrict__ dk,
                      T* __restrict__ dv, int H, int Sq, int Sk, float scale,
                      int causal, unsigned thresh, float mscale) {
  static_assert(D == 256, "the two-warpgroup K6 is the D = 256 body");
  constexpr int BQ = K6W_QUERIES, NT = K6W_THREADS;
  constexpr uint32_t KB = TC_ROWS * D * 2, QB = BQ * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  const uint32_t sK = smem_u32(smem), sV = sK + KB, sQ = sV + KB,
                 sDO = sQ + 2 * QB;
  float* ms = reinterpret_cast<float*>(smem + 2 * KB + 4 * QB);  // [2][BQ]
  float* lis = ms + 2 * BQ;                                      // 1/l or 0
  float* dcs = lis + 2 * BQ;
  int* sgq = reinterpret_cast<int*>(dcs + 2 * BQ);
  unsigned* rks = reinterpret_cast<unsigned*>(sgq + 2 * BQ);

  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * TC_ROWS;
  const int tid = threadIdx.x, lane = tid & 31;
  // the warpgroup (0: dv, 1: dk), made warp-uniform for the compiler
  const int wg = __shfl_sync(FULL, tid / TC_THREADS, 0);
  const int wt = tid % TC_THREADS, r0 = (wt >> 5) * 16;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const bool has_seg = seg_kv != nullptr;
  const int q_begin = causal ? k0 : 0;
  const int n_qt = q_begin < Sq ? (Sq - q_begin + BQ - 1) / BQ : 0;
  unsigned hkey = 0;
  if constexpr (DROPOUT) hkey = head_key(seed, bh);

  // as in attention_bwd_dkv_tc: a q tile's row statistics a tile ahead
  float m_nx = 0.f, l_nx = 0.f, d_nx = 0.f;
  int seg_nx = 0;
  auto fetch_stats = [&](int it) {
    const int qi = q_begin + it * BQ + tid;
    const bool ok = tid < BQ && it < n_qt && qi < Sq;
    const size_t si = (size_t)bh * Sq + (ok ? qi : 0);
    m_nx = ok ? m_in[si] : 0.f;
    l_nx = ok ? l_in[si] : 0.f;
    d_nx = ok ? d_in[si] : 0.f;
    seg_nx = (ok && has_seg) ? seg_q[(size_t)b * Sq + qi] : 0;
  };
  auto stage_q = [&](int it, int st) {
    const int q0 = q_begin + it * BQ;
    tile_async<BQ, D, NT>(sQ + st * QB, q + qoff, q0, Sq);
    tile_async<BQ, D, NT>(sDO + st * QB, dout + qoff, q0, Sq);
    if (tid < BQ) {
      ms[st * BQ + tid] = m_nx * LOG2E;   // m log2 e
      lis[st * BQ + tid] = l_nx > 0.f ? 1.f / l_nx : 0.f;
      dcs[st * BQ + tid] = d_nx;
      sgq[st * BQ + tid] = seg_nx;
      rks[st * BQ + tid] = DROPOUT ? fmix32(hkey ^ (unsigned)(q0 + tid)) : 0u;
    }
    fetch_stats(it + 1);
  };

  if (n_qt > 0) {   // else dk = dv = 0
    tile_async<TC_ROWS, D, NT>(sK, k + koff, k0, Sk);
    tile_async<TC_ROWS, D, NT>(sV, v + koff, k0, Sk);
    fetch_stats(0);
    stage_q(0, 0);
  }
  cp_async_commit();

  int kj[2];
  int seg_key[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    kj[i] = k0 + r0 + (lane >> 2) + 8 * i;
    if (has_seg && kj[i] < Sk) seg_key[i] = seg_kv[(size_t)b * Sk + kj[i]];
  }
  // dv (warpgroup 0) or dk (warpgroup 1)
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_qt; ++it) {
    const int st = it & 1;
    if (it + 1 < n_qt) stage_q(it + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    fence_async_smem();
    __syncthreads();
    const int q0 = q_begin + it * BQ;
    const uint32_t sq = sQ + st * QB, sdo = sDO + st * QB;

    // S^T = K Q^T in both warpgroups, dP^T = V dO^T in warpgroup 1: rows
    // are keys, columns queries
    float x[BQ / 8][4], dp[BQ / 8][4];
    wg_fence();
    wg_abt<T, BQ, D>(x, sK, sq);
    if (wg == 1) wg_abt<T, BQ, D>(dp, sV, sdo);
    wg_commit();
    wg_wait();
    fence_acc(x);
    fence_acc(dp);
    {
      // only the diagonal, ragged or segmented tiles have masked pairs
      const bool edge = has_seg || k0 + TC_ROWS > Sk || q0 + BQ > Sq ||
                        (causal && k0 + TC_ROWS - 1 > q0);
      // P (P mscale for dv) in warpgroup 0, dS in warpgroup 1
      auto probs = [&](auto edge_tag) {
        constexpr bool EDGE = decltype(edge_tag)::value;
        const float c2 = scale * LOG2E;
#pragma unroll
        for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e >> 1, c = 8 * j + 2 * (lane & 3) + (e & 1);
            const int y = st * BQ + c, qi = q0 + c;
            bool mk = false;
            if constexpr (EDGE)
              mk = kj[i] >= Sk || qi >= Sq || (causal && kj[i] > qi) ||
                   (has_seg && sgq[y] != seg_key[i]);
            const float p =
                mk ? 0.f : ex2(fminf(fmaf(x[j][e], c2, -ms[y]), 0.f)) * lis[y];
            float msc = 1.f;
            if constexpr (DROPOUT)   // the replayed mask; masked pairs draw nothing
              msc = (!mk && fmix32(rks[y] ^ (unsigned)kj[i]) >= thresh)
                        ? mscale : 0.f;
            if (wg == 0) {
              x[j][e] = DROPOUT ? p * msc : p;
            } else {
              float dpm = dp[j][e];
              if constexpr (DROPOUT) dpm *= msc;
              x[j][e] = p * (dpm - dcs[y]) * scale;
            }
          }
      };
      if (edge) probs(std::true_type());
      else probs(std::false_type());
    }
    // dv += (P^T mscale) dO or dk += dS^T Q, the fragments rounded to T
    uint32_t f[BQ / 16][4];
    to_frags<T, BQ>(x, f);
    wg_fence();
    wg_fb<T, BQ, D>(acc, f, wg == 0 ? sdo : sq);
    wg_commit();
    wg_wait();
    fence_acc(acc);
    __syncthreads();   // this stage is free for the tile after next
  }

  store_rows<T, D>((wg == 0 ? dv : dk) + koff, acc, kj, Sk, lane);
}

// the dynamic shared memory granted to each kernel on each device
constexpr int MAX_DEVICES = 64;

// a kernel with its dynamic shared memory: a size over the 48 KB default
// is granted once a device (granted[device] records it), not every launch
template <typename Kernel, typename... Args>
cudaError_t launch_kernel(Kernel kernel, int smem, int (&granted)[MAX_DEVICES],
                          dim3 grid, int threads, cudaStream_t st,
                          Args... args) {
  if (smem > 48 * 1024) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= MAX_DEVICES || granted[device] < smem) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      if (device < MAX_DEVICES) granted[device] = smem;
    }
  }
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// seed == nullptr: no dropout. bf16/fp16 on the tensor cores, the grid (B *
// H, 64-row q tiles); fp32 on the CUDA cores, the grid (q tiles, B * H)
template <typename T, int D>
cudaError_t launch_dq(int BH, cudaStream_t st, const void* q, const void* k,
                      const void* v, const void* o, const void* dout,
                      const void* seg_q, const void* seg_kv, const void* seed,
                      void* dq, void* m, void* l, void* d, int H, int Sq,
                      int Sk, float scale, int causal, unsigned thresh,
                      float mscale) {
#define DQ_KERNEL_ARGS                                                        \
  (const T*)q, (const T*)k, (const T*)v, (const T*)o, (const T*)dout,         \
      (const int*)seg_q, (const int*)seg_kv, (const int*)seed, (T*)dq,        \
      (float*)m, (float*)l, (float*)d, H, Sq, Sk, scale, causal, thresh, mscale
  static int granted[2][MAX_DEVICES];   // without, with dropout
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    const dim3 grid((Sq + ROWS - 1) / ROWS, BH);
    err = seed == nullptr
              ? launch_kernel(attention_bwd_dq_simt<T, D, false>, simt_smem<D>(),
                              granted[0], grid, THREADS, st, DQ_KERNEL_ARGS)
              : launch_kernel(attention_bwd_dq_simt<T, D, true>, simt_smem<D>(),
                              granted[1], grid, THREADS, st, DQ_KERNEL_ARGS);
  } else {
    constexpr int WGS = k5_warpgroups<D>(), rows = TC_ROWS * WGS;
    const dim3 grid(BH, (Sq + rows - 1) / rows);
    err = seed == nullptr
              ? launch_kernel(attention_bwd_dq_tc<T, D, false>, k5_smem<D>(),
                              granted[0], grid, TC_THREADS * WGS, st,
                              DQ_KERNEL_ARGS)
              : launch_kernel(attention_bwd_dq_tc<T, D, true>, k5_smem<D>(),
                              granted[1], grid, TC_THREADS * WGS, st,
                              DQ_KERNEL_ARGS);
  }
#undef DQ_KERNEL_ARGS
  return err;
}

// as launch_dq, over 64-row k tiles
template <typename T, int D>
cudaError_t launch_dkv(int BH, cudaStream_t st, const void* q, const void* k,
                       const void* v, const void* dout, const void* seg_q,
                       const void* seg_kv, const void* m, const void* l,
                       const void* d, const void* seed, void* dk, void* dv,
                       int H, int Sq, int Sk, float scale, int causal,
                       unsigned thresh, float mscale) {
#define DKV_KERNEL_ARGS                                                       \
  (const T*)q, (const T*)k, (const T*)v, (const T*)dout, (const int*)seg_q,   \
      (const int*)seg_kv, (const float*)m, (const float*)l, (const float*)d,  \
      (const int*)seed, (T*)dk, (T*)dv, H, Sq, Sk, scale, causal, thresh,     \
      mscale
  const int tiles = (Sk + TC_ROWS - 1) / TC_ROWS;
  static int granted[2][MAX_DEVICES];   // without, with dropout
  cudaError_t err;
  if constexpr (sizeof(T) == 4) {
    const dim3 grid(tiles, BH);
    err = seed == nullptr
              ? launch_kernel(attention_bwd_dkv_simt<T, D, false>,
                              simt_smem<D>(), granted[0], grid, THREADS, st,
                              DKV_KERNEL_ARGS)
              : launch_kernel(attention_bwd_dkv_simt<T, D, true>,
                              simt_smem<D>(), granted[1], grid, THREADS, st,
                              DKV_KERNEL_ARGS);
  } else if constexpr (D == 256) {
    const dim3 grid(BH, tiles);
    err = seed == nullptr
              ? launch_kernel(attention_bwd_dkv_tc2<T, D, false>, k6w_smem<D>(),
                              granted[0], grid, K6W_THREADS, st,
                              DKV_KERNEL_ARGS)
              : launch_kernel(attention_bwd_dkv_tc2<T, D, true>, k6w_smem<D>(),
                              granted[1], grid, K6W_THREADS, st,
                              DKV_KERNEL_ARGS);
  } else {
    const dim3 grid(BH, tiles);
    err = seed == nullptr
              ? launch_kernel(attention_bwd_dkv_tc<T, D, false>, k6_smem<D>(),
                              granted[0], grid, TC_THREADS, st,
                              DKV_KERNEL_ARGS)
              : launch_kernel(attention_bwd_dkv_tc<T, D, true>, k6_smem<D>(),
                              granted[1], grid, TC_THREADS, st,
                              DKV_KERNEL_ARGS);
  }
#undef DKV_KERNEL_ARGS
  return err;
}

bool bad_args(int B, int H, int Sq, int Sk, int D, int dtype,
              const void* seg_q, const void* seg_kv) {
  return (D != 64 && D != 128 && D != 256) || dtype < 0 || dtype > 2 || B < 1 || H < 1 ||
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
  cudaStream_t st = (cudaStream_t)stream;
#define DQ_ARGS B * H, st, q, k, v, o, dout, seg_q, seg_kv, seed, dq, m, l, d, H, Sq, Sk, scale, causal, thresh, mscale
#define DQ_D(T) \
  (D == 64 ? launch_dq<T, 64>(DQ_ARGS) \
           : D == 128 ? launch_dq<T, 128>(DQ_ARGS) : launch_dq<T, 256>(DQ_ARGS))
  if (dtype == 0)
    err = DQ_D(__nv_bfloat16);
  else if (dtype == 1)
    err = DQ_D(__half);
  else
    err = DQ_D(float);
#undef DQ_D
#undef DQ_ARGS
  return (int)err;
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
  cudaStream_t st = (cudaStream_t)stream;
#define DKV_ARGS B * H, st, q, k, v, dout, seg_q, seg_kv, m, l, d, seed, dk, dv, H, Sq, Sk, scale, causal, thresh, mscale
#define DKV_D(T) \
  (D == 64 ? launch_dkv<T, 64>(DKV_ARGS) \
           : D == 128 ? launch_dkv<T, 128>(DKV_ARGS) : launch_dkv<T, 256>(DKV_ARGS))
  if (dtype == 0)
    err = DKV_D(__nv_bfloat16);
  else if (dtype == 1)
    err = DKV_D(__half);
  else
    err = DKV_D(float);
#undef DKV_D
#undef DKV_ARGS
  return (int)err;
}

extern "C" const char* attention_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Packed prefill attention, forward: softmax(scale * Q K^T + mask) V.
//
// Replaces apex_tpu/ops/attention_pallas.py:230 _fwd_kernel and :262
// _fwd_kernel_chunked (the VMEM-row kernel under fused_attention_rows), and
// the library flash kernel that apex_tpu/ops/attention.py:203 dispatches to
// on the TPU. Semantics are those of apex_tpu/ops/attention.py:25
// _dense_attention: fp32 scores from input-dtype operands; a key is masked
// where it lies above the causal diagonal (key index > query index) or
// where its segment id differs from the query's; masked keys are excluded
// from the softmax; a fully masked row gives 0.
//
// The DROPOUT instantiation (K1d) is the dropout branch of _fwd_kernel
// (:252-256): inverted dropout on the normalized probabilities, P * mscale
// with mscale = 1/(1-p) where a score is kept and 0 where it is dropped.
// The mask is _dropout_mscale :198 bit for bit, a chained murmur3 fmix32
// hash of the seed and the score's global (b*H + h, row, column): the seed
// (an int32 read through a pointer, so that the caller never syncs to pass
// it) gives s = fmix32(0x9E3779B9 ^ seed), the block s_bh = fmix32(s ^ bh),
// each row rowkey = fmix32(s_bh ^ row) once, and each live (row, column)
// one more fmix32 compared with the threshold p * 2^32. It is drawn in
// registers and never stored; tiles the causal mask skips draw nothing.
// The mask scales the normalized P, so the running sum l takes the
// unmasked exp(s - m) and only the value numerator takes the mask; a row
// whose keys are all dropped gives 0. Serving runs the no-dropout
// instantiation, which compiles to the kernel without the hash.
//
// Layout: q [B, H, Sq, D], k and v [B, H, Sk, D], out [B, H, Sq, D], all
// contiguous (and 16-byte aligned for bf16/fp16), one dtype (bf16, fp16 or
// fp32); segment ids [B, Sq] and [B, Sk] int32, or null for none; the
// dropout seed one int32, or null for no dropout. D is 64, 128 or 256:
// the wrapper zero-pads a head dim between two of them up to the next,
// which is exact (zero columns of q and k add nothing to a score, zero
// columns of v give zero output columns, sliced away) because the scale
// is passed in from the true head dim.
//
// What bounds it on H100: at the training shape (B 8, H 12, S 1024, D 64,
// bf16, causal) the function moves 50.3 MB (q, k, v read, o written),
// 15 us at 3.35 TB/s, and its two products over the 50.4 M live pairs are
// 12.9 GFLOP, 13 us at 989 TFLOP/s: the bytes bound it, closely followed
// by the products. With dropout the hash bounds it: ~11 integer operations
// a live pair, 33 us on 132 x 64 INT32 lanes. At the serving shape (B 1,
// H 12, S 512, D 64, three segments) it moves ~3.1 MB, ~0.94 us; there a
// block has at most 8 key tiles, so latency, not a rate, sets its time.
// The TPU kernel keeps a whole [bq, sk] score row in VMEM; 227 KB of
// shared memory cannot, so this kernel streams K/V tiles through shared
// memory and keeps an online max and sum per query row in fp32 registers
// (flash style). Tiles wholly above the causal diagonal of the block are
// never loaded (the idea of _fwd_kernel_chunked).
//
// bf16 and fp16 run on the tensor cores (prefill_attention_tc), by
// Hopper's wgmma (sm_90a). A block is one warpgroup (four warps, each
// holding 16 of the block's 64 query rows) that owns a 64-row Q tile:
//  - Q comes in once by cp.async; K and V come in as 64-key tiles through
//    a two-stage cp.async ring (the next tile loads while this one
//    computes; zero-filled past the ragged edge), in wgmma's 128-byte
//    swizzle (a D = 64 row is exactly 128 bytes). One barrier a tile.
//  - S = Q K^T is wgmma m64n64k16 with both operands K-major in shared
//    memory and fp32 accumulators; its first k step overwrites them.
//  - The online softmax runs on the accumulator fragment: a thread holds
//    two rows' slices, and a row's max takes two quad shuffles a tile;
//    its sum stays a per-thread partial until the end. exp is ex2 (the
//    SFU) of scores already scaled by scale * log2 e; O's accumulators
//    are rescaled only where m moved. Only the diagonal, ragged or
//    segmented tiles evaluate the mask.
//  - With dropout each accumulator element draws its hash in registers
//    from a rowkey computed once per row, as K5d/K6d draw it.
//  - O += P V is wgmma RS: P, packed from the accumulators to bf16/fp16,
//    is the register A fragment (the packing is the one rounding of P),
//    and V (keys x D, row-major) is read MN-major through the transpose
//    bit.
//  - The epilogue multiplies by 1/l (0 where l = 0), and by 1/(1-p) with
//    dropout (the mask enters the value product as 0/1), and stores the
//    input dtype.
// P is rounded as exp(s - m_running) in one pass, where the TPU kernel
// rounds the normalized P * mscale of a whole row: each is one rounding of
// P to the input dtype, at another scale. Each block owns its output rows
// (no atomics: two runs give the same bits). The grid puts the q tiles
// with the most keys under the causal mask first, so the causal tail does
// not idle the card. At D = 64 four blocks share an SM (three with
// dropout), so one block's products overlap another's exponentials and
// hash; at D = 128, two. Issuing the next tile's S before this tile's
// softmax, so that the softmax overlaps P V inside the warpgroup
// (FlashAttention-3's intra-warpgroup overlap), measured slower than these
// independent blocks: it needs ~30 more registers, which cost a block an
// SM. Not yet done (later work): a TMA producer warp, two warpgroups in
// ping-pong, and emitting (m, l) for the backward.
//
// At D = 256 the same body runs one block an SM: O's accumulator is 64 x
// 256 fp32 (128 registers a thread), the value product two m64n128k16
// halves, and the shared tiles 160 KB.
//
// fp32 stays on the CUDA cores (prefill_attention_simt): four threads per
// query row over 32-key tiles, fp32 FMAs, its tiles in dynamic shared
// memory (and at D = 256 the block's Q rows too, which would not fit a
// thread's registers). On the tensor cores fp32 would run as TF32, which
// keeps 10 mantissa bits and cannot hold fp32's 1e-4 band against the
// plain version.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr unsigned FULL = 0xffffffffu;

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

constexpr int BQ = 64;              // query rows per block
constexpr int BK = 32;              // keys per shared-memory tile
constexpr int TPR = 4;              // threads per query row
constexpr int THREADS = BQ * TPR;   // 256
constexpr int KPT = BK / TPR;       // keys scored per thread per tile

// the block's Q rows sit in shared memory where a thread's registers
// cannot hold its row
template <int D> __host__ __device__ constexpr bool simt_q_smem() { return D > 128; }

// K and V tiles, P, the key segment ids and (simt_q_smem) Q, in bytes
template <int D> constexpr int simt_smem() {
  return 4 * (2 * BK * (D + 1) + BQ * (BK + 1) + BK +
              (simt_q_smem<D>() ? BQ * (D + 1) : 0));
}

template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(THREADS)
prefill_attention_simt(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ seg_q,
                       const int* __restrict__ seg_kv,
                       const int* __restrict__ seed, T* __restrict__ out,
                       int H, int Sq, int Sk, float scale, int causal,
                       unsigned thresh, float mscale) {
  static_assert(D % TPR == 0, "D must split over the threads of a row");
  constexpr bool QS = simt_q_smem<D>();
  extern __shared__ float simt_smem_f[];
  // +1: row stride off the bank period
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(simt_smem_f);
  float (*vs)[D + 1] = ks + BK;
  float (*ps)[BK + 1] = reinterpret_cast<float (*)[BK + 1]>(vs + BK);
  int* segk = reinterpret_cast<int*>(ps + BQ);
  float (*qs)[D + 1] = reinterpret_cast<float (*)[D + 1]>(segk + BK);

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

  float qr[QS ? 1 : D];
  if constexpr (QS) {
    // each thread its quarter of the row; the first tile's barrier
    // publishes them
    for (int c = sub; c < D; c += TPR)
      qs[r][c] = row_ok ? (float)q[qbase + (size_t)qi * D + c] : 0.f;
  } else {
#pragma unroll
    for (int c = 0; c < D; ++c) qr[c] = row_ok ? q[qbase + (size_t)qi * D + c] : 0.f;
  }
  const int seg_row = (has_seg && row_ok) ? seg_q[(size_t)b * Sq + qi] : 0;
  unsigned rowkey = 0;
  if constexpr (DROPOUT) rowkey = fmix32(head_key(seed, bh) ^ (unsigned)qi);

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
        kv = k[kbase + (size_t)kj * D + c];
        vv = v[kbase + (size_t)kj * D + c];
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
      if constexpr (QS) {
#pragma unroll 16
        for (int c = 0; c < D; ++c) dot = fmaf(qs[r][c], ks[j][c], dot);
      } else {
#pragma unroll
        for (int c = 0; c < D; ++c) dot = fmaf(qr[c], ks[j][c], dot);
      }
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
      out[qbase + (size_t)qi * D + sub + TPR * i] = acc[i] * inv;
  }
}



// ---------------------------------------------------------------------------
// bf16 and fp16: the tensor cores (wgmma, fp32 accumulators)

constexpr int TC_THREADS = 128;   // four warps; warp w owns rows 16w..16w+15
constexpr int TC_ROWS = 64;       // query rows of a block
constexpr int TC_KEYS = 64;       // keys per K/V tile
static_assert(TC_ROWS == BQ, "both bodies tile 64 rows");

// wgmma.mma_async m64nNk16 with fp32 accumulators: d (64 x N) += a b. The
// four warps of the warpgroup each hold 16 rows of d in the m16n8 C layout:
// thread (g = lane / 4, t = lane % 4) of warp w has rows 16w + g and
// 16w + g + 8, columns 8j + 2t and 8j + 2t + 1, as d[j][0..1] and
// d[j][2..3]. SS: a and b from shared memory, both K-major. RS: a from
// registers (the A fragment of the warp's 16 rows, the layout of mma.sync
// m16n8k16), b from shared memory MN-major (the transpose bit). acc = 0
// writes d = a b, ignoring d's old contents; acc = 1 adds.
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
  static __device__ __forceinline__ void ss64(float (&d)[8][4], uint64_t da,
                                              uint64_t db, int acc) {
    if constexpr (BF16) WGMMA_SS_N64("bf16");
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

// 2^x on the SFU (MUFU.EX2); ex2(-inf) = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float row_max4(float x) {
  x = fmaxf(x, __shfl_xor_sync(FULL, x, 1));
  return fmaxf(x, __shfl_xor_sync(FULL, x, 2));
}
__device__ __forceinline__ float row_sum4(float x) {
  x += __shfl_xor_sync(FULL, x, 1);
  return x + __shfl_xor_sync(FULL, x, 2);
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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Shared tiles of R rows x D 16-bit columns are D/64 panels of R rows x 128
// bytes; in each row the 16-byte chunk c sits at c ^ (row & 7): wgmma's
// canonical 128-byte-swizzled layout (eight-row groups of 1024 bytes), with
// no bank conflicts. Byte offset of chunk c (columns 8c..8c+7) of row r:
template <int R>
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (uint32_t)((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// rows [r0, r0 + R) of a [S, D] slab into a swizzled tile, zeros past S
template <int R, int D, typename T>
__device__ __forceinline__ void tile_async(uint32_t dst, const T* slab, int r0,
                                           int S) {
  constexpr int C = D / 8;
  static_assert(R * C % TC_THREADS == 0, "tile split");
#pragma unroll
  for (int i = 0; i < R * C / TC_THREADS; ++i) {
    const int e = threadIdx.x + i * TC_THREADS;
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

// issue s (64 x 64) = Q K^T over k = D: Q a [64, D] tile, K a [64, D]
// tile, both K-major (k step kk is 32 bytes into panel kk / 4; LBO unused).
// The first k step overwrites s, so it needs no zeroing.
template <typename T, int D>
__device__ __forceinline__ void wg_qkt(float (&s)[TC_KEYS / 8][4], uint32_t a,
                                       uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    Tc<T>::ss64(s, desc128(a + (kk >> 2) * (TC_ROWS * 128) + (kk & 3) * 32, 16),
                desc128(b + (kk >> 2) * (TC_KEYS * 128) + (kk & 3) * 32, 16),
                kk > 0);
}

// issue acc (64 x D) += P V over the tile's keys: P register fragments (the
// warp's 16 rows x 64 keys), V a [64, D] tile read MN-major (k step kk is
// 16 rows, 2048 bytes, on; LBO the panel stride, from columns 0-63 to
// 64-127)
template <typename T, int D>
__device__ __forceinline__ void wg_pv(float (&acc)[D / 8][4],
                                      const uint32_t (&f)[TC_KEYS / 16][4],
                                      uint32_t b) {
  if constexpr (D == 256) {
    // two m64n128 halves: columns 0-127 from panels 0-1, 128-255 from 2-3
    auto& lo = *reinterpret_cast<float (*)[16][4]>(&acc[0][0]);
    auto& hi = *reinterpret_cast<float (*)[16][4]>(&acc[16][0]);
#pragma unroll
    for (int kk = 0; kk < TC_KEYS / 16; ++kk) {
      Tc<T>::template rs<128>(lo, f[kk], desc128(b + kk * 2048, TC_KEYS * 128), 1);
      Tc<T>::template rs<128>(
          hi, f[kk], desc128(b + 2 * TC_KEYS * 128 + kk * 2048, TC_KEYS * 128), 1);
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < TC_KEYS / 16; ++kk)
      Tc<T>::template rs<D>(acc, f[kk], desc128(b + kk * 2048, TC_KEYS * 128), 1);
  }
}

// an accumulator (16 x 64, fp32) rounded to T as the A fragments of the next
// product: the C layout of n8 blocks 2kk and 2kk+1 is the A layout of k step kk
template <typename T>
__device__ __forceinline__ void to_frags(const float (&x)[TC_KEYS / 8][4],
                                         uint32_t (&f)[TC_KEYS / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < TC_KEYS / 16; ++kk) {
    f[kk][0] = Tc<T>::pack(x[2 * kk][0], x[2 * kk][1]);
    f[kk][1] = Tc<T>::pack(x[2 * kk][2], x[2 * kk][3]);
    f[kk][2] = Tc<T>::pack(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    f[kk][3] = Tc<T>::pack(x[2 * kk + 1][2], x[2 * kk + 1][3]);
  }
}

// blocks an SM holds: at D = 64 four (at most 128 registers a thread;
// K1 needs 123) or, with dropout, three (168: the hash spills under 128);
// at D = 128 two (the shared tiles of a third would not fit); at D = 256
// one (160 KB of tiles)
template <int D, bool DROPOUT> __host__ __device__ constexpr int tc_blocks() {
  return D == 64 ? (DROPOUT ? 3 : 4) : D == 128 ? 2 : 1;
}

template <int D> constexpr int tc_smem() {
  // Q, K x 2, V x 2; key segment ids x 2; 1 KB of alignment
  return 5 * TC_ROWS * D * 2 + 2 * TC_KEYS * 4 + 1024;
}

__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

template <typename T, int D, bool DROPOUT>
__global__ void __launch_bounds__(TC_THREADS, tc_blocks<D, DROPOUT>())
prefill_attention_tc(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_kv,
                     const int* __restrict__ seed, T* __restrict__ out, int H,
                     int Sq, int Sk, float scale, int causal, unsigned thresh,
                     float mscale) {
  constexpr int NK = TC_KEYS;
  constexpr uint32_t TB = TC_ROWS * D * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1k(smem_raw);
  const uint32_t sQ = smem_u32(smem), sK = sQ + TB, sV = sK + 2 * TB;
  int* segk = reinterpret_cast<int*>(smem + 5 * TB);          // [2][NK]

  const int bh = blockIdx.x, b = bh / H;
  // the q tiles with the most keys under the causal mask go first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;
  const int tid = threadIdx.x, lane = tid & 31, r0 = (tid >> 5) * 16;
  const size_t qoff = (size_t)bh * Sq * D, koff = (size_t)bh * Sk * D;
  const bool has_seg = seg_kv != nullptr;
  // causal: keys past the block's last query row are masked for every row
  const int n_kt = ((causal ? min(Sk, q0 + TC_ROWS) : Sk) + NK - 1) / NK;

  auto stage_kv = [&](int it, int st) {
    const int k0 = it * NK;
    tile_async<NK, D>(sK + st * TB, k + koff, k0, Sk);
    tile_async<NK, D>(sV + st * TB, v + koff, k0, Sk);
    if (tid < NK)
      segk[st * NK + tid] = (has_seg && k0 + tid < Sk)
                                ? seg_kv[(size_t)b * Sk + k0 + tid] : 0;
    cp_async_commit();
  };
  tile_async<TC_ROWS, D>(sQ, q + qoff, q0, Sq);
  stage_kv(0, 0);

  int qi[2];
  int seg_row[2] = {0, 0};
  unsigned rowkey[2] = {0u, 0u};
  // m: the running max of the row's live scores, in log2 units (scale *
  // log2 e folded in); l: this thread's share of the running sum of
  // exp(s - m), summed over the row's four threads at the end
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qi[i] = q0 + r0 + (lane >> 2) + 8 * i;
    if (has_seg && qi[i] < Sq) seg_row[i] = seg_q[(size_t)b * Sq + qi[i]];
    if constexpr (DROPOUT) rowkey[i] = fmix32(head_key(seed, bh) ^ (unsigned)qi[i]);
  }
  const float c2 = scale * LOG2E;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_kt; ++it) {
    const int st = it & 1;
    // this tile has landed, and every warp is done with the other stage
    cp_async_wait_all();
    fence_async_smem();
    __syncthreads();
    if (it + 1 < n_kt) stage_kv(it + 1, st ^ 1);
    const int k0 = it * NK;
    const int* sg = segk + st * NK;

    float s[NK / 8][4];
    wg_fence();
    wg_qkt<T, D>(s, sQ, sK + st * TB);
    wg_commit();
    wg_wait();
    fence_acc(s);

    // only the diagonal, ragged or segmented tiles have masked pairs
    const bool edge = has_seg || k0 + NK > Sk || q0 + TC_ROWS > Sq ||
                      (causal && k0 + NK - 1 > q0);
    float alpha[2];
    auto softmax = [&](auto edge_tag) {
      constexpr bool EDGE = decltype(edge_tag)::value;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * i + h;
            float x = s[j][e] * c2;
            if constexpr (EDGE) {
              const int c = 8 * j + 2 * (lane & 3) + h, kj = k0 + c;
              if (qi[i] >= Sq || kj >= Sk || (causal && kj > qi[i]) ||
                  (has_seg && sg[c] != seg_row[i]))
                x = -INFINITY;
            }
            s[j][e] = x;
            tmax = fmaxf(tmax, x);
          }
        const float m_new = fmaxf(m[i], row_max4(tmax));
        // m_new == -inf: every key so far is masked for this row, and every
        // p below is ex2(-inf) = 0
        const float mref = m_new == -INFINITY ? 0.f : m_new;
        alpha[i] = m_new == m[i] ? 1.f : ex2(m[i] - mref);
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NK / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int e = 2 * i + h;
            const float p = ex2(s[j][e] - mref);
            psum += p;   // l takes the unmasked p
            if constexpr (DROPOUT) {
              const unsigned kj = (unsigned)(k0 + 8 * j + 2 * (lane & 3) + h);
              s[j][e] = fmix32(rowkey[i] ^ kj) >= thresh ? p : 0.f;
            } else {
              s[j][e] = p;
            }
          }
        l[i] = l[i] * alpha[i] + psum;
        m[i] = m_new;
      }
    };
    if (edge) softmax(std::true_type());
    else softmax(std::false_type());

    // O's rows rescaled where their max moved
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (alpha[i] != 1.f) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[j][2 * i] *= alpha[i];
          acc[j][2 * i + 1] *= alpha[i];
        }
      }
    uint32_t f[NK / 16][4];
    to_frags<T>(s, f);                 // P rounded to T
    wg_fence();
    wg_pv<T, D>(acc, f, sV + st * TB);
    wg_commit();
    wg_wait();
    fence_acc(acc);
  }

  // the epilogue: 1/l (0 for a fully masked row), times 1/(1-p) with
  // dropout, and the rows to the [Sq, D] slab
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = row_sum4(l[i]);
    const float inv = lt > 0.f ? (DROPOUT ? mscale : 1.f) / lt : 0.f;
    if (qi[i] >= Sq) continue;
    uint32_t* dst = reinterpret_cast<uint32_t*>(out + qoff + (size_t)qi[i] * D +
                                                2 * (lane & 3));
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      dst[4 * j] = Tc<T>::pack(acc[j][2 * i] * inv, acc[j][2 * i + 1] * inv);
  }
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

template <typename T, int D, bool DROPOUT>
cudaError_t launch_one(int BH, cudaStream_t st, const void* q, const void* k,
                       const void* v, const void* seg_q, const void* seg_kv,
                       const void* seed, void* out, int H, int Sq, int Sk,
                       float scale, int causal, unsigned thresh,
                       float mscale) {
#define K1_KERNEL_ARGS                                                     \
  (const T*)q, (const T*)k, (const T*)v, (const int*)seg_q,                \
      (const int*)seg_kv, (const int*)seed, (T*)out, H, Sq, Sk, scale,     \
      causal, thresh, mscale
  const int tiles = (Sq + BQ - 1) / BQ;
  static int granted[MAX_DEVICES];
  cudaError_t err;
  if constexpr (sizeof(T) == 4)
    err = launch_kernel(prefill_attention_simt<T, D, DROPOUT>, simt_smem<D>(),
                        granted, dim3(tiles, BH), THREADS, st, K1_KERNEL_ARGS);
  else
    err = launch_kernel(prefill_attention_tc<T, D, DROPOUT>, tc_smem<D>(),
                        granted, dim3(BH, tiles), TC_THREADS, st,
                        K1_KERNEL_ARGS);
#undef K1_KERNEL_ARGS
  return err;
}

// seed == nullptr: no dropout. bf16/fp16 on the tensor cores, the grid (B *
// H, 64-row q tiles); fp32 on the CUDA cores, the grid (q tiles, B * H)
template <typename T>
cudaError_t launch(int D, int BH, cudaStream_t st, const void* q,
                   const void* k, const void* v, const void* seg_q,
                   const void* seg_kv, const void* seed, void* out, int H,
                   int Sq, int Sk, float scale, int causal, unsigned thresh,
                   float mscale) {
#define K1_ARGS BH, st, q, k, v, seg_q, seg_kv, seed, out, H, Sq, Sk, scale, causal, thresh, mscale
  if (seed == nullptr)
    return D == 64    ? launch_one<T, 64, false>(K1_ARGS)
           : D == 128 ? launch_one<T, 128, false>(K1_ARGS)
                      : launch_one<T, 256, false>(K1_ARGS);
  return D == 64    ? launch_one<T, 64, true>(K1_ARGS)
         : D == 128 ? launch_one<T, 128, true>(K1_ARGS)
                    : launch_one<T, 256, true>(K1_ARGS);
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
  if ((D != 64 && D != 128 && D != 256) || dtype < 0 || dtype > 2 || B < 1 || H < 1 ||
      Sq < 1 || Sk < 1 || B * H > 65535 ||
      (seg_q == nullptr) != (seg_kv == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define FWD_ARGS D, B * H, st, q, k, v, seg_q, seg_kv, seed, out, H, Sq, Sk, scale, causal, thresh, mscale
  if (dtype == 0)
    err = launch<__nv_bfloat16>(FWD_ARGS);
  else if (dtype == 1)
    err = launch<__half>(FWD_ARGS);
  else
    err = launch<float>(FWD_ARGS);
#undef FWD_ARGS
  return (int)err;
}

extern "C" const char* prefill_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Fused linear + cross entropy, the LM head without logits: the forward (K7),
// the vocabulary-shard forward of tensor parallelism (K7p), the dX pass (K8)
// and the dE pass (K9).
//
// Replaces apex_tpu/ops/xent_pallas.py: _fwd :417 (pallas_call :429; kernel
// _fwd_kernel :184 over _accumulate_chunk :149), _fwd_sharded :321 (pallas_call
// :339; kernel _fwd_partial_kernel :203 over the same _accumulate_chunk), and
// _bwd_kernels :449, its dX call (:467, _dx_kernel :222) and its dE call (:482,
// _de_kernel :246), which the sharded backward _bwd_sharded_rule :373 reuses on
// a shard with the whole vocabulary's v_total.
// Semantics and rounding points are theirs, for x [n, h] and E [V, h] of one
// dtype (bf16, fp16 or fp32), int32 labels [n] (a label outside [0, V) hits
// no column):
//  - logits = x E^T with fp32 accumulation, never written to device memory;
//  - the forward keeps an fp32 online (max, sum of exponentials) per row, the
//    target logit through the label's column and, with label smoothing eps,
//    the row's logits sum u: lse = m + log s, loss = lse - t, or
//    lse - (1 - eps) t - eps u / V (contrib-xentropy semantics);
//  - dX = dl * sum_v coeff E with coeff = exp(logits - lse) - (1 - eps) hit -
//    eps / v_total rounded to E's dtype, fp32 accumulation, the result rounded to
//    x's dtype;
//  - dE = sum_rows coeff^T wx with coeff rounded to x's dtype and wx = dl * x
//    rounded to x's dtype, fp32 accumulation, the result in E's dtype.
//
// What bounds it on H100: all three are products with a reduction attached.
// At the training shape (x [8192, 768], E [50304, 768], bf16) K7 computes one
// product (2 n V h = 633 GFLOP, 0.64 ms at 989 TFLOP/s) and K8 and K9 two each
// (the recomputed logits and the gradient product, 1.27 TFLOP, 1.28 ms); the
// bytes each must move (x, E, the row vectors and its output, 90-168 MB) take
// 27-50 us. So they are bound by operations, and the bf16 and fp16 products
// run on the tensor cores. The fp32 instantiations compute with CUDA-core
// FMAs (the *_simt kernels), since TF32 would break fp32 parity.
//
// Design, and what it does about the TPU kernel's shape:
//  - K7: a block owns 128 rows and a contiguous share of the vocabulary
//    (nsplit shares, chosen by the caller so that the grid fills the card:
//    row tiles alone give 64 blocks for 132 SMs). It walks its share tile by
//    tile and writes per-row partials (max, sum of exponentials, target,
//    logits sum); a second small kernel combines the shares in a fixed
//    order, the cross-shard combine _fwd_sharded :350-361 does for tp > 1.
//    Its first stage has three forms, chosen by dtype and width alone:
//     - bf16 and fp16 where h % 64 == 0 (xent_fwd_tc, Hopper's wgmma): two
//       consumer warpgroups of 64 rows each hold one 64 x 256 tile of
//       logits in fp32 registers (m64n256k16, both operands K-major from
//       128-byte-swizzled shared memory), summed over the depth in
//       64-column panels. One producer warp fills a ring of four stages,
//       each a 128 x 64 panel of x and a 256 x 64 panel of E (48 KB), by
//       TMA; the consumers hand a stage back on its mbarrier once their
//       products have read it, so the next tile's panels load while a
//       warpgroup folds its fragment into the row state: the tile's max by
//       two quad shuffles, exponentials as ex2 of one FMA with log2 e
//       folded in, per-thread partial sums (combined in a fixed order at
//       the end), and the target by one compare of the label's column. V
//       is a multiple of 128, so the last 256-wide tile is whole or half:
//       its columns past V (zero-filled E rows) are never read. The grid is
//       whole waves of one block an SM where the shape allows (64 row
//       blocks x 33 shares at the training shape).
//     - fp32: logits_tile with CUDA-core FMAs (TF32 would break fp32
//       parity), 128-wide tiles;
//     - bf16/fp16 at other widths: logits_tile on nvcuda::wmma 16x16x16
//       fragments (mma.sync) into fp32 shared memory, where the softmax
//       arithmetic reads it by row; the depth streams in 32-deep cp.async
//       slices. The blocks of one share start their walk at eight points
//       of it and share E through L2.
//  - K7p is K7 on one rank's shard of E: the same first stage, then a second
//    small kernel that folds the shares in the same order into the rank's
//    four row partials and forms no lse; the cross-rank combine is PyTorch
//    and torch.distributed (apex_tpu_torch/ops/xent.py), as the JAX package
//    does it in jnp outside Pallas. At the tp = 2 training shape (x [8192,
//    768], a shard of 25216 rows) it is bound by operations as K7 is: 2 n Vs h
//    = 317 GFLOP, 0.32 ms at 989 TFLOP/s.
//  - K8 and K9 take v_total, the vocabulary the uniform smoothing term
//    divides by: V for the whole table, Vs * tp for a shard.
//  - The TPU backward accumulates each output block while its inner grid index
//    walks (xent_pallas.py:14-18, :248-249). Hopper runs blocks in no order,
//    so the inner grid axis becomes a loop inside the block and each block
//    owns its output tile outright: no atomics, no second pass, and the same
//    bits on every run.
//  - K8 and K9 for bf16 and fp16 where h % 64 == 0 and h <= 1024
//    (xent_bwd_tc, Hopper's wgmma): K1's shape. A block owns 64 rows, x's for
//    K8 and E's for K9, kept resident in shared memory (96 KB at h = 768),
//    and streams the other operand in 32-row tiles through a two-stage ring
//    that the tensor memory accelerator (TMA) fills: thread 0 issues one
//    box a 64-column panel, completing on the stage's mbarrier, in wgmma's
//    128-byte swizzle; rows past the end arrive as zeros. Each streamed
//    tile serves both products, so each block reads it once: at the training
//    shape K8 reads E from L2 once for every 64 rows of x (9.9 GB), and K9
//    x (in L2) once for every 64 rows of E (9.9 GB). Two consumer
//    warpgroups each hold 64 x 384 fp32 accumulators (192 registers a
//    thread; three of 64 x 256 spilled under the 168 registers 384 threads
//    may have, and ptxas then serialized every wgmma). A tile's step:
//     1. S = own . streamed^T (64 x 32), wgmma SS m64n32k16 with both
//        operands K-major, each warpgroup over half the depth; each hands
//        the other the fp32 partial of the other's 32 rows through shared
//        memory, and the two add in either order to the same bits.
//     2. coeff = (ex2(S log2 e - lse log2 e) - (1 - eps) hit) - eps /
//        v_total on the accumulator fragment (a thread keeps one row; the
//        hit is one compare), rounded to E's dtype (K8) or x's (K9) into C
//        (64 x 32, K-major, swizzled), then fence.proxy.async, since wgmma
//        reads C through the async proxy.
//     3. K8: dX += C . E_tile, wgmma SS m64n256k16 and m64n128k16, E's tile
//        read MN-major through the transpose bit. K9: dE^T += wx^T C^T,
//        wgmma RS m64n64k16 with wx^T the A operand built in registers:
//        x's tile by ldmatrix.trans, times dl, rounded to x's dtype (the
//        TPU kernel's wx), so no wx is written back; a ring of three
//        fragment sets lets one group load while two multiply.
//    Three barriers a step. The epilogue stages the output tile (dl * acc
//    for K8, dE^T transposed for K9) through the owned tile's space and
//    writes 16-byte chunks. The main body is built for h = 768 (one
//    768-column window, trip counts and offsets known); another
//    instantiation takes the other widths with 16-row streamed tiles (so
//    that two stages fit beside a 1024-wide owned tile), 768-column windows
//    on blockIdx.y that each recompute S, and 64-column products.
//  - The general form of K8/K9 (fp32, and bf16/fp16 where h % 64 == 32 or
//    h > 1024): K8 a block owns 32 rows x 768 columns of dX and loops over
//    128-wide vocabulary tiles (logits in logits_tile, coeff, then coeff . E
//    streamed in slices); K9 a block owns 32 vocabulary rows x 768 columns
//    of dE and loops over the rows in 64-row tiles, with wx = dl * x formed
//    in shared memory. A width above 768 takes more column tiles, each
//    recomputing the logits.
//  - How far from the bound, on an H100 SXM at 700 W (chip_smoke.py phase
//    3): K7 was 4.0 ms on wmma (6.3x its bound), K8 and K9 12.2 and 17.1
//    ms; on wgmma they take the times PERF.md records.
//  - Ragged edges: rows past n load as zeros and are masked on the way out;
//    V is a multiple of 128 and h of 32, so vocabulary and depth tiles are
//    whole.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 32;                  // depth of one slice of a logits product
constexpr int PAD = 8;                  // elements added to a shared-memory row
constexpr int LD = BK + PAD;            // row stride of a depth slice
constexpr int FWD_ROWS = 128, FWD_VOCAB = 128;    // K7 tile
constexpr int FWD_START_GROUPS = 8;
constexpr int DX_ROWS = 32, DX_VOCAB = 128;       // K8 tile
constexpr int DE_ROWS = 64, DE_VOCAB = 32;        // K9 tile
constexpr int COLS = 768;               // accumulator columns of a K8/K9 block
constexpr int WARP_COLS = COLS / WARPS; // 96
constexpr int CG = WARP_COLS / 16;      // 16-wide column groups per warp
constexpr int LDE = COLS + PAD;         // row stride of a streamed E / x slice
constexpr int SCRATCH_LD = 20;          // per-warp 16 x 16 fp32 staging tile
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

// depth slices of the streamed gradient products: two 16-deep steps for the
// half types, one for fp32 (whose slices are twice the bytes)
template <typename T> __host__ __device__ constexpr int bk2() {
  return sizeof(T) == 4 ? 16 : 32;
}


__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// wait until at most N of this thread's most recent groups are in flight
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy a rows x cols tile (global row stride ldg, shared row stride lds) with
// 16-byte cp.async; rows at or past valid_rows are zero-filled. cols *
// sizeof(T) is a multiple of 16.
template <typename T>
__device__ __forceinline__ void load_async(T* s, int lds, const T* g, long ldg,
                                           int rows, int cols, int valid_rows) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = cols / VEC;
  for (int i = threadIdx.x; i < rows * per_row; i += THREADS) {
    const int r = i / per_row, c = (i - r * per_row) * VEC;
    T* dst = s + r * lds + c;
    if (r < valid_rows)
      cp_async16(dst, g + r * ldg + c);
    else
      *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
  }
}

// ---- 16 x 16 x 16 products of one warp ------------------------------------
// Operand A is read as element (row, k), operand B as (k, column), from shared
// memory in a row- or column-major layout. bf16 and fp16 go through the tensor
// cores (wmma); fp32 through CUDA-core FMAs, lane l owning row l / 2 and
// columns 8 (l % 2) .. 8 (l % 2) + 7 of the 16 x 16 tile.

struct Row {
  static constexpr bool row = true;
  using wmma_t = wmma::row_major;
};
struct Col {
  static constexpr bool row = false;
  using wmma_t = wmma::col_major;
};

template <typename T, class L> struct FragA {
  wmma::fragment<wmma::matrix_a, 16, 16, 16, T, typename L::wmma_t> f;
  __device__ __forceinline__ void load(const T* p, int ld) { wmma::load_matrix_sync(f, p, ld); }
};
template <typename T, class L> struct FragB {
  wmma::fragment<wmma::matrix_b, 16, 16, 16, T, typename L::wmma_t> f;
  __device__ __forceinline__ void load(const T* p, int ld) { wmma::load_matrix_sync(f, p, ld); }
};
template <class L> struct FragA<float, L> {
  const float* p;
  int ld;
  __device__ __forceinline__ void load(const float* q, int l) { p = q; ld = l; }
  __device__ __forceinline__ float at(int r, int k) const { return L::row ? p[r * ld + k] : p[k * ld + r]; }
};
template <class L> struct FragB<float, L> {
  const float* p;
  int ld;
  __device__ __forceinline__ void load(const float* q, int l) { p = q; ld = l; }
  __device__ __forceinline__ float at(int k, int c) const { return L::row ? p[k * ld + c] : p[c * ld + k]; }
};

struct AccTc {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> f;
  __device__ __forceinline__ void zero() { wmma::fill_fragment(f, 0.0f); }
  __device__ __forceinline__ void store(float* p, int ld) const {
    wmma::store_matrix_sync(p, f, ld, wmma::mem_row_major);
  }
};
struct AccFma {
  float v[8];
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = 0.0f;
  }
  __device__ __forceinline__ void store(float* p, int ld) const {
    const int lane = threadIdx.x & 31;
    float* q = p + (lane >> 1) * ld + (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) q[j] = v[j];
  }
};
template <typename T> struct AccOf { using type = AccTc; };
template <> struct AccOf<float> { using type = AccFma; };

template <typename T, class LA, class LB>
__device__ __forceinline__ void mma(AccTc& c, const FragA<T, LA>& a, const FragB<T, LB>& b) {
  wmma::mma_sync(c.f, a.f, b.f, c.f);
}
template <class LA, class LB>
__device__ __forceinline__ void mma(AccFma& c, const FragA<float, LA>& a,
                                    const FragB<float, LB>& b) {
  const int lane = threadIdx.x & 31, r = lane >> 1, c0 = (lane & 1) * 8;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    const float av = a.at(r, k);
#pragma unroll
    for (int j = 0; j < 8; ++j) c.v[j] = fmaf(av, b.at(k, c0 + j), c.v[j]);
  }
}

// S[BR x BV] (fp32, row stride lds, shared memory) = x[r0 .. r0+BR) .
// e[v0 .. v0+BV)^T over the whole depth h, through two depth slices in sx and
// se: one loads while the other is computed. Rows of x at or past n load as
// zeros. The warps tile S as WR x WC. Ends with S visible to every thread.
// Copies the caller started before the call complete at its first wait.
template <typename T, int BR, int BV, int WR, int WC>
__device__ void logits_tile(const T* __restrict__ x, const T* __restrict__ e,
                            int n, int h, int r0, int v0, T* sx, T* se, float* S,
                            int lds) {
  constexpr int FR = BR / WR / 16, FC = BV / WC / 16;
  static_assert(WR * WC == WARPS && FR >= 1 && FC >= 1, "warp tiling");
  const int warp = threadIdx.x >> 5;
  const int wr = warp / WC, wc = warp % WC;
  typename AccOf<T>::type acc[FR][FC];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j) acc[i][j].zero();
  const T* xg = x + (long)r0 * h;
  const T* eg = e + (long)v0 * h;
  const int nk = h / BK;
  load_async<T>(sx, LD, xg, h, BR, BK, n - r0);
  load_async<T>(se, LD, eg, h, BV, BK, BV);
  cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    // slice kt has landed, and every warp is done with slice kt - 1, whose
    // buffer the next load takes
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < nk) {
      const int nb = (kt + 1) & 1, k0 = (kt + 1) * BK;
      load_async<T>(sx + nb * BR * LD, LD, xg + k0, h, BR, BK, n - r0);
      load_async<T>(se + nb * BV * LD, LD, eg + k0, h, BV, BK, BV);
    }
    cp_async_commit();
    const T* ax = sx + (kt & 1) * BR * LD;
    const T* be = se + (kt & 1) * BV * LD;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      FragA<T, Row> a[FR];
#pragma unroll
      for (int i = 0; i < FR; ++i) a[i].load(ax + (wr * FR * 16 + i * 16) * LD + kk, LD);
#pragma unroll
      for (int j = 0; j < FC; ++j) {
        FragB<T, Col> b;   // B(k, c) = E[c][k]
        b.load(be + (wc * FC * 16 + j * 16) * LD + kk, LD);
#pragma unroll
        for (int i = 0; i < FR; ++i) mma(acc[i][j], a[i], b);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < FC; ++j)
      acc[i][j].store(S + (wr * FR * 16 + i * 16) * lds + wc * FC * 16 + j * 16, lds);
  __syncthreads();
}

// Shared memory of one block, carved in 128-byte aligned pieces.
struct Carve {
  unsigned char* p;
  template <typename U> __device__ U* take(size_t count) {
    U* out = reinterpret_cast<U*>(p);
    p += (count * sizeof(U) + 127) / 128 * 128;
    return out;
  }
};
constexpr size_t piece(size_t bytes) { return (bytes + 127) / 128 * 128; }

template <typename T> constexpr size_t fwd_smem() {
  return piece(2 * FWD_ROWS * LD * sizeof(T)) + piece(2 * FWD_VOCAB * LD * sizeof(T)) +
         piece(FWD_ROWS * (FWD_VOCAB + 4) * sizeof(float)) +
         piece(4 * FWD_ROWS * sizeof(float)) + piece(FWD_ROWS * sizeof(int));
}
template <typename T> constexpr size_t dx_smem() {
  return piece(2 * DX_ROWS * LD * sizeof(T)) + piece(2 * DX_VOCAB * LD * sizeof(T)) +
         piece(DX_ROWS * (DX_VOCAB + 4) * sizeof(float)) +
         piece(DX_ROWS * (DX_VOCAB + PAD) * sizeof(T)) +
         piece(2 * bk2<T>() * LDE * sizeof(T)) + 3 * piece(DX_ROWS * sizeof(float));
}
template <typename T> constexpr size_t de_smem() {
  return piece(2 * DE_ROWS * LD * sizeof(T)) + piece(2 * DE_VOCAB * LD * sizeof(T)) +
         piece(DE_ROWS * (DE_VOCAB + 4) * sizeof(float)) +
         piece(DE_ROWS * (DE_VOCAB + PAD) * sizeof(T)) +
         piece(2 * bk2<T>() * LDE * sizeof(T)) + 3 * piece(DE_ROWS * sizeof(float));
}

// ---- K7: forward partials over one vocabulary share, then the combine -----
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
xent_fwd_partial_kernel(const T* __restrict__ x, const T* __restrict__ e,
                        const int* __restrict__ labels, float* __restrict__ part,
                        int n, int V, int h, int nsplit, int smoothing) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDS = FWD_VOCAB + 4;
  Carve c{smem};
  T* sx = c.take<T>(2 * FWD_ROWS * LD);
  T* se = c.take<T>(2 * FWD_VOCAB * LD);
  float* S = c.take<float>(FWD_ROWS * LDS);
  float* st = c.take<float>(4 * FWD_ROWS);   // m, s, t, u of each row
  int* lab = c.take<int>(FWD_ROWS);
  const int r0 = blockIdx.x * FWD_ROWS, split = blockIdx.y;
  const int tiles = V / FWD_VOCAB;
  const int t0 = (int)((long)split * tiles / nsplit);
  const int t1 = (int)((long)(split + 1) * tiles / nsplit);
  for (int i = threadIdx.x; i < FWD_ROWS; i += THREADS) {
    st[i] = -INFINITY;
    st[FWD_ROWS + i] = 0.0f;
    st[2 * FWD_ROWS + i] = 0.0f;
    st[3 * FWD_ROWS + i] = 0.0f;
    lab[i] = r0 + i < n ? labels[r0 + i] : -1;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int ROWS_PER_WARP = FWD_ROWS / WARPS;
  // the blocks of a share start their walk at FWD_START_GROUPS different
  // tiles of it, so that they do not all read the same lines of L2 at once
  const int span = t1 - t0;
  const int first = (int)((long)(blockIdx.x % FWD_START_GROUPS) * span / FWD_START_GROUPS);
  for (int step = 0; step < span; ++step) {
    const int vt = t0 + (first + step < span ? first + step : first + step - span);
    const int v0 = vt * FWD_VOCAB;
    logits_tile<T, FWD_ROWS, FWD_VOCAB, 4, 2>(x, e, n, h, r0, v0, sx, se, S, LDS);
    // each warp owns 16 rows; its lanes read a row's 128 logits, 4 apiece
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = warp * ROWS_PER_WARP + i;
      const float* row = S + r * LDS;
      float z[FWD_VOCAB / 32];
      float mx = -INFINITY;
#pragma unroll
      for (int q = 0; q < FWD_VOCAB / 32; ++q) {
        z[q] = row[lane + 32 * q];
        mx = fmaxf(mx, z[q]);
      }
      mx = warp_max(mx);
      const float m_old = st[r], m_new = fmaxf(m_old, mx);
      float se_sum = 0.0f, u = 0.0f;
#pragma unroll
      for (int q = 0; q < FWD_VOCAB / 32; ++q) {
        se_sum += expf(z[q] - m_new);
        u += z[q];
      }
      se_sum = warp_sum(se_sum);
      if (smoothing) u = warp_sum(u);
      if (lane == 0) {
        st[r] = m_new;
        st[FWD_ROWS + r] = st[FWD_ROWS + r] * expf(m_old - m_new) + se_sum;
        const int lc = lab[r] - v0;
        if (lc >= 0 && lc < FWD_VOCAB) st[2 * FWD_ROWS + r] += row[lc];
        if (smoothing) st[3 * FWD_ROWS + r] += u;
      }
    }
    __syncthreads();   // the next tile rewrites S
  }
  for (int i = threadIdx.x; i < FWD_ROWS; i += THREADS) {
    if (r0 + i >= n) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      part[((long)k * nsplit + split) * n + r0 + i] = st[k * FWD_ROWS + i];
  }
}

__global__ void xent_fwd_combine_kernel(const float* __restrict__ part,
                                        float* __restrict__ loss,
                                        float* __restrict__ lse, int n,
                                        int nsplit, float eps, float vocab) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long plane = (long)nsplit * n;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part[(long)s * n + r]);
  float sum = 0.0f, t = 0.0f, u = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const long i = (long)s * n + r;
    sum += part[plane + i] * expf(part[i] - m);
    t += part[2 * plane + i];
    u += part[3 * plane + i];
  }
  const float l = m + logf(sum);
  lse[r] = l;
  loss[r] = eps != 0.0f ? l - (1.0f - eps) * t - eps * u / vocab : l - t;
}

// K7p's second stage: the per-share partials folded, in the same fixed order,
// into the row's (max, sum of exponentials at that max, target, logits sum),
// the four fp32 partials of one vocabulary shard that the cross-rank combine
// of _fwd_sharded :350-361 takes. It forms no lse.
__global__ void xent_fwd_partials_combine_kernel(const float* __restrict__ part,
                                                 float* __restrict__ out, int n,
                                                 int nsplit) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n) return;
  const long plane = (long)nsplit * n;
  float m = -INFINITY;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part[(long)s * n + r]);
  float sum = 0.0f, t = 0.0f, u = 0.0f;
  for (int s = 0; s < nsplit; ++s) {
    const long i = (long)s * n + r;
    sum += part[plane + i] * expf(part[i] - m);
    t += part[2 * plane + i];
    u += part[3 * plane + i];
  }
  out[r] = m;
  out[n + r] = sum;
  out[2 * n + r] = t;
  out[3 * n + r] = u;
}

// ---- K8 and K9, the general form: fp32, and bf16/fp16 at widths the
// tensor-core body does not take --------------------------------------------

// K8: dX
template <typename T>
__device__ __forceinline__ void dx_general(const T* __restrict__ x, const T* __restrict__ e,
                                           const int* __restrict__ labels,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ dl,
                                           T* __restrict__ dx, int n, int V, int h,
                                           float eps, int v_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDS = DX_VOCAB + 4, LDC = DX_VOCAB + PAD, K2 = bk2<T>();
  Carve c{smem};
  constexpr int NKS = DX_VOCAB / K2;
  T* sx = c.take<T>(2 * DX_ROWS * LD);
  T* se = c.take<T>(2 * DX_VOCAB * LD);
  float* S = c.take<float>(DX_ROWS * LDS);
  T* C = c.take<T>(DX_ROWS * LDC);
  T* E2 = c.take<T>(2 * K2 * LDE);
  float* lse_s = c.take<float>(DX_ROWS);
  float* dl_s = c.take<float>(DX_ROWS);
  int* lab_s = c.take<int>(DX_ROWS);
  const int r0 = blockIdx.x * DX_ROWS, c0 = blockIdx.y * COLS;
  const int ncols = min(COLS, h - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = threadIdx.x; i < DX_ROWS; i += THREADS) {
    const bool live = r0 + i < n;
    lse_s[i] = live ? lse[r0 + i] : 0.0f;
    dl_s[i] = live ? dl[r0 + i] : 0.0f;
    lab_s[i] = live ? labels[r0 + i] : -1;
  }
  __syncthreads();
  constexpr int FR = DX_ROWS / 16;
  typename AccOf<T>::type acc[FR][CG];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[i][j].zero();
  const float uniform = eps / (float)v_total;
  for (int v0 = 0; v0 < V; v0 += DX_VOCAB) {
    // the product's first two slices of E load with the logits
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      load_async<T>(E2 + ks * K2 * LDE, LDE, e + (long)(v0 + ks * K2) * h + c0, h, K2,
                    ncols, K2);
      cp_async_commit();
    }
    logits_tile<T, DX_ROWS, DX_VOCAB, 2, 4>(x, e, n, h, r0, v0, sx, se, S, LDS);
    for (int i = threadIdx.x; i < DX_ROWS * DX_VOCAB; i += THREADS) {
      const int r = i / DX_VOCAB, col = i - r * DX_VOCAB;
      float cf = 0.0f;
      if (r0 + r < n) {
        // (p - (1 - eps) hit) - eps / V, the TPU kernel's order
        cf = expf(S[r * LDS + col] - lse_s[r]);
        if (v0 + col == lab_s[r]) cf -= 1.0f - eps;
        cf -= uniform;
      }
      C[r * LDC + col] = from_f<T>(cf);
    }
    for (int ks = 0; ks < NKS; ++ks) {
      cp_async_wait<1>();   // slice ks has landed
      __syncthreads();
      const T* b = E2 + (ks & 1) * K2 * LDE;
#pragma unroll
      for (int kk = 0; kk < K2; kk += 16) {
        FragA<T, Row> a[FR];
#pragma unroll
        for (int i = 0; i < FR; ++i) a[i].load(C + i * 16 * LDC + ks * K2 + kk, LDC);
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int col = warp * WARP_COLS + j * 16;
          if (col >= ncols) continue;
          FragB<T, Row> fb;   // B(k, c) = E[v0 + k][c0 + c]
          fb.load(b + kk * LDE + col, LDE);
#pragma unroll
          for (int i = 0; i < FR; ++i) mma(acc[i][j], a[i], fb);
        }
      }
      __syncthreads();
      if (ks + 2 < NKS)
        load_async<T>(E2 + (ks & 1) * K2 * LDE, LDE,
                      e + (long)(v0 + (ks + 2) * K2) * h + c0, h, K2, ncols, K2);
      cp_async_commit();
    }
  }
  // dX = dl * acc in x's dtype, through a per-warp staging tile
  float* scratch = reinterpret_cast<float*>(E2) + warp * 16 * SCRATCH_LD;
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int col = warp * WARP_COLS + j * 16;
      if (col >= ncols) continue;
      acc[i][j].store(scratch, SCRATCH_LD);
      __syncwarp();
      for (int k = lane; k < 256; k += 32) {
        const int rr = k >> 4, cc = k & 15, r = r0 + i * 16 + rr;
        if (r < n)
          dx[(long)r * h + c0 + col + cc] =
              from_f<T>(dl_s[i * 16 + rr] * scratch[rr * SCRATCH_LD + cc]);
      }
      __syncwarp();
    }
}

// K9: dE
template <typename T>
__device__ __forceinline__ void de_general(const T* __restrict__ x, const T* __restrict__ e,
                                           const int* __restrict__ labels,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ dl,
                                           T* __restrict__ de, int n, int V, int h,
                                           float eps, int v_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LDS = DE_VOCAB + 4, LDC = DE_VOCAB + PAD, K2 = bk2<T>();
  constexpr int VEC = 16 / sizeof(T);
  Carve c{smem};
  constexpr int NKS = DE_ROWS / K2;
  T* sx = c.take<T>(2 * DE_ROWS * LD);
  T* se = c.take<T>(2 * DE_VOCAB * LD);
  float* S = c.take<float>(DE_ROWS * LDS);
  T* C = c.take<T>(DE_ROWS * LDC);
  T* X2 = c.take<T>(2 * K2 * LDE);
  float* lse_s = c.take<float>(DE_ROWS);
  float* dl_s = c.take<float>(DE_ROWS);
  int* lab_s = c.take<int>(DE_ROWS);
  const int v0 = blockIdx.x * DE_VOCAB, c0 = blockIdx.y * COLS;
  const int ncols = min(COLS, h - c0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int FV = DE_VOCAB / 16;
  typename AccOf<T>::type acc[FV][CG];
#pragma unroll
  for (int i = 0; i < FV; ++i)
#pragma unroll
    for (int j = 0; j < CG; ++j) acc[i][j].zero();
  const float uniform = eps / (float)v_total;
  for (int r0 = 0; r0 < n; r0 += DE_ROWS) {
    for (int i = threadIdx.x; i < DE_ROWS; i += THREADS) {
      const bool live = r0 + i < n;
      lse_s[i] = live ? lse[r0 + i] : 0.0f;
      dl_s[i] = live ? dl[r0 + i] : 0.0f;
      lab_s[i] = live ? labels[r0 + i] : -1;
    }
    // the product's first two slices of x load with the logits
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const int rs = r0 + ks * K2;
      load_async<T>(X2 + ks * K2 * LDE, LDE, x + (long)rs * h + c0, h, K2, ncols,
                    n - rs);
      cp_async_commit();
    }
    logits_tile<T, DE_ROWS, DE_VOCAB, 4, 2>(x, e, n, h, r0, v0, sx, se, S, LDS);
    for (int i = threadIdx.x; i < DE_ROWS * DE_VOCAB; i += THREADS) {
      const int r = i / DE_VOCAB, col = i - r * DE_VOCAB;
      float cf = 0.0f;
      if (r0 + r < n) {
        // (p - (1 - eps) hit) - eps / V, the TPU kernel's order
        cf = expf(S[r * LDS + col] - lse_s[r]);
        if (v0 + col == lab_s[r]) cf -= 1.0f - eps;
        cf -= uniform;
      }
      C[r * LDC + col] = from_f<T>(cf);
    }
    for (int ks = 0; ks < NKS; ++ks) {
      cp_async_wait<1>();   // slice ks has landed
      __syncthreads();
      // wx = dl * x in x's dtype, in place
      T* xs = X2 + (ks & 1) * K2 * LDE;
      const int vecs = ncols / VEC;
      for (int i = threadIdx.x; i < K2 * vecs; i += THREADS) {
        const int rr = i / vecs, cc = (i - rr * vecs) * VEC;
        const float w = dl_s[ks * K2 + rr];
        T* p = xs + rr * LDE + cc;
        alignas(16) T v[VEC];
        *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(p);
#pragma unroll
        for (int q = 0; q < VEC; ++q) v[q] = from_f<T>(w * to_f(v[q]));
        *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(v);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < K2; kk += 16) {
        FragA<T, Col> a[FV];   // A(v, k) = coeff[row k][vocab v]
#pragma unroll
        for (int i = 0; i < FV; ++i) a[i].load(C + (ks * K2 + kk) * LDC + i * 16, LDC);
#pragma unroll
        for (int j = 0; j < CG; ++j) {
          const int col = warp * WARP_COLS + j * 16;
          if (col >= ncols) continue;
          FragB<T, Row> fb;   // B(k, c) = wx[row k][c0 + c]
          fb.load(xs + kk * LDE + col, LDE);
#pragma unroll
          for (int i = 0; i < FV; ++i) mma(acc[i][j], a[i], fb);
        }
      }
      __syncthreads();
      if (ks + 2 < NKS) {
        const int rs = r0 + (ks + 2) * K2;
        load_async<T>(xs, LDE, x + (long)rs * h + c0, h, K2, ncols, n - rs);
      }
      cp_async_commit();
    }
  }
  float* scratch = reinterpret_cast<float*>(X2) + warp * 16 * SCRATCH_LD;
#pragma unroll
  for (int i = 0; i < FV; ++i)
#pragma unroll
    for (int j = 0; j < CG; ++j) {
      const int col = warp * WARP_COLS + j * 16;
      if (col >= ncols) continue;
      acc[i][j].store(scratch, SCRATCH_LD);
      __syncwarp();
      for (int k = lane; k < 256; k += 32) {
        const int rr = k >> 4, cc = k & 15;
        de[(long)(v0 + i * 16 + rr) * h + c0 + col + cc] =
            from_f<T>(scratch[rr * SCRATCH_LD + cc]);
      }
      __syncwarp();
    }
}

// fp32 computes on the CUDA cores (AccFma), bf16/fp16 on wmma fragments
#define XENT_GENERAL(NAME, BODY)                                                    \
  template <typename T>                                                           \
  __global__ void __launch_bounds__(THREADS, 1)                                   \
      NAME(const T* __restrict__ x, const T* __restrict__ e,                      \
           const int* __restrict__ labels, const float* __restrict__ lse,         \
           const float* __restrict__ dl, T* __restrict__ out, int n, int V, int h, \
           float eps, int v_total) {                                              \
    BODY<T>(x, e, labels, lse, dl, out, n, V, h, eps, v_total);                   \
  }
XENT_GENERAL(xent_dx_simt, dx_general)
XENT_GENERAL(xent_de_simt, de_general)
XENT_GENERAL(xent_dx_wmma, dx_general)
XENT_GENERAL(xent_de_wmma, de_general)
#undef XENT_GENERAL

// ---- K8 and K9 on the tensor cores: bf16 and fp16, h % 64 == 0, h <= 1024 --
// (the design is in the header). The toolbox below is prefill_attention.cu's
// and attention_bwd.cu's; each source keeps its own copy, since the build
// hashes one source alone.

// two consumer warpgroups, each holding 64 x 384 fp32 accumulators (192
// registers a thread; three warpgroups of 64 x 256 spill under the 168
// registers 384 threads may have)
constexpr int TC_WGS = 2;
constexpr int TC_THREADS = 128 * TC_WGS;        // 256
constexpr int TC_OWN = 64;                      // owned rows of a block
constexpr int TC_COLS = 768;                    // a block's column window
constexpr int TC_WG_COLS = TC_COLS / TC_WGS;    // 384, a warpgroup's columns
constexpr int TC_MAIN_H = 768;                  // the width the main body is built for
constexpr int TC_MAX_H = 1024;
constexpr float LOG2E = 1.4426950408889634f;
// The streamed tiles' first row: K8's blocks all start at E's first tile,
// so that they read each tile from device memory about once; K9's blocks
// start at 8 points of x (in L2). On an H100 at the training shape these
// beat 16 points for K8 (2.74 against 2.78-2.81 ms) and one point or one a
// block for K9 (3.42-3.44 against 3.48-3.50 and 3.52-3.54 ms).
constexpr int DX_STARTS = 1, DE_STARTS = 8;

// the widths the tensor-core body takes
bool tc_takes(int h) { return h % 64 == 0 && h <= TC_MAX_H; }

// the owned tile, two streamed stages of B rows, C, the S partials each
// warpgroup hands the other (B / 8 x 128 float2 a warpgroup), K9's and
// K8's row vectors, the stages' mbarriers, and 1 KB of alignment
template <int B> size_t tc_smem(int h) {
  return (size_t)128 * h + (size_t)4 * B * h + 8192 + (size_t)TC_WGS * B * 16 * 8 +
         3 * 2 * B * 4 + 3 * TC_OWN * 4 + 16 + 1024;
}

#define WGMMA_SS_N16(TY)                                            \
  asm volatile(                                                     \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"                  \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"  \
      "%0, %1, %2, %3, %4, %5, %6, %7 "                             \
      "}, %8, %9, p, 1, 1, 0, 0;\n}\n"                              \
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), \
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3])  \
      : "l"(da), "l"(db), "r"(acc))

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

#define WGMMA_SS_N64_TB(TY, D0)                                                         \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "          \
      "%30, %31 "                                                                       \
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"                                                \
      : "+f"(d[D0 + 0][0]), "+f"(d[D0 + 0][1]), "+f"(d[D0 + 0][2]), "+f"(d[D0 + 0][3]), \
        "+f"(d[D0 + 1][0]), "+f"(d[D0 + 1][1]), "+f"(d[D0 + 1][2]), "+f"(d[D0 + 1][3]), \
        "+f"(d[D0 + 2][0]), "+f"(d[D0 + 2][1]), "+f"(d[D0 + 2][2]), "+f"(d[D0 + 2][3]), \
        "+f"(d[D0 + 3][0]), "+f"(d[D0 + 3][1]), "+f"(d[D0 + 3][2]), "+f"(d[D0 + 3][3]), \
        "+f"(d[D0 + 4][0]), "+f"(d[D0 + 4][1]), "+f"(d[D0 + 4][2]), "+f"(d[D0 + 4][3]), \
        "+f"(d[D0 + 5][0]), "+f"(d[D0 + 5][1]), "+f"(d[D0 + 5][2]), "+f"(d[D0 + 5][3]), \
        "+f"(d[D0 + 6][0]), "+f"(d[D0 + 6][1]), "+f"(d[D0 + 6][2]), "+f"(d[D0 + 6][3]), \
        "+f"(d[D0 + 7][0]), "+f"(d[D0 + 7][1]), "+f"(d[D0 + 7][2]), "+f"(d[D0 + 7][3])  \
      : "l"(da), "l"(db), "r"(acc))

#define WGMMA_SS_N128_TB(TY, D0)                                                            \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "              \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "              \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "              \
      "%58, %59, %60, %61, %62, %63 "                                                       \
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"                                                    \
      : "+f"(d[D0 + 0][0]), "+f"(d[D0 + 0][1]), "+f"(d[D0 + 0][2]), "+f"(d[D0 + 0][3]),     \
        "+f"(d[D0 + 1][0]), "+f"(d[D0 + 1][1]), "+f"(d[D0 + 1][2]), "+f"(d[D0 + 1][3]),     \
        "+f"(d[D0 + 2][0]), "+f"(d[D0 + 2][1]), "+f"(d[D0 + 2][2]), "+f"(d[D0 + 2][3]),     \
        "+f"(d[D0 + 3][0]), "+f"(d[D0 + 3][1]), "+f"(d[D0 + 3][2]), "+f"(d[D0 + 3][3]),     \
        "+f"(d[D0 + 4][0]), "+f"(d[D0 + 4][1]), "+f"(d[D0 + 4][2]), "+f"(d[D0 + 4][3]),     \
        "+f"(d[D0 + 5][0]), "+f"(d[D0 + 5][1]), "+f"(d[D0 + 5][2]), "+f"(d[D0 + 5][3]),     \
        "+f"(d[D0 + 6][0]), "+f"(d[D0 + 6][1]), "+f"(d[D0 + 6][2]), "+f"(d[D0 + 6][3]),     \
        "+f"(d[D0 + 7][0]), "+f"(d[D0 + 7][1]), "+f"(d[D0 + 7][2]), "+f"(d[D0 + 7][3]),     \
        "+f"(d[D0 + 8][0]), "+f"(d[D0 + 8][1]), "+f"(d[D0 + 8][2]), "+f"(d[D0 + 8][3]),     \
        "+f"(d[D0 + 9][0]), "+f"(d[D0 + 9][1]), "+f"(d[D0 + 9][2]), "+f"(d[D0 + 9][3]),     \
        "+f"(d[D0 + 10][0]), "+f"(d[D0 + 10][1]), "+f"(d[D0 + 10][2]), "+f"(d[D0 + 10][3]), \
        "+f"(d[D0 + 11][0]), "+f"(d[D0 + 11][1]), "+f"(d[D0 + 11][2]), "+f"(d[D0 + 11][3]), \
        "+f"(d[D0 + 12][0]), "+f"(d[D0 + 12][1]), "+f"(d[D0 + 12][2]), "+f"(d[D0 + 12][3]), \
        "+f"(d[D0 + 13][0]), "+f"(d[D0 + 13][1]), "+f"(d[D0 + 13][2]), "+f"(d[D0 + 13][3]), \
        "+f"(d[D0 + 14][0]), "+f"(d[D0 + 14][1]), "+f"(d[D0 + 14][2]), "+f"(d[D0 + 14][3]), \
        "+f"(d[D0 + 15][0]), "+f"(d[D0 + 15][1]), "+f"(d[D0 + 15][2]), "+f"(d[D0 + 15][3])  \
      : "l"(da), "l"(db), "r"(acc))

// TB: "1" reads b MN-major (the transpose bit), "0" K-major
#define WGMMA_SS_N256(TY, D0, TB)                                                           \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"                                         \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"                         \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "              \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "              \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "              \
      "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "              \
      "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "              \
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "              \
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "            \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "            \
      "%124, %125, %126, %127 "                                                             \
      "}, %128, %129, p, 1, 1, 0, " TB ";\n}\n"                                        \
      : "+f"(d[D0 + 0][0]), "+f"(d[D0 + 0][1]), "+f"(d[D0 + 0][2]), "+f"(d[D0 + 0][3]),     \
        "+f"(d[D0 + 1][0]), "+f"(d[D0 + 1][1]), "+f"(d[D0 + 1][2]), "+f"(d[D0 + 1][3]),     \
        "+f"(d[D0 + 2][0]), "+f"(d[D0 + 2][1]), "+f"(d[D0 + 2][2]), "+f"(d[D0 + 2][3]),     \
        "+f"(d[D0 + 3][0]), "+f"(d[D0 + 3][1]), "+f"(d[D0 + 3][2]), "+f"(d[D0 + 3][3]),     \
        "+f"(d[D0 + 4][0]), "+f"(d[D0 + 4][1]), "+f"(d[D0 + 4][2]), "+f"(d[D0 + 4][3]),     \
        "+f"(d[D0 + 5][0]), "+f"(d[D0 + 5][1]), "+f"(d[D0 + 5][2]), "+f"(d[D0 + 5][3]),     \
        "+f"(d[D0 + 6][0]), "+f"(d[D0 + 6][1]), "+f"(d[D0 + 6][2]), "+f"(d[D0 + 6][3]),     \
        "+f"(d[D0 + 7][0]), "+f"(d[D0 + 7][1]), "+f"(d[D0 + 7][2]), "+f"(d[D0 + 7][3]),     \
        "+f"(d[D0 + 8][0]), "+f"(d[D0 + 8][1]), "+f"(d[D0 + 8][2]), "+f"(d[D0 + 8][3]),     \
        "+f"(d[D0 + 9][0]), "+f"(d[D0 + 9][1]), "+f"(d[D0 + 9][2]), "+f"(d[D0 + 9][3]),     \
        "+f"(d[D0 + 10][0]), "+f"(d[D0 + 10][1]), "+f"(d[D0 + 10][2]), "+f"(d[D0 + 10][3]), \
        "+f"(d[D0 + 11][0]), "+f"(d[D0 + 11][1]), "+f"(d[D0 + 11][2]), "+f"(d[D0 + 11][3]), \
        "+f"(d[D0 + 12][0]), "+f"(d[D0 + 12][1]), "+f"(d[D0 + 12][2]), "+f"(d[D0 + 12][3]), \
        "+f"(d[D0 + 13][0]), "+f"(d[D0 + 13][1]), "+f"(d[D0 + 13][2]), "+f"(d[D0 + 13][3]), \
        "+f"(d[D0 + 14][0]), "+f"(d[D0 + 14][1]), "+f"(d[D0 + 14][2]), "+f"(d[D0 + 14][3]), \
        "+f"(d[D0 + 15][0]), "+f"(d[D0 + 15][1]), "+f"(d[D0 + 15][2]), "+f"(d[D0 + 15][3]), \
        "+f"(d[D0 + 16][0]), "+f"(d[D0 + 16][1]), "+f"(d[D0 + 16][2]), "+f"(d[D0 + 16][3]), \
        "+f"(d[D0 + 17][0]), "+f"(d[D0 + 17][1]), "+f"(d[D0 + 17][2]), "+f"(d[D0 + 17][3]), \
        "+f"(d[D0 + 18][0]), "+f"(d[D0 + 18][1]), "+f"(d[D0 + 18][2]), "+f"(d[D0 + 18][3]), \
        "+f"(d[D0 + 19][0]), "+f"(d[D0 + 19][1]), "+f"(d[D0 + 19][2]), "+f"(d[D0 + 19][3]), \
        "+f"(d[D0 + 20][0]), "+f"(d[D0 + 20][1]), "+f"(d[D0 + 20][2]), "+f"(d[D0 + 20][3]), \
        "+f"(d[D0 + 21][0]), "+f"(d[D0 + 21][1]), "+f"(d[D0 + 21][2]), "+f"(d[D0 + 21][3]), \
        "+f"(d[D0 + 22][0]), "+f"(d[D0 + 22][1]), "+f"(d[D0 + 22][2]), "+f"(d[D0 + 22][3]), \
        "+f"(d[D0 + 23][0]), "+f"(d[D0 + 23][1]), "+f"(d[D0 + 23][2]), "+f"(d[D0 + 23][3]), \
        "+f"(d[D0 + 24][0]), "+f"(d[D0 + 24][1]), "+f"(d[D0 + 24][2]), "+f"(d[D0 + 24][3]), \
        "+f"(d[D0 + 25][0]), "+f"(d[D0 + 25][1]), "+f"(d[D0 + 25][2]), "+f"(d[D0 + 25][3]), \
        "+f"(d[D0 + 26][0]), "+f"(d[D0 + 26][1]), "+f"(d[D0 + 26][2]), "+f"(d[D0 + 26][3]), \
        "+f"(d[D0 + 27][0]), "+f"(d[D0 + 27][1]), "+f"(d[D0 + 27][2]), "+f"(d[D0 + 27][3]), \
        "+f"(d[D0 + 28][0]), "+f"(d[D0 + 28][1]), "+f"(d[D0 + 28][2]), "+f"(d[D0 + 28][3]), \
        "+f"(d[D0 + 29][0]), "+f"(d[D0 + 29][1]), "+f"(d[D0 + 29][2]), "+f"(d[D0 + 29][3]), \
        "+f"(d[D0 + 30][0]), "+f"(d[D0 + 30][1]), "+f"(d[D0 + 30][2]), "+f"(d[D0 + 30][3]), \
        "+f"(d[D0 + 31][0]), "+f"(d[D0 + 31][1]), "+f"(d[D0 + 31][2]), "+f"(d[D0 + 31][3])  \
      : "l"(da), "l"(db), "r"(acc))

#define WGMMA_SS_N256_TB(TY, D0) WGMMA_SS_N256(TY, D0, "1")

#define WGMMA_RS_N64(TY, D0)                                                            \
  asm volatile(                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                      \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "          \
      "%30, %31 "                                                                       \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                  \
      : "+f"(d[D0 + 0][0]), "+f"(d[D0 + 0][1]), "+f"(d[D0 + 0][2]), "+f"(d[D0 + 0][3]), \
        "+f"(d[D0 + 1][0]), "+f"(d[D0 + 1][1]), "+f"(d[D0 + 1][2]), "+f"(d[D0 + 1][3]), \
        "+f"(d[D0 + 2][0]), "+f"(d[D0 + 2][1]), "+f"(d[D0 + 2][2]), "+f"(d[D0 + 2][3]), \
        "+f"(d[D0 + 3][0]), "+f"(d[D0 + 3][1]), "+f"(d[D0 + 3][2]), "+f"(d[D0 + 3][3]), \
        "+f"(d[D0 + 4][0]), "+f"(d[D0 + 4][1]), "+f"(d[D0 + 4][2]), "+f"(d[D0 + 4][3]), \
        "+f"(d[D0 + 5][0]), "+f"(d[D0 + 5][1]), "+f"(d[D0 + 5][2]), "+f"(d[D0 + 5][3]), \
        "+f"(d[D0 + 6][0]), "+f"(d[D0 + 6][1]), "+f"(d[D0 + 6][2]), "+f"(d[D0 + 6][3]), \
        "+f"(d[D0 + 7][0]), "+f"(d[D0 + 7][1]), "+f"(d[D0 + 7][2]), "+f"(d[D0 + 7][3])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(acc))

// The products of one 16-bit input type (bf16 or fp16), fp32 accumulators.
// A warpgroup holds d (64 x N) in the m16n8 C layout: thread (g = lane / 4,
// t = lane % 4) of warp w has rows 16w + g and 16w + g + 8, columns 8j + 2t
// and 8j + 2t + 1, as d[j][0..1] and d[j][2..3]. acc = 0 writes d = a b,
// ignoring d's old contents; acc = 1 adds.
template <typename T> struct Tc {
  static constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  // S's partial, m64nBk16: a and b K-major
  template <int B>
  static __device__ __forceinline__ void s_part(float (&d)[B / 8][4], uint64_t da,
                                                uint64_t db, int acc) {
    static_assert(B == 16 || B == 32, "streamed rows");
    if constexpr (B == 16 && BF16) WGMMA_SS_N16("bf16");
    else if constexpr (B == 16) WGMMA_SS_N16("f16");
    else if constexpr (BF16) WGMMA_SS_N32("bf16");
    else WGMMA_SS_N32("f16");
  }
  // the gradient product into columns 8 D0 .. 8 D0 + N - 1 of d: a
  // K-major, b MN-major (the transpose bit)
  template <int N, int D0>
  static __device__ __forceinline__ void prod(float (&d)[TC_WG_COLS / 8][4], uint64_t da,
                                              uint64_t db, int acc) {
    static_assert(D0 + N / 8 <= TC_WG_COLS / 8, "accumulator columns");
    if constexpr (N == 256 && BF16) WGMMA_SS_N256_TB("bf16", D0);
    else if constexpr (N == 256) WGMMA_SS_N256_TB("f16", D0);
    else if constexpr (N == 128 && BF16) WGMMA_SS_N128_TB("bf16", D0);
    else if constexpr (N == 128) WGMMA_SS_N128_TB("f16", D0);
    else if constexpr (BF16) WGMMA_SS_N64_TB("bf16", D0);
    else WGMMA_SS_N64_TB("f16", D0);
  }
  // K9's gradient product into columns 8 D0 .. 8 D0 + 63 of d: a from
  // registers (the A fragments of the warp's 16 rows, the layout of mma.sync
  // m16n8k16), b K-major
  template <int D0>
  static __device__ __forceinline__ void rs64(float (&d)[TC_WG_COLS / 8][4],
                                              const uint32_t (&a)[4], uint64_t db, int acc) {
    if constexpr (BF16) WGMMA_RS_N64("bf16", D0);
    else WGMMA_RS_N64("f16", D0);
  }
  // K7's logits tile, m64n256k16 into all of d: a and b K-major
  static __device__ __forceinline__ void logits(float (&d)[32][4], uint64_t da, uint64_t db,
                                                int acc) {
    if constexpr (BF16) WGMMA_SS_N256("bf16", 0, "0");
    else WGMMA_SS_N256("f16", 0, "0");
  }
  // lo in the low half: the lower column index
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    uint32_t r;
    if constexpr (BF16) {
      __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
      r = *reinterpret_cast<uint32_t*>(&v);
    } else {
      __half2 v = __floats2half2_rn(lo, hi);
      r = *reinterpret_cast<uint32_t*>(&v);
    }
    return r;
  }
  static __device__ __forceinline__ float2 unpack(uint32_t r) {
    if constexpr (BF16) return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
    else return __half22float2(*reinterpret_cast<__half2*>(&r));
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
// at most N committed groups of this warpgroup still running
template <int N> __device__ __forceinline__ void wg_wait_n() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// four 8 x 8 16-bit matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8, and r[i] holds elements (2 (l % 4), l / 4) and
// (2 (l % 4) + 1, l / 4) of matrix i, the lower row in the low half
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
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

// 2^x on the SFU (MUFU.EX2)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ unsigned char* align1k(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// Shared tiles of R rows x h 16-bit columns are h/64 panels of R rows x 128
// bytes; in each row the 16-byte chunk c sits at c ^ (row & 7): wgmma's
// canonical 128-byte-swizzled layout (eight-row groups of 1024 bytes), with
// no bank conflicts. Byte offset of chunk c (columns 8c..8c+7) of row r:
template <int R>
__device__ __forceinline__ uint32_t sw(int r, int c) {
  return (uint32_t)((c >> 3) * (R * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4));
}

// a wgmma shared-memory matrix descriptor of a 128-byte-swizzled tile:
// start address, leading byte offset (LBO), stride byte offset (SBO, 1024:
// from one eight-row group to the next), layout 1 (128-byte swizzle), each
// offset in 16-byte units. Tiles start on 1024-byte boundaries. Adding
// bytes / 16 to a descriptor moves its start address.
__device__ __forceinline__ uint64_t desc128(uint32_t addr, uint32_t lbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// An mbarrier of `count` arrivals (one by default), with the bytes of the
// tensor-memory-accelerator (TMA) copies that complete on it: thread 0
// arrives and states the bytes, the copies land, and the phase flips for
// the threads waiting on its parity.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
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
// one box of a tensor map (64 columns x its rows, at column c and row r;
// rows past the matrix read as zeros) into shared memory at dst, in the
// 128-byte swizzle, completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, int c, int r,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(r), "r"(bar)
      : "memory");
}

// the generic body's gradient product: one 64-column product for each 64
// of the warpgroup's ncol columns (PANEL: one panel of the streamed tile, in
// descriptor units)
template <typename T, int PANEL, int C = 0>
__device__ __forceinline__ void prod64(float (&d)[TC_WG_COLS / 8][4], uint64_t a, uint64_t b,
                                       int add, int ncol) {
  if constexpr (C < TC_WG_COLS / 64) {
    if (64 * C < ncol) Tc<T>::template prod<64, 8 * C>(d, a, b + C * PANEL, add);
    prod64<T, PANEL, C + 1>(d, a, b, add, ncol);
  }
}

// K9's gradient product, dE^T (the warpgroup's columns of h x the 64 owned
// rows) += wx^T C^T, one m64n64 product for each 64 columns M of `groups`
// and each 16-row k step: wx^T, the A operand, from x by ldmatrix.trans
// (xa: this lane's address for M = 0, k step 0), times dl (dlk: the
// lane's rows 2t, 2t + 1 and 2t + 8, 2t + 9 of each k step) and rounded to
// T in registers; C (owned x streamed rows, K-major), the B operand. Group
// M's fragments load while groups M - 1 and M - 2 multiply; a[M % 3] is
// reused once group M - 3 is done.
template <typename T, int B, int M = 0>
__device__ __forceinline__ void wx_products(float (&d)[TC_WG_COLS / 8][4],
                                            uint32_t (&a)[3][B / 16][4], uint32_t xa,
                                            const float2 (&dlk)[B / 16][2], uint32_t sC,
                                            bool add0, int groups) {
  if constexpr (M < TC_WG_COLS / 64) {
    if (M < groups) {
      if constexpr (M >= 3) wg_wait_n<2>();
#pragma unroll
      for (int kk = 0; kk < B / 16; ++kk) {
        uint32_t(&f)[4] = a[M % 3][kk];
        ldsm_x4_t(f, xa + M * (B * 128) + kk * 2048);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 v = Tc<T>::unpack(f[i]), w = dlk[kk][i >> 1];
          f[i] = Tc<T>::pack(w.x * v.x, w.y * v.y);
        }
      }
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < B / 16; ++kk)
        Tc<T>::template rs64<8 * M>(d, a[M % 3][kk], desc128(sC + kk * 32, 16),
                                    add0 || kk > 0);
      wg_commit();
    }
    wx_products<T, B, M + 1>(d, a, xa, dlk, sC, add0, groups);
  }
}

// K8 (DE false): a block owns 64 rows of x and streams E; K9 (DE true): a
// block owns 64 rows of E and streams x, B rows a tile. H = TC_MAIN_H: the
// main body, built for that width (one 768-column window, both warpgroups
// full, trip counts known); H = 0: any other width the tensor cores take,
// with its 768-column windows on blockIdx.y (each recomputing the logits)
// and the warpgroups' products 64 columns each.
template <typename T, bool DE, int B, int H>
__global__ void __launch_bounds__(TC_THREADS, 1)
xent_bwd_tc(const __grid_constant__ CUtensorMap own_map,
            const __grid_constant__ CUtensorMap str_map, const int* __restrict__ labels,
            const float* __restrict__ lse, const float* __restrict__ dl,
            T* __restrict__ out, int n, int V, int h_in, float hit_w, float uniform) {
  constexpr int NJ = TC_WG_COLS / 8, SJ = B / 8;   // n8 blocks: accumulator, S
  const int h = H > 0 ? H : h_in;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = align1k(smem);
  const int stage_bytes = 2 * B * h;
  const uint32_t sOwn = smem_u32(base), sStr = sOwn + 128 * h,
                 sC = sStr + 2 * stage_bytes;
  unsigned char* cs = base + 128 * h + 2 * stage_bytes;          // C, T [64][B]
  float2* part = reinterpret_cast<float2*>(cs + 8192);          // [wg][SJ][128]
  float* str_lse = reinterpret_cast<float*>(part + TC_WGS * SJ * 128);  // K9, [2][B]
  int* str_lab = reinterpret_cast<int*>(str_lse + 2 * B);
  float* str_dl = reinterpret_cast<float*>(str_lab + 2 * B);
  float* own_lse = str_dl + 2 * B;                               // K8, [64]
  int* own_lab = reinterpret_cast<int*>(own_lse + TC_OWN);
  float* own_dl = reinterpret_cast<float*>(own_lab + TC_OWN);
  const uint32_t sBar = smem_u32(own_dl + TC_OWN);               // a stage's mbarrier

  const int tid = threadIdx.x, wg = tid >> 7, wt = tid & 127, lane = tid & 31;
  // the fragment rows of this thread: r_lo and r_lo + 8 of the 64
  const int r_lo = ((wt >> 5) << 4) + (lane >> 2);
  const int own0 = blockIdx.x * TC_OWN;
  const int c0 = H > 0 ? 0 : blockIdx.y * TC_COLS;
  const int cw = H > 0 ? TC_COLS : min(TC_COLS, h - c0);   // the block's columns
  const int wc0 = wg * TC_WG_COLS;               // the warpgroup's first, in them
  const int ncol = H > 0 ? TC_WG_COLS : max(0, min(TC_WG_COLS, cw - wc0));
  const int own_rows = DE ? V : n, str_rows = DE ? n : V;
  const int tiles = (str_rows + B - 1) / B;
  const int starts = DE ? DE_STARTS : DX_STARTS;
  const int t_first = (int)((long)(blockIdx.x % starts) * tiles / starts);

  // step s's streamed tile (s < tiles)
  auto tile_of = [&](int s) {
    const int t = t_first + s;
    return t < tiles ? t : t - tiles;
  };
  // thread 0: step s's tile into stage st by TMA, one box a 64-column panel
  // (with the owned tile, `extra` more bytes on the same barrier)
  auto load = [&](int s, int st, uint32_t extra) {
    const uint32_t bar = sBar + 8 * st;
    mbar_expect(bar, stage_bytes + extra);
    for (int p = 0; p < h / 64; ++p)
      tma_load(sStr + st * stage_bytes + p * (B * 128), &str_map, 64 * p, tile_of(s) * B,
               bar);
  };
  // K9: a streamed tile's lse (times log2 e), dl and labels, read into
  // registers one tile ahead and stored to shared memory beside the tile
  // (zeros and no label past the last row). Nothing uses a loaded value
  // before the next step, so no step waits on a global load.
  float lse_nx = 0.f, dl_nx = 0.f;
  int lab_nx = -1;
  bool ok_nx = false;
  auto rows_of = [&](int s, int st) {
    if (DE && tid < B) {
      if (st >= 0) {
        str_lse[st * B + tid] = ok_nx ? lse_nx * LOG2E : 0.f;
        str_dl[st * B + tid] = ok_nx ? dl_nx : 0.f;
        str_lab[st * B + tid] = ok_nx ? lab_nx : -1;
      }
      ok_nx = s < tiles && tile_of(s) * B + tid < n;
      const int rc = ok_nx ? tile_of(s) * B + tid : 0;
      lse_nx = lse[rc];
      dl_nx = dl[rc];
      lab_nx = labels[rc];
    }
  };

  if (tid == 0) {
    mbar_init(sBar);
    mbar_init(sBar + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int p = 0; p < h / 64; ++p)
      tma_load(sOwn + p * (TC_OWN * 128), &own_map, 64 * p, own0, sBar);
    load(0, 0, 128 * h);
  }
  rows_of(0, -1);
  rows_of(1, 0);

  // Each warpgroup computes S over half the depth; the two halves meet in
  // the coefficient pass, which warpgroup wg runs for the fragment rows of
  // its own half (row_e = r_lo + 8 wg): the other half of its partial goes
  // to the other warpgroup through shared memory.
  const int nk = h >> 4, k_lo = wg * nk / TC_WGS;
  const int k_cnt = H > 0 ? H / 16 / TC_WGS : (wg + 1) * nk / TC_WGS - k_lo;
  const int row_e = r_lo + 8 * wg;
  // K8: the owned rows' lse times log2 e, labels and dl, read from shared
  // memory where used (registers held beside the accumulators would spill)
  if (!DE && tid < TC_OWN) {
    const bool ok = own0 + tid < n;
    own_lse[tid] = ok ? lse[own0 + tid] * LOG2E : 0.f;
    own_lab[tid] = ok ? labels[own0 + tid] : -1;
    own_dl[tid] = ok ? dl[own0 + tid] : 0.f;
  }
  float acc[NJ][4];
  for (int s = 0; s < tiles; ++s) {
    const int st = s & 1;
    // both warpgroups are done with the other stage and with C: the next
    // tile may take that stage; then this one has landed
    __syncthreads();
    if (tid == 0 && s + 1 < tiles) load(s + 1, st ^ 1, 0);
    rows_of(s + 2, st ^ 1);   // K9: step s + 1's row vectors beside its tile
    mbar_wait(sBar + 8 * st, (s >> 1) & 1);
    const uint32_t cur = sStr + st * stage_bytes;

    // S = own . streamed^T (64 x B) over this warpgroup's depth. K step kk
    // is panel kk / 4, 32 bytes (16 columns) times kk % 4 into its rows.
    float sp[SJ][4];
    wg_fence();
    if constexpr (H > 0) {   // k_lo is a multiple of 4: offsets known
      static_assert(H / 16 % (4 * TC_WGS) == 0, "whole panels a warpgroup");
      const uint64_t da = desc128(sOwn + k_lo * (TC_OWN * 128 / 4), 16);
      const uint64_t db = desc128(cur + k_lo * (B * 128 / 4), 16);
#pragma unroll
      for (int i = 0; i < k_cnt; ++i)
        Tc<T>::template s_part<B>(
            sp, da + (((i >> 2) * TC_OWN * 128 + (i & 3) * 32) >> 4),
            db + (((i >> 2) * B * 128 + (i & 3) * 32) >> 4), i > 0);
    } else {
      for (int kk = k_lo; kk < k_lo + k_cnt; ++kk)
        Tc<T>::template s_part<B>(
            sp, desc128(sOwn + (kk >> 2) * (TC_OWN * 128) + (kk & 3) * 32, 16),
            desc128(cur + (kk >> 2) * (B * 128) + (kk & 3) * 32, 16), kk > k_lo);
    }
    wg_commit();
    wg_wait();
    fence_acc(sp);
    // the other warpgroup's rows of this partial (by selects: an index from
    // wg would put sp in local memory)
#pragma unroll
    for (int j = 0; j < SJ; ++j)
      part[(wg * SJ + j) * 128 + wt] =
          wg ? make_float2(sp[j][0], sp[j][1]) : make_float2(sp[j][2], sp[j][3]);
    __syncthreads();

    // coeff = (exp(S - lse) - (1 - eps) hit) - eps / v_total, the TPU
    // kernel's order, rounded to T into C (64 own rows x B streamed rows,
    // K-major). The two partials add in either order to the same bits.
    const int t0 = tile_of(s) * B;
#pragma unroll
    for (int j = 0; j < SJ; ++j) {
      const float2 o = part[((1 - wg) * SJ + j) * 128 + wt];
      const int col = 8 * j + 2 * (lane & 3);
      const float z[2] = {(wg ? sp[j][2] : sp[j][0]) + o.x,
                          (wg ? sp[j][3] : sp[j][1]) + o.y};
      float2 l2;   // lse log2 e and the label of each element's x row
      int2 lab;
      if constexpr (DE) {
        l2 = *reinterpret_cast<const float2*>(str_lse + st * B + col);
        lab = *reinterpret_cast<const int2*>(str_lab + st * B + col);
      } else {
        l2 = make_float2(own_lse[row_e], own_lse[row_e]);
        lab = make_int2(own_lab[row_e], own_lab[row_e]);
      }
      const int who = DE ? own0 + row_e : t0 + col;   // the hit's vocabulary row
      float cf[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        float p = ex2(fmaf(z[u], LOG2E, -(u ? l2.y : l2.x)));
        if ((u ? lab.y : lab.x) == who + (DE ? 0 : u)) p -= hit_w;
        cf[u] = p - uniform;
      }
      *reinterpret_cast<uint32_t*>(cs + sw<TC_OWN>(row_e, j) + 4 * (lane & 3)) =
          Tc<T>::pack(cf[0], cf[1]);
    }
    fence_async_smem();
    __syncthreads();

    if constexpr (DE) {
      // dE^T += wx^T C^T. Lane l's ldmatrix row: x row 8 (l / 16) + l % 8 of
      // the k step, columns 16 (warp) + 8 ((l / 8) % 2) of the 64
      const uint32_t xa =
          cur + ((c0 + wc0) >> 6) * (B * 128) + ((lane >> 4) * 8 + (lane & 7)) * 128 +
          ((((wt >> 5) * 2 + ((lane >> 3) & 1)) ^ (lane & 7)) << 4);
      const float* dls = str_dl + st * B + 2 * (lane & 3);
      float2 dlk[B / 16][2];
#pragma unroll
      for (int kk = 0; kk < B / 16; ++kk) {
        dlk[kk][0] = *reinterpret_cast<const float2*>(dls + 16 * kk);
        dlk[kk][1] = *reinterpret_cast<const float2*>(dls + 16 * kk + 8);
      }
      uint32_t a[3][B / 16][4];
      wx_products<T, B>(acc, a, xa, dlk, sC, s > 0, H > 0 ? TC_WG_COLS / 64 : ncol / 64);
      wg_wait();
      fence_acc(acc);
    } else if (H > 0 || ncol > 0) {
      // dX: acc += C . E[:, this warpgroup's columns], E's tile read MN-major
      // (k step kk is 16 rows, 2048 bytes, on; LBO the panel stride, from one
      // 64 columns to the next)
      const uint64_t da = desc128(sC, 16);
      const uint64_t db = desc128(cur + ((c0 + wc0) >> 6) * (B * 128), B * 128);
      constexpr uint32_t PANEL = B * 128 / 16;   // one panel, in descriptor units
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < B / 16; ++kk) {
        const int add = s > 0 || kk > 0;
        const uint64_t a = da + kk * 2, b = db + kk * 128;   // 32 and 2048 bytes
        if constexpr (H > 0) {
          Tc<T>::template prod<256, 0>(acc, a, b, add);
          Tc<T>::template prod<128, 32>(acc, a, b + 4 * PANEL, add);
        } else {
          prod64<T, PANEL>(acc, a, b, add, ncol);
        }
      }
      wg_commit();
      wg_wait();
      fence_acc(acc);
    }
  }

  // the epilogue: the block's output tile (K8: dl * acc) in T, swizzled, in
  // the owned tile's space, then to device memory in 16-byte chunks
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    if (8 * j >= ncol) continue;
    if constexpr (DE) {   // dE^T: rows 16 (warp) + g (+ 8) of 64 columns j / 8
      const int m = j >> 3, v = 8 * (j & 7) + 2 * (lane & 3);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = v + (e & 1), col = wc0 + 64 * m + r_lo + 8 * (e >> 1);
        *reinterpret_cast<T*>(base + sw<TC_OWN>(row, col >> 3) + (col & 7) * 2) =
            from_f<T>(acc[j][e]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = r_lo + 8 * i, col = wc0 + 8 * j + 2 * (lane & 3);
        // dl read here each time (volatile): two registers held beside all
        // 192 accumulators spill
        const float d = *reinterpret_cast<volatile float*>(own_dl + row);
        *reinterpret_cast<uint32_t*>(base + sw<TC_OWN>(row, col >> 3) + (col & 7) * 2) =
            Tc<T>::pack(d * acc[j][2 * i], d * acc[j][2 * i + 1]);
      }
    }
  }
  __syncthreads();
  const int cpr = cw >> 3;
  for (int k = tid; k < TC_OWN * cpr; k += TC_THREADS) {
    const int r = k / cpr, c = k - r * cpr;
    if (own0 + r < own_rows)
      *reinterpret_cast<uint4*>(out + (size_t)(own0 + r) * h + c0 + 8 * c) =
          *reinterpret_cast<const uint4*>(base + sw<TC_OWN>(r, c));
  }
}

// ---- K7 and K7p's first stage on the tensor cores: bf16 and fp16, h % 64 == 0

// A block takes 128 rows of x, two consumer warpgroups of 64, and walks its
// vocabulary share in 256-wide tiles: each tile's logits are one m64n256
// accumulator a warpgroup (128 fp32 registers a thread) summed over the
// depth in 64-column panels. A producer warp fills a ring of F_STAGES
// stages by TMA, each the x panel (128 x 64) and the E panel (256 x 64) of
// one depth step, and the consumers hand each stage back on its `empty`
// mbarrier once their products have read it; so the next tile's panels
// load while a warpgroup runs the row-state update on its fragment.
constexpr int F_ROWS = 128;                        // x rows of a block
constexpr int F_VOCAB = 256;                       // vocabulary columns of a tile
constexpr int F_STAGES = 4;
constexpr int F_XBYTES = F_ROWS * 128;             // a stage's x panel, 16 KB
constexpr int F_STAGE = F_XBYTES + F_VOCAB * 128;  // and its E panel: 48 KB
constexpr int F_THREADS = 2 * 128 + 32;            // two consumer warpgroups, a producer warp

// the widths the tensor-core forward takes (bf16 and fp16)
bool fwd_tc_takes(int h) { return h % 64 == 0; }

size_t fwd_tc_smem() { return (size_t)F_STAGES * F_STAGE + 2 * F_STAGES * 8 + 1024; }

// the max and the sum over the four threads of a quad, which hold one row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

template <typename T>
__global__ void __launch_bounds__(F_THREADS, 1)
xent_fwd_tc(const __grid_constant__ CUtensorMap x_map,
            const __grid_constant__ CUtensorMap e_map, const int* __restrict__ labels,
            float* __restrict__ part, int n, int V, int h, int nsplit, int smoothing) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t sBuf = smem_u32(align1k(smem));
  const uint32_t full = sBuf + F_STAGES * F_STAGE, empty = full + 8 * F_STAGES;
  const int tid = threadIdx.x, r0 = blockIdx.x * F_ROWS, split = blockIdx.y;
  const int tiles = (V + F_VOCAB - 1) / F_VOCAB;
  const int t0 = (int)((long)split * tiles / nsplit);
  const int t1 = (int)((long)(split + 1) * tiles / nsplit);
  const int panels = h >> 6;
  if (tid == 0) {
    for (int st = 0; st < F_STAGES; ++st) {
      mbar_init(full + 8 * st);
      mbar_init(empty + 8 * st, 2);   // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // the producer: step `it` is panel p of tile vt, into stage it % F_STAGES
    // once both warpgroups have handed back its previous contents. Rows of x
    // past n and of E past V arrive as zeros.
    if (tid == 256) {
      const int steps = (t1 - t0) * panels;
      for (int it = 0, vt = t0, p = 0; it < steps; ++it) {
        const int st = it % F_STAGES;
        mbar_wait(empty + 8 * st, ((it / F_STAGES) & 1) ^ 1);
        const uint32_t dst = sBuf + st * F_STAGE, bar = full + 8 * st;
        mbar_expect(bar, F_STAGE);
        tma_load(dst, &x_map, 64 * p, r0, bar);
        tma_load(dst + F_XBYTES, &e_map, 64 * p, vt * F_VOCAB, bar);
        if (++p == panels) {
          p = 0;
          ++vt;
        }
      }
    }
    return;
  }

  // the consumers. Thread (warp w, g = lane / 4, q = lane % 4) of warpgroup
  // wg holds rows 64 wg + 16 w + g and + 8 of the block, columns 8j + 2q and
  // 8j + 2q + 1 of the tile in acc[j][0..1] and acc[j][2..3]. A row's state:
  // the running max m (the same in the quad's four threads), and this
  // thread's partial sum of exponentials at m, target and logits sum.
  const int wg = tid >> 7, wt = tid & 127, lane = tid & 31, q = lane & 3;
  const int row = r0 + 64 * wg + ((wt >> 5) << 4) + (lane >> 2);
  int lab[2];
  float m[2], s[2], tg[2], u[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lab[i] = row + 8 * i < n ? labels[row + 8 * i] : -1;
    m[i] = -INFINITY;
    s[i] = tg[i] = u[i] = 0.f;
  }
  float acc[F_VOCAB / 8][4];
  int it = 0;
  for (int vt = t0; vt < t1; ++vt) {
    for (int p = 0; p < panels; ++p, ++it) {
      const int st = it % F_STAGES;
      mbar_wait(full + 8 * st, (it / F_STAGES) & 1);
      const uint64_t da = desc128(sBuf + st * F_STAGE + wg * (64 * 128), 16);
      const uint64_t db = desc128(sBuf + st * F_STAGE + F_XBYTES, 16);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)   // 16 columns, 32 bytes, a step
        Tc<T>::logits(acc, da + 2 * kk, db + 2 * kk, p > 0 || kk > 0);
      wg_commit();
      // the previous panel's products are done: its stage may refill
      wg_wait_n<1>();
      if (p > 0 && wt == 0) mbar_arrive(empty + 8 * ((it - 1) % F_STAGES));
    }
    wg_wait();
    fence_acc(acc);
    if (wt == 0) mbar_arrive(empty + 8 * ((it - 1) % F_STAGES));

    // the row state takes the tile: a new max from the fragment and two quad
    // shuffles, the old sum rescaled, exponentials as ex2 of one FMA. V is a
    // multiple of 128, so the last tile is whole or holds 128 columns (NJ =
    // 16); the zero-filled columns past V are never read.
    const int v0 = vt * F_VOCAB;
    auto update = [&](auto nj) {
      constexpr int NJ = decltype(nj)::value;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < NJ; ++j) mx = fmaxf(mx, fmaxf(acc[j][2 * i], acc[j][2 * i + 1]));
        const float m_new = fmaxf(m[i], quad_max(mx));
        // m[i] == -inf before the first tile: ex2(-inf) = 0 and s[i] is 0
        s[i] *= ex2((m[i] - m_new) * LOG2E);
        m[i] = m_new;
        const float ml = m_new * LOG2E;
        float p0 = 0.f, p1 = 0.f;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          p0 += ex2(fmaf(acc[j][2 * i], LOG2E, -ml));
          p1 += ex2(fmaf(acc[j][2 * i + 1], LOG2E, -ml));
        }
        s[i] += p0 + p1;
        // the label's column, in one thread of the quad; a label outside
        // [v0, v0 + 8 NJ), past V or outside [0, V) included, hits nothing
        const int lc = lab[i] - v0;
        if ((unsigned)lc < (unsigned)(8 * NJ)) {
          const int want = lc - 2 * q;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            if (8 * j == want) tg[i] += acc[j][2 * i];
            if (8 * j + 1 == want) tg[i] += acc[j][2 * i + 1];
          }
        }
        if (smoothing) {
          float u0 = 0.f, u1 = 0.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            u0 += acc[j][2 * i];
            u1 += acc[j][2 * i + 1];
          }
          u[i] += u0 + u1;
        }
      }
    };
    if (v0 + F_VOCAB <= V)
      update(std::integral_constant<int, F_VOCAB / 8>());
    else
      update(std::integral_constant<int, F_VOCAB / 16>());
  }

  // the quad's partials summed in a fixed order; its first thread writes
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float si = quad_sum(s[i]), ti = quad_sum(tg[i]), ui = quad_sum(u[i]);
    const int r = row + 8 * i;
    if (q == 0 && r < n) {
      part[(long)split * n + r] = m[i];
      part[((long)nsplit + split) * n + r] = si;
      part[((long)2 * nsplit + split) * n + r] = ti;
      part[((long)3 * nsplit + split) * n + r] = ui;
    }
  }
}

bool bad_args(int n, int V, int h, int dtype) {
  return n < 1 || V < FWD_VOCAB || V % FWD_VOCAB || h < BK || h % BK || dtype < 0 ||
         dtype > 2;
}

// cuTensorMapEncodeTiled (libcuda), reached through the runtime's entry-point
// query, so that the library links only the CUDA runtime
using EncodeTiled = decltype(&cuTensorMapEncodeTiled);
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    return cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                            cudaEnableDefault, &q) == cudaSuccess &&
                   q == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// the TMA map of a [rows, h] row-major matrix of T, read in boxes of 64
// columns x box_rows into 128-byte-swizzled panels; rows past the last read
// as zeros
template <typename T>
bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int h, int box_rows) {
  const EncodeTiled enc = encode_tiled();
  const cuuint64_t dims[2] = {(cuuint64_t)h, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)h * sizeof(T)};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows}, unit[2] = {1, 1};
  return enc != nullptr &&
         enc(map,
             std::is_same<T, __nv_bfloat16>::value ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                   : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
             2, const_cast<void*>(ptr), dims, strides, box, unit,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a kernel with its dynamic shared memory, granted first (over the 48 KB
// default)
template <typename Kernel, typename... Args>
cudaError_t launch_smem(Kernel kernel, size_t smem, dim3 grid, int threads, cudaStream_t st,
                        Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, st>>>(args...);
  return cudaGetLastError();
}

// the first stage of K7 and K7p: per-share partials into part [4, nsplit, n]
template <typename T>
cudaError_t launch_fwd_partial(cudaStream_t st, const void* x, const void* e,
                               const void* labels, void* part, int n, int V, int h,
                               int nsplit, float eps) {
  if constexpr (sizeof(T) == 2) {
    if (fwd_tc_takes(h)) {
      CUtensorMap x_map, e_map;
      if (!tensor_map<T>(&x_map, x, n, h, F_ROWS) || !tensor_map<T>(&e_map, e, V, h, F_VOCAB))
        return cudaErrorInvalidValue;
      return launch_smem(xent_fwd_tc<T>, fwd_tc_smem(), dim3((n + F_ROWS - 1) / F_ROWS, nsplit),
                         F_THREADS, st, x_map, e_map, (const int*)labels, (float*)part, n, V,
                         h, nsplit, (int)(eps != 0.0f));
    }
  }
  const size_t smem = fwd_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      xent_fwd_partial_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + FWD_ROWS - 1) / FWD_ROWS, nsplit);
  xent_fwd_partial_kernel<T><<<grid, THREADS, smem, st>>>(
      (const T*)x, (const T*)e, (const int*)labels, (float*)part, n, V, h, nsplit,
      eps != 0.0f);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd(cudaStream_t st, const void* x, const void* e,
                       const void* labels, void* part, void* loss, void* lse,
                       int n, int V, int h, int nsplit, float eps) {
  cudaError_t err = launch_fwd_partial<T>(st, x, e, labels, part, n, V, h, nsplit, eps);
  if (err != cudaSuccess) return err;
  xent_fwd_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)part, (float*)loss, (float*)lse, n, nsplit, eps, (float)V);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_partials(cudaStream_t st, const void* x, const void* e,
                                const void* labels, void* part, void* out, int n,
                                int V, int h, int nsplit, float eps) {
  cudaError_t err = launch_fwd_partial<T>(st, x, e, labels, part, n, V, h, nsplit, eps);
  if (err != cudaSuccess) return err;
  xent_fwd_partials_combine_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      (const float*)part, (float*)out, n, nsplit);
  return cudaGetLastError();
}

// K8 (DE false) or K9 (DE true): the tensor-core body where it takes h, else
// the general form (fp32 on the CUDA cores, bf16/fp16 on wmma)
template <typename T, bool DE>
cudaError_t launch_bwd(cudaStream_t st, const void* x, const void* e, const void* labels,
                       const void* lse, const void* dl, void* out, int n, int V, int h,
                       float eps, int v_total) {
#define XENT_BWD_ARGS                                                           \
  (const T*)x, (const T*)e, (const int*)labels, (const float*)lse, (const float*)dl, \
      (T*)out, n, V, h, eps, v_total
  const int col_tiles = (h + COLS - 1) / COLS;
  if constexpr (sizeof(T) == 4) {
    return DE ? launch_smem(xent_de_simt<T>, de_smem<T>(), dim3(V / DE_VOCAB, col_tiles),
                            THREADS, st, XENT_BWD_ARGS)
              : launch_smem(xent_dx_simt<T>, dx_smem<T>(),
                            dim3((n + DX_ROWS - 1) / DX_ROWS, col_tiles), THREADS, st,
                            XENT_BWD_ARGS);
  } else {
    if (tc_takes(h)) {
      const int B = h == TC_MAIN_H ? 32 : 16;
      CUtensorMap own_map, str_map;
      if (!tensor_map<T>(&own_map, DE ? e : x, DE ? V : n, h, TC_OWN) ||
          !tensor_map<T>(&str_map, DE ? x : e, DE ? n : V, h, B))
        return cudaErrorInvalidValue;
      const dim3 grid(((DE ? V : n) + TC_OWN - 1) / TC_OWN, (h + TC_COLS - 1) / TC_COLS);
      // hit_w = 1 - eps and uniform = eps / v_total, computed here in fp32 as
      // the general form computes them on the card, pass as parameters:
      // registers held across the main loop would spill
#define XENT_TC_ARGS                                                                    \
  own_map, str_map, (const int*)labels, (const float*)lse, (const float*)dl, (T*)out, n, \
      V, h, 1.0f - eps, eps / (float)v_total
      return B == 32 ? launch_smem(xent_bwd_tc<T, DE, 32, TC_MAIN_H>, tc_smem<32>(h), grid,
                                   TC_THREADS, st, XENT_TC_ARGS)
                     : launch_smem(xent_bwd_tc<T, DE, 16, 0>, tc_smem<16>(h), grid,
                                   TC_THREADS, st, XENT_TC_ARGS);
#undef XENT_TC_ARGS
    }
    return DE ? launch_smem(xent_de_wmma<T>, de_smem<T>(), dim3(V / DE_VOCAB, col_tiles),
                            THREADS, st, XENT_BWD_ARGS)
              : launch_smem(xent_dx_wmma<T>, dx_smem<T>(),
                            dim3((n + DX_ROWS - 1) / DX_ROWS, col_tiles), THREADS, st,
                            XENT_BWD_ARGS);
  }
#undef XENT_BWD_ARGS
}

}  // namespace

// part: fp32 [4, nsplit, n] scratch (the per-share row partials)
extern "C" int xent_fwd(const void* x, const void* e, const void* labels, void* part,
                        void* loss, void* lse, int n, int V, int h, int nsplit,
                        float smoothing, int dtype, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(n, V, h, dtype) || nsplit < 1 || nsplit > V / FWD_VOCAB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    err = launch_fwd<__nv_bfloat16>(st, x, e, labels, part, loss, lse, n, V, h, nsplit, smoothing);
  else if (dtype == 1)
    err = launch_fwd<__half>(st, x, e, labels, part, loss, lse, n, V, h, nsplit, smoothing);
  else
    err = launch_fwd<float>(st, x, e, labels, part, loss, lse, n, V, h, nsplit, smoothing);
  return (int)err;
}

// K7p: the four fp32 row partials [4, n] (max, sum of exponentials, target,
// logits sum; the last 0 without smoothing) of E, one rank's vocabulary shard,
// with labels already shifted to the shard (a label outside [0, V) hits
// nothing); part: fp32 [4, nsplit, n] scratch
extern "C" int xent_fwd_partials(const void* x, const void* e, const void* labels,
                                 void* part, void* out, int n, int V, int h,
                                 int nsplit, float smoothing, int dtype, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(n, V, h, dtype) || nsplit < 1 || nsplit > V / FWD_VOCAB)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    err = launch_fwd_partials<__nv_bfloat16>(st, x, e, labels, part, out, n, V, h, nsplit,
                                             smoothing);
  else if (dtype == 1)
    err = launch_fwd_partials<__half>(st, x, e, labels, part, out, n, V, h, nsplit,
                                      smoothing);
  else
    err = launch_fwd_partials<float>(st, x, e, labels, part, out, n, V, h, nsplit,
                                     smoothing);
  return (int)err;
}

// v_total: the vocabulary the uniform smoothing term divides by (V, or at
// tensor-parallel size tp > 1 the whole vocabulary V * tp of which E is a shard)
extern "C" int xent_bwd_dx(const void* x, const void* e, const void* labels,
                           const void* lse, const void* dl, void* dx, int n, int V,
                           int h, int v_total, float smoothing, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(n, V, h, dtype) || v_total < V) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DX_ARGS st, x, e, labels, lse, dl, dx, n, V, h, smoothing, v_total
  if (dtype == 0)
    err = launch_bwd<__nv_bfloat16, false>(DX_ARGS);
  else if (dtype == 1)
    err = launch_bwd<__half, false>(DX_ARGS);
  else
    err = launch_bwd<float, false>(DX_ARGS);
#undef DX_ARGS
  return (int)err;
}

// v_total: the vocabulary the uniform smoothing term divides by (V, or at
// tensor-parallel size tp > 1 the whole vocabulary V * tp of which E is a shard)
extern "C" int xent_bwd_de(const void* x, const void* e, const void* labels,
                           const void* lse, const void* dl, void* de, int n, int V,
                           int h, int v_total, float smoothing, int dtype, int device,
                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bad_args(n, V, h, dtype) || v_total < V) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
#define DE_ARGS st, x, e, labels, lse, dl, de, n, V, h, smoothing, v_total
  if (dtype == 0)
    err = launch_bwd<__nv_bfloat16, true>(DE_ARGS);
  else if (dtype == 1)
    err = launch_bwd<__half, true>(DE_ARGS);
  else
    err = launch_bwd<float, true>(DE_ARGS);
#undef DE_ARGS
  return (int)err;
}

extern "C" const char* xent_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

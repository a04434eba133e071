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
// 27-50 us. So they are bound by operations: the bf16 and fp16 products run on
// the tensor cores (nvcuda::wmma 16x16x16 fragments, mma.sync with fp32
// accumulators). The fp32 instantiation computes with CUDA-core FMAs, since
// TF32 would break fp32 parity. How far from the bound: on an H100 SXM at
// 700 W, chip_smoke.py's phase 3 measures K7 at 4.02 ms (6.3x its bound,
// 157 TFLOP/s), K8 at 12.19 ms (9.5x) and K9 at 17.05 ms (13.3x). wgmma,
// TMA and warp specialisation are later work; so is a larger row tile in K8
// and K9, see below.
//
// Design, and what it does about the TPU kernel's shape:
//  - A logits tile is an fp32 tile in shared memory, where the softmax
//    arithmetic reads it by row. K7, and K8/K9 in their general form, compute
//    it in logits_tile: the depth h streams through shared memory in 32-deep
//    slices of x and E with cp.async, one loading while one is computed.
//  - K7: a block owns 128 rows and a contiguous share of the vocabulary
//    (nsplit shares, chosen by the caller so that the grid fills the card:
//    row tiles alone give 64 blocks for 132 SMs). It walks its share in
//    128-wide tiles and writes per-row partials (max, sum of exponentials,
//    target, logits sum); a second small kernel combines the shares in a
//    fixed order, the cross-shard combine _fwd_sharded :350-361 does for
//    tp > 1. The blocks of one share start their walk at eight points of it
//    and share E through L2.
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
//    result on every run.
//     K8: a block owns 32 rows x 768 columns of dX (96 fp32 accumulator
//     registers a thread) and loops over every 128-wide vocabulary tile:
//     logits, coeff to shared memory in E's dtype, then coeff . E streamed in
//     32-row slices.
//     K9: a block owns 32 vocabulary rows x 768 columns of dE and loops over
//     all n rows in 64-row tiles: logits, coeff in x's dtype, then
//     coeff^T . wx, with wx = dl * x formed in shared memory from streamed
//     slices of x.
//    A width above 768 takes more column tiles, each recomputing the logits.
//    That general form reads all of E twice (logits and product) for every
//    32 rows in K8, and all of x twice for every 32 vocabulary rows in K9:
//    about 40 GB from L2 each at the training shape, bound by the bytes an SM
//    keeps in flight.
//  - The main path (bf16 or fp16, h <= 768) takes xent_bwd_resident_kernel
//    instead: the block's own 32 rows (of x for K8, of E for K9) stay in
//    shared memory, and the other operand streams in 32-row tiles that serve
//    both products, so each is read once per block: about 20 GB from L2 for
//    each kernel at the training shape. On the card the resident form took
//    them to 12.99 and 18.87 ms from the general form's 19.45 and 25.68 (a
//    ring of four depth slices in the general form had given 16.06 and
//    26.60); staggered walks then moved them by -6% and -1%, and 512
//    threads by +4% (K8) and -7% (K9), so L2 traffic and occupancy alone do
//    not set the time. Larger tiles need the accumulator spread
//    over more registers than a block has (a 64 x 768 fp32 tile is 192 KB):
//    wgmma's register-light accumulators are the next step.
//  - Ragged edges: rows past n load as zeros and are masked on the way out;
//    V is a multiple of 128 and h of 32, so vocabulary and depth tiles are
//    whole, and a width that is not a multiple of 768 leaves whole 16-column
//    fragments unused.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stddef.h>

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
template <typename T, int NT = THREADS>
__device__ __forceinline__ void load_async(T* s, int lds, const T* g, long ldg,
                                           int rows, int cols, int valid_rows) {
  constexpr int VEC = 16 / sizeof(T);
  const int per_row = cols / VEC;
  for (int i = threadIdx.x; i < rows * per_row; i += NT) {
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

// ---- K8: dX ----------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
xent_dx_kernel(const T* __restrict__ x, const T* __restrict__ e,
               const int* __restrict__ labels, const float* __restrict__ lse,
               const float* __restrict__ dl, T* __restrict__ dx, int n, int V,
               int h, float eps, int v_total) {
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

// ---- K9: dE ----------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
xent_de_kernel(const T* __restrict__ x, const T* __restrict__ e,
               const int* __restrict__ labels, const float* __restrict__ lse,
               const float* __restrict__ dl, T* __restrict__ de, int n, int V,
               int h, float eps, int v_total) {
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

// ---- K8 and K9 where h <= 768 and the type is bf16 or fp16 ----------------
// One operand's 32 rows stay in shared memory for the whole block (x's rows
// for K8, E's for K9), and the other operand streams in 32-row tiles, double
// buffered; each streamed tile serves both products, so the block reads it
// once. K8: acc[x row][c] += coeff[x row][v] E[v][c], dX = dl * acc. K9:
// acc[v][c] += coeff[x row][v] wx[x row][c], with wx = dl * x formed in the
// streamed tile once the logits are done with it. 512 threads share the
// 32 x 768 fp32 accumulator (48 registers each): with 16 warps an SM hides
// the latency of each phase (logits, coeff, wx, product) better than with 8.
// The 32 x 32 logits tile: warp w computes fragment row w % 2 over an eighth
// (w / 2) of the depth, and the eight partial tiles add in a fixed order in
// the coeff pass.
constexpr int RES_THREADS = 512, RES_WARPS = RES_THREADS / 32;
constexpr int RES_ROWS = 32, RES_PARTS = RES_WARPS / 2;
constexpr int RES_WARP_COLS = COLS / RES_WARPS, RES_CG = RES_WARP_COLS / 16;
constexpr int RES_LDS = RES_ROWS + 4, RES_LDC = RES_ROWS + PAD;
// Blocks start their walk over the streamed tiles at different tiles, so that
// they do not all read the same lines of L2 at once. K9 spreads its starts
// over all of x (12.6 MB at the training shape, which L2 holds); K8 over 16
// points of E (77 MB, more than the 50 MB L2), so that each group of blocks
// still finds the tiles its neighbours just read.
constexpr int DX_START_GROUPS = 16;

template <typename T> constexpr size_t resident_smem() {
  return 3 * piece(RES_ROWS * LDE * sizeof(T)) +
         piece(RES_PARTS * RES_ROWS * RES_LDS * sizeof(float)) +
         piece(RES_ROWS * RES_LDC * sizeof(T));
}

template <typename T, bool DE>
__global__ void __launch_bounds__(RES_THREADS, 1)
xent_bwd_resident_kernel(const T* __restrict__ x, const T* __restrict__ e,
                         const int* __restrict__ labels,
                         const float* __restrict__ lse,
                         const float* __restrict__ dl, T* __restrict__ out, int n,
                         int V, int h, float eps, int v_total) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int VEC = 16 / sizeof(T);
  Carve c{smem};
  T* stat = c.take<T>(RES_ROWS * LDE);        // the resident rows
  T* strm = c.take<T>(2 * RES_ROWS * LDE);    // two streamed tiles
  float* S = c.take<float>(RES_PARTS * RES_ROWS * RES_LDS);   // [part][x row][v]
  T* C = c.take<T>(RES_ROWS * RES_LDC);       // coeff [x row][v]
  const int own0 = blockIdx.x * RES_ROWS;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* stat_g = DE ? e : x;
  const T* strm_g = DE ? x : e;
  const int strm_rows = DE ? n : V;
  const int tiles = (strm_rows + RES_ROWS - 1) / RES_ROWS;
  const int starts = DE ? (int)gridDim.x : DX_START_GROUPS;
  const int t_first = (int)((long)(blockIdx.x % starts) * tiles / starts);
  load_async<T, RES_THREADS>(stat, LDE, stat_g + (long)own0 * h, h, RES_ROWS, h,
                             DE ? RES_ROWS : n - own0);
  load_async<T, RES_THREADS>(strm, LDE, strm_g + (long)t_first * RES_ROWS * h, h,
                             RES_ROWS, h, strm_rows - t_first * RES_ROWS);
  cp_async_commit();
  constexpr int FR = RES_ROWS / 16;
  AccTc acc[FR][RES_CG];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < RES_CG; ++j) acc[i][j].zero();
  const float uniform = eps / (float)v_total;
  // this warp's logits fragment row and share of the depth (16-deep steps)
  const int fr = warp & 1, part = warp >> 1;
  const int k_lo = part * (h / 16) / RES_PARTS * 16;
  const int k_hi = (part + 1) * (h / 16) / RES_PARTS * 16;
  for (int step = 0, t = t_first; step < tiles; ++step, t = t + 1 < tiles ? t + 1 : 0) {
    if (step + 1 < tiles) {
      const int r = (t + 1 < tiles ? t + 1 : 0) * RES_ROWS;
      load_async<T, RES_THREADS>(strm + ((step + 1) & 1) * RES_ROWS * LDE, LDE,
                                 strm_g + (long)r * h, h, RES_ROWS, h, strm_rows - r);
    }
    cp_async_commit();
    cp_async_wait<1>();   // tile t (and, at the first, the resident rows) landed
    __syncthreads();
    T* cur = strm + (step & 1) * RES_ROWS * LDE;
    const T* xs = DE ? cur : stat;
    const T* es = DE ? stat : cur;
    const int xr0 = DE ? t * RES_ROWS : own0;    // first x row of the tile
    const int v0 = DE ? own0 : t * RES_ROWS;     // first vocabulary row
    {
      AccTc s[2];
      s[0].zero();
      s[1].zero();
      for (int k = k_lo; k < k_hi; k += 16) {
        FragA<T, Row> a;
        a.load(xs + fr * 16 * LDE + k, LDE);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          FragB<T, Col> b;   // B(k, v) = E[v][k]
          b.load(es + j * 16 * LDE + k, LDE);
          mma(s[j], a, b);
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        s[j].store(S + (part * RES_ROWS + fr * 16) * RES_LDS + j * 16, RES_LDS);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < RES_ROWS * RES_ROWS; i += RES_THREADS) {
      const int r = i / RES_ROWS, v = i - r * RES_ROWS, xr = xr0 + r;
      float cf = 0.0f;
      if (xr < n) {
        float z = 0.0f;
#pragma unroll
        for (int p = 0; p < RES_PARTS; ++p) z += S[(p * RES_ROWS + r) * RES_LDS + v];
        cf = expf(z - lse[xr]);
        if (v0 + v == labels[xr]) cf -= 1.0f - eps;
        cf -= uniform;
      }
      C[r * RES_LDC + v] = from_f<T>(cf);
    }
    if (DE) {   // wx = dl * x in x's dtype, in place (the logits are done with x)
      const int vecs = h / VEC;
      for (int i = threadIdx.x; i < RES_ROWS * vecs; i += RES_THREADS) {
        const int r = i / vecs, cc = (i - r * vecs) * VEC;
        const float w = xr0 + r < n ? dl[xr0 + r] : 0.0f;
        T* p = cur + r * LDE + cc;
        alignas(16) T v[VEC];
        *reinterpret_cast<int4*>(v) = *reinterpret_cast<const int4*>(p);
#pragma unroll
        for (int u = 0; u < VEC; ++u) v[u] = from_f<T>(w * to_f(v[u]));
        *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(v);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < RES_ROWS; kk += 16) {
      FragA<T, typename std::conditional<DE, Col, Row>::type> a[FR];
#pragma unroll
      for (int i = 0; i < FR; ++i)   // K8: A(r, v) = C[r][v]; K9: A(v, r) = C[r][v]
        a[i].load(DE ? C + kk * RES_LDC + i * 16 : C + i * 16 * RES_LDC + kk, RES_LDC);
#pragma unroll
      for (int j = 0; j < RES_CG; ++j) {
        const int col = warp * RES_WARP_COLS + j * 16;
        if (col >= h) continue;
        FragB<T, Row> b;   // K8: B(v, c) = E[v][c]; K9: B(r, c) = wx[r][c]
        b.load(cur + kk * LDE + col, LDE);
#pragma unroll
        for (int i = 0; i < FR; ++i) mma(acc[i][j], a[i], b);
      }
    }
    __syncthreads();   // the next prefetch takes this tile's buffer
  }
  float* scratch = reinterpret_cast<float*>(strm) + warp * 16 * SCRATCH_LD;
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int j = 0; j < RES_CG; ++j) {
      const int col = warp * RES_WARP_COLS + j * 16;
      if (col >= h) continue;
      acc[i][j].store(scratch, SCRATCH_LD);
      __syncwarp();
      for (int k = lane; k < 256; k += 32) {
        const int rr = k >> 4, cc = k & 15, r = own0 + i * 16 + rr;
        const float a = scratch[rr * SCRATCH_LD + cc];
        if (DE)
          out[(long)r * h + col + cc] = from_f<T>(a);
        else if (r < n)
          out[(long)r * h + col + cc] = from_f<T>(dl[r] * a);
      }
      __syncwarp();
    }
}

bool bad_args(int n, int V, int h, int dtype) {
  return n < 1 || V < FWD_VOCAB || V % FWD_VOCAB || h < BK || h % BK || dtype < 0 ||
         dtype > 2;
}

// the first stage of K7 and K7p: per-share partials into part [4, nsplit, n]
template <typename T>
cudaError_t launch_fwd_partial(cudaStream_t st, const void* x, const void* e,
                               const void* labels, void* part, int n, int V, int h,
                               int nsplit, float eps) {
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

template <typename T, bool DE>
cudaError_t launch_resident(cudaStream_t st, const void* x, const void* e,
                            const void* labels, const void* lse, const void* dl,
                            void* out, int n, int V, int h, float eps, int v_total) {
  const size_t smem = resident_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(xent_bwd_resident_kernel<T, DE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  const int owners = DE ? V : n;
  xent_bwd_resident_kernel<T, DE><<<(owners + RES_ROWS - 1) / RES_ROWS, RES_THREADS, smem,
                                    st>>>(
      (const T*)x, (const T*)e, (const int*)labels, (const float*)lse,
      (const float*)dl, (T*)out, n, V, h, eps, v_total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dx(cudaStream_t st, const void* x, const void* e,
                      const void* labels, const void* lse, const void* dl, void* dx,
                      int n, int V, int h, float eps, int v_total) {
  if constexpr (sizeof(T) == 2) {
    if (h <= COLS)
      return launch_resident<T, false>(st, x, e, labels, lse, dl, dx, n, V, h, eps,
                                           v_total);
  }
  const size_t smem = dx_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      xent_dx_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((n + DX_ROWS - 1) / DX_ROWS, (h + COLS - 1) / COLS);
  xent_dx_kernel<T><<<grid, THREADS, smem, st>>>(
      (const T*)x, (const T*)e, (const int*)labels, (const float*)lse,
      (const float*)dl, (T*)dx, n, V, h, eps, v_total);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_de(cudaStream_t st, const void* x, const void* e,
                      const void* labels, const void* lse, const void* dl, void* de,
                      int n, int V, int h, float eps, int v_total) {
  if constexpr (sizeof(T) == 2) {
    if (h <= COLS)
      return launch_resident<T, true>(st, x, e, labels, lse, dl, de, n, V, h, eps,
                                           v_total);
  }
  const size_t smem = de_smem<T>();
  cudaError_t err = cudaFuncSetAttribute(
      xent_de_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(V / DE_VOCAB, (h + COLS - 1) / COLS);
  xent_de_kernel<T><<<grid, THREADS, smem, st>>>(
      (const T*)x, (const T*)e, (const int*)labels, (const float*)lse,
      (const float*)dl, (T*)de, n, V, h, eps, v_total);
  return cudaGetLastError();
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
  if (dtype == 0)
    err = launch_dx<__nv_bfloat16>(st, x, e, labels, lse, dl, dx, n, V, h, smoothing,
                                        v_total);
  else if (dtype == 1)
    err = launch_dx<__half>(st, x, e, labels, lse, dl, dx, n, V, h, smoothing,
                                        v_total);
  else
    err = launch_dx<float>(st, x, e, labels, lse, dl, dx, n, V, h, smoothing,
                                        v_total);
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
  if (dtype == 0)
    err = launch_de<__nv_bfloat16>(st, x, e, labels, lse, dl, de, n, V, h, smoothing,
                                        v_total);
  else if (dtype == 1)
    err = launch_de<__half>(st, x, e, labels, lse, dl, de, n, V, h, smoothing,
                                        v_total);
  else
    err = launch_de<float>(st, x, e, labels, lse, dl, de, n, V, h, smoothing,
                                        v_total);
  return (int)err;
}

extern "C" const char* xent_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

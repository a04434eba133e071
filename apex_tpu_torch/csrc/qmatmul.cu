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
// (B N) are small. A layer matrix of GPT-2-small is 0.6-2.4 MB, under a
// microsecond of bytes, so there the time is the launch and one memory
// round trip, if the whole matrix is in flight at once; the logits' 38.6
// MB want enough bytes in flight on every SM to hold the memory rate.
//
// On the CUDA cores a weight byte costs 8 fp32 multiply-adds, a widening
// and a shared-memory read, ~12 instructions, which caps a body near 2
// TB/s, below cuBLAS over a bf16 copy (the fp32 body below). The body for
// bf16 and fp16 x ("tc"):
//
//  - Tensor cores. mma.sync m16n8k16 with fp32 accumulators: A is 16
//    weight rows (output channels) by 16 k, B is 16 k by 8 x rows, so 16
//    by 8 outputs take one instruction where the CUDA cores take 8 FMAs a
//    weight byte. Up to four n-tiles (32 x rows) reuse one widened A.
//  - Widening in registers, exact: the byte's sign bit flipped (value +
//    128, 0..255) goes under an exponent by a byte permute, and one
//    subtraction takes the bias off: fp16 under 1024 (0x6400), one sub.f16x2
//    for two values; bf16 (7 mantissa bits) under 2^23 in fp32, then a
//    permute packs the two high halves (an integer of magnitude <= 128 has
//    zero low 16 bits in fp32). ~1 (fp16) or ~2.5 (bf16) instructions a
//    byte.
//  - A k order made for the loads. Within a chunk of 64 columns lane (g,
//    t) loads 16 bytes of weight rows g and g + 8 at column 16 t; its word
//    u feeds its A fragments of the chunk's k-step u directly, the slots
//    {2t, 2t + 1, 2t + 8, 2t + 9} taking the word's bytes 0-3. The B
//    fragment of that step is then x's columns 16 t + 4 u .. + 3 of row g,
//    which lie in x's own order: one 16-byte load feeds two steps. x (a few
//    KB, read by many warps) comes through L1 (__ldg), the weight streams
//    past it (ld.global.cs). A tail of 16-column steps past the last full
//    chunk (K a multiple of 16, not of 64) takes columns 16 u + 4 t. A sum
//    over k does not depend on which k sits in which slot.
//  - Any K. Where K is not a multiple of 16 (or x or wq is not 16-byte
//    aligned) a weight row is not 16-byte aligned, so the body takes its
//    element-load form (body 2; ops/qmatmul_cuda.plan's "tc_narrow"): the
//    same chunks, k order, mma and combine, each lane's 16 weight bytes and
//    16 x values loaded one at a time, and the chunk that holds K's last K
//    % 64 columns read in the full chunks' order with every column at K or
//    past it zero in both operands, so it adds nothing. x is never padded.
//  - Parallelism. A warp takes one 16-channel tile and one piece of K; a
//    block of 4 warps takes 4 / S tiles and S pieces of each, a cluster of
//    C blocks (along grid.y) C x S pieces. The grid's z walks groups of 8
//    NT x rows. ops/qmatmul_cuda.plan picks NT, S, C and D: at the layer
//    shapes S = 4 (the whole matrix in flight at once), a cluster only
//    where K is long (4h->h: C = 3; at K = 768 a cluster's launch and
//    combine cost more than they save), and at the logits one piece a
//    tile, no combine. Each
//    lane keeps D chunks of weight and x loads in flight, the next issued
//    before the current is used: D = 4 where a warp's piece fits in them,
//    else 2 (the logits: 76 registers a thread, so 6 blocks share an SM
//    and the 786 blocks run in one wave; D = 4 took 112 and 1.5 waves).
//    At D = 4 the output scales are loaded at the start, not at the end.
//  - Combine. The pieces of a tile sum in a fixed order: each warp writes
//    its 16 x 8 NT partial to its block's shared memory, the cluster (or,
//    with C = 1, the block) synchronises, and warp 0 of the tile in the
//    cluster's first block reads the C x S partials, its own and the other
//    blocks' through distributed shared memory, and adds them in order.
//    Nothing crosses blocks in device memory: no scratch, no ticket, no
//    atomics, so two runs give the same bits and a CUDA graph holds no
//    state.
//  - Rounding. bf16 and fp16 products of int8 values are exact in fp32;
//    each chunk's four mma (64 k) start from zero and the chunk's sum is
//    added to the fp32 accumulator by an ordinary (round-to-nearest) add,
//    so the tensor cores' own accumulation (aligned and truncated) spans 64
//    terms, not K. The scale multiplies the fp32 sum and one rounding to
//    x's dtype follows. Only the summation order differs from the plain
//    version's.
//
// fp32 x keeps a CUDA-core body ("simt"): the tensor cores would
// round x to TF32. A block of 4 warps takes 16 output channels (four a
// warp) and 8 x rows (grid.y walks further groups), walking K in chunks of
// 512 columns staged in shared memory; lane l reads columns [16 l, 16 l +
// 16) of a chunk, its weight bytes one 16-byte load a row a chunk ahead;
// 4 x 8 fp32 accumulators a lane, summed over the warp by an xor butterfly.
//
// It takes any K the same way: a 16-byte load where a lane's 16 columns
// lie before K and the row is aligned there, else byte loads with zeros at
// K and past it (x likewise).
//
// Every weight byte is read once (B <= 32 for tc, 8 for simt), no
// dequantized weight is written, and the two bodies agree with the plain
// version within a measured relative L2 (tests/port/kernel_l2_errors.py:
// bf16 <= 3.9e-5, fp16 <= 1.3e-5, fp32 <= 3.7e-7 on an H100).
//
// Measured (chip_smoke.py's phase_qmatmul_kernel, NVIDIA H100 80GB HBM3 at
// 700 W, each launch after the smoke's L2 flush, in turns): a bf16 decode
// step of GPT-2-small at 8 slots, 49 launches, 0.469-0.472 ms, where the
// same work on a CUDA-core body of 16 channels a block took 0.789 and
// cuBLAS over a bf16 copy 0.525; a layer shape 7.8-11.2 us, where one
// launch that moves 4 bytes takes 5.0 us timed the same way; the logits
// 27.8 us, 0.43 of the 11.8 us byte bound. The plan's constants
// (WARPS_PER_SM, a cluster only at K = 3072, D = 2 at the logits) were
// chosen by timing every split (S, C, D) at the five decode shapes on
// that card. Two other loads for the logits were tried on the card and
// were slower, so neither is here: x staged once a block in shared
// memory, and the weights through a cp.async ring in shared memory 3-6
// chunks deep.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace cg = cooperative_groups;

namespace {

constexpr int WARPS = 4;            // warps a block (both bodies)
constexpr int THREADS = WARPS * 32;

// ---- tc: bf16 / fp16 x on the tensor cores
constexpr int TILE_N = 16;          // output channels a warp (the mma's m)
constexpr int TILE_B = 8;           // x rows an n-tile (the mma's n)
constexpr int MAX_NT = 4;           // n-tiles a warp
constexpr int CHUNK = 64;           // K columns a chunk: 16 bytes a lane a row
constexpr int STEP = 16;            // K columns an mma
constexpr int MAX_CLUSTER = 8;      // the portable cluster size

// ---- simt: fp32 x on the CUDA cores
constexpr int RPW = 4;              // output channels a warp
constexpr int COLS = WARPS * RPW;   // output channels a block
constexpr int ROWS = 8;             // x rows a block
constexpr int VEC = 16;             // columns a lane a chunk
constexpr int SCHUNK = 32 * VEC;    // K columns a chunk
constexpr int PITCH = 33;           // floats between a row-column's lanes

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __half from_f<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// ------------------------------------------------------------------ tc

// bytes 2 HI and 2 HI + 1 of a word whose sign bits were flipped (each
// byte value + 128), as a bf16x2 or f16x2 (the lower byte in the low half)
template <int HI>
__device__ __forceinline__ uint32_t widen2(uint32_t biased, const __nv_bfloat16*) {
  const float lo =
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | (2 * HI))) - 8388736.0f;
  const float hi =
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | (2 * HI + 1))) -
      8388736.0f;
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}
template <int HI>
__device__ __forceinline__ uint32_t widen2(uint32_t biased, const __half*) {
  const uint32_t h = __byte_perm(biased, 0x64646464u, HI ? 0x4342u : 0x4140u);
  uint32_t out;
  asm("sub.rn.f16x2 %0, %1, %2;" : "=r"(out) : "r"(h), "r"(0x64806480u));  // - 1152
  return out;
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1, const __nv_bfloat16*) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1, const __half*) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t word(const uint4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

__device__ __forceinline__ uint32_t ld_w4(const int8_t* p) {
  return (uint32_t)__ldcs(reinterpret_cast<const int*>(p));
}

// A warp's piece of K: full chunks [c_lo, c_lo + nfull) and, for the last
// piece, `tail` 16-column steps past the last full chunk (WIDE: K a
// multiple of 16; else the steps that cover K's last K % 64 columns, the
// rest zero)
struct Piece {
  int c_lo, nfull, tail;
};

template <bool WIDE>
__device__ __forceinline__ Piece piece_of(int p, int P, int K) {
  const int n64 = K / CHUNK;
  const int c_lo = (int)((long long)p * n64 / P);
  const int c_hi = (int)((long long)(p + 1) * n64 / P);
  const int rest = K % CHUNK;
  return {c_lo, c_hi - c_lo, p == P - 1 ? (WIDE ? rest / STEP : (rest + STEP - 1) / STEP) : 0};
}

// one chunk of a lane's operands: its words of weight rows g (a) and g + 8
// (b), and its x fragments of each n-tile, two words a k-step
template <int NT>
struct Chunk {
  uint4 a, b;
  uint4 x[NT][2];
};

// the first column of chunk j of the piece this lane reads (a tail's
// pieces lie 16 apart from it)
__device__ __forceinline__ int chunk_col(const Piece& pc, int K, int t, int j) {
  return j < pc.nfull ? (pc.c_lo + j) * CHUNK + 16 * t : K / CHUNK * CHUNK + 4 * t;
}

// the x fragments of a chunk at column col of rows xrow (null: a row past
// B, zeros), through L1: a full chunk's 16 consecutive columns (two
// 16-byte loads), a tail's `tail` 4-column pieces 16 apart
template <typename T, int NT>
__device__ __forceinline__ void load_x(const T* const (&xrow)[NT], int col, bool full,
                                       int tail, uint4 (&xf)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    xf[n][0] = xf[n][1] = make_uint4(0u, 0u, 0u, 0u);
    if (xrow[n] == nullptr) continue;
    if (full) {
      xf[n][0] = __ldg(reinterpret_cast<const uint4*>(xrow[n] + col));
      xf[n][1] = __ldg(reinterpret_cast<const uint4*>(xrow[n] + col + 8));
    } else {
      uint2 q[3] = {make_uint2(0u, 0u), make_uint2(0u, 0u), make_uint2(0u, 0u)};
#pragma unroll
      for (int u = 0; u < 3; ++u)
        if (u < tail) q[u] = __ldg(reinterpret_cast<const uint2*>(xrow[n] + col + u * STEP));
      xf[n][0] = make_uint4(q[0].x, q[0].y, q[1].x, q[1].y);
      xf[n][1] = make_uint4(q[2].x, q[2].y, 0u, 0u);
    }
  }
}

// the 16 weight bytes at p + col (those at K or past it zero), one byte
// load each: a row of a K that is not a multiple of 16 is not 16-byte
// aligned
__device__ __forceinline__ uint4 load_w_bytes(const int8_t* p, int col, int K) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (col + i < K) w[i / 4] |= (uint32_t)(uint8_t)p[col + i] << (8 * (i % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 16 x values at p + col (those at K or past it zero), one load each
template <typename T>
__device__ __forceinline__ void load_x_elems(const T* p, int col, int K, uint4 (&xf)[2]) {
  T v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = col + i < K ? p[col + i] : from_f<T>(0.0f);
  memcpy(xf, v, sizeof(v));
}

// chunk j of the piece: the weight words and the x fragments. WIDE: 16-byte
// weight loads and x as load_x reads it; else (any K) every chunk, the
// last one too, in the full chunks' column order, by element loads, the
// columns at K or past it zero
template <typename T, int NT, bool WIDE>
__device__ __forceinline__ void load_chunk(const int8_t* wa, const int8_t* wb,
                                           const T* const (&xrow)[NT], const Piece& pc,
                                           int K, int t, int j, Chunk<NT>& c) {
  if constexpr (!WIDE) {
    const int col = (pc.c_lo + j) * CHUNK + 16 * t;
    c.a = load_w_bytes(wa, col, K);
    c.b = load_w_bytes(wb, col, K);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      if (xrow[n] == nullptr) {
        c.x[n][0] = c.x[n][1] = make_uint4(0u, 0u, 0u, 0u);
      } else {
        load_x_elems<T>(xrow[n], col, K, c.x[n]);
      }
    }
    return;
  }
  const int col = chunk_col(pc, K, t, j);
  if (j < pc.nfull) {
    const int4 va = __ldcs(reinterpret_cast<const int4*>(wa + col));
    const int4 vb = __ldcs(reinterpret_cast<const int4*>(wb + col));
    c.a = make_uint4(va.x, va.y, va.z, va.w);
    c.b = make_uint4(vb.x, vb.y, vb.z, vb.w);
  } else {
    const int tail = pc.tail;
    c.a = make_uint4(ld_w4(wa + col), tail > 1 ? ld_w4(wa + col + STEP) : 0u,
                     tail > 2 ? ld_w4(wa + col + 2 * STEP) : 0u, 0u);
    c.b = make_uint4(ld_w4(wb + col), tail > 1 ? ld_w4(wb + col + STEP) : 0u,
                     tail > 2 ? ld_w4(wb + col + 2 * STEP) : 0u, 0u);
  }
  load_x<T, NT>(xrow, col, j < pc.nfull, pc.tail, c.x);
}

// a chunk's products into acc: each k-step's widened A against every
// n-tile's B, the chunk's sum added to acc in fp32
template <typename T, int NT>
__device__ __forceinline__ void use_chunk(const Chunk<NT>& c, int steps,
                                          float (&acc)[NT][4]) {
  float part[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) part[n][e] = 0.0f;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    if (u < steps) {
      const uint32_t wa = word(c.a, u) ^ 0x80808080u, wb = word(c.b, u) ^ 0x80808080u;
      const uint32_t frag[4] = {widen2<0>(wa, (const T*)nullptr),
                                widen2<0>(wb, (const T*)nullptr),
                                widen2<1>(wa, (const T*)nullptr),
                                widen2<1>(wb, (const T*)nullptr)};
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const uint4& q = c.x[n][u / 2];
        mma(part[n], frag, u % 2 ? q.z : q.x, u % 2 ? q.w : q.y, (const T*)nullptr);
      }
    }
  }
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
}

// D: chunks a lane keeps in flight, weights and x (the plan's depth);
// WIDE: 16-byte loads (K a multiple of 16, rows 16-byte aligned)
template <typename T, int NT, int D, bool WIDE>
__device__ __forceinline__ void tc_body(const T* __restrict__ x, const int8_t* __restrict__ wq,
                                        const float* __restrict__ scale, T* __restrict__ y,
                                        int B, int N, int K, int S, int C) {
  __shared__ float4 red[WARPS][NT][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r = warp / S, s = warp - r * S;
  const int rank = blockIdx.y;                  // the block's rank in its cluster
  const int n0 = (blockIdx.x * (WARPS / S) + r) * TILE_N;
  const bool live = n0 < N;
  const int b0 = blockIdx.z * TILE_B * NT;
  const int P = S * C;
  const Piece pc = piece_of<WIDE>(rank * S + s, P, K);
  const int total = live ? pc.nfull + (pc.tail > 0) : 0;
  // a channel past N reads the last row again; its sums are not written
  const int8_t* wa = wq + (long long)min(n0 + g, N - 1) * K;
  const int8_t* wb = wq + (long long)min(n0 + g + 8, N - 1) * K;
  const T* xrow[NT];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int row = b0 + n * TILE_B + g;
    xrow[n] = row < B ? x + (long long)row * K : nullptr;
  }
  // at depth 4 (short pieces) the scales of channels g and g + 8 are
  // loaded now, so that the epilogue does not wait a memory round trip for
  // them; at depth 2 (the logits) the epilogue loads them: 8 more
  // registers a thread would leave room for 5 blocks an SM, not 6
  float sc[2] = {0.0f, 0.0f};
  if constexpr (D == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + g + 8 * h;
      sc[h] = live && n < N ? __ldg(scale + n) : 0.0f;
    }
  }
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  Chunk<NT> ring[D];
#pragma unroll
  for (int d = 0; d < D; ++d)
    if (d < total) load_chunk<T, NT, WIDE>(wa, wb, xrow, pc, K, t, d, ring[d]);
  for (int j0 = 0; j0 < total; j0 += D) {
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const int j = j0 + d;
      if (j < total) {
        const Chunk<NT> c = ring[d];
        if (j + D < total) load_chunk<T, NT, WIDE>(wa, wb, xrow, pc, K, t, j + D, ring[d]);
        use_chunk<T, NT>(c, j < pc.nfull || !WIDE ? 4 : pc.tail, acc);
      }
    }
  }

  if (P > 1) {
    // the tile's C x S partials, summed in (rank, piece) order by warp 0
    // of the tile in the cluster's first block
#pragma unroll
    for (int n = 0; n < NT; ++n)
      red[warp][n][lane] = make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    if (C > 1) cg::this_cluster().sync();
    else __syncthreads();
    if (rank == 0 && s == 0) {
      for (int c = 0; c < C; ++c) {
        float4* src = &red[0][0][0];
        if (c > 0) src = cg::this_cluster().map_shared_rank(src, c);
        for (int q = c == 0 ? 1 : 0; q < S; ++q) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float4 v = src[((r * S + q) * NT + n) * 32 + lane];
            acc[n][0] += v.x; acc[n][1] += v.y; acc[n][2] += v.z; acc[n][3] += v.w;
          }
        }
      }
    }
    if (C > 1) cg::this_cluster().sync();  // the partials are read before any block leaves
    if (rank != 0 || s != 0) return;
  }
  if (!live) return;
  // c0, c1: channel n0 + g, x rows 2t, 2t + 1; c2, c3: channel n0 + g + 8
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + g + 8 * h;
    if (n >= N) continue;
    if constexpr (D != 4) sc[h] = scale[n];
#pragma unroll
    for (int q = 0; q < NT; ++q) {
      const int row = b0 + q * TILE_B + 2 * t;
      if (row < B) y[(long long)row * N + n] = from_f<T>(__fmul_rn(acc[q][2 * h], sc[h]));
      if (row + 1 < B)
        y[(long long)(row + 1) * N + n] = from_f<T>(__fmul_rn(acc[q][2 * h + 1], sc[h]));
    }
  }
}

// ---------------------------------------------------------------- simt

// the first n (at most 16) of 16 consecutive floats from src, the rest
// zero: 16-byte loads where all 16 are wanted and src is 16-byte aligned,
// else element loads
__device__ __forceinline__ void load16(const float* src, int n, float (&v)[VEC]) {
  if (n >= VEC && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(src) + q);
      v[4 * q] = f.x; v[4 * q + 1] = f.y; v[4 * q + 2] = f.z; v[4 * q + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < VEC; ++j) v[j] = j < n ? src[j] : 0.0f;
  }
}

// the k-th signed byte of a word whose sign bits were flipped (each byte
// then holds value + 128), as a float: the byte is placed under the
// exponent of 2^23, and 2^23 + 128 is taken off (both steps exact)
__device__ __forceinline__ float byte_f(unsigned biased, int k) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7440u | k)) - 8388736.0f;
}

// this lane's 16 bytes of each of the warp's four rows in the chunk at c0:
// one 16-byte load where the row is 16-byte aligned there and all 16 lie
// before K, else byte loads, the bytes at K or past it zero
__device__ __forceinline__ void load_w(const int8_t* wq, int n0, int N, int K, int c0,
                                       int lane, unsigned (&w)[RPW][4]) {
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    // a channel past N reads the last row again; its sums are not written
    const long long row = (long long)min(n0 + r, N - 1) * K;
    const int col = c0 + lane * VEC;
    const int8_t* src = wq + row + col;
    uint4 v;
    if (col + VEC <= K && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      const int4 q = __ldcs(reinterpret_cast<const int4*>(src));
      v = make_uint4(q.x, q.y, q.z, q.w);
    } else {
      v = load_w_bytes(wq + row, col, K);
    }
    w[r][0] = v.x ^ 0x80808080u;
    w[r][1] = v.y ^ 0x80808080u;
    w[r][2] = v.z ^ 0x80808080u;
    w[r][3] = v.w ^ 0x80808080u;
  }
}

__device__ __forceinline__ void simt_body(const float* __restrict__ x,
                                          const int8_t* __restrict__ wq,
                                          const float* __restrict__ scale,
                                          float* __restrict__ y, int B, int N, int K) {
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
  for (int c0 = 0; c0 < K; c0 += SCHUNK) {
    const bool mine = lane * VEC < min(SCHUNK, K - c0);   // this lane's columns
#pragma unroll
    for (int r = 0; r < RPW; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) w[r][q] = next[r][q];
    if (mine) {
      for (int b = warp; b < nb; b += WARPS) {
        float v[VEC];
        load16(x + (long long)(b0 + b) * K + c0 + lane * VEC, K - c0 - lane * VEC, v);
#pragma unroll
        for (int j = 0; j < VEC; ++j) xs[(b * VEC + j) * PITCH + lane] = v[j];
      }
    }
    const int c1 = c0 + SCHUNK;
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
      if (lane == b && b < nb && n < N) y[(long long)(b0 + b) * N + n] = __fmul_rn(v, scale[n]);
    }
  }
}

// ------------------------------------------------------------- kernels

// NT = 0: the simt body (T = float); 1-4: the tc body with NT n-tiles, D
// chunks in flight and 16-byte loads (WIDE) or element loads
template <typename T, int NT, int D, bool WIDE>
__global__ void __launch_bounds__(THREADS)
qmatmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
               const float* __restrict__ scale, T* __restrict__ y, int B, int N, int K,
               int S, int C) {
  if constexpr (NT == 0) {
    simt_body(x, wq, scale, y, B, N, K);
  } else {
    tc_body<T, NT, D, WIDE>(x, wq, scale, y, B, N, K, S, C);
  }
}

template <typename T, int NT, int D, bool WIDE>
cudaError_t launch_tc(const void* x, const int8_t* wq, const float* scale, void* y, int B,
                      int N, int K, int S, int C, cudaStream_t stream) {
  const long long tiles = (N + TILE_N - 1) / TILE_N, per = WARPS / S;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((tiles + per - 1) / per), (unsigned)C,
                     (unsigned)((B + TILE_B * NT - 1) / (TILE_B * NT)));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = C;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = C > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, qmatmul_kernel<T, NT, D, WIDE>, static_cast<const T*>(x), wq, scale,
      static_cast<T*>(y), B, N, K, S, C);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename T, bool WIDE>
cudaError_t launch_tc_plan(const void* x, const int8_t* wq, const float* scale, void* y,
                           int B, int N, int K, int nt, int S, int C, int depth,
                           cudaStream_t st) {
  switch (nt * 10 + depth) {
    case 14: return launch_tc<T, 1, 4, WIDE>(x, wq, scale, y, B, N, K, S, C, st);
    case 12: return launch_tc<T, 1, 2, WIDE>(x, wq, scale, y, B, N, K, S, C, st);
    case 24: return launch_tc<T, 2, 4, WIDE>(x, wq, scale, y, B, N, K, S, C, st);
    case 22: return launch_tc<T, 2, 2, WIDE>(x, wq, scale, y, B, N, K, S, C, st);
    case 32: return launch_tc<T, 3, 2, WIDE>(x, wq, scale, y, B, N, K, S, C, st);
    default: return launch_tc<T, 4, 2, WIDE>(x, wq, scale, y, B, N, K, S, C, st);
  }
}

template <typename T>
cudaError_t launch_tc_body(bool wide, const void* x, const int8_t* wq, const float* scale,
                           void* y, int B, int N, int K, int nt, int S, int C, int depth,
                           cudaStream_t st) {
  return wide ? launch_tc_plan<T, true>(x, wq, scale, y, B, N, K, nt, S, C, depth, st)
              : launch_tc_plan<T, false>(x, wq, scale, y, B, N, K, nt, S, C, depth, st);
}

cudaError_t launch_simt(const void* x, const int8_t* wq, const float* scale, void* y, int B,
                        int N, int K, cudaStream_t stream) {
  const dim3 grid((N + COLS - 1) / COLS, (B + ROWS - 1) / ROWS);
  qmatmul_kernel<float, 0, 0, false><<<grid, THREADS, 0, stream>>>(
      static_cast<const float*>(x), wq, scale, static_cast<float*>(y), B, N, K, 1, 1);
  return cudaGetLastError();
}

// the plan (ops/qmatmul_cuda.plan) this entry takes: body 0 (tc, 16-byte
// loads) for bf16 and fp16 x, K a multiple of 16, x and wq 16-byte
// aligned, or body 2 (tc, element loads) for bf16 and fp16 x at any K and
// alignment, each with 1-4 n-tiles, S in {1, 2, 4} pieces a block, C in
// 1..8 blocks a cluster, S C pieces of at least one 64-column chunk (one
// piece where K < 64), depth 2, or 4 at 1-2 n-tiles, at most 65535 row
// groups; body 1 (simt) for fp32 x at any K, nt = S = C = depth = 1, at
// most 65535 groups of 8 rows
bool plan_ok(const void* x, const int8_t* wq, int B, int K, int dtype, int body, int nt, int S,
             int C, int depth) {
  if (body == 0 || body == 2) {
    const int pieces = K / CHUNK > 1 ? K / CHUNK : 1;
    const bool wide_ok = K % STEP == 0 && !(reinterpret_cast<uintptr_t>(x) & 15) &&
                         !(reinterpret_cast<uintptr_t>(wq) & 15);
    return (dtype == 0 || dtype == 1) && (body == 2 || wide_ok) &&
           nt >= 1 && nt <= MAX_NT && (S == 1 || S == 2 || S == 4) && C >= 1 &&
           C <= MAX_CLUSTER && S * C <= pieces && (depth == 2 || (depth == 4 && nt <= 2)) &&
           (B + TILE_B * nt - 1) / (TILE_B * nt) <= 65535;
  }
  return body == 1 && dtype == 2 && nt == 1 && S == 1 && C == 1 && depth == 1 &&
         (B + ROWS - 1) / ROWS <= 65535;
}

}  // namespace

// K23: x [B, K] (dtype 0 bf16, 1 fp16, 2 fp32), wq [N, K] int8 at any K,
// scale [N] fp32, y [B, N] in x's dtype; all contiguous. (body, nt, split,
// cluster, depth): the plan, refused with cudaErrorInvalidValue where
// plan_ok does not hold
extern "C" int qmatmul_w8a16(const void* x, const int8_t* wq, const float* scale, void* y,
                             int B, int N, int K, int dtype, int body, int nt, int split,
                             int cluster, int depth, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (!x || !wq || !scale || !y || B < 1 || N < 1 || K < 1 ||
      !plan_ok(x, wq, B, K, dtype, body, nt, split, cluster, depth))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (body == 1) return (int)launch_simt(x, wq, scale, y, B, N, K, st);
  if (dtype == 0)
    return (int)launch_tc_body<__nv_bfloat16>(body == 0, x, wq, scale, y, B, N, K, nt, split,
                                              cluster, depth, st);
  return (int)launch_tc_body<__half>(body == 0, x, wq, scale, y, B, N, K, nt, split, cluster,
                                     depth, st);
}

extern "C" const char* qmatmul_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

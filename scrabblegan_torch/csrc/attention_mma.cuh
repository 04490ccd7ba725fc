// The K walk of the non-local attention forward, shared by the attention
// forward kernel (attention_fwd.cu) and the whole-block kernel
// (fused_block_fwd.cu): for the queries a block owns, scores against every
// key, an online softmax in base 2, and the value product,
//
//   acc[q, :] = sum_k exp2(log2(e) (theta[q, :] . phi[:, k]) - m[q]) g[:, k],
//   l[q]      = sum_k exp2(...),
//
// with the division acc / l left to the caller. The (Q, K) scores never leave
// the chip. Two walks, one per operand dtype:
//
// bfloat16, `kwalk_mma`: both products on the tensor cores with mma.sync.
// - A block is 4 warps and 128 queries; a warp owns 32 queries, two m16 tiles
//   (on an H100, 16 queries a warp with twice the warps measured 3-9% slower,
//   and 256 queries a block, which halves what the blocks stage from L2, 1-2%
//   slower).
// - Scores: m16n8k8 bf16, one k8 step for Ca = 8 (Ca = 12 is padded with
//   zero channels to two steps, Ca = 24 takes three), float32 accumulators;
//   bf16 products are exact in float32. theta is the A operand, held in
//   registers for the whole walk; phi is the B operand.
// - Softmax: the scores of a chunk of 32 keys stay in the accumulators'
//   registers. The running max of a row moves at most once a chunk, and only
//   when a score of the warp exceeds it by more than 8 in log2 units (the
//   quotient acc / l does not depend on it, and probabilities up to 2^8 are
//   safe in float32 and keep bf16's relative precision); only then do the
//   four lanes that share a row exchange their maxima (two shuffles) and are
//   the sums rescaled, so the common chunk costs one compare a row. log2(e)
//   scales the float32 score in the one FMA that subtracts the max; exp2 is
//   ex2.approx. The row sum is kept per lane in float32, from the unrounded
//   probabilities, and reduced across the four lanes once at the end.
// - Value product: m16n8k16 bf16. The probabilities, rounded to bf16, are the
//   A operand straight from the score accumulators' registers (the
//   accumulator layout of m16n8 is the A layout of m16n8k16); g is the B
//   operand, Cg / 8 n-tiles (four for Cg = 32), float32 accumulators. At
//   Cg = 96 a lane holds 96 accumulators; the kernels that walk at the wider
//   widths ask for fewer blocks an SM, so registers do not spill.
// - Shared memory: phi and g stay bf16, channel-major as they arrive
//   ([Ca + Cg channels][128 keys + 8 of padding], so ldmatrix rows fall in
//   distinct banks), in key tiles of 128, double-buffered: the next tile
//   loads with 16-byte cp.async under the current tile's math. gT's rows are
//   the B layout of the value product as they are (ldmatrix); phi's channel
//   pairs are strided, so its B fragments are read with ldmatrix.trans.
//   16-byte copies need K a multiple of 8 and aligned rows; otherwise
//   (`vec` false) the tile is staged element by element. Keys past the end
//   are zero in shared memory and their scores are masked to -inf.
// What bounds it: not the products (80 flops a pair on the tensor cores) but
// one exp2 a (query, key) pair on the special-function units, 16 a clock on
// each SM, and the float32 bookkeeping of the softmax around it: per pair one
// FMA, one add for the row sum, about one max, half a bf16 pack. On an H100
// the walk runs at about half the exponentials' rate; taking out any one of
// the exp2, the max or the value product saves 8-12%, so it is the number of
// instructions issued that sets the pace, not one unit.
//
// float32, `kwalk_fma`: one thread a query, float32 FMAs on the CUDA cores,
// phi and g staged as float32 key-major in tiles of 128 keys, scores 32 at a
// time in registers. A single TF32 pass is not accurate enough under the
// exponential (the float32 tolerance is 1e-4), so float32 operands keep
// this loop.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

typedef __nv_bfloat16 bf16;

constexpr int kCa = 8;             // score channels (C / 8) of the ScrabbleGAN blocks
constexpr int kCg = 32;            // value channels (C / 2) of the ScrabbleGAN blocks
constexpr int kCt = kCa + kCg;     // channels staged per key
constexpr int kThreads = 128;      // threads a block, either walk
constexpr int kQb = 128;           // queries a block, either walk
constexpr int kMt = 2;             // m16 tiles of queries a warp owns in the mma walk
constexpr int kWarpQ = 16 * kMt;   // queries a warp in the mma walk
constexpr int kMmaBlocks = 4;      // blocks of the mma walk an SM should hold: 128 registers
constexpr int kKt = 128;           // keys per shared-memory tile
constexpr int kKs = 32;            // keys per chunk: the running max moves once a chunk
constexpr int kPad = 8;            // bf16 of padding per shared-memory row
constexpr int kRow = kKt + kPad;   // a shared-memory row of the mma walk, in bf16
constexpr float kSlack = 8.f;      // log2 units the running max may lag a row's true max by
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kKt % kKs == 0, "a tile holds whole chunks");

// The channel counts of one instance of the tensor-core kernels: CA score
// channels, padded with zero channels to kCaP, a whole number of the k8 steps
// of the score products (the padding is zeros in the theta fragments and zero
// rows of phi in shared memory, so it adds nothing); CG value channels, a
// whole number of the k16 steps of the value products. (8, 32) is the
// ScrabbleGAN blocks', (12, 48) and (24, 96) BigGAN's D and G at 128 x 128.
template <int CA, int CG>
struct Widths {
  static constexpr int kCaP = (CA + 7) / 8 * 8;  // score channels, padded
  static constexpr int kKs = kCaP / 8;           // k8 steps of a score
  static constexpr int kCt = kCaP + CG;          // rows a key tile stages
  static constexpr int kNt = CG / 8;             // n8 tiles of the value channels
  static_assert(CG % 16 == 0, "whole k16 steps of value channels");
};
static_assert(kQb == kThreads, "the float32 walk: a thread stages a key and owns a query");
static_assert(kQb == kThreads / 32 * kWarpQ, "the mma walk: the warps' queries are the block's");
static_assert(kQb == kKt, "an output tile reuses a key tile's rows");

// x rounded to bfloat16 and widened again
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// ---- PTX ---------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the last 16 - src_bytes of them zero
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of matrix l / 8
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row))
               : "memory");
}

// an 8x8 bf16 matrix held as an accumulator or A fragment holds it (lane l:
// row l / 4, columns 2 (l % 4) and the next), transposed, in the same layout
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(d) : "r"(a));
  return d;
}

// d = a b: (16 x 8) (8 x 8), bf16 operands, float32 sums from zero
__device__ __forceinline__ void mma_16808(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "f"(0.f));
}
// d += a b: (16 x 8) (8 x 8), bf16 operands, float32 sums
__device__ __forceinline__ void mma_16808_add(float (&d)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}
// the same with the A fragment as two registers
__device__ __forceinline__ void mma_16808(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%7, %7, %7, %7};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b), "f"(0.f));
}
__device__ __forceinline__ void mma_16808_add(float (&d)[4], uint32_t a0, uint32_t a1,
                                              uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5}, {%6}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(b));
}
// d += a b: (16 x 16) (16 x 8), bf16 operands, float32 sums
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats rounded to bf16, `lo` in the low half: a fragment register
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// ---- the bfloat16 walk on the tensor cores --------------------------------------

// `rows` rows of `cols` (at most kRow) bf16, `src_stride` apart in global
// memory and starting at column `c0` of them, into a shared-memory tile;
// columns from `c_len` on are zero. `vec`: c_len is a multiple of 8 and
// every row 16-byte aligned, so 16-byte cp.async does it (the caller commits
// and waits); else plain loads and stores.
__device__ __forceinline__ void stage_rows(bf16 (*dst)[kRow], const bf16* src, int rows,
                                           long long src_stride, int c0, int c_len, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < rows * (kKt / 8); i += kThreads) {
      const int r = i / (kKt / 8);
      const int j = (i % (kKt / 8)) * 8;
      const bf16* row = src + r * src_stride;
      const bool in = c0 + j < c_len;
      cp_async16(&dst[r][j], in ? row + c0 + j : row, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < rows * kKt; i += kThreads) {
      const int r = i / kKt;
      const int j = i % kKt;
      dst[r][j] = c0 + j < c_len ? src[r * src_stride + c0 + j] : __float2bfloat16(0.f);
    }
  }
}

// one key tile: phi in rows 0..CA - 1, g in rows kCaP..kCaP + CG - 1 (rows 0..7
// and 8..39 at the default widths); the padding rows between are left alone
// (see `zero_rows`)
template <int CA = kCa, int CG = kCg>
__device__ __forceinline__ void stage_kv(bf16 (*dst)[kRow], const bf16* ph, const bf16* gg,
                                         int k_len, int k0, bool vec) {
  stage_rows(dst, ph, CA, k_len, k0, k_len, vec);
  stage_rows(dst + Widths<CA, CG>::kCaP, gg, CG, k_len, k0, k_len, vec);
  cp_async_commit();
}

// rows r0..r1 - 1 of `n` shared-memory tiles `stride` rows apart set to zero,
// by every thread of the block: the score channels' padding, which no tile's
// staging writes; read only after the walk's first __syncthreads
__device__ __forceinline__ void zero_rows(bf16 (*tile)[kRow], int n, int stride, int r0, int r1) {
  const int rows = r1 - r0;
  for (int i = threadIdx.x; i < n * rows * kRow; i += kThreads) {
    const int t = i / (rows * kRow), r = r0 + (i / kRow) % rows;
    tile[t * stride + r][i % kRow] = __float2bfloat16(0.f);
  }
}

// The walk of one warp's 32 queries over all keys, at the widths (CA, CG)
// (`Widths`). The caller has staged key tile 0 into kv[0] (`stage_kv`) and, if
// CA is padded, zeroed the padding rows of both buffers (`zero_rows`); every
// thread of the block calls this, and warps without a query (`warp_active`
// false) only stage and synchronise.
// th[mt][2 ks + h]: the A fragment of theta's k8 step ks for the m16 tile mt,
// rows g + 8 h (g the lane's group, lane / 4), channels 8 ks + 2 t, 8 ks + 2 t +
// 1 (t = lane % 4), zero past CA; kLog2Scores says that log2(e) is already
// folded into it (the whole-block kernel's weight), else the walk scales the
// float32 scores.
// acc[mt][ct][e]: row g + 8 (e / 2), channel 8 ct + 2 t + e % 2, undivided;
// l[2 mt + h]: the row sums, reduced across the row's four lanes.
// The widths come from the last argument (a `Widths` tag), (8, 32) without it.
template <bool kLog2Scores, int CA = kCa, int CG = kCg>
__device__ __forceinline__ void kwalk_mma(const uint32_t (&th)[kMt][2 * Widths<CA, CG>::kKs],
                                          const bf16* ph, const bf16* gg, int k_len, bool vec,
                                          bf16 (*kv)[Widths<CA, CG>::kCt][kRow], bool warp_active,
                                          float (&acc)[kMt][CG / 8][4], float (&l)[2 * kMt],
                                          Widths<CA, CG> = {}) {
  using W = Widths<CA, CG>;
  constexpr float unit = kLog2Scores ? 1.f : kLog2e;  // log2 units per unit of score
  const int lane = threadIdx.x & 31;
  const int t = lane & 3;
  float m[2 * kMt];  // running max per row, in the scores' own units
#pragma unroll
  for (int r = 0; r < 2 * kMt; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int ct = 0; ct < W::kNt; ++ct)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][ct][e] = 0.f;

  const int tiles = (k_len + kKt - 1) / kKt;
  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kKt;
    if (it + 1 < tiles) {  // the next tile loads under this one's math
      stage_kv<CA, CG>(kv[(it + 1) & 1], ph, gg, k_len, k0 + kKt, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `it` has landed for every thread
    if (warp_active) {
      bf16(*cur)[kRow] = kv[it & 1];
      const int kn = min(kKt, k_len - k0);
      for (int j0 = 0; j0 < kn; j0 += kKs) {
        // scores of 32 queries x 32 keys: four n-tiles of 8 keys, a k8 step
        // of the channels at a time
        uint32_t pb[W::kKs][4];
#pragma unroll
        for (int ks = 0; ks < W::kKs; ++ks)
          ldmatrix_x4_trans(pb[ks], &cur[8 * ks + (lane & 7)][j0 + (lane >> 3) * 8]);
        float s[kMt][4][4];
#pragma unroll
        for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_16808(s[mt][nt], th[mt][0], th[mt][1], pb[0][nt]);
#pragma unroll
        for (int ks = 1; ks < W::kKs; ++ks)
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              mma_16808_add(s[mt][nt], th[mt][2 * ks], th[mt][2 * ks + 1], pb[ks][nt]);
        if (j0 + kKs > kn) {  // keys past the end
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j0 + nt * 8 + 2 * t + (e & 1) >= kn) {
#pragma unroll
                for (int mt = 0; mt < kMt; ++mt) s[mt][nt][e] = -INFINITY;
              }
        }
        // The lane's own max per row. The running max need not be the true one:
        // any value within reach of float32's exponent gives the same
        // quotient, so it moves, at most once a chunk, only when some lane of
        // the warp sees a score more than kSlack above it; then the four lanes
        // of every row agree on the new one and sums are rescaled.
        float cm[2 * kMt];
        bool moved = false;
#pragma unroll
        for (int r = 0; r < 2 * kMt; ++r) {
          const int mt = r >> 1, h = r & 1;
          float v = fmaxf(s[mt][0][2 * h], s[mt][0][2 * h + 1]);
#pragma unroll
          for (int nt = 1; nt < 4; ++nt)
            v = fmaxf(v, fmaxf(s[mt][nt][2 * h], s[mt][nt][2 * h + 1]));
          cm[r] = v;
          moved |= v > m[r] + kSlack / unit;
        }
        if (__any_sync(0xffffffffu, moved)) {
#pragma unroll
          for (int r = 0; r < 2 * kMt; ++r) {
            const int mt = r >> 1, h = r & 1;
            float v = fmaxf(cm[r], __shfl_xor_sync(0xffffffffu, cm[r], 1));
            v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
            const float mn = fmaxf(m[r], v);
            const float scale = ex2((m[r] - mn) * unit);  // 0 on the first chunk
            m[r] = mn;
            l[r] *= scale;
#pragma unroll
            for (int ct = 0; ct < W::kNt; ++ct) {
              acc[mt][ct][2 * h] *= scale;
              acc[mt][ct][2 * h + 1] *= scale;
            }
          }
        }
        float nm[2 * kMt];
#pragma unroll
        for (int r = 0; r < 2 * kMt; ++r) nm[r] = -m[r] * unit;
        // 16 keys at a time: probabilities, then the value product
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          uint32_t pa[kMt][4];
#pragma unroll
          for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
            for (int nn = 0; nn < 2; ++nn)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float* sc = s[mt][2 * kk + nn];
                const float p0 = ex2(fmaf(sc[2 * h], unit, nm[2 * mt + h]));
                const float p1 = ex2(fmaf(sc[2 * h + 1], unit, nm[2 * mt + h]));
                l[2 * mt + h] += p0 + p1;
                pa[mt][2 * nn + h] = pack_bf16(p0, p1);
              }
#pragma unroll
          for (int cp = 0; cp < CG / 16; ++cp) {  // two channel tiles a load
            uint32_t gb[4];
            ldmatrix_x4(gb, &cur[W::kCaP + (2 * cp + (lane >> 4)) * 8 + (lane & 7)]
                                [j0 + 16 * kk + ((lane >> 3) & 1) * 8]);
#pragma unroll
            for (int mt = 0; mt < kMt; ++mt) {
              mma_16816(acc[mt][2 * cp], pa[mt], gb[0], gb[1]);
              mma_16816(acc[mt][2 * cp + 1], pa[mt], gb[2], gb[3]);
            }
          }
        }
      }
    }
    __syncthreads();  // tile `it` is consumed
  }
#pragma unroll
  for (int r = 0; r < 2 * kMt; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// A warp's 32 columns (from `w0`) of a shared-memory tile of `rows` rows to
// global rows `dst_stride` apart; dst points at the tile's column 0 and
// `valid` columns of the tile exist. `vec`: valid is a multiple of 8 and the
// rows 16-byte aligned.
__device__ __forceinline__ void warp_copy_out(bf16 (*tile)[kRow], int rows, bf16* dst,
                                              long long dst_stride, int w0, int valid, bool vec) {
  const int lane = threadIdx.x & 31;
  for (int i = lane; i < rows * (kWarpQ / 8); i += 32) {
    const int r = i / (kWarpQ / 8);
    const int j = w0 + (i % (kWarpQ / 8)) * 8;
    if (vec) {
      if (j < valid)
        *reinterpret_cast<uint4*>(dst + r * dst_stride + j) =
            *reinterpret_cast<const uint4*>(&tile[r][j]);
    } else {
      for (int e = 0; e < 8; ++e)
        if (j + e < valid) dst[r * dst_stride + j + e] = tile[r][j + e];
    }
  }
}

// ---- the float32 walk on the CUDA cores -----------------------------------------

// One thread's query over all keys. theta in log2 units; kv is the block's
// tile of kKt keys, [key][phi 0..7 | g 0..31]; every thread of the block
// calls this, and a thread without a query (`active` false) only stages.
// acc is undivided, l the row sum.
__device__ __forceinline__ void kwalk_fma(const float (&theta)[kCa], const float* ph,
                                          const float* gg, int k_len, bool active,
                                          float (*kv)[kCt], float (&acc)[kCg], float& l) {
  float m = -INFINITY;  // running max, log2 units
  l = 0.f;              // running sum of exp2(s - m)
#pragma unroll
  for (int c = 0; c < kCg; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < k_len; k0 += kKt) {
    const int kn = min(kKt, k_len - k0);
    __syncthreads();  // the previous tile is consumed
    {
      // thread t stages key k0 + t; keys past the end are zero, so the
      // masked scores below multiply finite values only
      const int t = threadIdx.x;
      const bool kin = t < kn;
      const long long kk = k0 + t;
#pragma unroll
      for (int c = 0; c < kCa; ++c) kv[t][c] = kin ? ph[(long long)c * k_len + kk] : 0.f;
#pragma unroll
      for (int c = 0; c < kCg; ++c) kv[t][kCa + c] = kin ? gg[(long long)c * k_len + kk] : 0.f;
    }
    __syncthreads();
    if (!active) continue;

    for (int j0 = 0; j0 < kn; j0 += kKs) {
      float s[kKs];
      float cmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKs; ++j) {
        const float4* row = reinterpret_cast<const float4*>(kv[j0 + j]);
        const float4 p0 = row[0];
        const float4 p1 = row[1];
        float v = theta[0] * p0.x;
        v = fmaf(theta[1], p0.y, v);
        v = fmaf(theta[2], p0.z, v);
        v = fmaf(theta[3], p0.w, v);
        v = fmaf(theta[4], p1.x, v);
        v = fmaf(theta[5], p1.y, v);
        v = fmaf(theta[6], p1.z, v);
        v = fmaf(theta[7], p1.w, v);
        s[j] = (j0 + j < kn) ? v : -INFINITY;
        cmax = fmaxf(cmax, s[j]);
      }
      if (cmax > m) {  // rescale only when the running max moves
        const float scale = exp2f(m - cmax);  // 0 on the first chunk
        l *= scale;
#pragma unroll
        for (int c = 0; c < kCg; ++c) acc[c] *= scale;
        m = cmax;
      }
#pragma unroll
      for (int j = 0; j < kKs; ++j) {
        const float p = exp2f(s[j] - m);
        l += p;
        const float4* gv = reinterpret_cast<const float4*>(&kv[j0 + j][kCa]);
#pragma unroll
        for (int c4 = 0; c4 < kCg / 4; ++c4) {
          const float4 v = gv[c4];
          acc[4 * c4 + 0] = fmaf(p, v.x, acc[4 * c4 + 0]);
          acc[4 * c4 + 1] = fmaf(p, v.y, acc[4 * c4 + 1]);
          acc[4 * c4 + 2] = fmaf(p, v.z, acc[4 * c4 + 2]);
          acc[4 * c4 + 3] = fmaf(p, v.w, acc[4 * c4 + 3]);
        }
      }
    }
  }
}

}  // namespace attn

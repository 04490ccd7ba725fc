// Non-local attention backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attention_bwd_kernel`
// (scrabblegan_tpu/kernels/attention.py, called through `_pallas_backward`).
// With A = softmax_k(theta_q . phi_k) (unscaled) and out_q = sum_k A_qk g_k,
// for an output cotangent dout it computes, per batch:
//
//   dA_qk = dout_q . g_k
//   c_q   = sum_k A_qk dA_qk
//   dS_qk = A_qk (dA_qk - c_q)
//   dtheta_q = sum_k dS_qk phi_k,  dphi_k = sum_q dS_qk theta_q,
//   dg_k     = sum_q A_qk dout_q
//
// Operands are channel-packed as in the forward: thetaT (B, Ca, Q), phiT
// (B, Ca, K), gT (B, Cg, K), doutT (B, Cg, Q); the grads have the operands'
// shapes and dtypes. (Ca, Cg) is (8, 32) in float32 or bfloat16, or (12, 48)
// or (24, 96) in bfloat16: each pair is a template instance of the three
// kernels (`Widths` in attention_mma.cuh). A score product takes Ca in k8
// steps, Ca = 12 padded with zero channels to two; a dA product takes Cg in
// k16 steps, three for Cg = 48 (`ChannelFragments`). At (24, 96) the gradient
// kernel's tiles and dtheta slots take 116 KB of shared memory, one block an
// SM, and its registers are not bounded below 255.
//
// What bounds it on this card. The work is 176 flops and one exponential a
// (query, key) pair; at the train step's shapes (batch 16) a call is 1.6 M
// pairs (D's and W's B1 at len 5) to 105 M (G's B3 at len 10), microseconds
// of tensor-core time, so a call is bound by how many of the 132 SMs it
// reaches and by its launches: on an H100 (700 W) 0.015 ms on the device for
// the B1 call, where three empty launches take 0.009-0.016, and 0.20 ms for
// G's float32 B3 call at len 5, whose products cost six mma each. At large
// batches the gradient kernel issues about 155 instructions a warp for
// 16 x 16 pairs (18 mma, 8 exp2, the two-part split of A and dS a third of
// them) and runs at 2.4 ms for 1.68 G pairs (batch 1024, len 5, bf16), three
// times the forward's walk. The TPU kernel walks query blocks on a
// sequential grid axis and accumulates dphi and dg in VMEM; here blocks run
// in parallel, so the sums across blocks are partial sums in float32 scratch,
// added in a fixed order by a last small kernel: no float atomics, two runs
// give the same bits.
//
// Design: every product on the tensor cores (mma.sync, bfloat16 operands,
// float32 sums; fragments and staging from attention_mma.cuh), the scores and
// dA evaluated twice a pair:
// 1. `attention_bwd_stats_kernel`, queries as the M rows: lse_q (log2 units) and c_q.
//    A warp owns 16 queries: theta and dout are its A fragments for the whole
//    walk. K is staged channel-major in tiles of 128 keys, double-buffered
//    with 16-byte cp.async, and walked in chunks of 32: S = theta . phi
//    (m16n8k8) and dA = dout . g (two m16n8k16) stay in the accumulators.
//    Each lane keeps its own running max (moved only when a score exceeds it
//    by more than 8 log2 units, as in the forward), sum l and t = sum e dA
//    for its columns of a row, so the walk needs no shuffle; the four lanes
//    of a row, then the warps that split the keys, are merged at the end.
//    `query_warps` of a block's four warps split its queries and the others
//    the chunks of every tile, so the grid has B x Q / (16 query_warps)
//    blocks: the host picks query_warps so that a small batch fills the card.
// 2. `attention_bwd_grads_kernel`, keys as the M rows (S^T = phi^T theta), so that lse
//    and c broadcast along columns and dphi and dg are plain accumulators: a
//    block owns 64 keys, a warp 16 of them (phi and g are its A fragments),
//    and walks `tiles_per_split` query tiles of 128 (theta, dout, lse, c
//    staged as above) in steps of 16 queries. A^T = exp2(log2e s - lse) and
//    dS^T = A^T (dA^T - c) are formed in the score accumulators' registers
//    and become, rounded to bfloat16 parts, the A operand of dphi += dS^T
//    theta and dg += A^T dout (the accumulator layout of m16n8 is the A
//    layout of m16n8k16). dtheta needs dS with queries as rows: movmatrix
//    transposes the 8x8 blocks in registers, and dS phi of the warp's 16 keys
//    goes to shared memory, where the block's warps are summed in order into
//    the key tile's partial dtheta (B x key tiles x Ca x Q float32). The grid
//    is (key tiles, query splits, B); the host picks the split.
// 3. `attention_bwd_reduce_kernel`: dtheta = sum over key tiles, dphi and dg = sum over
//    query splits, in order, rounded once to the operands' dtype.
//
// Precision. The softmax statistics, c and every accumulator are float32.
// A product's operands are bfloat16 numbers: a bfloat16 operand is one
// (kParts = 1), a float32 operand is split into three whose sum is the
// float32 value (kParts = 3: hi, the rounding of what hi leaves, and of what
// both leave), and a product of two split operands is the sum of the six
// mma of parts i, j with i + j < 3. Two parts (three mma) leave the grads
// about 1e-4 (1 + |grad|) off the plain float32 backward, at the edge of the
// 2e-4 tolerance; three parts leave 1e-5. (One TF32 pass is far off; 3xTF32
// costs the same six-fold tensor time and has other fragment layouts.) A and
// dS are float32 in registers and are split the same way (kRegParts): three
// parts for float32 operands, two for bfloat16 ones, because dS rounded once
// to bfloat16 leaves dtheta and dphi up to 3e-2 (1 + |grad|) off, beyond the
// 2e-2 tolerance, and two parts 5e-3. A float32 call first writes its
// operands' parts as bfloat16 planes (`attention_bwd_split_kernel`, rows padded to 8
// columns so that 16-byte copies always apply), so kernels 1 and 2 read
// bfloat16 planes whatever the dtype.
//
// Staging: 16-byte cp.async into rows padded by 8 bf16 where the rows are
// aligned and the length a multiple of 8, element by element otherwise, chosen
// in the C entry; columns past the end are zero, keys past the end are masked
// to -inf (kernel 1) or are zero rows of phi (kernel 2), queries past the end
// get lse = +inf, so A = 0.
//
// The C entry launches on the caller's stream, does not synchronise, allocates
// nothing (the caller passes the scratch), and returns cudaGetLastError().

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int kWarps = kThreads / 32;  // warps a block, both kernels
constexpr int kRows = 16;              // rows of scores a warp owns; queries a step of kernel 2
constexpr int kKeys = kWarps * kRows;  // keys a block of kernel 2 owns
constexpr int kQt = kKt;               // queries per staged tile of kernel 2
constexpr int kSlotRow = kQt + 4;      // floats a channel of a warp's dtheta slot: banks 8 t + g
constexpr int kStatsBlocksPerSm = 2;   // blocks an SM the host's plan aims at: kernel 1,
constexpr int kGradsBlocksPerSm = 8;   // kernel 2 (measured: 2, 4, 8, 16, 32 at the step's shapes)
static_assert(kQt == kThreads, "a thread stages and sums one query of a tile");
constexpr float kLowest = -1e30f;      // a running max before any key; finite, so never inf - inf

// bfloat16 parts of an operand of type T, and of A and dS in registers
template <typename T> struct Parts;
template <> struct Parts<float> { static constexpr int kParts = 3, kRegParts = 3; };
template <> struct Parts<bf16> { static constexpr int kParts = 1, kRegParts = 2; };

// An operand as bfloat16 planes: element (part p, batch b, channel c, column
// j) at ptr[p * ps + b * bs + c * rs + j]; a row has rs columns in memory.
struct Src {
  const bf16* ptr;
  long long ps, bs;
  int rs;
  __device__ __forceinline__ const bf16* plane(int p, int b) const { return ptr + p * ps + b * bs; }
};

__device__ __forceinline__ uint32_t pack_if(bool ok, const bf16* lo, const bf16* hi) {
  return ok ? pack_bf16(*lo, *hi) : 0u;
}

// (x0, x1) as N bfloat16 pairs, part r into out[r][idx]
template <int N>
__device__ __forceinline__ void split_pack(float x0, float x1, uint32_t (&out)[N][4], int idx) {
#pragma unroll
  for (int r = 0; r < N; ++r) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
    out[r][idx] = *reinterpret_cast<const uint32_t*>(&v);
    if (r + 1 < N) {
      x0 -= __low2float(v);
      x1 -= __high2float(v);
    }
  }
}

// One tile of 128 columns from column c0: `a`'s CA channels into rows
// 0..CA - 1 and `c`'s CG into rows kCaP.. of every part's plane (rows 0..7 and
// 8..39 at the default widths); the padding rows between are left alone.
template <int P, int CA, int CG>
__device__ __forceinline__ void stage_tile(bf16 (*dst)[Widths<CA, CG>::kCt][kRow], const Src& a,
                                           const Src& c, int b, int c0, bool vec) {
#pragma unroll
  for (int p = 0; p < P; ++p) {
    stage_rows(dst[p], a.plane(p, b), CA, a.rs, c0, a.rs, vec);
    stage_rows(dst[p] + Widths<CA, CG>::kCaP, c.plane(p, b), CG, c.rs, c0, c.rs, vec);
  }
  cp_async_commit();
}

// Loads the B fragments of a k16 product whose B operand is CG channels of a
// staged tile from row r0 (channels as the contraction, `ldmatrix.trans`),
// for the 8-column n-tiles at columns col(n): full[i][n] holds the k16 steps
// 2 i and 2 i + 1 (channels 32 i.. of the four 8-row matrices), and, where CG
// is an odd number of k16 steps, half[n / 2][2 (n % 2)..] the last one, two
// n-tiles a load.
template <int CG, int N>
struct ChannelFragments {
  static constexpr int kFull = CG / 32, kHalf = (CG % 32) / 16;
  uint32_t full[kFull > 0 ? kFull : 1][N][4];
  uint32_t half[kHalf ? N / 2 : 1][4];

  template <typename Col>
  __device__ __forceinline__ void load(bf16 (*tile)[kRow], int r0, Col col) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < kFull; ++i)
#pragma unroll
      for (int n = 0; n < N; ++n)
        ldmatrix_x4_trans(full[i][n], &tile[r0 + 32 * i + (lane >> 3) * 8 + (lane & 7)][col(n)]);
    if constexpr (kHalf > 0) {
#pragma unroll
      for (int n2 = 0; n2 < N / 2; ++n2)
        ldmatrix_x4_trans(half[n2], &tile[r0 + 32 * kFull + ((lane >> 3) & 1) * 8 + (lane & 7)]
                                         [col(2 * n2 + (lane >> 4))]);
    }
  }
  // d0[n] += a[2 i] b and d1[n] += a[2 i + 1] b over the full pairs, then d0[n]
  // += the last step: consecutive mma go to different accumulators
  template <int M>
  __device__ __forceinline__ void mma(float (&d0)[M][4], float (&d1)[M][4],
                                      const uint32_t (&a)[CG / 16][4]) const {
    static_assert(M == N, "an accumulator a tile");
#pragma unroll
    for (int i = 0; i < kFull; ++i) {
#pragma unroll
      for (int n = 0; n < N; ++n) mma_16816(d0[n], a[2 * i], full[i][n][0], full[i][n][1]);
#pragma unroll
      for (int n = 0; n < N; ++n) mma_16816(d1[n], a[2 * i + 1], full[i][n][2], full[i][n][3]);
    }
    if constexpr (kHalf > 0) {
#pragma unroll
      for (int n = 0; n < N; ++n)
        mma_16816(d0[n], a[2 * kFull], half[n >> 1][2 * (n & 1)], half[n >> 1][2 * (n & 1) + 1]);
    }
  }
};

// ---- 0. float32 operands as bfloat16 planes --------------------------------------

struct SplitJob {
  const float* src;  // (B, c, n), batch stride bs
  bf16* dst;         // (P, B, c, np), np = n rounded up to 8, zero past n
  long long bs;
  int c, n, np;
};
struct SplitJobs { SplitJob job[4]; };

template <int P>
__global__ void attention_bwd_split_kernel(SplitJobs jobs, int batch) {
  const SplitJob jb = jobs.job[blockIdx.y];
  const long long groups = (long long)batch * jb.c * (jb.np / 8);  // 8 columns a thread
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < groups;
       i += (long long)gridDim.x * blockDim.x) {
    const int j = (i % (jb.np / 8)) * 8;
    const long long row = i / (jb.np / 8);
    const float* src = jb.src + (row / jb.c) * jb.bs + (row % jb.c) * jb.n;
    float x[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] = j + e < jb.n ? src[j + e] : 0.f;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 v = __floats2bfloat162_rn(x[2 * e], x[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&v);
        x[2 * e] -= __low2float(v);
        x[2 * e + 1] -= __high2float(v);
      }
      *reinterpret_cast<uint4*>(jb.dst + (p * groups + i) * 8) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ---- 1. lse and c per query --------------------------------------------------------

// blocks an SM the kernels ask for: shared memory's limit at the default
// widths; registers' at the wider ones
template <int P, int CG>
__host__ __device__ constexpr int stats_blocks() {
  return P > 1 ? 3 : CG <= 32 ? 4 : CG <= 48 ? 3 : 2;
}
template <int P, int CG>
__host__ __device__ constexpr int grads_blocks() {
  return P > 1 ? 2 : CG <= 32 ? 4 : CG <= 48 ? 3 : 1;
}

template <int P, int CA, int CG>
__global__ void __launch_bounds__(kThreads, stats_blocks<P, CG>())
attention_bwd_stats_kernel(Src th, Src ph, Src gg, Src dd, float* __restrict__ lse_out,
                 float* __restrict__ c_out, int q_len, int k_len, int wq, int vec_k) {
  using W = Widths<CA, CG>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*kv)[P][W::kCt][kRow] = reinterpret_cast<bf16(*)[P][W::kCt][kRow]>(smem);  // [buffer][part]
  float(*merge)[kRows][3] =
      reinterpret_cast<float(*)[kRows][3]>(smem + sizeof(bf16) * 2 * P * W::kCt * kRow);

  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qw = warp % wq, kg = warp / wq, nkg = kWarps / wq;  // query warp, key group
  const int q0 = (blockIdx.x * wq + qw) * kRows;
  const bool warp_active = q0 < q_len;

  stage_tile<P, CA, CG>(kv[0], ph, gg, b, 0, vec_k);
  if constexpr (W::kCaP > CA) zero_rows(kv[0][0], 2 * P, W::kCt, CA, W::kCaP);

  // A fragments for the whole walk: theta (16 x kCaP, a k8 step a pair of
  // registers, zero past CA), dout (16 x CG, a k16 step a row)
  uint32_t ta[P][2 * W::kKs], doa[P][CG / 16][4];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bf16* tp = th.plane(p, b);
    const bf16* dp = dd.plane(p, b);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int q = q0 + 8 * h + g;
      const bool ok = q < q_len;
#pragma unroll
      for (int ks = 0; ks < W::kKs; ++ks) {
        const int c = 8 * ks + 2 * t;  // channels c, c + 1
        const bf16* col = tp + (long long)c * th.rs + q;
        ta[p][2 * ks + h] = pack_if(ok && (W::kCaP == CA || c < CA), col, col + th.rs);
      }
#pragma unroll
      for (int s = 0; s < CG / 16; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long ch = 16 * s + 8 * hh + 2 * t;
          doa[p][s][h + 2 * hh] = pack_if(ok, dp + ch * dd.rs + q, dp + (ch + 1) * dd.rs + q);
        }
    }
  }

  // per row g + 8 h, over this lane's columns of it: running max (score units),
  // sum of exp2, sum of exp2 dA
  float m[2] = {kLowest, kLowest}, l[2] = {0.f, 0.f}, tt[2] = {0.f, 0.f};

  const int tiles = (k_len + kKt - 1) / kKt;
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {  // the next tile loads under this one's math
      stage_tile<P, CA, CG>(kv[(it + 1) & 1], ph, gg, b, (it + 1) * kKt, vec_k);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_active) {
      bf16(*cur)[W::kCt][kRow] = kv[it & 1];
      const int kn = min(kKt, k_len - it * kKt);
      for (int j0 = kg * kKs; j0 < kn; j0 += nkg * kKs) {
        // consecutive mma go to different accumulators (a dependent one waits
        // for the whole latency of the one before): alternate k16 steps of dA
        // have their own and are added at the end
        float s[4][4], da[4][4], da1[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] = da[nt][e] = da1[nt][e] = 0.f;
#pragma unroll
        for (int pj = 0; pj < P; ++pj) {
          uint32_t pb[W::kKs][4];        // phi: four n-tiles of 8 keys, a k8 step each
          ChannelFragments<CG, 4> gb;    // g: k16 steps of channels of each n-tile
#pragma unroll
          for (int ks = 0; ks < W::kKs; ++ks)
            ldmatrix_x4_trans(pb[ks], &cur[pj][8 * ks + (lane & 7)][j0 + (lane >> 3) * 8]);
          gb.load(cur[pj], W::kCaP, [&](int nt) { return j0 + nt * 8; });
#pragma unroll
          for (int pi = 0; pi < P - pj; ++pi) {
#pragma unroll
            for (int ks = 0; ks < W::kKs; ++ks)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                mma_16808_add(s[nt], ta[pi][2 * ks], ta[pi][2 * ks + 1], pb[ks][nt]);
            gb.mma(da, da1, doa[pi]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) da[nt][e] += da1[nt][e];
        if (j0 + kKs > kn) {  // keys past the end
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (j0 + nt * 8 + 2 * t + (e & 1) >= kn) s[nt][e] = -INFINITY;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float cm = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) cm = fmaxf(cm, fmaxf(s[nt][2 * h], s[nt][2 * h + 1]));
          if (cm > m[h] + kSlack / kLog2e) {
            const float scale = ex2((m[h] - cm) * kLog2e);  // 0 on the first chunk
            l[h] *= scale;
            tt[h] *= scale;
            m[h] = cm;
          }
          const float nm = -m[h] * kLog2e;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
#pragma unroll
            for (int e = 2 * h; e < 2 * h + 2; ++e) {
              const float p = ex2(fmaf(s[nt][e], kLog2e, nm));
              l[h] += p;
              tt[h] = fmaf(p, da[nt][e], tt[h]);
            }
        }
      }
    }
    __syncthreads();  // tile `it` is consumed
  }

  // the four lanes of a row, then the key groups, in a fixed order
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float w = ex2((m[h] - mx) * kLog2e);
    l[h] *= w;
    tt[h] *= w;
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    tt[h] += __shfl_xor_sync(0xffffffffu, tt[h], 1);
    tt[h] += __shfl_xor_sync(0xffffffffu, tt[h], 2);
    if (t == 0) {
      merge[warp][8 * h + g][0] = mx;
      merge[warp][8 * h + g][1] = l[h];
      merge[warp][8 * h + g][2] = tt[h];
    }
  }
  __syncthreads();
  if (kg == 0 && t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 8 * h + g;
      const int q = q0 + row;
      if (q >= q_len) continue;
      float mx = kLowest;
      for (int i = 0; i < nkg; ++i) mx = fmaxf(mx, merge[qw + i * wq][row][0]);
      float ls = 0.f, ts = 0.f;
      for (int i = 0; i < nkg; ++i) {
        const float* part = merge[qw + i * wq][row];
        const float w = ex2((part[0] - mx) * kLog2e);
        ls += part[1] * w;
        ts += part[2] * w;
      }
      lse_out[(long long)b * q_len + q] = mx * kLog2e + log2f(ls);
      c_out[(long long)b * q_len + q] = ts / ls;
    }
  }
}

// ---- 2. the gradients, keys as rows ---------------------------------------------------

template <int P, int R, int CA, int CG>
__global__ void __launch_bounds__(kThreads, grads_blocks<P, CG>())
attention_bwd_grads_kernel(Src th, Src ph, Src gg, Src dd, const float* __restrict__ lse,
                 const float* __restrict__ cq, float* __restrict__ dth_part,
                 float* __restrict__ dkv_part, int q_len, int k_len, int tiles_per_split,
                 int vec_q) {
  using W = Widths<CA, CG>;
  constexpr int KS = W::kKs;
  constexpr int kTerms = P > R ? P : R;  // parts i of A or dS and j of an operand: i + j < kTerms
  constexpr int kGroups = KS + W::kNt;   // 8-row groups of a staged tile: theta's, then dout's
  extern __shared__ __align__(16) unsigned char smem[];
  bf16(*qv)[P][W::kCt][kRow] = reinterpret_cast<bf16(*)[P][W::kCt][kRow]>(smem);  // [buffer][part]
  float(*st)[2][kQt] =
      reinterpret_cast<float(*)[2][kQt]>(smem + sizeof(bf16) * 2 * P * W::kCt * kRow);  // lse, c
  float(*slots)[W::kCaP][kSlotRow] = reinterpret_cast<float(*)[W::kCaP][kSlotRow]>(st + 2);

  const int b = blockIdx.z, kt = blockIdx.x, split = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int key0 = kt * kKeys + warp * kRows;
  const bool warp_active = key0 < k_len;
  const int warps_active = min(kWarps, (k_len - kt * kKeys + kRows - 1) / kRows);
  const int t0 = split * tiles_per_split;
  const int t1 = min(t0 + tiles_per_split, (q_len + kQt - 1) / kQt);
  const float* lse_b = lse + (long long)b * q_len;
  const float* c_b = cq + (long long)b * q_len;

  auto stage = [&](int tile) {
    stage_tile<P, CA, CG>(qv[(tile - t0) & 1], th, dd, b, tile * kQt, vec_q);
    for (int i = threadIdx.x; i < kQt; i += kThreads) {
      const int q = tile * kQt + i;
      st[(tile - t0) & 1][0][i] = q < q_len ? lse_b[q] : INFINITY;  // A = 0 past the end
      st[(tile - t0) & 1][1][i] = q < q_len ? c_b[q] : 0.f;
    }
  };
  stage(t0);
  if constexpr (W::kCaP > CA) zero_rows(qv[0][0], 2 * P, W::kCt, CA, W::kCaP);

  // A fragments of the warp's 16 keys: phi^T (16 x kCaP, a k8 step a pair of
  // registers), g^T (16 x CG, a k16 step a row); phi again as the B operand
  // of dtheta (16 keys x 8 channels a tile). Keys past the end and channels
  // past CA are zero in all three: their rows of A^T and dS^T are finite, add
  // nothing to dtheta, and their dphi and dg are not stored.
  uint32_t pa[P][2 * KS], ga[P][CG / 16][4], pbk[P][KS][2];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const bf16* pp = ph.plane(p, b);
    const bf16* gp = gg.plane(p, b);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int key = key0 + 8 * h + g;
      const bool ok = key < k_len;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int c = 8 * ks + 2 * t;  // channels c, c + 1
        const bf16* col = pp + (long long)c * ph.rs + key;
        pa[p][2 * ks + h] = pack_if(ok && (W::kCaP == CA || c < CA), col, col + ph.rs);
      }
#pragma unroll
      for (int s = 0; s < CG / 16; ++s)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const long long ch = 16 * s + 8 * hh + 2 * t;
          ga[p][s][h + 2 * hh] = pack_if(ok, gp + ch * gg.rs + key, gp + (ch + 1) * gg.rs + key);
        }
      const int kb = key0 + 8 * h + 2 * t;  // keys 2 t, 2 t + 1 of half h, channel 8 ks + g
      const bf16 zero = __float2bfloat16(0.f);
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const bool in = W::kCaP == CA || 8 * ks + g < CA;
        const bf16* row = pp + (long long)(8 * ks + g) * ph.rs;
        pbk[p][ks][h] = pack_bf16(in && kb < k_len ? row[kb] : zero,
                                  in && kb + 1 < k_len ? row[kb + 1] : zero);
      }
    }
  }

  // rows: keys g, g + 8; columns: channels 2 t, 2 t + 1 (+ 8 ks or 8 ct)
  float dphi[KS][4], dg[W::kNt][4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) dphi[ks][e] = 0.f;
#pragma unroll
    for (int ct = 0; ct < W::kNt; ++ct) dg[ct][e] = 0.f;
  }

  for (int tile = t0; tile < t1; ++tile) {
    const int buf = (tile - t0) & 1;
    if (tile + 1 < t1) {  // the next tile loads under this one's math
      stage(tile + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_active) {
      bf16(*cur)[W::kCt][kRow] = qv[buf];
      const int qn = min(kQt, q_len - tile * kQt);
      for (int j0 = 0; j0 < qn; j0 += kKs) {
        uint32_t tb[P][KS][4];  // theta: four n-tiles of 8 queries, a k8 step each
#pragma unroll
        for (int p = 0; p < P; ++p)
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
            ldmatrix_x4_trans(tb[p][ks], &cur[p][8 * ks + (lane & 7)][j0 + (lane >> 3) * 8]);
#pragma unroll
        for (int hq = 0; hq < 2; ++hq) {  // steps of 16 queries
          const int j1 = j0 + kRows * hq;
          if (j1 >= qn) break;
          // S^T = phi^T theta and dA^T = g^T dout: 16 keys x two n-tiles of 8 queries
          // (consecutive mma go to different accumulators: see kernel 1)
          float s[2][4], da[2][4], da1[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = da[n][e] = da1[n][e] = 0.f;
#pragma unroll
          for (int pj = 0; pj < P; ++pj) {
            ChannelFragments<CG, 2> db;  // dout: k16 steps of channels of each n-tile
            db.load(cur[pj], W::kCaP, [&](int n) { return j1 + n * 8; });
#pragma unroll
            for (int pi = 0; pi < P - pj; ++pi) {
#pragma unroll
              for (int ks = 0; ks < KS; ++ks)
#pragma unroll
                for (int n = 0; n < 2; ++n)
                  mma_16808_add(s[n], pa[pi][2 * ks], pa[pi][2 * ks + 1], tb[pj][ks][2 * hq + n]);
              db.mma(da, da1, ga[pi]);
            }
          }
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) da[n][e] += da1[n][e];
          // A^T and dS^T in place, as bfloat16 parts in the A layout of m16n8k16
          // (register h + 2 n: keys g + 8 h, queries 2 t, 2 t + 1 of n-tile n)
          uint32_t ap[R][4], dsp[R][4];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int col = j1 + n * 8 + 2 * t;
            const float2 ls = *reinterpret_cast<const float2*>(&st[buf][0][col]);
            const float2 cc = *reinterpret_cast<const float2*>(&st[buf][1][col]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float a0 = ex2(fmaf(s[n][2 * h], kLog2e, -ls.x));
              const float a1 = ex2(fmaf(s[n][2 * h + 1], kLog2e, -ls.y));
              split_pack<R>(a0, a1, ap, h + 2 * n);
              split_pack<R>(a0 * (da[n][2 * h] - cc.x), a1 * (da[n][2 * h + 1] - cc.y), dsp,
                            h + 2 * n);
            }
          }
          // dphi += dS^T theta and dg += A^T dout: the 16 queries are the
          // contraction. dtheta of the step = dS phi over the warp's keys: dS
          // with queries as rows is the transpose of each 8x8 block of dS^T.
          uint32_t dst[R][4];
#pragma unroll
          for (int pi = 0; pi < R; ++pi) {
            dst[pi][0] = movmatrix_trans(dsp[pi][0]);
            dst[pi][1] = movmatrix_trans(dsp[pi][2]);
            dst[pi][2] = movmatrix_trans(dsp[pi][1]);
            dst[pi][3] = movmatrix_trans(dsp[pi][3]);
          }
          float dth[KS][4];
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e) dth[ks][e] = 0.f;
          const int col = j1 + ((lane >> 3) & 1) * 8;
#pragma unroll
          for (int pj = 0; pj < P; ++pj) {
            // the tile's 8-row groups two a load (theta's, then dout's; an odd
            // last group twice): group u is fr[u / 2][2 (u % 2)], [.. + 1]
            uint32_t fr[(kGroups + 1) / 2][4];
#pragma unroll
            for (int i = 0; i < (kGroups + 1) / 2; ++i) {
              const int grp = min(2 * i + (lane >> 4), kGroups - 1);
              ldmatrix_x4(fr[i], &cur[pj][8 * grp + (lane & 7)][col]);
            }
#pragma unroll
            for (int pi = 0; pi < R && pi < kTerms - pj; ++pi) {
#pragma unroll
              for (int u = 0; u < kGroups; ++u) {
                const uint32_t b0 = fr[u >> 1][2 * (u & 1)], b1 = fr[u >> 1][2 * (u & 1) + 1];
                if (u < KS) mma_16816(dphi[u], dsp[pi], b0, b1);
                else mma_16816(dg[u - KS], ap[pi], b0, b1);
              }
#pragma unroll
              for (int ks = 0; ks < KS; ++ks)
                mma_16816(dth[ks], dst[pi], pbk[pj][ks][0], pbk[pj][ks][1]);
            }
          }
#pragma unroll
          for (int ks = 0; ks < KS; ++ks)
#pragma unroll
            for (int e = 0; e < 4; ++e)  // queries g, g + 8; channels 8 ks + 2 t, + 1
              slots[warp][8 * ks + 2 * t + (e & 1)][j1 + g + 8 * (e >> 1)] = dth[ks][e];
        }
      }
    }
    __syncthreads();  // tile consumed, slots written
    {
      // the key tile's partial dtheta: the block's warps in order. Unrolled, so
      // that a thread's loads are all in flight before its first sum.
      float* out = dth_part + ((long long)b * gridDim.x + kt) * CA * q_len;
      const int j = threadIdx.x;  // kQt == kThreads: a thread sums one query's CA channels
#pragma unroll
      for (int ch = 0; ch < CA; ++ch) {
        float v = slots[0][ch][j];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) v += w < warps_active ? slots[w][ch][j] : 0.f;
        if (tile * kQt + j < q_len) out[(long long)ch * q_len + tile * kQt + j] = v;
      }
    }
  }

  if (warp_active) {
    float* out = dkv_part + ((long long)b * gridDim.y + split) * (CA + CG) * k_len;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = key0 + g + 8 * (e >> 1);
      const int ch = 2 * t + (e & 1);
      if (key >= k_len) continue;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        if (W::kCaP == CA || 8 * ks + ch < CA)
          out[(long long)(8 * ks + ch) * k_len + key] = dphi[ks][e];
#pragma unroll
      for (int ct = 0; ct < W::kNt; ++ct)
        out[(long long)(CA + 8 * ct + ch) * k_len + key] = dg[ct][e];
    }
  }
}

// ---- 3. the partial sums, in order -------------------------------------------------------

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int CA, int CG>
__global__ void attention_bwd_reduce_kernel(const float* __restrict__ dth_part,
                                  const float* __restrict__ dkv_part, T* __restrict__ dthetaT,
                                  T* __restrict__ dphiT, T* __restrict__ dgT, int batch, int q_len,
                                  int k_len, int key_tiles, int splits) {
  const long long nq = (long long)CA * q_len, nk = (long long)(CA + CG) * k_len;
  const long long total = batch * (nq + nk);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < total;
       i += (long long)gridDim.x * blockDim.x) {
    if (i < batch * nq) {
      const long long b = i / nq, r = i % nq;
      const float* part = dth_part + b * key_tiles * nq + r;
      float v = part[0];
      for (int j = 1; j < key_tiles; ++j) v += part[j * nq];
      store(dthetaT + i, v);
    } else {
      const long long b = (i - batch * nq) / nk, r = (i - batch * nq) % nk;
      const float* part = dkv_part + b * splits * nk + r;
      float v = part[0];
      for (int j = 1; j < splits; ++j) v += part[j * nk];
      const long long na = (long long)CA * k_len;
      if (r < na) store(dphiT + b * na + r, v);
      else store(dgT + b * (nk - na) + r - na, v);
    }
  }
}

__global__ void attention_bwd_empty_kernel() {}

// ---- the host side -----------------------------------------------------------------------

template <int P, int CA, int CG>
__host__ __device__ constexpr int stats_smem() {
  return sizeof(bf16) * 2 * P * Widths<CA, CG>::kCt * kRow + sizeof(float) * kWarps * kRows * 3;
}
template <int P, int CA, int CG>
__host__ __device__ constexpr int grads_smem() {
  return sizeof(bf16) * 2 * P * Widths<CA, CG>::kCt * kRow +
         sizeof(float) * (2 * 2 * kQt + kWarps * Widths<CA, CG>::kCaP * kSlotRow);
}

inline int blocks_for(long long elements) {
  return static_cast<int>(elements / 256 < 1 ? 1 : elements / 256 > 2048 ? 2048 : elements / 256);
}

struct Call {
  const void *thetaT, *phiT, *gT, *doutT;
  void *dthetaT, *dphiT, *dgT;
  float *lse, *cq, *dth_part, *dkv_part;
  bf16* planes;
  int batch, q_len, k_len;
  long long theta_bs, phi_bs, g_bs, dout_bs;
  int query_warps, tiles_per_split;
};

// a bfloat16 operand as its own single plane; 16-byte copies where its rows allow them
inline Src own_plane(const void* p, long long bs, int n, int* vec) {
  *vec = *vec && n % 8 == 0 && bs % 8 == 0 && aligned16(p);
  return Src{static_cast<const bf16*>(p), 0, bs, n};
}

template <typename T, int CA, int CG>
cudaError_t launch(const Call& c, cudaStream_t s) {
  constexpr int P = Parts<T>::kParts, R = Parts<T>::kRegParts;
  const int key_tiles = (c.k_len + kKeys - 1) / kKeys;
  const int query_tiles = (c.q_len + kQt - 1) / kQt;
  const int splits = (query_tiles + c.tiles_per_split - 1) / c.tiles_per_split;
  Src th, ph, gg, dd;
  int vec_q = 1, vec_k = 1;
  if constexpr (P == 1) {
    th = own_plane(c.thetaT, c.theta_bs, c.q_len, &vec_q);
    dd = own_plane(c.doutT, c.dout_bs, c.q_len, &vec_q);
    ph = own_plane(c.phiT, c.phi_bs, c.k_len, &vec_k);
    gg = own_plane(c.gT, c.g_bs, c.k_len, &vec_k);
  } else {
    SplitJobs jobs;
    bf16* at = c.planes;
    int i = 0;
    auto planes_of = [&](const void* src, long long bs, int ch, int n) {
      const int np = (n + 7) / 8 * 8;  // rows padded to 8 columns: 16-byte copies always apply
      const long long plane = (long long)c.batch * ch * np;
      jobs.job[i++] = SplitJob{static_cast<const float*>(src), at, bs, ch, n, np};
      const Src out{at, plane, (long long)ch * np, np};
      at += P * plane;
      return out;
    };
    th = planes_of(c.thetaT, c.theta_bs, CA, c.q_len);
    ph = planes_of(c.phiT, c.phi_bs, CA, c.k_len);
    gg = planes_of(c.gT, c.g_bs, CG, c.k_len);
    dd = planes_of(c.doutT, c.dout_bs, CG, c.q_len);
    const dim3 grid(blocks_for((long long)c.batch * CG * dd.rs / 8), 4);
    attention_bwd_split_kernel<P><<<grid, 256, 0, s>>>(jobs, c.batch);
  }
  // more than 48 KB of shared memory a block has to be asked for, once per device
  static bool asked[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= 64 || !asked[device]) {
    err = cudaFuncSetAttribute(attention_bwd_stats_kernel<P, CA, CG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               stats_smem<P, CA, CG>());
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(attention_bwd_grads_kernel<P, R, CA, CG>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               grads_smem<P, CA, CG>());
    if (err != cudaSuccess) return err;
    if (device < 64) asked[device] = true;
  }
  const int wq = c.query_warps;
  const dim3 stats_grid((c.q_len + kRows * wq - 1) / (kRows * wq), c.batch);
  attention_bwd_stats_kernel<P, CA, CG><<<stats_grid, kThreads, stats_smem<P, CA, CG>(), s>>>(
      th, ph, gg, dd, c.lse, c.cq, c.q_len, c.k_len, wq, vec_k);
  const dim3 grads_grid(key_tiles, splits, c.batch);
  attention_bwd_grads_kernel<P, R, CA, CG><<<grads_grid, kThreads, grads_smem<P, CA, CG>(), s>>>(
      th, ph, gg, dd, c.lse, c.cq, c.dth_part, c.dkv_part, c.q_len, c.k_len, c.tiles_per_split,
      vec_q);
  const long long outs =
      (long long)c.batch * (CA * (long long)c.q_len + (CA + CG) * (long long)c.k_len);
  attention_bwd_reduce_kernel<T, CA, CG><<<blocks_for(outs), 256, 0, s>>>(
      c.dth_part, c.dkv_part, static_cast<T*>(c.dthetaT), static_cast<T*>(c.dphiT),
      static_cast<T*>(c.dgT), c.batch, c.q_len, c.k_len, key_tiles, splits);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (ca, cg): the channels of theta and phi,
// and of g and dout: (8, 32) in either dtype, (12, 48) and (24, 96) in
// bfloat16; any other pair returns cudaErrorInvalidValue and launches
// nothing. dthetaT (B, ca, Q), dphiT (B, ca, K) and dgT (B, cg, K) are
// dense. Scratch, all written before it is read: lse and cq float32 (B, Q);
// dth_part float32 (B, key tiles, ca, Q) with ceil(K / 64) key tiles;
// dkv_part float32 (B, splits, ca + cg, K) with ceil(ceil(Q / 128) /
// tiles_per_split) splits; planes, float32 operands only, bfloat16
// 3 x B x 40 x (Q + K, each rounded up to 8). query_warps is 1, 2 or 4 and
// tiles_per_split at least 1: the caller's plan.
// `device` is the operands' CUDA ordinal (see attention_fwd). Returns
// cudaGetLastError() after the launches: three, and the split before them for
// float32.
extern "C" int attention_bwd(const void* thetaT, const void* phiT, const void* gT,
                             const void* doutT, void* dthetaT, void* dphiT, void* dgT,
                             void* lse, void* cq, void* dth_part, void* dkv_part, void* planes,
                             int batch, int q_len, int k_len, long long theta_bs,
                             long long phi_bs, long long g_bs, long long dout_bs,
                             int query_warps, int tiles_per_split, int ca, int cg, int dtype,
                             int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if ((query_warps != 1 && query_warps != 2 && query_warps != 4) || tiles_per_split < 1 ||
      (dtype == 0 && planes == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Call c{thetaT, phiT, gT, doutT, dthetaT, dphiT, dgT,
               static_cast<float*>(lse), static_cast<float*>(cq), static_cast<float*>(dth_part),
               static_cast<float*>(dkv_part), static_cast<bf16*>(planes), batch, q_len, k_len,
               theta_bs, phi_bs, g_bs, dout_bs, query_warps, tiles_per_split};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ca == kCa && cg == kCg) {
    if (dtype == 1) return static_cast<int>(launch<bf16, kCa, kCg>(c, s));
    if (dtype == 0) return static_cast<int>(launch<float, kCa, kCg>(c, s));
  } else if (dtype == 1 && ca == 12 && cg == 48) {
    return static_cast<int>(launch<bf16, 12, 48>(c, s));
  } else if (dtype == 1 && ca == 24 && cg == 96) {
    return static_cast<int>(launch<bf16, 24, 96>(c, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As many empty launches as a backward call of that dtype makes: the floor
// under a call's time once the card is filled.
extern "C" int attention_bwd_floor(int dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  for (int i = 0; i < (dtype == 0 ? 4 : 3); ++i)
    attention_bwd_empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// The constants the host's plan and its CPU emulation share with the kernels.
extern "C" int attention_bwd_warps() { return kWarps; }
extern "C" int attention_bwd_warp_rows() { return kRows; }
extern "C" int attention_bwd_keys() { return kKeys; }
extern "C" int attention_bwd_query_tile() { return kQt; }
extern "C" int attention_bwd_stats_blocks_per_sm() { return kStatsBlocksPerSm; }
extern "C" int attention_bwd_grads_blocks_per_sm() { return kGradsBlocksPerSm; }
extern "C" int attention_bwd_parts(int dtype) {
  return dtype == 0 ? Parts<float>::kParts : Parts<bf16>::kParts;
}
extern "C" int attention_bwd_reg_parts(int dtype) {
  return dtype == 0 ? Parts<float>::kRegParts : Parts<bf16>::kRegParts;
}

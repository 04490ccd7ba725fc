// Non-local attention forward core for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attention_kernel`
// (scrabblegan_tpu/kernels/attention.py, called through `_pallas_forward`).
// Computes, per batch b and query q, with channel-packed operands:
//
//   outT[b, :, q] = sum_k softmax_k(theta[b, :, q] . phi[b, :, k]) * g[b, :, k]
//
// thetaT (B, Ca, Q), phiT (B, Ca, K), gT (B, Cg, K) -> outT (B, Cg, Q), float32
// or bfloat16 in and out, float32 sums inside. The attention is unscaled (no
// 1/sqrt(d)), as in the reference's NonLocalBlock. (Ca, Cg) is (8, 32), the
// ScrabbleGAN blocks', in either dtype, or in bfloat16 (12, 48) and (24, 96),
// BigGAN's D and G at 128 x 128: one template instance of the tensor-core
// kernel each (the (24, 96) one's key tiles take 64 KB of dynamic shared
// memory); the C entry refuses any other pair.
//
// The walk over the keys (scores, online base-2 softmax, value product) is
// attention_mma.cuh's, shared with the whole-block kernel; see its note for
// the design. This file adds what surrounds it:
// - grid (ceil(Q / 128), B), 128 threads; the ragged Q edge is masked;
// - bfloat16: a warp owns 32 queries. Its theta fragments are read straight
//   from global memory once (channel pairs of a query are strided by Q);
//   the divided output goes through shared memory, so a warp stores each
//   channel's 32 queries as 16-byte vectors (element by element where Q is
//   not a multiple of 8 or the rows are unaligned);
// - float32: one thread a query, theta premultiplied by log2(e), the output
//   stored to outT[b, c, q] with neighbouring threads on neighbouring q.
//
// What bounds it: at len 5, batch 1024, bfloat16 (Q = 2560, K = 640) the
// operands are 0.26 GB (0.08 ms at 3.35 TB/s) and the two products 134 GFLOP
// (0.14 ms on the tensor cores), but the 1.68 G exponentials need about
// 0.45 ms on the special-function units (16 a clock on each of 132 SMs), so
// the exponentials and the float32 softmax around them set the pace; the
// walk keeps them at one exp2 and a handful of float32 operations a pair.
// float32 operands run 80 flops a pair on the CUDA cores and are bound by
// those.
//
// The C entry launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include "attention_mma.cuh"

namespace {

using namespace attn;

// Blocks an SM the walk at value width CG asks for: 128 registers a thread at
// Cg = 32 (as the whole-block kernel), 168 at 48, 255 at 96, where a lane
// holds 96 accumulators.
template <int CG>
__host__ __device__ constexpr int mma_blocks() {
  return CG <= 32 ? kMmaBlocks : CG <= 48 ? 3 : 2;
}
// shared memory of the two key tiles at the widths (CA, CG), in bytes
template <int CA, int CG>
__host__ __device__ constexpr int fwd_smem() {
  return sizeof(bf16) * 2 * Widths<CA, CG>::kCt * kRow;
}
constexpr int kStaticSmem = 48 * 1024;  // more has to be dynamic, and asked for

// Each operand's (C, N) block is dense; *_bs is its batch stride in elements,
// so channel slices of a wider projection are taken without a copy.
template <int CA, int CG>
__global__ void __launch_bounds__(kThreads, mma_blocks<CG>())
attention_fwd_mma_kernel(const bf16* __restrict__ thetaT, const bf16* __restrict__ phiT,
                         const bf16* __restrict__ gT, bf16* __restrict__ outT, int q_len,
                         int k_len, long long theta_bs, long long phi_bs, long long g_bs,
                         int vec_k, int vec_q) {
  using W = Widths<CA, CG>;
  bf16(*kv)[W::kCt][kRow];
  if constexpr (fwd_smem<CA, CG>() <= kStaticSmem) {
    __shared__ __align__(16) bf16 kv_static[2][W::kCt][kRow];
    kv = kv_static;
  } else {
    extern __shared__ __align__(16) unsigned char fwd_dynamic[];
    kv = reinterpret_cast<bf16(*)[W::kCt][kRow]>(fwd_dynamic);
  }

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* th = thetaT + b * theta_bs;
  const bf16* ph = phiT + b * phi_bs;
  const bf16* gg = gT + b * g_bs;

  stage_kv<CA, CG>(kv[0], ph, gg, k_len, 0, vec_k);
  if constexpr (W::kCaP > CA) zero_rows(kv[0], 2, W::kCt, CA, W::kCaP);

  const int qw = q0 + warp * kWarpQ;
  uint32_t theta[kMt][2 * W::kKs];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int ks = 0; ks < W::kKs; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = qw + mt * 16 + h * 8 + g;
        const int c = 8 * ks + 2 * t;  // channels c, c + 1; zero past CA
        const bf16 zero = __float2bfloat16(0.f);
        const bool in0 = q < q_len && (W::kCaP == CA || c < CA);
        const bool in1 = q < q_len && (W::kCaP == CA || c + 1 < CA);
        theta[mt][2 * ks + h] = pack_bf16(in0 ? th[(long long)c * q_len + q] : zero,
                                          in1 ? th[(long long)(c + 1) * q_len + q] : zero);
      }

  const bool warp_active = qw < q_len;
  float acc[kMt][W::kNt][4];
  float l[2 * kMt];
  kwalk_mma<false>(theta, ph, gg, k_len, vec_k, kv, warp_active, acc, l, W{});

  if (!warp_active) return;
  bf16(*tile)[kRow] = kv[0];  // [channel][query of the block]: every key tile is consumed
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / l[2 * mt + h];
      const int col = warp * kWarpQ + mt * 16 + h * 8 + g;
#pragma unroll
      for (int ct = 0; ct < W::kNt; ++ct) {
        tile[ct * 8 + 2 * t][col] = __float2bfloat16(acc[mt][ct][2 * h] * inv);
        tile[ct * 8 + 2 * t + 1][col] = __float2bfloat16(acc[mt][ct][2 * h + 1] * inv);
      }
    }
  __syncwarp();
  warp_copy_out(tile, CG, outT + (long long)b * CG * q_len + q0, q_len, warp * kWarpQ,
                q_len - q0, vec_q);
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_fma_kernel(const float* __restrict__ thetaT, const float* __restrict__ phiT,
                         const float* __restrict__ gT, float* __restrict__ outT, int q_len,
                         int k_len, long long theta_bs, long long phi_bs, long long g_bs) {
  __shared__ __align__(16) float kv[kKt][kCt];  // [key][phi 0..7 | g 0..31]

  const int b = blockIdx.y;
  const int q = blockIdx.x * kQb + threadIdx.x;
  const bool active = q < q_len;
  const float* th = thetaT + b * theta_bs;

  float theta[kCa];
#pragma unroll
  for (int c = 0; c < kCa; ++c) theta[c] = active ? th[(long long)c * q_len + q] * kLog2e : 0.f;
  float acc[kCg];
  float l;
  kwalk_fma(theta, phiT + b * phi_bs, gT + b * g_bs, k_len, active, kv, acc, l);

  if (active) {
    const float inv = 1.f / l;
    float* o = outT + (long long)b * kCg * q_len;
#pragma unroll
    for (int c = 0; c < kCg; ++c) o[(long long)c * q_len + q] = acc[c] * inv;
  }
}

// The bfloat16 kernel at the widths (CA, CG) on `grid`: the dynamic shared
// memory of the wide instances is asked for once per device.
template <int CA, int CG>
cudaError_t launch_mma(dim3 grid, cudaStream_t s, const void* thetaT, const void* phiT,
                       const void* gT, void* outT, int q_len, int k_len, long long theta_bs,
                       long long phi_bs, long long g_bs, int vec_k, int vec_q) {
  constexpr int smem = fwd_smem<CA, CG>() <= kStaticSmem ? 0 : fwd_smem<CA, CG>();
  if constexpr (smem > 0) {
    static bool asked[64] = {};
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (device >= 64 || !asked[device]) {
      err = cudaFuncSetAttribute(attention_fwd_mma_kernel<CA, CG>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return err;
      if (device < 64) asked[device] = true;
    }
  }
  attention_fwd_mma_kernel<CA, CG><<<grid, kThreads, smem, s>>>(
      static_cast<const bf16*>(thetaT), static_cast<const bf16*>(phiT),
      static_cast<const bf16*>(gT), static_cast<bf16*>(outT), q_len, k_len, theta_bs, phi_bs,
      g_bs, vec_k, vec_q);
  return cudaSuccess;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. (ca, cg): the channels of theta and phi,
// and of g and the output: (8, 32) in either dtype, (12, 48) and (24, 96) in
// bfloat16; any other pair returns cudaErrorInvalidValue and launches nothing.
// `device` is the operands' CUDA ordinal: this library carries its own
// (static) CUDA runtime, whose current device is set here rather than
// inherited from the caller's. Returns cudaGetLastError() after the launch.
extern "C" int attention_fwd(const void* thetaT, const void* phiT, const void* gT,
                             void* outT, int batch, int q_len, int k_len,
                             long long theta_bs, long long phi_bs, long long g_bs,
                             int ca, int cg, int dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((q_len + kQb - 1) / kQb, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // 16-byte copies where the rows allow them, element by element otherwise
    const int vec_k = k_len % 8 == 0 && aligned16(phiT) && aligned16(gT) && phi_bs % 8 == 0 &&
                      g_bs % 8 == 0;
    const int vec_q = q_len % 8 == 0 && aligned16(outT);
    cudaError_t err;
    if (ca == kCa && cg == kCg)
      err = launch_mma<kCa, kCg>(grid, s, thetaT, phiT, gT, outT, q_len, k_len, theta_bs, phi_bs,
                                 g_bs, vec_k, vec_q);
    else if (ca == 12 && cg == 48)
      err = launch_mma<12, 48>(grid, s, thetaT, phiT, gT, outT, q_len, k_len, theta_bs, phi_bs,
                               g_bs, vec_k, vec_q);
    else if (ca == 24 && cg == 96)
      err = launch_mma<24, 96>(grid, s, thetaT, phiT, gT, outT, q_len, k_len, theta_bs, phi_bs,
                               g_bs, vec_k, vec_q);
    else
      return static_cast<int>(cudaErrorInvalidValue);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else if (dtype == 0 && ca == kCa && cg == kCg) {
    attention_fwd_fma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(thetaT), static_cast<const float*>(phiT),
        static_cast<const float*>(gT), static_cast<float*>(outT), q_len, k_len, theta_bs,
        phi_bs, g_bs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile sizes, so the host can check that its emulation of this kernel's
// blocking uses the same ones.
extern "C" int attention_fwd_key_tile() { return kKt; }
extern "C" int attention_fwd_key_chunk() { return kKs; }
extern "C" int attention_fwd_warp_queries() { return kWarpQ; }

// The whole non-local block forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_fused_block_kernel`
// (scrabblegan_tpu/kernels/attention.py, called through `_fused_block_forward`).
// Computes, per batch b and query q, around the pooled K-side operands:
//
//   theta[:, q]  = x[b, :, q]^T Wt                      (Wt with log2(e) folded in)
//   a[:, q]      = sum_k softmax2_k(theta[:, q] . phi[b, :, k]) * g[b, :, k]
//   out[b, :, q] = x[b, :, q] + Wo^T a[:, q]            (Wo with sigma folded in)
//
// x (B, 64, N) -> out (B, 64, N), Wt (64, 8), phiT (B, 8, K), gT (B, 32, K),
// Wo (32, 64); float32 or bfloat16 in and out, float32 sums inside, rounded to
// the working dtype where the TPU kernel rounds: theta, the attention output,
// the out projection, the residual sum. x is the NCHW activation viewed flat,
// so a query's 64 channels are strided by N.
//
// The walk over the keys is attention_mma.cuh's, shared with the attention
// forward kernel; this file keeps the two projections and the residual
// around it, so neither theta nor the attention output reaches device memory.
// Grid (ceil(N / 128), B), 128 threads; the ragged N edge and any K are masked.
// - bfloat16: a warp owns 32 queries. The block's x tile (64 channels x 128
//   queries, 17 KB) and Wo are staged in shared memory once (16-byte
//   cp.async where N is a multiple of 8 and the rows are aligned, element by
//   element otherwise). theta = x_q Wt runs as m16n8k16 mma with x as the A
//   operand (ldmatrix.trans from the channel-major tile) and Wt's fragments
//   read from global memory once; its accumulators, rounded, are the walk's
//   theta fragments. After the walk the divided, rounded attention output is
//   the A operand of the out projection straight from the walk's accumulators
//   (m16n8k16, Wo through ldmatrix.trans); its result is rounded and added to
//   x in place in the shared tile, which the warp then stores as 16-byte
//   vectors. x is read from device memory once.
// - float32: one thread a query; Wt and Wo in shared memory as float32, the
//   projections as FMAs around the CUDA-core walk, x re-read for the residual.
//
// What bounds it: at G's B3, len 5, batch 1024, bf16 (N = 2560, K = 640) the
// bytes that must move (x, phi, g in, out) are 723 MB, 0.216 ms at 3.35 TB/s,
// and the 147.6 GFLOP of the products 0.15 ms on the tensor cores; the 1.68 G
// exponentials of the walk need about 0.45 ms on the special-function units,
// so they set the pace, as in the attention forward kernel. The projections
// are 4% of the operations and ride the tensor cores beside the walk.
//
// The C entry launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include "attention_mma.cuh"

namespace {

using namespace attn;

constexpr int kC = 64;             // block channels
constexpr int kWoRow = kC + kPad;  // a shared-memory row of Wo, in bf16

// x's and out's (C, N) blocks are dense; phi's and g's (C, K) blocks are
// dense; *_bs are batch strides in elements (phi and g are channel slices of
// one pooled projection).
__global__ void __launch_bounds__(kThreads, kMmaBlocks)
fused_block_fwd_mma_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w_theta,
                           const bf16* __restrict__ phiT, const bf16* __restrict__ gT,
                           const bf16* __restrict__ w_out, bf16* __restrict__ out, int n,
                           int k_len, long long x_bs, long long phi_bs, long long g_bs,
                           int vec_k, int vec_n) {
  __shared__ __align__(16) bf16 kv[2][kCt][kRow];
  __shared__ __align__(16) bf16 xs[kC][kRow];      // [channel][query of the block]
  __shared__ __align__(16) bf16 wo[kCg][kWoRow];   // [attention channel][block channel]

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kQb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int w0 = warp * kWarpQ;  // the warp's first column of the tile
  const bf16* ph = phiT + b * phi_bs;
  const bf16* gg = gT + b * g_bs;

  // first the x tile, then key tile 0, so the theta projection runs under
  // the key tile's copy
  stage_rows(xs, x + b * x_bs, kC, n, q0, n, vec_n);
  cp_async_commit();
  stage_kv(kv[0], ph, gg, k_len, 0, vec_k);
  for (int i = threadIdx.x; i < kCg * kC; i += kThreads) wo[i / kC][i % kC] = w_out[i];

  // Wt's B fragments: rows (block channels) 16 ks + 2 t (+ 1, + 8, + 9), column g
  uint32_t wt[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ks * 16 + h * 8 + 2 * t;
      wt[ks][h] = pack_bf16(w_theta[c * kCa + g], w_theta[(c + 1) * kCa + g]);
    }
  cp_async_wait<1>();
  __syncthreads();  // the x tile and Wo are in shared memory

  const bool warp_active = q0 + w0 < n;
  uint32_t theta[kMt][2];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt) {
    float acc_t[4] = {0.f, 0.f, 0.f, 0.f};
    if (warp_active) {
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint32_t xa[4];
        ldmatrix_x4_trans(xa, &xs[ks * 16 + (lane >> 4) * 8 + (lane & 7)]
                                 [w0 + mt * 16 + ((lane >> 3) & 1) * 8]);
        mma_16816(acc_t, xa, wt[ks][0], wt[ks][1]);
      }
    }
    theta[mt][0] = pack_bf16(acc_t[0], acc_t[1]);  // rounded to bf16, as the TPU kernel's
    theta[mt][1] = pack_bf16(acc_t[2], acc_t[3]);
  }

  float acc[kMt][4][4];
  float l[2 * kMt];
  kwalk_mma<true>(theta, ph, gg, k_len, vec_k, kv, warp_active, acc, l);
  if (!warp_active) return;

  // the attention output, divided and rounded: the out projection's A fragments
  uint32_t attn_a[kMt][2][4];
#pragma unroll
  for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = 1.f / l[2 * mt + h];
#pragma unroll
      for (int ct = 0; ct < 4; ++ct)
        attn_a[mt][ct >> 1][2 * (ct & 1) + h] =
            pack_bf16(acc[mt][ct][2 * h] * inv, acc[mt][ct][2 * h + 1] * inv);
    }
  // out projection, two tiles of 8 block channels at a time; rounded, then
  // the residual in place in the x tile
#pragma unroll
  for (int cp = 0; cp < kC / 16; ++cp) {
    float o[kMt][2][4];
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[mt][nn][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t wb[4];
      ldmatrix_x4_trans(wb, &wo[ks * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)]
                               [(2 * cp + (lane >> 4)) * 8]);
#pragma unroll
      for (int mt = 0; mt < kMt; ++mt) {
        mma_16816(o[mt][0], attn_a[mt][ks], wb[0], wb[1]);
        mma_16816(o[mt][1], attn_a[mt][ks], wb[2], wb[3]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < kMt; ++mt)
#pragma unroll
      for (int nn = 0; nn < 2; ++nn)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bf16* cell = &xs[(2 * cp + nn) * 8 + 2 * t + (e & 1)][w0 + mt * 16 + (e >> 1) * 8 + g];
          *cell = __float2bfloat16(round_bf16(o[mt][nn][e]) + __bfloat162float(*cell));
        }
  }
  __syncwarp();
  warp_copy_out(xs, kC, out + (long long)b * kC * n + q0, n, w0, n - q0, vec_n);
}

__global__ void __launch_bounds__(kThreads)
fused_block_fwd_fma_kernel(const float* __restrict__ x, const float* __restrict__ w_theta,
                           const float* __restrict__ phiT, const float* __restrict__ gT,
                           const float* __restrict__ w_out, float* __restrict__ out, int n,
                           int k_len, long long x_bs, long long phi_bs, long long g_bs) {
  __shared__ __align__(16) float kv[kKt][kCt];  // [key][phi 0..7 | g 0..31]
  __shared__ float wt[kC][kCa];
  __shared__ float wo[kCg][kC];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kQb + threadIdx.x;
  const bool active = q < n;
  const float* xb = x + b * x_bs;

  for (int i = threadIdx.x; i < kC * kCa; i += kThreads) wt[i / kCa][i % kCa] = w_theta[i];
  for (int i = threadIdx.x; i < kCg * kC; i += kThreads) wo[i / kC][i % kC] = w_out[i];
  __syncthreads();

  float theta[kCa];
#pragma unroll
  for (int d = 0; d < kCa; ++d) theta[d] = 0.f;
  if (active) {
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const float xv = xb[(long long)c * n + q];
#pragma unroll
      for (int d = 0; d < kCa; ++d) theta[d] = fmaf(xv, wt[c][d], theta[d]);
    }
  }

  float acc[kCg];
  float l;
  kwalk_fma(theta, phiT + b * phi_bs, gT + b * g_bs, k_len, active, kv, acc, l);

  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int d = 0; d < kCg; ++d) acc[d] *= inv;
    float* ob = out + (long long)b * kC * n;
#pragma unroll 2
    for (int c = 0; c < kC; ++c) {
      float o = 0.f;
#pragma unroll
      for (int d = 0; d < kCg; ++d) o = fmaf(acc[d], wo[d][c], o);
      ob[(long long)c * n + q] = o + xb[(long long)c * n + q];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `device` is the operands' CUDA ordinal:
// this library carries its own (static) CUDA runtime, whose current device is
// set here rather than inherited from the caller's. Returns cudaGetLastError()
// after the launch.
extern "C" int fused_block_fwd(const void* x, const void* w_theta, const void* phiT,
                               const void* gT, const void* w_out, void* out, int batch,
                               int n, int k_len, long long x_bs, long long phi_bs,
                               long long g_bs, int dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((n + kQb - 1) / kQb, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // 16-byte copies where the rows allow them, element by element otherwise
    const int vec_k = k_len % 8 == 0 && aligned16(phiT) && aligned16(gT) && phi_bs % 8 == 0 &&
                      g_bs % 8 == 0;
    const int vec_n = n % 8 == 0 && aligned16(x) && aligned16(out) && x_bs % 8 == 0;
    fused_block_fwd_mma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const bf16*>(x), static_cast<const bf16*>(w_theta),
        static_cast<const bf16*>(phiT), static_cast<const bf16*>(gT),
        static_cast<const bf16*>(w_out), static_cast<bf16*>(out), n, k_len, x_bs, phi_bs, g_bs,
        vec_k, vec_n);
  } else if (dtype == 0) {
    fused_block_fwd_fma_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w_theta),
        static_cast<const float*>(phiT), static_cast<const float*>(gT),
        static_cast<const float*>(w_out), static_cast<float*>(out), n, k_len, x_bs, phi_bs,
        g_bs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's widths and tiles, so the host can check that its emulation
// and its wrapper use the same ones.
extern "C" int fused_block_fwd_channels() { return kC; }
extern "C" int fused_block_fwd_key_tile() { return kKt; }

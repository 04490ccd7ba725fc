// Non-local attention forward core for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_attention_kernel`
// (scrabblegan_tpu/kernels/attention.py, called through `_pallas_forward`).
// Computes, per batch b and query q, with channel-packed operands:
//
//   outT[b, :, q] = sum_k softmax_k(theta[b, :, q] . phi[b, :, k]) * g[b, :, k]
//
// thetaT (B, 8, Q), phiT (B, 8, K), gT (B, 32, K) -> outT (B, 32, Q), float32
// or bfloat16 in and out, float32 inside. The attention is unscaled (no
// 1/sqrt(d)), as in the reference's NonLocalBlock.
//
// Design (simple and exact first; see the TPU kernel for what it keeps out of
// device memory: the (Q, K) scores never leave the chip):
// - grid (ceil(Q / 128), B), 128 threads, one query row per thread; the ragged
//   Q edge is masked;
// - each thread keeps theta (8 floats, premultiplied by log2(e)), a running
//   max and sum, and 32 float32 accumulators in registers;
// - the block walks K in tiles of KT keys: phi and g of the tile are staged in
//   shared memory as float32, key-major (40 floats a key), so a thread reads
//   one key with ten 16-byte broadcast loads;
// - inside a tile, KS scores at a time are held in registers; the running max
//   moves once per chunk (online softmax in base 2, exp2f), and the sum is
//   divided out once at the end;
// - stores go to outT[b, c, q]: neighbouring threads write neighbouring q.
//
// What bounds it: float32 FMAs on the CUDA cores, about 80 flops per (q, k)
// pair (8 FMAs for the score, 32 for the value product, one exp2). At len 5,
// batch 1024 (Q = 2560, K = 640) that is ~134 GFLOP against ~0.26 GB of
// operand traffic, so it is far on the compute side of the roofline. Moving
// both products onto the tensor cores (mma.sync / wgmma, bf16 or TF32
// operands with the softmax kept in float32) is later work.
//
// The C entry launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCa = 8;             // score channels (C / 8)
constexpr int kCg = 32;            // value channels (C / 2)
constexpr int kCt = kCa + kCg;     // floats staged per key
constexpr int kThreads = 128;      // one query row per thread
constexpr int kKt = kThreads;      // keys per shared-memory tile: one per thread to stage
constexpr int kKs = 32;            // scores held in registers per chunk
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kKt % kKs == 0, "a tile holds whole chunks");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Each operand's (C, N) block is dense; *_bs is its batch stride in elements,
// so channel slices of a wider projection are taken without a copy.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ thetaT, const T* __restrict__ phiT,
                     const T* __restrict__ gT, T* __restrict__ outT, int q_len,
                     int k_len, long long theta_bs, long long phi_bs,
                     long long g_bs) {
  __shared__ __align__(16) float kv[kKt][kCt];  // [key][phi 0..7 | g 0..31]

  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < q_len;
  const T* th = thetaT + b * theta_bs;
  const T* ph = phiT + b * phi_bs;
  const T* gg = gT + b * g_bs;

  float theta[kCa];
#pragma unroll
  for (int c = 0; c < kCa; ++c) {
    theta[c] = active ? to_f32(th[(long long)c * q_len + q]) * kLog2e : 0.f;
  }
  float m = -INFINITY;  // running max, log2 units
  float l = 0.f;        // running sum of exp2(s - m)
  float acc[kCg];
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
      for (int c = 0; c < kCa; ++c) {
        kv[t][c] = kin ? to_f32(ph[(long long)c * k_len + kk]) : 0.f;
      }
#pragma unroll
      for (int c = 0; c < kCg; ++c) {
        kv[t][kCa + c] = kin ? to_f32(gg[(long long)c * k_len + kk]) : 0.f;
      }
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

  if (active) {
    const float inv = 1.f / l;
    T* o = outT + (long long)b * kCg * q_len;
#pragma unroll
    for (int c = 0; c < kCg; ++c) {
      o[(long long)c * q_len + q] = from_f32<T>(acc[c] * inv);
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. `device` is the operands' CUDA ordinal:
// this library carries its own (static) CUDA runtime, whose current device is
// set here rather than inherited from the caller's. Returns cudaGetLastError()
// after the launch.
extern "C" int attention_fwd(const void* thetaT, const void* phiT, const void* gT,
                             void* outT, int batch, int q_len, int k_len,
                             long long theta_bs, long long phi_bs, long long g_bs,
                             int dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const dim3 grid((q_len + kThreads - 1) / kThreads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    attention_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(thetaT), static_cast<const __nv_bfloat16*>(phiT),
        static_cast<const __nv_bfloat16*>(gT), static_cast<__nv_bfloat16*>(outT), q_len,
        k_len, theta_bs, phi_bs, g_bs);
  } else if (dtype == 0) {
    attention_fwd_kernel<float><<<grid, kThreads, 0, s>>>(
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

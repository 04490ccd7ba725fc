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
// Wo (32, 64); float32 or bfloat16 in and out, float32 inside, rounded to the
// working dtype where the TPU kernel rounds: theta, the attention output, the
// out projection, the residual sum. x is the NCHW activation viewed flat, so
// a query's 64 channels are strided by N.
//
// Design (simple and right first): the attention forward kernel
// (attention_fwd.cu) with the two projections and the residual moved inside,
// so neither theta nor the attention output ever reaches device memory.
// - grid (ceil(N / 128), B), 128 threads, one query per thread; the ragged N
//   edge and any K are masked;
// - Wt and Wo are staged in shared memory as float32 (10 KB); every thread
//   reads the same entry at a time, a broadcast;
// - each thread reads its query's 64 channels of x (neighbouring threads,
//   neighbouring q: coalesced) and forms theta in float32;
// - K is walked in shared-memory tiles of 128 keys (phi and g as float32,
//   key-major, 40 floats a key) with the base-2 online softmax of the forward
//   kernel: scores 32 at a time in registers, the running max moving once a
//   chunk, one division at the end;
// - the out projection runs channel by channel, 32 FMAs each, and re-reads x
//   for the residual (it is in L2) rather than holding 64 more registers.
//
// What bounds it: at G's B3, len 5, batch 1024, bf16 (N = 2560, K = 640) the
// bytes that must move (x, phi, g in, out) are 723 MB, 0.216 ms at 3.35 TB/s;
// the arithmetic is 147.6 GFLOP, 80 flops a (q, k) pair and 5,120 a query for
// the projections. Here that arithmetic runs as float32 FMAs on the CUDA
// cores (67 TFLOP/s), ~2.2 ms at best, and exp2 of 1.68 G scores on the
// special-function units, so the kernel is bound by operations, as the
// attention forward kernel is. The tensor cores are later work.
//
// The C entry launches on the caller's stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kC = 64;             // block channels
constexpr int kCa = 8;             // score channels (C / 8)
constexpr int kCg = 32;            // value channels (C / 2)
constexpr int kCt = kCa + kCg;     // floats staged per key
constexpr int kThreads = 128;      // one query per thread
constexpr int kKt = kThreads;      // keys per shared-memory tile: one per thread to stage
constexpr int kKs = 32;            // scores held in registers per chunk

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

// x rounded to the working dtype T and widened again
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// x's and out's (C, N) blocks are dense; phi's and g's (C, K) blocks are
// dense; *_bs are batch strides in elements (phi and g are channel slices of
// one pooled projection).
template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_block_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w_theta,
                       const T* __restrict__ phiT, const T* __restrict__ gT,
                       const T* __restrict__ w_out, T* __restrict__ out, int n,
                       int k_len, long long x_bs, long long phi_bs, long long g_bs) {
  __shared__ __align__(16) float kv[kKt][kCt];  // [key][phi 0..7 | g 0..31]
  __shared__ float wt[kC][kCa];
  __shared__ float wo[kCg][kC];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < n;
  const T* xb = x + b * x_bs;
  const T* ph = phiT + b * phi_bs;
  const T* gg = gT + b * g_bs;

  for (int i = threadIdx.x; i < kC * kCa; i += kThreads) wt[i / kCa][i % kCa] = to_f32(w_theta[i]);
  for (int i = threadIdx.x; i < kCg * kC; i += kThreads) wo[i / kC][i % kC] = to_f32(w_out[i]);
  __syncthreads();

  float theta[kCa];
#pragma unroll
  for (int d = 0; d < kCa; ++d) theta[d] = 0.f;
  if (active) {
#pragma unroll 4
    for (int c = 0; c < kC; ++c) {
      const float xv = to_f32(xb[(long long)c * n + q]);
#pragma unroll
      for (int d = 0; d < kCa; ++d) theta[d] = fmaf(xv, wt[c][d], theta[d]);
    }
  }
#pragma unroll
  for (int d = 0; d < kCa; ++d) theta[d] = round_to<T>(theta[d]);

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
#pragma unroll
    for (int d = 0; d < kCg; ++d) acc[d] = round_to<T>(acc[d] * inv);
    T* ob = out + (long long)b * kC * n;
#pragma unroll 2
    for (int c = 0; c < kC; ++c) {
      float o = 0.f;
#pragma unroll
      for (int d = 0; d < kCg; ++d) o = fmaf(acc[d], wo[d][c], o);
      const float y = round_to<T>(o) + to_f32(xb[(long long)c * n + q]);
      ob[(long long)c * n + q] = from_f32<T>(y);
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
  const dim3 grid((n + kThreads - 1) / kThreads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    using T = __nv_bfloat16;
    fused_block_fwd_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w_theta), static_cast<const T*>(phiT),
        static_cast<const T*>(gT), static_cast<const T*>(w_out), static_cast<T*>(out), n,
        k_len, x_bs, phi_bs, g_bs);
  } else if (dtype == 0) {
    using T = float;
    fused_block_fwd_kernel<T><<<grid, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(w_theta), static_cast<const T*>(phiT),
        static_cast<const T*>(gT), static_cast<const T*>(w_out), static_cast<T*>(out), n,
        k_len, x_bs, phi_bs, g_bs);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The kernel's widths and tiles, so the host can check that its emulation
// and its wrapper use the same ones.
extern "C" int fused_block_fwd_channels() { return kC; }
extern "C" int fused_block_fwd_key_tile() { return kKt; }

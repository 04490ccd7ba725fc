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
// Operands are channel-packed as in the forward: thetaT (B, 8, Q), phiT
// (B, 8, K), gT (B, 32, K), doutT (B, 32, Q); the grads have the operands'
// shapes and dtypes (float32 or bfloat16), the math is float32 throughout.
//
// Design. The TPU kernel recomputes A per query block and accumulates dphi /
// dg in VMEM across a sequential grid axis. Hopper's blocks run in parallel
// and in no order, so that accumulation does not carry over; this design
// splits the work in two launches, one thread per row, with no atomics, so
// two runs give the same bits:
// 1. query side, grid (ceil(Q / 128), B): one thread per query. Pass 1 walks
//    the keys in shared-memory tiles of 128 (phi and g as float32, key-major)
//    with an online base-2 softmax that keeps the running max m, the sum l
//    and t = sum_k e_k dA_k, so that c = t / l. Pass 2 walks the keys again
//    and forms dtheta from A = exp2(s - lse), lse = m + log2(l). It writes
//    dtheta and the per-row lse and c to float32 scratch (B, Q).
// 2. key side, grid (ceil(K / 128), B): one thread per key, phi_k and g_k in
//    registers. It walks the queries in shared-memory tiles of 128 (theta,
//    dout, lse, c) and accumulates dphi_k and dg_k in registers, in query
//    order.
// Ragged Q and K edges are masked by loop bounds (a tile's rows past the end
// are never read) and by the `active` test on the thread's own row.
//
// What bounds it: float32 FMAs on the CUDA cores. A (q, k) pair costs about
// 8 + 32 FMAs and an exp2 in each query-side pass and 8 + 32 + 8 + 32 in the
// key-side pass: ~250 flops, about 3x the forward's ~80. c_q could instead be
// dout_q . out_q from a saved forward output, which would drop the query side's
// first pass, at a small cost in bf16 accuracy (out would be stored in bf16);
// moving the products onto the tensor cores (mma.sync / wgmma) is later work.
//
// The C entry launches both kernels on the caller's stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kCa = 8;          // score channels (C / 8)
constexpr int kCg = 32;         // value channels (C / 2)
constexpr int kThreads = 128;   // one row per thread
constexpr int kTile = kThreads; // rows staged per shared-memory tile
constexpr int kKRow = kCa + kCg;          // key row: phi 0..7 | g 0..31
constexpr int kQRow = kCa + kCg + 4;      // query row: theta | dout | lse, c, pad
constexpr float kLog2e = 1.4426950408889634f;

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

__device__ __forceinline__ float dot8(const float* a, const float4* b) {
  const float4 b0 = b[0];
  const float4 b1 = b[1];
  float v = a[0] * b0.x;
  v = fmaf(a[1], b0.y, v);
  v = fmaf(a[2], b0.z, v);
  v = fmaf(a[3], b0.w, v);
  v = fmaf(a[4], b1.x, v);
  v = fmaf(a[5], b1.y, v);
  v = fmaf(a[6], b1.z, v);
  v = fmaf(a[7], b1.w, v);
  return v;
}

__device__ __forceinline__ float dot32(const float* a, const float4* b) {
  float v = 0.f;
#pragma unroll
  for (int c4 = 0; c4 < kCg / 4; ++c4) {
    const float4 w = b[c4];
    v = fmaf(a[4 * c4 + 0], w.x, v);
    v = fmaf(a[4 * c4 + 1], w.y, v);
    v = fmaf(a[4 * c4 + 2], w.z, v);
    v = fmaf(a[4 * c4 + 3], w.w, v);
  }
  return v;
}

// Stage keys k0 .. k0 + kn - 1 of phi and g into kv (thread t stages key t).
template <typename T>
__device__ __forceinline__ void stage_keys(float (*kv)[kKRow], const T* ph, const T* gg,
                                           int k_len, int k0, int kn) {
  const int t = threadIdx.x;
  if (t >= kn) return;
  const long long kk = k0 + t;
#pragma unroll
  for (int c = 0; c < kCa; ++c) kv[t][c] = to_f32(ph[(long long)c * k_len + kk]);
#pragma unroll
  for (int c = 0; c < kCg; ++c) kv[t][kCa + c] = to_f32(gg[(long long)c * k_len + kk]);
}

// Each operand's (C, N) block is dense; *_bs is its batch stride in elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_query_kernel(const T* __restrict__ thetaT, const T* __restrict__ phiT,
                           const T* __restrict__ gT, const T* __restrict__ doutT,
                           T* __restrict__ dthetaT, float* __restrict__ lse_out,
                           float* __restrict__ c_out, int q_len, int k_len,
                           long long theta_bs, long long phi_bs, long long g_bs,
                           long long dout_bs) {
  __shared__ __align__(16) float kv[kTile][kKRow];

  const int b = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < q_len;
  const T* th = thetaT + b * theta_bs;
  const T* ph = phiT + b * phi_bs;
  const T* gg = gT + b * g_bs;
  const T* dd = doutT + b * dout_bs;

  float theta2[kCa];  // theta * log2(e): scores in log2 units
  float dout[kCg];
#pragma unroll
  for (int c = 0; c < kCa; ++c) {
    theta2[c] = active ? to_f32(th[(long long)c * q_len + q]) * kLog2e : 0.f;
  }
#pragma unroll
  for (int c = 0; c < kCg; ++c) dout[c] = active ? to_f32(dd[(long long)c * q_len + q]) : 0.f;

  // pass 1: running max m, sum l of exp2(s - m), and t = sum exp2(s - m) dA
  float m = -INFINITY, l = 0.f, t = 0.f;
  for (int k0 = 0; k0 < k_len; k0 += kTile) {
    const int kn = min(kTile, k_len - k0);
    __syncthreads();  // the previous tile is consumed
    stage_keys(kv, ph, gg, k_len, k0, kn);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < kn; ++j) {
      const float4* row = reinterpret_cast<const float4*>(kv[j]);
      const float s = dot8(theta2, row);
      const float da = dot32(dout, row + kCa / 4);
      if (s > m) {  // rescale only when the running max moves
        const float scale = exp2f(m - s);  // 0 on the first key
        l *= scale;
        t *= scale;
        m = s;
      }
      const float e = exp2f(s - m);
      l += e;
      t = fmaf(e, da, t);
    }
  }
  const float lse = m + log2f(l);
  const float cq = t / l;

  // pass 2: dtheta_q = sum_k A_qk (dA_qk - c_q) phi_k
  float dth[kCa];
#pragma unroll
  for (int c = 0; c < kCa; ++c) dth[c] = 0.f;
  for (int k0 = 0; k0 < k_len; k0 += kTile) {
    const int kn = min(kTile, k_len - k0);
    __syncthreads();
    stage_keys(kv, ph, gg, k_len, k0, kn);
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < kn; ++j) {
      const float4* row = reinterpret_cast<const float4*>(kv[j]);
      const float s = dot8(theta2, row);
      const float da = dot32(dout, row + kCa / 4);
      const float ds = exp2f(s - lse) * (da - cq);
      const float4 p0 = row[0];
      const float4 p1 = row[1];
      dth[0] = fmaf(ds, p0.x, dth[0]);
      dth[1] = fmaf(ds, p0.y, dth[1]);
      dth[2] = fmaf(ds, p0.z, dth[2]);
      dth[3] = fmaf(ds, p0.w, dth[3]);
      dth[4] = fmaf(ds, p1.x, dth[4]);
      dth[5] = fmaf(ds, p1.y, dth[5]);
      dth[6] = fmaf(ds, p1.z, dth[6]);
      dth[7] = fmaf(ds, p1.w, dth[7]);
    }
  }

  if (active) {
    T* o = dthetaT + (long long)b * kCa * q_len;
#pragma unroll
    for (int c = 0; c < kCa; ++c) o[(long long)c * q_len + q] = from_f32<T>(dth[c]);
    lse_out[(long long)b * q_len + q] = lse;
    c_out[(long long)b * q_len + q] = cq;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_key_kernel(const T* __restrict__ thetaT, const T* __restrict__ phiT,
                         const T* __restrict__ gT, const T* __restrict__ doutT,
                         const float* __restrict__ lse_in, const float* __restrict__ c_in,
                         T* __restrict__ dphiT, T* __restrict__ dgT, int q_len, int k_len,
                         long long theta_bs, long long phi_bs, long long g_bs,
                         long long dout_bs) {
  __shared__ __align__(16) float qv[kTile][kQRow];  // [query][theta | dout | lse, c]

  const int b = blockIdx.y;
  const int k = blockIdx.x * kThreads + threadIdx.x;
  const bool active = k < k_len;
  const T* th = thetaT + b * theta_bs;
  const T* ph = phiT + b * phi_bs;
  const T* gg = gT + b * g_bs;
  const T* dd = doutT + b * dout_bs;
  const float* lse_b = lse_in + (long long)b * q_len;
  const float* c_b = c_in + (long long)b * q_len;

  float phi2[kCa];  // phi * log2(e): scores in log2 units
  float g[kCg];
#pragma unroll
  for (int c = 0; c < kCa; ++c) {
    phi2[c] = active ? to_f32(ph[(long long)c * k_len + k]) * kLog2e : 0.f;
  }
#pragma unroll
  for (int c = 0; c < kCg; ++c) g[c] = active ? to_f32(gg[(long long)c * k_len + k]) : 0.f;
  float dphi[kCa], dg[kCg];
#pragma unroll
  for (int c = 0; c < kCa; ++c) dphi[c] = 0.f;
#pragma unroll
  for (int c = 0; c < kCg; ++c) dg[c] = 0.f;

  for (int q0 = 0; q0 < q_len; q0 += kTile) {
    const int qn = min(kTile, q_len - q0);
    __syncthreads();  // the previous tile is consumed
    {
      const int r = threadIdx.x;
      if (r < qn) {
        const long long qq = q0 + r;
#pragma unroll
        for (int c = 0; c < kCa; ++c) qv[r][c] = to_f32(th[(long long)c * q_len + qq]);
#pragma unroll
        for (int c = 0; c < kCg; ++c) qv[r][kCa + c] = to_f32(dd[(long long)c * q_len + qq]);
        qv[r][kCa + kCg] = lse_b[qq];
        qv[r][kCa + kCg + 1] = c_b[qq];
      }
    }
    __syncthreads();
    if (!active) continue;
    for (int j = 0; j < qn; ++j) {
      const float4* row = reinterpret_cast<const float4*>(qv[j]);
      const float s = dot8(phi2, row);
      const float da = dot32(g, row + kCa / 4);
      const float4 tail = row[(kCa + kCg) / 4];  // lse, c, pad, pad
      const float a = exp2f(s - tail.x);
      const float ds = a * (da - tail.y);
      const float4 t0 = row[0];
      const float4 t1 = row[1];
      dphi[0] = fmaf(ds, t0.x, dphi[0]);
      dphi[1] = fmaf(ds, t0.y, dphi[1]);
      dphi[2] = fmaf(ds, t0.z, dphi[2]);
      dphi[3] = fmaf(ds, t0.w, dphi[3]);
      dphi[4] = fmaf(ds, t1.x, dphi[4]);
      dphi[5] = fmaf(ds, t1.y, dphi[5]);
      dphi[6] = fmaf(ds, t1.z, dphi[6]);
      dphi[7] = fmaf(ds, t1.w, dphi[7]);
      const float4* dv = row + kCa / 4;
#pragma unroll
      for (int c4 = 0; c4 < kCg / 4; ++c4) {
        const float4 v = dv[c4];
        dg[4 * c4 + 0] = fmaf(a, v.x, dg[4 * c4 + 0]);
        dg[4 * c4 + 1] = fmaf(a, v.y, dg[4 * c4 + 1]);
        dg[4 * c4 + 2] = fmaf(a, v.z, dg[4 * c4 + 2]);
        dg[4 * c4 + 3] = fmaf(a, v.w, dg[4 * c4 + 3]);
      }
    }
  }

  if (active) {
    T* op = dphiT + (long long)b * kCa * k_len;
    T* og = dgT + (long long)b * kCg * k_len;
#pragma unroll
    for (int c = 0; c < kCa; ++c) op[(long long)c * k_len + k] = from_f32<T>(dphi[c]);
#pragma unroll
    for (int c = 0; c < kCg; ++c) og[(long long)c * k_len + k] = from_f32<T>(dg[c]);
  }
}

template <typename T>
void launch(const void* thetaT, const void* phiT, const void* gT, const void* doutT,
            void* dthetaT, void* dphiT, void* dgT, float* lse, float* cq, int batch,
            int q_len, int k_len, long long theta_bs, long long phi_bs, long long g_bs,
            long long dout_bs, cudaStream_t s) {
  const T* th = static_cast<const T*>(thetaT);
  const T* ph = static_cast<const T*>(phiT);
  const T* gg = static_cast<const T*>(gT);
  const T* dd = static_cast<const T*>(doutT);
  const dim3 q_grid((q_len + kThreads - 1) / kThreads, batch);
  attention_bwd_query_kernel<T><<<q_grid, kThreads, 0, s>>>(
      th, ph, gg, dd, static_cast<T*>(dthetaT), lse, cq, q_len, k_len, theta_bs, phi_bs,
      g_bs, dout_bs);
  const dim3 k_grid((k_len + kThreads - 1) / kThreads, batch);
  attention_bwd_key_kernel<T><<<k_grid, kThreads, 0, s>>>(
      th, ph, gg, dd, lse, cq, static_cast<T*>(dphiT), static_cast<T*>(dgT), q_len, k_len,
      theta_bs, phi_bs, g_bs, dout_bs);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. dthetaT (B, 8, Q), dphiT (B, 8, K) and
// dgT (B, 32, K) are dense; lse and c are float32 (B, Q) scratch. `device` is
// the operands' CUDA ordinal (see attention_fwd). Returns cudaGetLastError()
// after the two launches.
extern "C" int attention_bwd(const void* thetaT, const void* phiT, const void* gT,
                             const void* doutT, void* dthetaT, void* dphiT, void* dgT,
                             void* lse, void* cq, int batch, int q_len, int k_len,
                             long long theta_bs, long long phi_bs, long long g_bs,
                             long long dout_bs, int dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  float* c = static_cast<float*>(cq);
  if (dtype == 1) {
    launch<__nv_bfloat16>(thetaT, phiT, gT, doutT, dthetaT, dphiT, dgT, l, c, batch, q_len,
                          k_len, theta_bs, phi_bs, g_bs, dout_bs, s);
  } else if (dtype == 0) {
    launch<float>(thetaT, phiT, gT, doutT, dthetaT, dphiT, dgT, l, c, batch, q_len, k_len,
                  theta_bs, phi_bs, g_bs, dout_bs, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The tile size, so the host can check that its emulation uses the same one.
extern "C" int attention_bwd_tile() { return kTile; }

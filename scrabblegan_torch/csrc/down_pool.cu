// The down-block's 2x2/2 average pool for Hopper (sm_90a): one pass forward,
// one pass backward.
//
// Replaces no TPU kernel. The JAX package leaves ResNetBlockDown's pool to
// XLA (scrabblegan_tpu/ops/blocks.py), which fuses it into its neighbours;
// the port ran it as two `F.avg_pool2d` and an add forward and two pool
// backwards, whose NCHW kernels reach a small share of the card's bandwidth.
// It computes, for NCHW-contiguous a and optional b of one shape and dtype,
// H and W even:
//
//   out[n, c, i, j] = (sum of a's 2x2 window at (2i, 2j) + the same of b) / 4
//
// each window summed in float32 in PyTorch's order (row by row, left to
// right), divided by 4 and rounded to the inputs' dtype (float32 or
// bfloat16), then the two pooled values added in float32 and rounded: the
// composition's roundings, so the result equals `F.avg_pool2d(a, 2) +
// F.avg_pool2d(b, 2)` bit for bit and the rest of the step sees the numbers
// it saw before. The backward writes g[n, c, i, j] / 4 (exact) into each of
// the window's four positions of one full-resolution gradient, which is a's
// and b's alike: the pool is linear, and the sum's two terms have the same
// gradient.
//
// What bounds it: bytes. It does one add a loaded element, so the card's
// 3.35 TB/s sets the pace: at BigGAN D's five pooled blocks (batch 256,
// bf16) a forward moves 2.74 GB and a backward about 2.0 GB. The design
// moves each byte once and keeps the rest off the memory pipe:
// - one thread computes kOut neighbouring outputs of a row, reading 2 kOut
//   neighbouring inputs of each of the window's two rows of a and of b as
//   16-byte loads (narrower where 2 kOut elements are fewer bytes) and
//   storing kOut outputs as one store; neighbouring threads take
//   neighbouring vectors, so a warp reads whole rows;
// - the host takes the widest kOut (16 bytes of output at most) that
//   divides the pooled width and that the pointers' alignment allows: 8
//   (bf16) or 4 (float32) at BigGAN's widths, 4 at ScrabbleGAN's pooled
//   widths 4, 12, 20, ..., down to 1 for an odd pooled width;
// - the index arithmetic (one division) is done once a vector, in 32 bits
//   where the input's element count allows it: with 64-bit indices alone a
//   forward and backward over BigGAN D's pooled blocks took 3.8% longer,
//   and over ScrabbleGAN's three bf16 blocks at 10 letters (batch 16) 13.7%
//   (H100 80GB HBM3, 700 W); an input of more than 2^32 elements takes the
//   64-bit instance;
// - one vector a thread, 256 threads a block, as many blocks as vectors
//   need: each thread has all its loads in flight at once, and the grid
//   comes from the element count alone.
// The sum of a and b is made in registers, so the forward writes one pooled
// tensor where the composition wrote three, and the backward writes one
// full-resolution gradient where it wrote two.
//
// The NHWC instance (`down_pool_nhwc_fwd` / `_bwd`) computes the same for
// channels_last-contiguous a and b (memory order N, H, W, C) and writes a
// channels_last result: a thread takes kVec neighbouring channels of one
// output pixel and reads them at each of the window's four pixels, C
// elements apart along a row and 2 W C between the window's rows, as
// 16-byte loads where C and the pointers allow (kVec 8 in bfloat16, 4 in
// float32 at BigGAN D's 96-1536 channels; 1 for block 0's 3-channel
// input); neighbouring threads take neighbouring channel vectors, so a warp
// reads whole pixels. Its window sums, roundings and backward are the NCHW
// instance's, so it equals the composition on channels_last inputs bit for
// bit too. Two divisions a vector (by C / kVec, then by the pooled width).
//
// The C entries launch on the caller's stream, do not synchronise, allocate
// nothing, and return cudaGetLastError() (cudaErrorMisalignedAddress for
// pointers not aligned to one element pair, or under NHWC to one element,
// cudaErrorInvalidValue for another dtype code).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;

template <int kBytes> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// n neighbouring elements at p, in loads of at most 16 bytes, as float32
template <typename T, int n>
__device__ __forceinline__ void load(const T* __restrict__ p, float (&x)[n]) {
  constexpr int kBytes = n * sizeof(T) < 16 ? n * sizeof(T) : 16;
  constexpr int kPer = kBytes / sizeof(T);
  using R = typename Raw<kBytes>::type;
#pragma unroll
  for (int i = 0; i < n; i += kPer) {
    const R r = __ldg(reinterpret_cast<const R*>(p + i));
    const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
    for (int j = 0; j < kPer; ++j) x[i + j] = to_float(e[j]);
  }
}

// n neighbouring elements to p, in stores of at most 16 bytes
template <typename T, int n>
__device__ __forceinline__ void store(T* __restrict__ p, const T (&x)[n]) {
  constexpr int kBytes = n * sizeof(T) < 16 ? n * sizeof(T) : 16;
  constexpr int kPer = kBytes / sizeof(T);
  using R = typename Raw<kBytes>::type;
#pragma unroll
  for (int i = 0; i < n; i += kPer) {
    R r;
    T* e = reinterpret_cast<T*>(&r);
#pragma unroll
    for (int j = 0; j < kPer; ++j) e[j] = x[i + j];
    *reinterpret_cast<R*>(p + i) = r;
  }
}

// s[j] = the 2x2 window sums of the kOut windows whose top-left input is at
// p (input rows `w_in` elements long), each summed as PyTorch's avg_pool2d
// sums it
template <typename T, int kOut>
__device__ __forceinline__ void window_sums(const T* __restrict__ p, long long w_in,
                                            float (&s)[kOut]) {
  float top[2 * kOut], bottom[2 * kOut];
  load<T, 2 * kOut>(p, top);
  load<T, 2 * kOut>(p + w_in, bottom);
#pragma unroll
  for (int j = 0; j < kOut; ++j)
    s[j] = top[2 * j] + top[2 * j + 1] + bottom[2 * j] + bottom[2 * j + 1];
}

// Vector v of `vectors` covers outputs [col, col + kOut) of output row `row`
// (over N, C and the pooled height); `row_vectors` = wo / kOut. Input row
// 2 row starts at element 4 row wo (the pooled height is half the input's).
template <typename T, int kOut, typename I>
__global__ void __launch_bounds__(kThreads)
down_pool_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
                     I vectors, I row_vectors, I wo) {
  const I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= vectors) return;
  const I row = v / row_vectors;
  const I col = (v - row * row_vectors) * kOut;
  const I at = 4 * row * wo + 2 * col;
  float s[kOut];
  T o[kOut];
  window_sums<T, kOut>(a + at, 2 * wo, s);
#pragma unroll
  for (int j = 0; j < kOut; ++j) o[j] = from_float<T>(s[j] * 0.25f);
  if (b != nullptr) {
    window_sums<T, kOut>(b + at, 2 * wo, s);
#pragma unroll
    for (int j = 0; j < kOut; ++j)
      o[j] = from_float<T>(to_float(o[j]) + to_float(from_float<T>(s[j] * 0.25f)));
  }
  store<T, kOut>(out + row * wo + col, o);
}

// The same vectors over the pooled gradient g: each of its kOut values,
// times 1/4, into both columns of its window in both rows of d.
template <typename T, int kOut, typename I>
__global__ void __launch_bounds__(kThreads)
down_pool_bwd_kernel(const T* __restrict__ g, T* __restrict__ d, I vectors, I row_vectors,
                     I wo) {
  const I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= vectors) return;
  const I row = v / row_vectors;
  const I col = (v - row * row_vectors) * kOut;
  float x[kOut];
  load<T, kOut>(g + row * wo + col, x);
  T o[2 * kOut];
#pragma unroll
  for (int j = 0; j < kOut; ++j) o[2 * j] = o[2 * j + 1] = from_float<T>(x[j] * 0.25f);
  T* top = d + 4 * row * wo + 2 * col;
  store<T, 2 * kOut>(top, o);
  store<T, 2 * kOut>(top + 2 * wo, o);
}

// kVec sums of the 2x2 window whose top-left pixel starts at p, in NHWC:
// the right neighbour `c` elements on, the row below `down` elements on;
// summed as PyTorch's avg_pool2d sums it (row by row, left to right)
template <typename T, int kVec, typename I>
__device__ __forceinline__ void window_sums_nhwc(const T* __restrict__ p, I c, I down,
                                                 float (&s)[kVec]) {
  float x00[kVec], x01[kVec], x10[kVec], x11[kVec];
  load<T, kVec>(p, x00);
  load<T, kVec>(p + c, x01);
  load<T, kVec>(p + down, x10);
  load<T, kVec>(p + down + c, x11);
#pragma unroll
  for (int k = 0; k < kVec; ++k) s[k] = x00[k] + x01[k] + x10[k] + x11[k];
}

// Vector v of `vectors` covers channels [ch, ch + kVec) of output pixel
// p = row wo + j (row over N and the pooled height); `pixel_vectors` =
// c / kVec. The window's top-left input pixel is (2 row) (2 wo) + 2 j.
template <typename T, int kVec, typename I>
__global__ void __launch_bounds__(kThreads)
down_pool_nhwc_fwd_kernel(const T* __restrict__ a, const T* __restrict__ b,
                          T* __restrict__ out, I vectors, I pixel_vectors, I wo, I c) {
  const I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= vectors) return;
  const I p = v / pixel_vectors;
  const I ch = (v - p * pixel_vectors) * kVec;
  const I row = p / wo;
  const I at = (4 * row * wo + 2 * (p - row * wo)) * c + ch;
  float s[kVec];
  T o[kVec];
  window_sums_nhwc<T, kVec, I>(a + at, c, 2 * wo * c, s);
#pragma unroll
  for (int k = 0; k < kVec; ++k) o[k] = from_float<T>(s[k] * 0.25f);
  if (b != nullptr) {
    window_sums_nhwc<T, kVec, I>(b + at, c, 2 * wo * c, s);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      o[k] = from_float<T>(to_float(o[k]) + to_float(from_float<T>(s[k] * 0.25f)));
  }
  store<T, kVec>(out + p * c + ch, o);
}

// The same vectors over the pooled gradient g: its kVec values, times 1/4,
// into the window's four pixels of d.
template <typename T, int kVec, typename I>
__global__ void __launch_bounds__(kThreads)
down_pool_nhwc_bwd_kernel(const T* __restrict__ g, T* __restrict__ d, I vectors,
                          I pixel_vectors, I wo, I c) {
  const I v = static_cast<I>(blockIdx.x) * kThreads + threadIdx.x;
  if (v >= vectors) return;
  const I p = v / pixel_vectors;
  const I ch = (v - p * pixel_vectors) * kVec;
  const I row = p / wo;
  float x[kVec];
  load<T, kVec>(g + p * c + ch, x);
  T o[kVec];
#pragma unroll
  for (int k = 0; k < kVec; ++k) o[k] = from_float<T>(x[k] * 0.25f);
  T* top = d + (4 * row * wo + 2 * (p - row * wo)) * c + ch;
  store<T, kVec>(top, o);
  store<T, kVec>(top + c, o);
  store<T, kVec>(top + 2 * wo * c, o);
  store<T, kVec>(top + 2 * wo * c + c, o);
}

// the largest power of two (at most 16) that divides the address
int alignment(const void* p) {
  const uintptr_t x = reinterpret_cast<uintptr_t>(p);
  int align = 16;
  while (align > 1 && x % align != 0) align /= 2;
  return align;
}

// The widest kOut (8, 4, 2, 1; at most 16 bytes of T) that divides wo, whose
// pooled-side accesses (kOut elements) fit `pooled_align` and whose
// full-resolution accesses (2 kOut elements, at most 16 bytes) fit
// `full_align`; 0 if none does.
template <typename T>
int vector_width(long long wo, int pooled_align, int full_align) {
  for (int k = 16 / static_cast<int>(sizeof(T)); k >= 1; k /= 2) {
    const int full_bytes = 2 * k * sizeof(T) < 16 ? 2 * k * static_cast<int>(sizeof(T)) : 16;
    if (wo % k == 0 && pooled_align >= k * static_cast<int>(sizeof(T)) &&
        full_align >= full_bytes)
      return k;
  }
  return 0;
}

template <typename T, int kOut, typename I>
cudaError_t launch(const T* a, const T* b, T* out, const T* g, T* d, long long rows,
                   long long wo, cudaStream_t s) {
  const long long vectors = rows * (wo / kOut);
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;  // past the grid's x limit
  if (g == nullptr)
    down_pool_fwd_kernel<T, kOut, I><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, b, out, static_cast<I>(vectors), static_cast<I>(wo / kOut), static_cast<I>(wo));
  else
    down_pool_bwd_kernel<T, kOut, I><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        g, d, static_cast<I>(vectors), static_cast<I>(wo / kOut), static_cast<I>(wo));
  return cudaGetLastError();
}

// 32-bit indices where the full-resolution side's 4 rows wo elements fit
template <typename T, int kOut>
cudaError_t launch_indexed(const T* a, const T* b, T* out, const T* g, T* d, long long rows,
                           long long wo, cudaStream_t s) {
  if (4 * rows * wo <= static_cast<long long>(UINT_MAX))
    return launch<T, kOut, unsigned int>(a, b, out, g, d, rows, wo, s);
  return launch<T, kOut, unsigned long long>(a, b, out, g, d, rows, wo, s);
}

// The forward (g == nullptr) or the backward, in T.
template <typename T>
int run(const void* a, const void* b, void* out, const void* g, void* d, long long rows,
        long long wo, cudaStream_t s) {
  const bool fwd = g == nullptr;
  int full = fwd ? alignment(a) : alignment(d);
  if (fwd && b != nullptr && alignment(b) < full) full = alignment(b);
  const int k = vector_width<T>(wo, fwd ? alignment(out) : alignment(g), full);
  const T *ta = static_cast<const T*>(a), *tb = static_cast<const T*>(b),
          *tg = static_cast<const T*>(g);
  T *to = static_cast<T*>(out), *td = static_cast<T*>(d);
  cudaError_t err = cudaErrorMisalignedAddress;
  switch (k) {
    case 8:
      if constexpr (sizeof(T) == 2) err = launch_indexed<T, 8>(ta, tb, to, tg, td, rows, wo, s);
      break;
    case 4: err = launch_indexed<T, 4>(ta, tb, to, tg, td, rows, wo, s); break;
    case 2: err = launch_indexed<T, 2>(ta, tb, to, tg, td, rows, wo, s); break;
    case 1: err = launch_indexed<T, 1>(ta, tb, to, tg, td, rows, wo, s); break;
  }
  return static_cast<int>(err);
}

template <typename T, int kVec, typename I>
cudaError_t launch_nhwc(const T* a, const T* b, T* out, const T* g, T* d, long long rows,
                        long long wo, long long c, cudaStream_t s) {
  const long long vectors = rows * wo * (c / kVec);
  const long long blocks = (vectors + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return cudaErrorInvalidConfiguration;
  if (g == nullptr)
    down_pool_nhwc_fwd_kernel<T, kVec, I><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        a, b, out, static_cast<I>(vectors), static_cast<I>(c / kVec), static_cast<I>(wo),
        static_cast<I>(c));
  else
    down_pool_nhwc_bwd_kernel<T, kVec, I><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        g, d, static_cast<I>(vectors), static_cast<I>(c / kVec), static_cast<I>(wo),
        static_cast<I>(c));
  return cudaGetLastError();
}

// 32-bit indices where the full-resolution side's 4 rows wo c elements fit
template <typename T, int kVec>
cudaError_t launch_nhwc_indexed(const T* a, const T* b, T* out, const T* g, T* d,
                                long long rows, long long wo, long long c, cudaStream_t s) {
  if (4 * rows * wo * c <= static_cast<long long>(UINT_MAX))
    return launch_nhwc<T, kVec, unsigned int>(a, b, out, g, d, rows, wo, c, s);
  return launch_nhwc<T, kVec, unsigned long long>(a, b, out, g, d, rows, wo, c, s);
}

// The NHWC forward (g == nullptr) or backward, in T: the widest kVec (at
// most 16 bytes) that divides c and that every pointer's alignment allows.
template <typename T>
int run_nhwc(const void* a, const void* b, void* out, const void* g, void* d, long long rows,
             long long wo, long long c, cudaStream_t s) {
  int align = g == nullptr ? alignment(a) : alignment(g);
  const void* others[] = {b, out, d};
  for (const void* p : others)
    if (p != nullptr && alignment(p) < align) align = alignment(p);
  int k = 16 / static_cast<int>(sizeof(T));
  while (k > 1 && (c % k != 0 || align < k * static_cast<int>(sizeof(T)))) k /= 2;
  const T *ta = static_cast<const T*>(a), *tb = static_cast<const T*>(b),
          *tg = static_cast<const T*>(g);
  T *to = static_cast<T*>(out), *td = static_cast<T*>(d);
  if (align < static_cast<int>(sizeof(T))) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaError_t err = cudaErrorMisalignedAddress;
  switch (k) {
    case 8:
      if constexpr (sizeof(T) == 2)
        err = launch_nhwc_indexed<T, 8>(ta, tb, to, tg, td, rows, wo, c, s);
      break;
    case 4: err = launch_nhwc_indexed<T, 4>(ta, tb, to, tg, td, rows, wo, c, s); break;
    case 2: err = launch_nhwc_indexed<T, 2>(ta, tb, to, tg, td, rows, wo, c, s); break;
    case 1: err = launch_nhwc_indexed<T, 1>(ta, tb, to, tg, td, rows, wo, c, s); break;
  }
  return static_cast<int>(err);
}

// c = 0: the NCHW instance; c > 0 (the NHWC entries' check): the NHWC
// instance with c channels
int dispatch(const void* a, const void* b, void* out, const void* g, void* d, long long rows,
             long long wo, long long c, int dtype, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (rows <= 0 || wo <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (c > 0) {
    if (dtype == 0) return run_nhwc<float>(a, b, out, g, d, rows, wo, c, s);
    if (dtype == 1) return run_nhwc<bf16>(a, b, out, g, d, rows, wo, c, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) return run<float>(a, b, out, g, d, rows, wo, s);
  if (dtype == 1) return run<bf16>(a, b, out, g, d, rows, wo, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// out (rows, wo) = the 2x2/2 average of a + that of b (b may be null), a and
// b (2 rows, 2 wo) NCHW-contiguous, rows = N C H/2. dtype: 0 = float32, 1 =
// bfloat16. `device` is the operands' CUDA ordinal: this library carries its
// own (static) CUDA runtime, whose current device is set here.
extern "C" int down_pool_fwd(const void* a, const void* b, void* out, long long rows,
                             long long wo, int dtype, int device, void* stream) {
  return dispatch(a, b, out, nullptr, nullptr, rows, wo, 0, dtype, device, stream);
}

// d (2 rows, 2 wo) = g (rows, wo) / 4 spread over each 2x2 window.
extern "C" int down_pool_bwd(const void* g, void* d, long long rows, long long wo, int dtype,
                             int device, void* stream) {
  return dispatch(nullptr, nullptr, nullptr, g, d, rows, wo, 0, dtype, device, stream);
}

// The same over channels_last-contiguous tensors: out (rows, wo, c) from a
// and b (2 rows, 2 wo, c), rows = N H/2, c > 0 channels innermost.
extern "C" int down_pool_nhwc_fwd(const void* a, const void* b, void* out, long long rows,
                                  long long wo, long long c, int dtype, int device,
                                  void* stream) {
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(a, b, out, nullptr, nullptr, rows, wo, c, dtype, device, stream);
}

// d (2 rows, 2 wo, c) = g (rows, wo, c) / 4 spread over each 2x2 window.
extern "C" int down_pool_nhwc_bwd(const void* g, void* d, long long rows, long long wo,
                                  long long c, int dtype, int device, void* stream) {
  if (c <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch(nullptr, nullptr, nullptr, g, d, rows, wo, c, dtype, device, stream);
}

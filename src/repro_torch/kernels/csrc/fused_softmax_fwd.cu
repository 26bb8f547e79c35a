// Fused scale-mask-softmax forward, for Hopper.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (via `fused_softmax_fwd`) in
// src/repro/kernels/fused_softmax.py. It computes the same function on the
// same layout: x (rows, sk), rows = prod(leading dims) * sq, contiguous, fp32
// or bf16; y (rows, sk) in x's dtype:
//   v = fp32(x) * scale, masked to NEG_INF (-0.7 * FLT_MAX, as the reference)
//   where causal and (row % sk) < col; y = exp(v - max) / sum(exp(v - max)).
// All math is fp32, so a masked column gives exactly 0.
//
// What bounds it on an H100: it reads x once (with causal, only the kept
// lower triangle: row r of a block keeps r + 1 columns) and writes y once,
// a few operations per element, far below the ~295 operations per byte
// where the tensor cores would take over, so the card's bound is its
// memory rate: at the paper's GPT-3 score shape (b 2 x 104 heads x 2048 x
// 2048, bf16, causal) 0.87 GB read and 1.74 GB written, 2.62 GB at
// 3.35 TB/s, about 0.78 ms.
//
// Design, dispatched by sk (not a fallback: each sk has one kernel):
//   * sk <= 4096: `fused_softmax_fwd_warp_kernel`, the shape of Megatron-LM's
//     scaled_upper_triang_masked_softmax. A warp owns a row, which stays in
//     its registers (COLS / 32 fp32 values a thread, COLS the next power of
//     two >= sk, one instance per power of two from 32 to 4096) between its
//     one read and its one write. Each thread loads VEC neighbouring
//     columns at a time, 16 bytes when the row's bytes and both bases allow
//     it (sk * sizeof(T) % 16 == 0), one element otherwise: a template
//     argument, not a branch per element. Under the causal mask a vector
//     wholly past the row's last kept column is never loaded and is written
//     as exact zeros. The max first (warp shuffles), then one exp2 per
//     element, kept in place, then the sum; y = e * (1 / sum).
//   * sk > 4096: `fused_softmax_fwd_online_kernel`, a block of 256 threads
//     a row with an online (max, sum of exp) pair per thread, merged by warp
//     shuffles and shared memory, and a second read of the row (from L2)
//     for the write: such a row does not fit one warp's registers.

#include "hopper.cuh"  // exp2_approx

#include <math.h>

namespace {

using hopper::exp2_approx;

constexpr int THREADS = 256;
constexpr int MAX_COLS = 4096;  // the widest row a warp keeps in registers
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // as the reference
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// VEC elements of T moved as one load and one store of VEC * sizeof(T)
// bytes (both addresses aligned to that size).
template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };
template <typename T, int VEC>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  *reinterpret_cast<R*>(dst) = *reinterpret_cast<const R*>(src);
}

// A warp a row, the row in registers. COLS: a power of two >= sk; VEC:
// columns a thread moves at once (16 bytes, or 1 where sk or a base is not
// 16-byte aligned).
template <typename T, int COLS, int VEC>
__global__ void __launch_bounds__(THREADS)
fused_softmax_fwd_warp_kernel(const T* __restrict__ x, T* __restrict__ y,
                              long long rows, int sk, int causal, float scale) {
  constexpr int PER = COLS / 32;     // values a thread keeps
  constexpr int ITERS = PER / VEC;   // vectors a thread moves
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * (THREADS / 32)
                        + (threadIdx.x >> 5);
  if (row >= rows) return;  // a whole warp: the shuffles below stay full
  const T* xr = x + row * sk;
  T* yr = y + row * sk;
  const int last = causal ? static_cast<int>(row % sk) : sk - 1;  // last kept column

  // Vector it of this thread covers columns 32 VEC it + VEC lane + [0, VEC).
  float v[PER];
  float mx = NEG_INF;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int c0 = (32 * it + lane) * VEC;
    if (c0 <= last) {  // a vector past the last kept column is never loaded
      alignas(sizeof(T) * VEC) T in[VEC];
      copy_vec<T, VEC>(in, xr + c0);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float val = c0 + e <= last ? to_f(in[e]) * scale : NEG_INF;
        v[it * VEC + e] = val;
        mx = fmaxf(mx, val);
      }
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[it * VEC + e] = NEG_INF;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  const float mx2 = mx * LOG2E;
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    v[i] = exp2_approx(fmaf(v[i], LOG2E, -mx2));
    sum += v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, off);
  const float inv = 1.f / sum;
#pragma unroll
  for (int it = 0; it < ITERS; ++it) {
    const int c0 = (32 * it + lane) * VEC;
    if (c0 < sk) {
      alignas(sizeof(T) * VEC) T out[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) store(&out[e], v[it * VEC + e] * inv);
      copy_vec<T, VEC>(yr + c0, out);
    }
  }
}

// Merge the partial (max m2, sum l2) into (m, l). Two empty partials
// (m = -inf) stay empty instead of giving 0 * exp(nan).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = mn == -INFINITY ? 0.f : l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

// A block a row, for rows too wide for one warp's registers: an online
// (max, sum of exp) pass, then a second read of the row for the write.
template <typename T>
__global__ void __launch_bounds__(THREADS)
fused_softmax_fwd_online_kernel(const T* __restrict__ x, T* __restrict__ y,
                                int sk, int causal, float scale) {
  __shared__ float red_m[THREADS / 32], red_l[THREADS / 32];
  const int lane = threadIdx.x;
  const long long row = blockIdx.x;
  const T* xr = x + row * sk;
  const int last = causal ? static_cast<int>(row % sk) : sk - 1;  // last kept column

  float m = -INFINITY, l = 0.f;
  for (int c = lane; c < sk; c += THREADS) {
    const float v = c <= last ? to_f(xr[c]) * scale : NEG_INF;
    const float mn = fmaxf(m, v);
    l = l * expf(m - mn) + expf(v - mn);
    m = mn;
  }
  for (int off = 16; off > 0; off >>= 1)
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, l, off));
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 == 0) {
    red_m[warp] = m;
    red_l[warp] = l;
  }
  __syncthreads();
  m = red_m[0];
  l = red_l[0];
  for (int w = 1; w < THREADS / 32; ++w) merge(m, l, red_m[w], red_l[w]);
  T* yr = y + row * sk;
  for (int c = lane; c < sk; c += THREADS) {
    const float v = c <= last ? to_f(xr[c]) * scale : NEG_INF;
    store(yr + c, expf(v - m) / l);
  }
}

template <typename T, int COLS>
cudaError_t launch_warp(const void* x, void* y, long long rows, int sk,
                        int causal, float scale, cudaStream_t stream) {
  constexpr int VEC_MAX = 16 / sizeof(T) < COLS / 32 ? 16 / sizeof(T) : COLS / 32;
  const long long blocks = (rows + THREADS / 32 - 1) / (THREADS / 32);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const bool vec = (static_cast<long long>(sk) * sizeof(T)) % 16 == 0
                   && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  if (vec)
    fused_softmax_fwd_warp_kernel<T, COLS, VEC_MAX>
        <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(xt, yt, rows, sk, causal, scale);
  else
    fused_softmax_fwd_warp_kernel<T, COLS, 1>
        <<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(xt, yt, rows, sk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, long long rows, int sk, int causal,
                     float scale, cudaStream_t stream) {
  if (sk <= 32) return launch_warp<T, 32>(x, y, rows, sk, causal, scale, stream);
  if (sk <= 64) return launch_warp<T, 64>(x, y, rows, sk, causal, scale, stream);
  if (sk <= 128) return launch_warp<T, 128>(x, y, rows, sk, causal, scale, stream);
  if (sk <= 256) return launch_warp<T, 256>(x, y, rows, sk, causal, scale, stream);
  if (sk <= 512) return launch_warp<T, 512>(x, y, rows, sk, causal, scale, stream);
  if (sk <= 1024) return launch_warp<T, 1024>(x, y, rows, sk, causal, scale, stream);
  if (sk <= 2048) return launch_warp<T, 2048>(x, y, rows, sk, causal, scale, stream);
  if (sk <= MAX_COLS) return launch_warp<T, MAX_COLS>(x, y, rows, sk, causal, scale, stream);
  if (rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_softmax_fwd_online_kernel<T><<<static_cast<unsigned>(rows), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns a cudaError_t; 0 means launched.
extern "C" int fused_softmax_fwd(const void* x, void* y, int dtype,
                                 long long rows, int sk, int causal,
                                 float scale, void* stream) {
  if (rows < 1 || sk < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(x, y, rows, sk, causal, scale, st)
      : dispatch<float>(x, y, rows, sk, causal, scale, st);
  return static_cast<int>(err);
}

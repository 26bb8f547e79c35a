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
// lower triangle: row r of a block keeps r + 1 columns, and the kernel loads
// no masked element) and writes y once, a few operations per element, far
// below the ~295 operations per byte where the tensor cores would take over,
// so the card's bound is its memory rate: at the paper's GPT-3 score shape
// (b 2 x 104 heads x 2048 x 2048, bf16, causal) 0.87 GB read and 1.74 GB
// written, 2.62 GB at 3.35 TB/s, about 0.78 ms.
//
// Design. Each row is owned by a group of TPR threads: a warp (TPR 32, eight
// rows to a 256-thread block) when sk <= 512, the whole block (TPR 256)
// otherwise, so no block carries state for another and rows of any length
// fit. Pass 1 strides over the row keeping a running (max, sum of exp) per
// thread, the online-softmax update; a warp-shuffle and then a shared-memory
// reduction merge the pairs. Pass 2 reads the row again (from L2 at these
// row lengths) and writes exp(v - max) / sum. Neighbouring threads read
// neighbouring columns, so each warp's loads are coalesced. The second read
// and the scalar loads are what a faster version would remove (keep the row
// in registers, 16-byte loads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // as the reference

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// Merge the partial (max m2, sum l2) into (m, l). Two empty partials
// (m = -inf) stay empty instead of giving 0 * exp(nan).
__device__ __forceinline__ void merge(float& m, float& l, float m2, float l2) {
  const float mn = fmaxf(m, m2);
  l = mn == -INFINITY ? 0.f : l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
}

template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ x, T* __restrict__ y, long long rows, int sk,
           int causal, float scale) {
  constexpr int RPB = THREADS / TPR;  // rows per block
  __shared__ float red_m[THREADS / 32], red_l[THREADS / 32];
  const int lane = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * RPB + threadIdx.x / TPR;
  const bool live = row < rows;
  const T* xr = x + (live ? row : 0) * sk;
  const int last = causal ? static_cast<int>(row % sk) : sk - 1;  // last kept column

  float m = -INFINITY, l = 0.f;
  if (live) {
    for (int c = lane; c < sk; c += TPR) {
      const float v = c <= last ? to_f(xr[c]) * scale : NEG_INF;
      const float mn = fmaxf(m, v);
      l = l * expf(m - mn) + expf(v - mn);
      m = mn;
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    merge(m, l, __shfl_xor_sync(0xffffffffu, m, off),
          __shfl_xor_sync(0xffffffffu, l, off));
  if constexpr (TPR > 32) {  // one row per block: merge its warps
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 == 0) {
      red_m[warp] = m;
      red_l[warp] = l;
    }
    __syncthreads();
    m = red_m[0];
    l = red_l[0];
    for (int w = 1; w < TPR / 32; ++w) merge(m, l, red_m[w], red_l[w]);
  }
  if (!live) return;
  T* yr = y + row * sk;
  for (int c = lane; c < sk; c += TPR) {
    const float v = c <= last ? to_f(xr[c]) * scale : NEG_INF;
    store(yr + c, expf(v - m) / l);
  }
}

template <typename T, int TPR>
cudaError_t launch(const void* x, void* y, long long rows, int sk, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int RPB = THREADS / TPR;
  const long long blocks = (rows + RPB - 1) / RPB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fwd_kernel<T, TPR><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), rows, sk, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, void* y, long long rows, int sk, int causal,
                     float scale, cudaStream_t stream) {
  if (sk <= 512) return launch<T, 32>(x, y, rows, sk, causal, scale, stream);
  return launch<T, THREADS>(x, y, rows, sk, causal, scale, stream);
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

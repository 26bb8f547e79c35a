// Fused scale-mask-softmax backward, for Hopper.
//
// Replaces the Pallas TPU kernel `_bwd_kernel` (via `fused_softmax_bwd`) in
// src/repro/kernels/fused_softmax.py. Same function, same layout: y and dy
// (rows, sk), contiguous, fp32 or bf16; dx (rows, sk) in their dtype:
//   dx = (y * (dy - sum_row(y * dy))) * scale, all in fp32.
// The mask needs no handling here: a masked column has y = 0, so dx = 0.
//
// What bounds it on an H100: it reads y and dy once and writes dx once, a
// few operations per element, so the card's bound is its memory rate: at the
// paper's GPT-3 score shape (b 2 x 104 heads x 2048 x 2048, bf16) 5.23 GB at
// 3.35 TB/s, about 1.56 ms.
//
// Design: a warp owns a row when sk <= 512 (eight rows to a 256-thread
// block), the whole block otherwise. Pass 1 strides over the row
// summing y * dy in fp32 per thread, then a warp-shuffle and a shared-memory
// sum; pass 2 reads y and dy again (from L2 at these row lengths) and writes
// dx.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <typename T, int TPR>
__global__ void __launch_bounds__(THREADS)
fused_softmax_bwd_kernel(const T* __restrict__ y, const T* __restrict__ dy,
                         T* __restrict__ dx, long long rows, int sk, float scale) {
  constexpr int RPB = THREADS / TPR;  // rows per block
  __shared__ float red[THREADS / 32];
  const int lane = threadIdx.x % TPR;
  const long long row = static_cast<long long>(blockIdx.x) * RPB + threadIdx.x / TPR;
  const bool live = row < rows;
  const long long base = (live ? row : 0) * sk;

  float dot = 0.f;
  if (live)
    for (int c = lane; c < sk; c += TPR) dot += to_f(y[base + c]) * to_f(dy[base + c]);
  for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
  if constexpr (TPR > 32) {  // one row per block: sum its warps
    if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = dot;
    __syncthreads();
    dot = red[0];
    for (int w = 1; w < TPR / 32; ++w) dot += red[w];
  }
  if (!live) return;
  for (int c = lane; c < sk; c += TPR) {
    const float yv = to_f(y[base + c]);
    store(dx + base + c, (yv * (to_f(dy[base + c]) - dot)) * scale);
  }
}

template <typename T, int TPR>
cudaError_t launch(const void* y, const void* dy, void* dx, long long rows,
                   int sk, float scale, cudaStream_t stream) {
  constexpr int RPB = THREADS / TPR;
  const long long blocks = (rows + RPB - 1) / RPB;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  fused_softmax_bwd_kernel<T, TPR><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(dy), static_cast<T*>(dx),
      rows, sk, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* y, const void* dy, void* dx, long long rows,
                     int sk, float scale, cudaStream_t stream) {
  if (sk <= 512) return launch<T, 32>(y, dy, dx, rows, sk, scale, stream);
  return launch<T, THREADS>(y, dy, dx, rows, sk, scale, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Returns a cudaError_t; 0 means launched.
extern "C" int fused_softmax_bwd(const void* y, const void* dy, void* dx,
                                 int dtype, long long rows, int sk, float scale,
                                 void* stream) {
  if (rows < 1 || sk < 1 || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(y, dy, dx, rows, sk, scale, st)
      : dispatch<float>(y, dy, dx, rows, sk, scale, st);
  return static_cast<int>(err);
}

// Rotary position embedding of q and k together, one launch a direction, for
// Hopper.
//
// Replaces no TPU kernel: the JAX package leaves rope to XLA, which fuses it
// into the projections. Eagerly, the plain version (kernels/ref.py
// `rope_ref`, ~18 ops for q and again for k) copies the frequencies to the
// card from pageable memory on every call (a stream synchronise), runs each
// product and sum as its own pass over the whole q or k in fp32, and keeps
// fp32 cos and sin for its backward.
//
// Function, on x (b, s, heads, hd) of fp32 or bf16 with hd = 2 half, the
// rows (b, s, heads) at any strides and head_dim contiguous:
//   ang[t, i] = fp32(pos[t]) * freq[i],  c = cos(ang), s = sin(ang)
//   y[..., i]        = x[..., i] c - x[..., i + half] s
//   y[..., i + half] = x[..., i + half] c + x[..., i] s
// every product and sum in fp32, rounded once to x's dtype: the plain
// version's arithmetic, with no FMA contraction (`__fmul_rn`, `__fsub_rn`,
// `__fadd_rn`), so the two agree bit for bit. The backward is the rotation by
// -ang of the incoming gradients (s negated, which is exact): the same
// kernel with `inverse` set. y of q and of k are written contiguous.
//
// What bounds it on an H100: it reads q and k once and writes them once, a
// few operations an element, so the card's memory rate: granite-moe's
// microbatch (4 x 2048 tokens, 16 + 8 heads of 64, bf16) is 12.6 M elements,
// 50 MB, about 15 us at 3.35 TB/s.
//
// Design: a block takes TOKENS tokens. Its threads first compute each
// (token, i) angle and its sincosf (full precision) once, into shared
// memory: the angle table never exists in device memory. Then each thread
// takes (token, head, vector) items over all of q's and k's heads: a vector
// is VEC elements at i and the VEC at i + half, 16 bytes each where the
// strides, the bases and half allow it (VEC 8 in bf16, 4 in fp32), one
// element otherwise (a template argument, not a branch per element).
// Neighbouring threads take neighbouring vectors of a head, then the next
// head, so a warp reads and writes whole rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int TOKENS = 8;      // tokens a block
constexpr int MAX_HALF = 128;  // head_dim <= 256

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// VEC elements of T moved as one access of VEC * sizeof(T) bytes.
template <int BYTES> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<16> { using type = uint4; };
template <typename T, int VEC>
__device__ __forceinline__ void copy_vec(T* dst, const T* src) {
  using R = typename Raw<sizeof(T) * VEC>::type;
  *reinterpret_cast<R*>(dst) = *reinterpret_cast<const R*>(src);
}

template <typename T, typename P, int VEC>
__global__ void __launch_bounds__(THREADS)
rope_kernel(const T* __restrict__ q, const T* __restrict__ k, T* __restrict__ qo,
            T* __restrict__ ko, const P* __restrict__ pos,
            const float* __restrict__ freq, int s, long long tokens, int nq,
            int nkv, int half, long long qsb, long long qss, long long qsh,
            long long ksb, long long kss, long long ksh, long long psb,
            long long pss, int inverse) {
  __shared__ __align__(16) float cs[TOKENS][MAX_HALF];
  __shared__ __align__(16) float sn[TOKENS][MAX_HALF];
  const long long t0 = static_cast<long long>(blockIdx.x) * TOKENS;
  const int nt = static_cast<int>(tokens - t0 < TOKENS ? tokens - t0 : TOKENS);

  for (int e = threadIdx.x; e < nt * half; e += THREADS) {
    const int t = e / half, i = e - t * half;
    const long long tok = t0 + t;
    const long long bi = tok / s, si = tok - bi * s;
    const float p = static_cast<float>(pos[bi * psb + si * pss]);
    float sv, cv;
    sincosf(__fmul_rn(p, freq[i]), &sv, &cv);
    cs[t][i] = cv;
    sn[t][i] = inverse ? -sv : sv;
  }
  __syncthreads();

  const int vecs = half / VEC;
  const int heads = nq + nkv;
  const int items = nt * heads * vecs;
  const int hd = 2 * half;
  for (int w = threadIdx.x; w < items; w += THREADS) {
    const int v = w % vecs;
    const int hw = w / vecs;
    const int h = hw % heads;
    const int t = hw / heads;
    const long long tok = t0 + t;
    const long long bi = tok / s, si = tok - bi * s;
    const T* src;
    T* dst;
    if (h < nq) {
      src = q + bi * qsb + si * qss + h * qsh;
      dst = qo + (tok * nq + h) * hd;
    } else {
      src = k + bi * ksb + si * kss + (h - nq) * ksh;
      dst = ko + (tok * nkv + (h - nq)) * hd;
    }
    const int i0 = v * VEC;
    alignas(sizeof(T) * VEC) T x1[VEC];
    alignas(sizeof(T) * VEC) T x2[VEC];
    copy_vec<T, VEC>(x1, src + i0);
    copy_vec<T, VEC>(x2, src + half + i0);
    alignas(sizeof(T) * VEC) T y1[VEC];
    alignas(sizeof(T) * VEC) T y2[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float a = to_f(x1[j]), b = to_f(x2[j]);
      const float c = cs[t][i0 + j], sv = sn[t][i0 + j];
      store(&y1[j], __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, sv)));
      store(&y2[j], __fadd_rn(__fmul_rn(b, c), __fmul_rn(a, sv)));
    }
    copy_vec<T, VEC>(dst + i0, y1);
    copy_vec<T, VEC>(dst + half + i0, y2);
  }
}

template <typename T, typename P, int VEC>
cudaError_t launch(const void* q, const void* k, void* qo, void* ko, const void* pos,
                   const float* freq, int b, int s, int nq, int nkv, int half,
                   const long long* st, int inverse, cudaStream_t stream) {
  const long long tokens = static_cast<long long>(b) * s;
  const long long blocks = (tokens + TOKENS - 1) / TOKENS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rope_kernel<T, P, VEC><<<static_cast<unsigned>(blocks), THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<T*>(qo),
      static_cast<T*>(ko), static_cast<const P*>(pos), freq, s, tokens, nq, nkv,
      half, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], inverse);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t dispatch(int vec, const void* q, const void* k, void* qo, void* ko,
                     const void* pos, const float* freq, int b, int s, int nq,
                     int nkv, int half, const long long* st, int inverse,
                     cudaStream_t stream) {
  constexpr int WIDE = 16 / sizeof(T);
  if (vec == WIDE)
    return launch<T, P, WIDE>(q, k, qo, ko, pos, freq, b, s, nq, nkv, half, st,
                              inverse, stream);
  if (vec == 1)
    return launch<T, P, 1>(q, k, qo, ko, pos, freq, b, s, nq, nkv, half, st,
                           inverse, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16; pos64: positions int64 (else int32); vec: 16 /
// the element size (the caller has checked every base, stride and half for
// 16-byte accesses) or 1. Strides in elements: q's (b, s, heads), k's, and
// the positions' (b, s). inverse: the backward's rotation by -ang. Returns a
// cudaError_t; 0 means launched.
extern "C" int rope_qk(const void* q, const void* k, void* qo, void* ko,
                       const void* pos, const float* freq, int dtype, int pos64,
                       int vec, int b, int s, int nq, int nkv, int half,
                       long long qsb, long long qss, long long qsh, long long ksb,
                       long long kss, long long ksh, long long psb, long long pss,
                       int inverse, void* stream) {
  if (b < 1 || s < 1 || nq < 1 || nkv < 0 || half < 1 || half > MAX_HALF ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const long long st[8] = {qsb, qss, qsh, ksb, kss, ksh, psb, pss};
  cudaStream_t stm = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 1)
    err = pos64 ? dispatch<__nv_bfloat16, long long>(vec, q, k, qo, ko, pos, freq, b, s,
                                                     nq, nkv, half, st, inverse, stm)
                : dispatch<__nv_bfloat16, int>(vec, q, k, qo, ko, pos, freq, b, s, nq,
                                               nkv, half, st, inverse, stm);
  else
    err = pos64 ? dispatch<float, long long>(vec, q, k, qo, ko, pos, freq, b, s, nq,
                                             nkv, half, st, inverse, stm)
                : dispatch<float, int>(vec, q, k, qo, ko, pos, freq, b, s, nq, nkv,
                                       half, st, inverse, stm);
  return static_cast<int>(err);
}

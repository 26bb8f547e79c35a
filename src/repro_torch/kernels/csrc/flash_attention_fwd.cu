// Flash-attention forward (FA-2 online softmax) for Hopper, plain FMA: the
// fp32 route.
//
// Replaces the Pallas TPU kernel `_kernel` reached through
// `flash_attention_fwd` in src/repro/kernels/flash_attention.py, for fp32
// inputs; bf16 inputs take csrc/flash_attention_fwd_sm90.cu (wgmma, TMA).
// The fp32 route stays on the CUDA cores because wgmma would run fp32 as
// TF32 (about three decimal digits), and the fp32 checks hold exact fp32
// products: 3e-5 of the plain version on the card, 1e-5 of the CPU in the
// pipelined arms. It computes the same function in the same layout:
//   q (b, sq, nq, hd), k/v (b, sk, nkv, hd) fp32, any strides with a unit
//   last stride; O (b, sq, nq, hd) and LSE (b, sq, nkv, m) contiguous fp32,
//   m = nq / nkv.
//   Masks: causal, sliding window, kv padding, `q_offset` shift of the query
//   positions; gemma2 logit softcap; denom = max(l, 1e-30).
//   Both dots run in fp32, as the reference does, so the outputs agree to
//   about 1e-6.
//
// What bounds it on an H100: its products run as fp32 FMAs on the CUDA
// cores, whose peak is 67 TFLOP/s; at the serving shape's work (b 4,
// s 2048, 64 heads of 128, causal: 2.75e11 FLOP) that is about 4 ms. The
// port's fp32 paths are the small checking sizes, where it is not the cost.
//
// Design. One thread block per (tile of 64 rows, kv head, batch), where a
// row is one (query, GQA head) pair: the m query heads that share a kv head
// ride in the tile, so each K/V tile is staged once for all of them. The
// block loops over kv tiles of 64 keys in place of the TPU's sequential grid
// axis, and skips whole tiles that the causal or window mask empties. K and V
// are staged in shared memory as fp32 (rows padded by one word so column
// reads hit distinct banks); the P tile reuses the K buffer. 128 threads:
// thread (ty, tx) owns rows ty + 16i (i < 4), score columns tx + 8j and output
// columns tx + 8c, so each row's max and sum reduce over 8 lanes of one warp
// with shuffles, and the fp32 accumulators of a row never leave registers.
// Ragged edges (sq, sk not multiples of the tile, head_dim below its
// instantiated width) are masked loads that read zeros.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;      // (query, GQA head) rows per block
constexpr int THREADS = 128;  // 16 row groups x 8 lanes
constexpr int RI = ROWS / 16; // rows per thread
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // as the reference

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int b, sq, sk, nq, nkv, hd, m, bq;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, q_offset;
  float softcap, scale;
};

// Keys per kv tile: 64, or 32 past head_dim 128, where a tile of 64 keys
// at the full head would not fit the shared memory of a block.
template <int HDP>
__host__ __device__ constexpr int keys() { return HDP > 128 ? 32 : 64; }

template <int HDP>
__host__ __device__ constexpr int k_region() {  // floats of the K buffer, then P
  constexpr int BK = keys<HDP>();
  return BK * (HDP + 1) > ROWS * (BK + 1) ? BK * (HDP + 1) : ROWS * (BK + 1);
}

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (ROWS * (HDP + 1) + k_region<HDP>() + keys<HDP>() * HDP);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS) flash_fwd_fma_kernel(Params p) {
  constexpr int QS = HDP + 1;
  constexpr int KS = HDP + 1;
  constexpr int BK = keys<HDP>();
  constexpr int CJ = BK / 8;  // score columns per thread
  constexpr int PS = BK + 1;
  constexpr int OC = HDP / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                     // ROWS x QS
  float* Ks = Qs + ROWS * QS;           // BK x KS, then P: ROWS x PS
  float* Vs = Ks + k_region<HDP>();     // BK x HDP

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int g = blockIdx.y, bb = blockIdx.z;
  const int m = p.m;
  const int q0 = blockIdx.x * p.bq;
  const int nq_tile = min(p.bq, p.sq - q0);
  const int nrows = nq_tile * m;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);

  for (int idx = tid; idx < ROWS * HDP; idx += THREADS) {
    const int r = idx / HDP, d = idx % HDP;
    float val = 0.f;
    if (r < nrows && d < p.hd) {
      const int qi = q0 + r / m, h = g * m + r % m;
      val = q[bb * p.qsb + qi * p.qss + h * p.qsh + d];
    }
    Qs[r * QS + d] = val;
  }

  int qpos[RI];
  float m_i[RI], l_i[RI], acc[RI][OC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    qpos[i] = q0 + (ty + 16 * i) / m + p.q_offset;
    m_i[i] = NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // Whole kv tiles the masks empty for every row of this block are skipped.
  int kv_end = p.sk;
  if (p.causal) kv_end = min(kv_end, q0 + nq_tile + p.q_offset);
  int kv_begin = 0;
  if (p.window) kv_begin = max(0, q0 + p.q_offset - p.window + 1) / BK * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's P and V are read
    for (int idx = tid; idx < BK * HDP; idx += THREADS) {
      const int j = idx / HDP, d = idx % HDP, kv = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (kv < p.sk && d < p.hd) {
        kval = k[bb * p.ksb + kv * p.kss + g * p.ksh + d];
        vval = v[bb * p.vsb + kv * p.vss + g * p.vsh + d];
      }
      Ks[j * KS + d] = kval;
      Vs[j * HDP + d] = vval;
    }
    __syncthreads();

    float s[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qv[RI], kv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < CJ; ++j) kv[j] = Ks[(tx + 8 * j) * KS + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap != 0.f) x = p.softcap * tanhf(x / p.softcap);
        bool keep = kpos < p.sk;
        if (p.causal) keep = keep && qpos[i] >= kpos;
        if (p.window) keep = keep && qpos[i] - kpos < p.window;
        x = keep ? x : NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      const float alpha = expf(m_i[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        rs += s[i][j];
      }
#pragma unroll
      for (int off = 4; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l_i[i] = l_i[i] * alpha + rs;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= alpha;
    }

    __syncthreads();  // every thread is done reading K: reuse it for P
    float* Ps = Ks;
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) Ps[(ty + 16 * i) * PS + tx + 8 * j] = s[i][j];
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = Vs[j * HDP + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 16 * i;
    if (r >= nrows) continue;
    const int qi = q0 + r / m, mi = r % m;
    const float denom = fmaxf(l_i[i], 1e-30f);
    float* orow = o + ((static_cast<long long>(bb) * p.sq + qi) * p.nq + g * m + mi) * p.hd;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = tx + 8 * c;
      if (d < p.hd) orow[d] = acc[i][c] / denom;
    }
    if (tx == 0)
      p.lse[((static_cast<long long>(bb) * p.sq + qi) * p.nkv + g) * m + mi] =
          m_i[i] + logf(denom);
  }
}

template <int HDP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_fma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + p.bq - 1) / p.bq, p.nkv, p.b);
  flash_fwd_fma_kernel<HDP><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  if (p.hd <= 32) return launch<32>(p, stream);
  if (p.hd <= 64) return launch<64>(p, stream);
  if (p.hd <= 96) return launch<96>(p, stream);
  if (p.hd <= 128) return launch<128>(p, stream);
  return launch<256>(p, stream);
}

}  // namespace

// fp32 only. Returns a cudaError_t; 0 means launched.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int b, int sq, int sk, int nq, int nkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int causal, int window, int q_offset, float softcap, float scale,
    void* stream) {
  if (hd < 1 || hd > 256 || nkv < 1 || nq % nkv || nq / nkv > ROWS ||
      b < 1 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, o, lse, b, sq, sk, nq, nkv, hd, nq / nkv,
           ROWS / (nq / nkv), qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
           causal, window, q_offset, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(p, st));
}

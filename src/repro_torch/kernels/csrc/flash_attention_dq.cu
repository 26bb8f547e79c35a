// Flash-attention backward, pass 1: dQ, for Hopper, plain FMA: the fp32
// route.
//
// Replaces the Pallas TPU kernel `_dq_kernel` (pass 1 of `flash_attention_bwd`)
// in src/repro/kernels/flash_attention.py, for fp32 inputs; bf16 inputs take
// csrc/flash_attention_dq_sm90.cu (wgmma, TMA). The fp32 route stays on the
// CUDA cores because wgmma would run fp32 as TF32 (about three decimal
// digits), and the fp32 checks hold exact fp32 products: grads within
// 2e-4 + 1e-3|want| of the plain version, 1e-5 of the CPU in the pipelined
// arms. It computes the same function in the same layout:
//   q/dout (b, sq, nq, hd), k/v (b, sk, nkv, hd) fp32, any strides with a
//   unit last stride; LSE (forward's) and D = rowsum(dO * O), both
//   (b, sq, nkv, m) contiguous fp32, m = nq / nkv; dQ (b, sq, nq, hd)
//   contiguous fp32.
//   P = exp(S - LSE) over the masked scores (causal, sliding window, kv
//   padding, `q_offset` shift of the query positions, gemma2 softcap),
//   dS = P (dO V^T - D) dcap scale with dcap = 1 - tanh^2 under a softcap,
//   dQ = sum over kv tiles of dS K. All products run in fp32.
//
// What bounds it on an H100: its products run as fp32 FMAs on the CUDA
// cores (67 TFLOP/s peak); the training shape's three products (b 1,
// s 2048, 64 heads of 128, causal: about 1.0e11 FLOP) would take about
// 1.5 ms there. The port's fp32 paths are the small checking sizes.
//
// Design. One thread block per (tile of 64 rows, kv head, batch), where a
// row is one (query, GQA head) pair, as in the forward kernel: the block
// owns its dQ rows and loops over the kv tiles itself, so no other block
// writes them and no atomics are needed (runs are bit-for-bit repeatable).
// Whole kv tiles that the causal or window mask empties are skipped through
// the loop bounds, as `_relevant` does on the TPU. Q and dO of the tile are
// staged once in shared memory as fp32; each kv tile stages K and V (rows
// padded by one word so column reads hit distinct banks), and dS reuses V's
// buffer once dP is done. 256 threads: thread (ty, tx) owns rows ty + 32i
// (i < 2), score columns tx + 8j and dQ columns tx + 8c, so S and dP come
// out of one loop over head_dim and dQ accumulates in registers. Rows past
// sq and keys past sk are masked loads that read zeros; a key past sk gets
// P = 0 and adds nothing to dQ.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;       // (query, GQA head) rows per block
constexpr int THREADS = 256;   // 32 row groups x 8 lanes
constexpr int RI = ROWS / 32;  // rows per thread
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // as the reference

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  int b, sq, sk, nq, nkv, hd, m, bq;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int causal, window, q_offset;
  float softcap, scale;
};

// Keys per kv tile: 64, or 32 past head_dim 128, where a tile of 64 keys
// at the full head would not fit the shared memory of a block.
template <int HDP>
__host__ __device__ constexpr int keys() { return HDP > 128 ? 32 : 64; }

template <int HDP>
__host__ __device__ constexpr int v_region() {  // floats of the V buffer, then dS
  constexpr int BK = keys<HDP>();
  return BK * (HDP + 1) > ROWS * (BK + 1) ? BK * (HDP + 1) : ROWS * (BK + 1);
}

template <int HDP>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((2 * ROWS + keys<HDP>()) * (HDP + 1) + v_region<HDP>());
}

template <int HDP>
__global__ void __launch_bounds__(THREADS) flash_dq_fma_kernel(Params p) {
  constexpr int RS = HDP + 1;  // row stride of Q, dO, K, V
  constexpr int BK = keys<HDP>();
  constexpr int CJ = BK / 8;   // score columns per thread
  constexpr int PS = BK + 1;   // row stride of dS
  constexpr int OC = HDP / 8;  // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;               // ROWS x RS
  float* dOs = Qs + ROWS * RS;    // ROWS x RS
  float* Ks = dOs + ROWS * RS;    // BK x RS
  float* Vs = Ks + BK * RS;       // BK x RS, then dS: ROWS x PS

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int g = blockIdx.y, bb = blockIdx.z;
  const int m = p.m;
  const int q0 = blockIdx.x * p.bq;
  const int nq_tile = min(p.bq, p.sq - q0);
  const int nrows = nq_tile * m;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);

  for (int idx = tid; idx < ROWS * HDP; idx += THREADS) {
    const int r = idx / HDP, d = idx % HDP;
    float qval = 0.f, dval = 0.f;
    if (r < nrows && d < p.hd) {
      const int qi = q0 + r / m, h = g * m + r % m;
      qval = q[bb * p.qsb + qi * p.qss + h * p.qsh + d];
      dval = dout[bb * p.dsb + qi * p.dss + h * p.dsh + d];
    }
    Qs[r * RS + d] = qval;
    dOs[r * RS + d] = dval;
  }

  int qpos[RI];
  float lse[RI], dlt[RI], acc[RI][OC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 32 * i;
    qpos[i] = q0 + r / m + p.q_offset;
    lse[i] = 0.f;
    dlt[i] = 0.f;
    if (r < nrows) {
      const long long row = (static_cast<long long>(bb) * p.sq + q0 + r / m) * p.nkv * m
                            + static_cast<long long>(g) * m + r % m;
      lse[i] = p.lse[row];
      dlt[i] = p.delta[row];
    }
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  // Whole kv tiles the masks empty for every row of this block are skipped.
  int kv_end = p.sk;
  if (p.causal) kv_end = min(kv_end, q0 + nq_tile + p.q_offset);
  int kv_begin = 0;
  if (p.window) kv_begin = max(0, q0 + p.q_offset - p.window + 1) / BK * BK;

  for (int k0 = kv_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();  // the previous tile's K and dS are read
    for (int idx = tid; idx < BK * HDP; idx += THREADS) {
      const int j = idx / HDP, d = idx % HDP, kv = k0 + j;
      float kval = 0.f, vval = 0.f;
      if (kv < p.sk && d < p.hd) {
        kval = k[bb * p.ksb + kv * p.kss + g * p.ksh + d];
        vval = v[bb * p.vsb + kv * p.vss + g * p.vsh + d];
      }
      Ks[j * RS + d] = kval;
      Vs[j * RS + d] = vval;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T in one pass over head_dim.
    float s[RI][CJ], dp[RI][CJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qv[RI], dov[RI], kv[CJ], vv[CJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + 32 * i) * RS + d];
        dov[i] = dOs[(ty + 32 * i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        kv[j] = Ks[(tx + 8 * j) * RS + d];
        vv[j] = Vs[(tx + 8 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < CJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
        }
    }

    // dS = P (dP - D) dcap scale, P recomputed from the LSE.
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float x = s[i][j] * p.scale, dcap = 1.f;
        if (p.softcap != 0.f) {
          const float t = tanhf(x / p.softcap);
          x = p.softcap * t;
          dcap = 1.f - t * t;
        }
        bool keep = kpos < p.sk;
        if (p.causal) keep = keep && qpos[i] >= kpos;
        if (p.window) keep = keep && qpos[i] - kpos < p.window;
        const float pr = expf((keep ? x : NEG_INF) - lse[i]);
        s[i][j] = pr * (dp[i][j] - dlt[i]) * dcap * p.scale;
      }

    __syncthreads();  // every thread is done reading V: reuse it for dS
    float* dSs = Vs;
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < CJ; ++j) dSs[(ty + 32 * i) * PS + tx + 8 * j] = s[i][j];
    __syncthreads();

    // dQ += dS K
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float dsv[RI];
#pragma unroll
      for (int i = 0; i < RI; ++i) dsv[i] = dSs[(ty + 32 * i) * PS + j];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float kk = Ks[j * RS + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < RI; ++i) acc[i][c] = fmaf(dsv[i], kk, acc[i][c]);
      }
    }
  }

  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int r = ty + 32 * i;
    if (r >= nrows) continue;
    const int qi = q0 + r / m, mi = r % m;
    float* row = dq + ((static_cast<long long>(bb) * p.sq + qi) * p.nq + g * m + mi) * p.hd;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = tx + 8 * c;
      if (d < p.hd) row[d] = acc[i][c];
    }
  }
}

template <int HDP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_fma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sq + p.bq - 1) / p.bq, p.nkv, p.b);
  flash_dq_fma_kernel<HDP><<<grid, THREADS, smem, stream>>>(p);
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
extern "C" int flash_attention_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int b, int sq, int sk, int nq, int nkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long dsb, long long dss, long long dsh,
    int causal, int window, int q_offset, float softcap, float scale,
    void* stream) {
  if (hd < 1 || hd > 256 || nkv < 1 || nq % nkv || nq / nkv > ROWS ||
      b < 1 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{q, k, v, dout, lse, delta, dq, b, sq, sk, nq, nkv, hd, nq / nkv,
           ROWS / (nq / nkv), qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
           dsb, dss, dsh, causal, window, q_offset, softcap, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(dispatch(p, st));
}

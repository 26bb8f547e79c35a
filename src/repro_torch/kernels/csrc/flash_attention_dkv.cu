// Flash-attention backward, pass 2: dK and dV, for Hopper, plain FMA: the
// fp32 route.
//
// Replaces the Pallas TPU kernel `_dkv_kernel` (pass 2 of `flash_attention_bwd`)
// in src/repro/kernels/flash_attention.py, for fp32 inputs; bf16 inputs take
// csrc/flash_attention_dkv_sm90.cu (wgmma, TMA). The fp32 route stays on the
// CUDA cores because wgmma would run fp32 as TF32 (about three decimal
// digits), and the fp32 checks hold exact fp32 products. It computes the
// same function in the same layout:
//   q/dout (b, sq, nq, hd), k/v (b, sk, nkv, hd) fp32, any strides with a
//   unit last stride; LSE (forward's) and D = rowsum(dO * O), both
//   (b, sq, nkv, m) contiguous fp32, m = nq / nkv; dK and dV (b, sk, nkv, hd)
//   contiguous fp32.
//   P = exp(S - LSE) over the masked scores (causal, sliding window, kv
//   padding, `q_offset` shift of the query positions, gemma2 softcap),
//   dV = sum over query rows of P^T dO, dS = P (dO V^T - D) dcap scale with
//   dcap = 1 - tanh^2 under a softcap, dK = sum over query rows of dS^T Q;
//   the rows of a kv head cover its m query heads, so both sum over them.
//   All products run in fp32.
//
// What bounds it on an H100: its products run as fp32 FMAs on the CUDA
// cores (67 TFLOP/s peak); the training shape's four products (b 1,
// s 2048, 64 heads of 128, causal: about 1.4e11 FLOP) would take about
// 2 ms there. The port's fp32 paths are the small checking sizes.
//
// Design. One thread block per (tile of 64 keys, kv head, batch): the block
// owns its dK and dV rows and loops over the query tiles itself, so no other
// block writes them and no atomics are needed (runs are bit-for-bit
// repeatable). A query tile is 64 rows, each row one (query, GQA head) pair
// of this kv head, as in the forward kernel. Whole query tiles that the
// causal or window mask empties are skipped through the loop bounds, as
// `_relevant` does on the TPU. K and V of the block are staged once in shared
// memory; each query tile stages Q, dO, LSE and D (rows padded by one
// word so column reads hit distinct banks) and writes P^T and dS^T to two
// buffers of their own. 256 threads: thread (ty, tx) owns keys ty + 32i
// (i < 2), score columns (query rows) tx + 8j and dK/dV columns tx + 8c, so
// S^T and dP^T come out of one loop over head_dim and dK, dV accumulate in
// registers. Rows past sq read zeros and get P = 0, so they add nothing to
// dK and dV; keys past sk are never written.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int ROWS = 64;       // (query, GQA head) rows per query tile
constexpr int THREADS = 256;   // 32 key groups x 8 lanes
constexpr int RJ = ROWS / 8;   // score columns (rows) per thread
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // as the reference

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dk;
  void* dv;
  int b, sq, sk, nq, nkv, hd, m, bq;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh, dsb, dss, dsh;
  int causal, window, q_offset;
  float softcap, scale;
};

// Keys per block: 64, or 32 past head_dim 128, where a block of 64 keys
// at the full head would not fit the shared memory of a block.
template <int HDP>
__host__ __device__ constexpr int keys() { return HDP > 128 ? 32 : 64; }

template <int HDP>
constexpr size_t smem_bytes() {
  constexpr int BK = keys<HDP>();
  return sizeof(float) * (2 * BK * (HDP + 1) + 2 * ROWS * (HDP + 1)
                          + 2 * BK * (ROWS + 1) + 2 * ROWS);
}

template <int HDP>
__global__ void __launch_bounds__(THREADS) flash_dkv_fma_kernel(Params p) {
  constexpr int BK = keys<HDP>();
  constexpr int KI = BK / 32;   // keys per thread
  constexpr int RS = HDP + 1;   // row stride of K, V, Q, dO
  constexpr int PS = ROWS + 1;  // row stride of P^T and dS^T
  constexpr int OC = HDP / 8;   // dK/dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;               // BK x RS
  float* Vs = Ks + BK * RS;       // BK x RS
  float* Qs = Vs + BK * RS;       // ROWS x RS
  float* dOs = Qs + ROWS * RS;    // ROWS x RS
  float* Ps = dOs + ROWS * RS;    // BK x PS: P^T
  float* dSs = Ps + BK * PS;      // BK x PS: dS^T
  float* lses = dSs + BK * PS;    // ROWS
  float* dlts = lses + ROWS;      // ROWS

  const int tid = threadIdx.x, ty = tid >> 3, tx = tid & 7;
  const int g = blockIdx.y, bb = blockIdx.z;
  const int m = p.m, bq = p.bq;
  const int k0 = blockIdx.x * BK;
  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);

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

  int kpos[KI];
  float dk_acc[KI][OC], dv_acc[KI][OC];
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    kpos[i] = k0 + ty + 32 * i;
#pragma unroll
    for (int c = 0; c < OC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  }

  // Whole query tiles the masks empty for every key of this block are
  // skipped: under the causal mask the queries before the first key, under
  // the window the queries at or past the last key + window.
  const int k_last = min(k0 + BK, p.sk) - 1;
  int q_begin = 0, q_end = p.sq;
  if (p.causal) q_begin = max(0, k0 - p.q_offset) / bq * bq;
  if (p.window) q_end = min(q_end, max(0, k_last + p.window - p.q_offset));

  for (int q0 = q_begin; q0 < q_end; q0 += bq) {
    const int nrows = min(bq, p.sq - q0) * m;
    __syncthreads();  // the previous tile's Q, dO, P^T and dS^T are read
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
    if (tid < ROWS) {
      float l = 0.f, dl = 0.f;
      if (tid < nrows) {
        const long long row = (static_cast<long long>(bb) * p.sq + q0 + tid / m) * p.nkv * m
                              + static_cast<long long>(g) * m + tid % m;
        l = p.lse[row];
        dl = p.delta[row];
      }
      lses[tid] = l;
      dlts[tid] = dl;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T in one pass over head_dim.
    float s[KI][RJ], dp[KI][RJ];
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float kv[KI], vv[KI], qv[RJ], dov[RJ];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        kv[i] = Ks[(ty + 32 * i) * RS + d];
        vv[i] = Vs[(ty + 32 * i) * RS + d];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        qv[j] = Qs[(tx + 8 * j) * RS + d];
        dov[j] = dOs[(tx + 8 * j) * RS + d];
      }
#pragma unroll
      for (int i = 0; i < KI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
          dp[i][j] = fmaf(vv[i], dov[j], dp[i][j]);
        }
    }

    // P recomputed from the LSE; dS = P (dP - D) dcap scale.
#pragma unroll
    for (int i = 0; i < KI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int r = tx + 8 * j;
        const int qpos = q0 + r / m + p.q_offset;
        float x = s[i][j] * p.scale, dcap = 1.f;
        if (p.softcap != 0.f) {
          const float t = tanhf(x / p.softcap);
          x = p.softcap * t;
          dcap = 1.f - t * t;
        }
        bool keep = r < nrows && kpos[i] < p.sk;
        if (p.causal) keep = keep && qpos >= kpos[i];
        if (p.window) keep = keep && qpos - kpos[i] < p.window;
        const float pr = r < nrows ? expf((keep ? x : NEG_INF) - lses[r]) : 0.f;
        Ps[(ty + 32 * i) * PS + r] = pr;
        dSs[(ty + 32 * i) * PS + r] = pr * (dp[i][j] - dlts[r]) * dcap * p.scale;
      }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the tile's rows.
#pragma unroll 2
    for (int r = 0; r < ROWS; ++r) {
      float pv[KI], dsv[KI];
#pragma unroll
      for (int i = 0; i < KI; ++i) {
        pv[i] = Ps[(ty + 32 * i) * PS + r];
        dsv[i] = dSs[(ty + 32 * i) * PS + r];
      }
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float dov = dOs[r * RS + tx + 8 * c];
        const float qv = Qs[r * RS + tx + 8 * c];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          dv_acc[i][c] = fmaf(pv[i], dov, dv_acc[i][c]);
          dk_acc[i][c] = fmaf(dsv[i], qv, dk_acc[i][c]);
        }
      }
    }
  }

  float* dk = static_cast<float*>(p.dk);
  float* dv = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    if (kpos[i] >= p.sk) continue;
    const long long off = ((static_cast<long long>(bb) * p.sk + kpos[i]) * p.nkv + g) * p.hd;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = tx + 8 * c;
      if (d < p.hd) {
        dk[off + d] = dk_acc[i][c];
        dv[off + d] = dv_acc[i][c];
      }
    }
  }
}

template <int HDP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_fma_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((p.sk + keys<HDP>() - 1) / keys<HDP>(), p.nkv, p.b);
  flash_dkv_fma_kernel<HDP><<<grid, THREADS, smem, stream>>>(p);
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
extern "C" int flash_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
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
  Params p{q, k, v, dout, lse, delta, dk, dv, b, sq, sk, nq, nkv, hd,
           nq / nkv, ROWS / (nq / nkv), qsb, qss, qsh, ksb, kss, ksh,
           vsb, vss, vsh, dsb, dss, dsh, causal, window, q_offset, softcap,
           scale};
  return static_cast<int>(dispatch(p, static_cast<cudaStream_t>(stream)));
}

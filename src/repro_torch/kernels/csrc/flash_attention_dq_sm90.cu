// Flash-attention backward, pass 1: dQ, for Hopper, bf16 on the tensor
// cores: wgmma on bf16 tiles, TMA loads into an mbarrier ring.
//
// Replaces the Pallas TPU kernel `_dq_kernel` (pass 1 of
// `flash_attention_bwd`) in src/repro/kernels/flash_attention.py, for bf16
// inputs (fp32 inputs take csrc/flash_attention_dq.cu, whose products are
// exact fp32: wgmma would run fp32 as TF32). It computes the same function
// in the same layout:
//   q/dout (b, sq, nq, hd), k/v (b, sk, nkv, hd) bf16, any strides with a
//   unit last stride, 16-byte aligned (the wrapper checks TMA's terms); LSE
//   (forward's, natural log) and D = rowsum(dO * O), both (b, sq, nkv, m)
//   contiguous fp32, m = nq / nkv; dQ (b, sq, nq, hd) contiguous bf16.
//   P = exp(S - LSE) over the masked scores (causal, sliding window, kv
//   padding, `q_offset` shift of the query positions, gemma2 softcap),
//   dS = P (dO V^T - D) dcap scale with dcap = 1 - tanh^2 under a softcap,
//   dQ = sum over kv tiles of dS K.
//
// What bounds it on an H100: at the training shape (b 1, s 2048, 64 heads of
// 128, causal) three products over the causal half of the scores, about
// 1.0e11 FLOP, against about 0.17 GB of inputs and outputs: the bf16
// tensor-core rate, about 0.1 ms.
//
// Design. The forward kernel's (csrc/flash_attention_fwd_sm90.cu), with the
// same rows, tiles, ring, masks and tile skipping, from csrc/hopper.cuh.
// One block of one warpgroup owns each tile of 64 (query, GQA head) rows
// and loops over the kv tiles itself, so no other block writes its dQ rows
// and no atomics are needed: two runs give the same bits. Q and dO of the
// tile are TMA boxes loaded once; the LSE and D of the thread's two rows sit
// in registers. Each kv tile:
//   S = Q K^T and dP = dO V^T, two wgmmas from shared memory (K and V are
//   K-major for these: their rows run along head_dim);
//   P = exp2(S scale log2(e) - LSE log2(e)), dS = P (dP - D) dcap scale in
//   the accumulator registers;
//   dQ += dS K, dS in registers as the A fragment and K as the transposed
//   (MN-major) B. dS is split into bf16 hi + lo, two wgmmas, as the forward
//   splits P: one bf16 rounding of dS (2^-9 of each term) breaks the
//   bound 1e-2|dQ| + 1e-3 max|dQ| in a few elements of some cases (the
//   hd 96 GQA one among them). The split costs a third more tensor work.
// Every wgmma loop is unrolled at compile time (S and dP run hd rounded up
// to 16) and the softcap and mask branches are taken once a tile. dQ is
// written through Q's buffer by a TMA store, which drops rows past sq and
// columns past hd.
// head_dim 129-256: dQ is cut into two passes of 128 columns (HDO), one
// block each (blockIdx.y), as the forward cuts O: each keeps the hd-128
// register budget (dq[64]) and recomputes S and dP over the full head,
// about 1.4x the tensor work of one pass. A block holds Q, dO and the K/V
// ring at the full head, 197 KB, so one block fits an SM. Chunks wholly
// past hd (hd <= 192 at the 256 width) are not loaded or stored; they feed
// only dQ columns past hd.

#include "hopper.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int ROWS = 64;      // (query, GQA head) rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 128;  // one warpgroup
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // as the reference
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  CUtensorMap tq, tk, tv, tdo, tdq;
  const float* lse;
  const float* delta;
  int b, sq, sk, nkv, hd, m, bq, n_qt;
  int causal, window, q_offset;
  float softcap, scale;
};

template <int HDP>
constexpr size_t smem_bytes() {
  return 1024 + sizeof(bf16) * 64 * (HDP / 64) * (2 * ROWS + 2 * STAGES * BK)
         + 8 * (1 + STAGES);
}

// dS = P (dP - D) dcap scale over the tile, in place of S, P recomputed
// from the LSE and masked where EDGE: one variant per (softcap, edge) pair,
// chosen once a tile, so the loop over the thread's 32 scores has no branch.
template <bool CAP, bool EDGE>
__device__ __forceinline__ void tile_ds(float (&s)[BK / 2], const float (&dp)[BK / 2],
                                        const Params& p, int k0, int lane,
                                        const int (&qpos)[2], const float (&lse2)[2],
                                        const float (&dlt)[2]) {
  const float scale2 = p.scale * LOG2E, inv_cap = CAP ? 1.f / p.softcap : 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int h = (i >> 1) & 1;
    float x, dcap = 1.f;
    if (CAP) {
      const float th = tanhf(s[i] * p.scale * inv_cap);
      x = p.softcap * th * LOG2E;
      dcap = 1.f - th * th;
    } else {
      x = s[i] * scale2;
    }
    if (EDGE) {
      const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool keep = (kpos < p.sk) & (!p.causal | (qpos[h] >= kpos))
                        & (!p.window | (qpos[h] - kpos < p.window));
      x = keep ? x : NEG_INF;
    }
    s[i] = exp2_approx(x - lse2[h]) * (dp[i] - dlt[h]) * dcap * p.scale;
  }
}

// HDP: head_dim padded to 64-column chunks; KS: k16 steps of S and dP,
// head_dim rounded up to 16 (the columns past hd are TMA's zeros); HDO:
// the dQ columns of one pass (blockIdx.y picks the pass).
template <int HDP, int KS, int HDO>
__global__ void __launch_bounds__(THREADS)
flash_dq_sm90_kernel(const __grid_constant__ Params p) {
  constexpr int NC = HDP / 64;          // 64-column chunks of head_dim
  constexpr int NCO = HDO / 64;         // dQ chunks of one pass
  constexpr uint32_t KV_CHUNK = BK * 128;
  // This pass's first dQ chunk; the chunks TMA loads and stores: those
  // that start before hd.
  // One pass (HDO == HDP, hd <= 128) loads every chunk, known at compile
  // time; past 128 the pass (blockIdx.y) and hd decide.
  constexpr bool SPLIT = HDO < HDP;
  const int c0 = SPLIT ? blockIdx.y * NCO : 0;
  const int nc_live = SPLIT ? min(NC, (p.hd + 63) / 64) : NC;
  const int nco_live = SPLIT ? min(NCO, max(0, nc_live - c0)) : NCO;
  extern __shared__ char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));  // NC x ROWS x 64
  bf16* sdO = sQ + NC * ROWS * 64;      // NC x ROWS x 64
  bf16* sK = sdO + NC * ROWS * 64;      // STAGES x NC x BK x 64
  bf16* sV = sK + STAGES * NC * BK * 64;
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * NC * BK * 64);
  uint64_t* bar_kv = bar_q + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Query tile fastest and counting down, as in the forward.
  const int hb = blockIdx.x / p.n_qt;
  const int qt = p.n_qt - 1 - blockIdx.x % p.n_qt;
  const int g = hb % p.nkv, bb = hb / p.nkv;
  const int m = p.m;
  const int q0 = qt * p.bq;
  const int nq_tile = min(p.bq, p.sq - q0);
  const int nrows = nq_tile * m;

  // Whole kv tiles the masks empty for every row of this block are skipped.
  int kv_end = p.sk;
  if (p.causal) kv_end = min(kv_end, q0 + nq_tile + p.q_offset);
  int kv_begin = 0;
  if (p.window) kv_begin = max(0, q0 + p.q_offset - p.window + 1) / BK * BK;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&bar_kv[s], 1);
    fence_mbar_init();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, 2 * nc_live * 128 * m * p.bq);
    for (int c = 0; c < nc_live; ++c) {
      tma_load(sQ + c * ROWS * 64, &p.tq, bar_q, 64 * c, g * m, q0, bb);
      tma_load(sdO + c * ROWS * 64, &p.tdo, bar_q, 64 * c, g * m, q0, bb);
    }
    for (int t = 0; t < STAGES && t < n_tiles; ++t) {
      const int k0 = kv_begin + t * BK;
      mbar_expect_tx(&bar_kv[t], 2 * nc_live * KV_CHUNK);
      for (int c = 0; c < nc_live; ++c) {
        tma_load(sK + (t * NC + c) * BK * 64, &p.tk, &bar_kv[t], 64 * c, g, k0, bb);
        tma_load(sV + (t * NC + c) * BK * 64, &p.tv, &bar_kv[t], 64 * c, g, k0, bb);
      }
    }
  }

  // This thread's two accumulator rows: r0 and r0 + 8.
  const int r0 = 16 * warp + (lane >> 2);
  int qpos[2];
  float lse2[2], dlt[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 8 * h;
    qpos[h] = q0 + r / m + p.q_offset;
    lse2[h] = 0.f;
    dlt[h] = 0.f;
    if (r < nrows) {
      const long long row = ((static_cast<long long>(bb) * p.sq + q0 + r / m) * p.nkv + g) * m
                            + r % m;
      lse2[h] = p.lse[row] * LOG2E;
      dlt[h] = p.delta[row];
    }
  }
  float dq[HDO / 2];
#pragma unroll
  for (int i = 0; i < HDO / 2; ++i) dq[i] = 0.f;

  const int min_qpos = q0 + p.q_offset;
  const int max_qpos = q0 + nq_tile - 1 + p.q_offset;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const int k0 = kv_begin + t * BK;
    const bf16* tK = sK + st * NC * BK * 64;
    const bf16* tV = sV + st * NC * BK * 64;
    mbar_wait(&bar_kv[st], (t / STAGES) & 1);

    // S = Q K^T and dP = dO V^T
    float s[BK / 2], dp[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss_n64(s, desc_k(sQ + (kk / 4) * ROWS * 64, kk % 4),
                   desc_k(tK + (kk / 4) * BK * 64, kk % 4), kk > 0);
      wgmma_ss_n64(dp, desc_k(sdO + (kk / 4) * ROWS * 64, kk % 4),
                   desc_k(tV + (kk / 4) * BK * 64, kk % 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - D) dcap scale, P recomputed from the LSE
    const bool edge = k0 + BK > p.sk || (p.causal && k0 + BK - 1 > min_qpos)
                      || (p.window && k0 <= max_qpos - p.window);
    if (p.softcap != 0.f) {
      if (edge) tile_ds<true, true>(s, dp, p, k0, lane, qpos, lse2, dlt);
      else tile_ds<true, false>(s, dp, p, k0, lane, qpos, lse2, dlt);
    } else {
      if (edge) tile_ds<false, true>(s, dp, p, k0, lane, qpos, lse2, dlt);
      else tile_ds<false, false>(s, dp, p, k0, lane, qpos, lse2, dlt);
    }

    // dQ += dS K, dS as bf16 hi + lo
    uint32_t dh[BK / 16][4], dl[BK / 16][4];
    acc_to_a_split<BK>(s, dh, dl);
    fence_regs(dh);
    fence_regs(dl);
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dk = desc_mn(tK + c0 * BK * 64, kk, KV_CHUNK);
      if constexpr (HDO == 128) {
        wgmma_rs_n128_tb(dq, dh[kk], dk, 1);
        wgmma_rs_n128_tb(dq, dl[kk], dk, 1);
      } else {
        wgmma_rs_n64_tb(dq, dh[kk], dk, 1);
        wgmma_rs_n64_tb(dq, dl[kk], dk, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dq);

    __syncthreads();  // the warpgroup is done with this stage: refill it
    if (tid == 0 && t + STAGES < n_tiles) {
      const int kn = k0 + STAGES * BK;
      mbar_expect_tx(&bar_kv[st], 2 * nc_live * KV_CHUNK);
      for (int c = 0; c < nc_live; ++c) {
        tma_load(sK + (st * NC + c) * BK * 64, &p.tk, &bar_kv[st], 64 * c, g, kn, bb);
        tma_load(sV + (st * NC + c) * BK * 64, &p.tv, &bar_kv[st], 64 * c, g, kn, bb);
      }
    }
  }

  // dQ as bf16 into Q's buffer (swizzled), then one TMA store per chunk.
  char* out = reinterpret_cast<char*>(sQ);
#pragma unroll
  for (int i = 0; i < HDO / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(out + swz(ROWS, r0 + 8 * h, col)) =
        pack_bf16(dq[i], dq[i + 1]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < nco_live; ++c)
      tma_store(&p.tdq, sQ + c * ROWS * 64, 64 * (c0 + c), g * m, q0, bb);
    tma_store_wait();
  }
}

template <int HDP, int KS, int HDO>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dq_sm90_kernel<HDP, KS, HDO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.n_qt) * p.nkv * p.b, HDP / HDO);
  flash_dq_sm90_kernel<HDP, KS, HDO><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. Returns a cudaError_t; 0 means launched.
extern "C" int flash_attention_dq_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dq,
    int b, int sq, int sk, int nq, int nkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    long long dsb, long long dss, long long dsh,
    int causal, int window, int q_offset, float softcap, float scale,
    void* stream) {
  if (hd < 8 || hd > 256 || hd % 8 || nkv < 1 || nq % nkv || nq / nkv > ROWS ||
      b < 1 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.lse = lse;
  p.delta = delta;
  p.b = b; p.sq = sq; p.sk = sk; p.nkv = nkv; p.hd = hd;
  p.m = nq / nkv;
  p.bq = ROWS / p.m;
  p.n_qt = (sq + p.bq - 1) / p.bq;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  cudaError_t err;
  if ((err = make_map(&p.tq, q, b, sq, nq, hd, qsb, qss, qsh, p.m, p.bq)) ||
      (err = make_map(&p.tdo, dout, b, sq, nq, hd, dsb, dss, dsh, p.m, p.bq)) ||
      (err = make_map(&p.tk, k, b, sk, nkv, hd, ksb, kss, ksh, 1, BK)) ||
      (err = make_map(&p.tv, v, b, sk, nkv, hd, vsb, vss, vsh, 1, BK)) ||
      (err = make_map(&p.tdq, dq, b, sq, nq, hd, static_cast<long long>(sq) * nq * hd,
                      static_cast<long long>(nq) * hd, hd, p.m, p.bq)))
    return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hd <= 32) err = launch<64, 2, 64>(p, st);
  else if (hd <= 64) err = launch<64, 4, 64>(p, st);
  else if (hd <= 96) err = launch<128, 6, 128>(p, st);
  else if (hd <= 128) err = launch<128, 8, 128>(p, st);
  else if (hd <= 192) err = launch<256, 12, 128>(p, st);
  else err = launch<256, 16, 128>(p, st);
  return static_cast<int>(err);
}

// Flash-attention backward, pass 2: dK and dV, for Hopper, bf16 on the
// tensor cores: wgmma on bf16 tiles, TMA loads into an mbarrier ring.
//
// Replaces the Pallas TPU kernel `_dkv_kernel` (pass 2 of
// `flash_attention_bwd`) in src/repro/kernels/flash_attention.py, for bf16
// inputs (fp32 inputs take csrc/flash_attention_dkv.cu, whose products are
// exact fp32: wgmma would run fp32 as TF32). It computes the same function
// in the same layout:
//   q/dout (b, sq, nq, hd), k/v (b, sk, nkv, hd) bf16, any strides with a
//   unit last stride, 16-byte aligned (the wrapper checks TMA's terms); LSE
//   (forward's, natural log) and D = rowsum(dO * O), both (b, sq, nkv, m)
//   contiguous fp32, m = nq / nkv; dK and dV (b, sk, nkv, hd) contiguous
//   bf16.
//   P = exp(S - LSE) over the masked scores (causal, sliding window, kv
//   padding, `q_offset` shift of the query positions, gemma2 softcap),
//   dV = sum over query rows of P^T dO, dS = P (dO V^T - D) dcap scale with
//   dcap = 1 - tanh^2 under a softcap, dK = sum over query rows of dS^T Q;
//   the rows of a kv head cover its m query heads, so both sum over them.
//
// What bounds it on an H100: at the training shape (b 1, s 2048, 64 heads of
// 128, causal) four products over the causal half of the scores, about
// 1.4e11 FLOP, against about 0.17 GB of inputs and outputs: the bf16
// tensor-core rate, about 0.14 ms.
//
// Design: the dq kernel's (csrc/flash_attention_dq_sm90.cu) mirrored, key-
// stationary, from csrc/hopper.cuh. One block of one warpgroup owns a tile
// of 64 keys of one (kv head, batch) and loops over the query tiles
// itself, so no other block writes its dK and dV rows and no atomics are
// needed: two runs give the same bits. K and V of the tile are TMA boxes
// loaded once. A query tile is 64 rows, each one (query, GQA head) pair of
// this kv head, as in dq: its Q and dO boxes (64 columns of hd, m heads,
// 64/m positions) come through a 2-stage mbarrier ring, and its 64 LSE and
// D values beside them in shared memory (plain loads, issued a tile ahead
// into a register). Each query tile:
//   S^T = K Q^T and dP^T = V dO^T, two wgmmas from shared memory (A is K
//   or V, B is Q or dO, all K-major: their rows run along head_dim); the
//   accumulator rows are keys, its columns query rows, so each thread reads
//   the LSE and D of its 16 columns from the stage's copy;
//   P^T = exp2(S^T scale log2(e) - LSE log2(e)), dS^T = P^T (dP^T - D)
//   dcap scale in the accumulator registers;
//   dV += P^T dO and dK += dS^T Q, P^T and dS^T in registers as the A
//   fragments, dO and Q as the transposed (MN-major) B. Both go in as bf16
//   hi + lo pairs, two wgmmas each, as the forward splits P and dq splits
//   dS: a CPU emulation (scripts/dkv_bf16_rounding.py) found one bf16
//   rounding of either breaks the bound 1e-2|want| + 1e-3 max|want| in a
//   few elements of every case of chip_smoke.py's SM90_SWEEP, the split in
//   none. The split costs half again the tensor work.
// Query tiles that the causal or window mask empties for every key of the
// block are skipped through the loop bounds, as `_relevant` does on the
// TPU; blocks take the key tiles in order, so under the causal mask the
// longest (key tile 0, which sees every query) go first. Masks are applied
// element by element only on tiles that cut them, in a variant chosen
// once a tile at compile time with the softcap; keys past sk need no mask,
// since their dK and dV rows are never stored. Query rows past sq (TMA's
// zeros) and the rows a box leaves empty when m does not divide 64 (zeroed
// once) get an LSE of +inf, so P = dS = 0 there. Every wgmma loop is
// unrolled at compile time (S^T and dP^T run hd rounded up to 16). dK and
// dV are written through K's and V's buffers by TMA stores, which drop rows
// past sk and columns past hd.
// head_dim 129-256: the dK and dV accumulators of 256 columns cannot sit
// beside the rest in 255 registers (the hd-128 kernel already takes about
// 250). So dK and dV are cut into two passes of 128 columns (HDO), one
// block each (blockIdx.y): each keeps the hd-128 register budget and
// recomputes S^T and dP^T over the full head, about 1.5x the tensor work
// of one pass. A block holds K, V and the Q/dO ring at the full head, 199
// KB, so one block fits an SM. Chunks wholly past hd (hd <= 192 at the 256
// width) are not loaded or stored; they feed only columns past hd.

#include "hopper.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BK = 64;        // keys per block
constexpr int ROWS = 64;      // (query, GQA head) rows per query tile
constexpr int STAGES = 2;     // Q/dO ring depth
constexpr int THREADS = 128;  // one warpgroup
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // as the reference
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  const float* lse;
  const float* delta;
  int b, sq, sk, nkv, hd, m, bq;
  int causal, window, q_offset;
  float softcap, scale;
};

template <int HDP>
constexpr size_t smem_bytes() {
  return 1024 + sizeof(bf16) * 64 * (HDP / 64) * (2 * BK + 2 * STAGES * ROWS)
         + sizeof(float) * 2 * STAGES * ROWS + 8 * (1 + STAGES);
}

// P^T in place of S^T and dS^T = P^T (dP^T - D) dcap scale in place of
// dP^T, P recomputed from the LSE and masked where EDGE: one variant per
// (softcap, edge) pair, chosen once a tile, so the loop over the thread's
// 32 scores has no branch. Register 4j + e holds key row kr + 8 (e / 2) and
// query row 8j + 2 (lane % 4) + e % 2 of the tile.
template <bool CAP, bool EDGE>
__device__ __forceinline__ void tile_ds(float (&s)[ROWS / 2], float (&dp)[ROWS / 2],
                                        const Params& p, int kpos0, int q0,
                                        int lane, const float* lse2,
                                        const float* dlt) {
  const float scale2 = p.scale * LOG2E, inv_cap = CAP ? 1.f / p.softcap : 0.f;
#pragma unroll
  for (int j = 0; j < ROWS / 8; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 l2 = *reinterpret_cast<const float2*>(lse2 + c);
    const float2 d2 = *reinterpret_cast<const float2*>(dlt + c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float x, dcap = 1.f;
      if (CAP) {
        const float th = tanhf(s[i] * p.scale * inv_cap);
        x = p.softcap * th * LOG2E;
        dcap = 1.f - th * th;
      } else {
        x = s[i] * scale2;
      }
      if (EDGE) {
        const int kpos = kpos0 + 8 * (e >> 1);
        const int qpos = q0 + (c + (e & 1)) / p.m + p.q_offset;
        const bool keep = (!p.causal | (qpos >= kpos))
                          & (!p.window | (qpos - kpos < p.window));
        x = keep ? x : NEG_INF;
      }
      const float pr = exp2_approx(x - ((e & 1) ? l2.y : l2.x));
      s[i] = pr;
      dp[i] = pr * (dp[i] - ((e & 1) ? d2.y : d2.x)) * dcap * p.scale;
    }
  }
}

// HDP: head_dim padded to 64-column chunks; KS: k16 steps of S^T and dP^T,
// head_dim rounded up to 16 (the columns past hd are TMA's zeros); HDO:
// the dK/dV columns of one pass (blockIdx.y picks the pass).
template <int HDP, int KS, int HDO>
__global__ void __launch_bounds__(THREADS, HDP > 128 ? 1 : 2)
flash_dkv_sm90_kernel(const __grid_constant__ Params p) {
  constexpr int NC = HDP / 64;              // 64-column chunks of head_dim
  constexpr int NCO = HDO / 64;             // dK/dV chunks of one pass
  // This pass's first dK/dV chunk; the chunks TMA loads and stores: those
  // that start before hd.
  // One pass (HDO == HDP, hd <= 128) loads every chunk, known at compile
  // time; past 128 the pass (blockIdx.y) and hd decide.
  constexpr bool SPLIT = HDO < HDP;
  const int c0 = SPLIT ? blockIdx.y * NCO : 0;
  const int nc_live = SPLIT ? min(NC, (p.hd + 63) / 64) : NC;
  const int nco_live = SPLIT ? min(NCO, max(0, nc_live - c0)) : NCO;
  constexpr uint32_t Q_CHUNK = ROWS * 128;  // bytes between chunks of a Q/dO tile
  extern __shared__ char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(align1024(smem_raw));  // NC x BK x 64
  bf16* sV = sK + NC * BK * 64;             // NC x BK x 64
  bf16* sQ = sV + NC * BK * 64;             // STAGES x NC x ROWS x 64
  bf16* sdO = sQ + STAGES * NC * ROWS * 64;
  float* sL = reinterpret_cast<float*>(sdO + STAGES * NC * ROWS * 64);  // STAGES x ROWS
  float* sD = sL + STAGES * ROWS;
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(sD + STAGES * ROWS);
  uint64_t* bar_q = bar_kv + 1;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Key tile slowest: under the causal mask tile 0 is the longest.
  const int hb = blockIdx.x % (p.nkv * p.b);
  const int k0 = blockIdx.x / (p.nkv * p.b) * BK;
  const int g = hb % p.nkv, bb = hb / p.nkv;
  const int m = p.m, bq = p.bq;
  const int box_rows = m * bq;

  // Whole query tiles the masks empty for every key of this block are
  // skipped: under the causal mask the queries before the first key, under
  // the window those at or past the last key + window.
  const int k_last = min(k0 + BK, p.sk) - 1;
  int q_begin = 0, q_end = p.sq;
  if (p.causal) q_begin = max(0, k0 - p.q_offset) / bq * bq;
  if (p.window) q_end = min(q_end, max(0, k_last + p.window - p.q_offset));
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + bq - 1) / bq : 0;

  // LSE * log2(e) (threads 0-63) or D (64-127) of row tid % 64 of the tile
  // at q0; +inf and 0 on rows past sq or past the box, so P = 0 there.
  const int lr = tid & (ROWS - 1);
  auto fetch = [&](int q0) -> float {
    const int pos = q0 + lr / m;
    if (lr >= box_rows || pos >= p.sq) return tid < ROWS ? INFINITY : 0.f;
    const long long row = ((static_cast<long long>(bb) * p.sq + pos) * p.nkv + g) * m
                          + lr % m;
    return tid < ROWS ? p.lse[row] * LOG2E : p.delta[row];
  };
  float* const my_ld = tid < ROWS ? sL : sD;

  if (tid == 0) {
    mbar_init(bar_kv, 1);
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(&bar_q[s], 1);
    fence_mbar_init();
  }
  // The rows a box of m heads x 64/m positions leaves empty are never
  // written by TMA: zero them once in every stage, so they add 0 * 0.
  if (box_rows < ROWS) {
    const int words = (ROWS - box_rows) * 32;  // 4-byte words per chunk
    for (int idx = tid; idx < 2 * STAGES * NC * words; idx += THREADS) {
      const int chunk = idx / words, w = idx % words;
      bf16* base = (chunk < STAGES * NC ? sQ : sdO) + (chunk % (STAGES * NC)) * ROWS * 64;
      reinterpret_cast<uint32_t*>(base + box_rows * 64)[w] = 0u;
    }
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_kv, 2 * nc_live * BK * 128);
    for (int c = 0; c < nc_live; ++c) {
      tma_load(sK + c * BK * 64, &p.tk, bar_kv, 64 * c, g, k0, bb);
      tma_load(sV + c * BK * 64, &p.tv, bar_kv, 64 * c, g, k0, bb);
    }
    for (int t = 0; t < STAGES && t < n_tiles; ++t) {
      const int q0 = q_begin + t * bq;
      mbar_expect_tx(&bar_q[t], 2 * nc_live * 128 * box_rows);
      for (int c = 0; c < nc_live; ++c) {
        tma_load(sQ + (t * NC + c) * ROWS * 64, &p.tq, &bar_q[t], 64 * c, g * m, q0, bb);
        tma_load(sdO + (t * NC + c) * ROWS * 64, &p.tdo, &bar_q[t], 64 * c, g * m, q0, bb);
      }
    }
  }
  for (int t = 0; t < STAGES && t < n_tiles; ++t) my_ld[t * ROWS + lr] = fetch(q_begin + t * bq);
  __syncthreads();

  // This thread's two accumulator rows (keys) kr and kr + 8.
  const int kr = 16 * warp + (lane >> 2);
  float dk[HDO / 2], dv[HDO / 2];
#pragma unroll
  for (int i = 0; i < HDO / 2; ++i) dk[i] = dv[i] = 0.f;

  mbar_wait(bar_kv, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const int q0 = q_begin + t * bq;
    const bool refill = t + STAGES < n_tiles;
    const float next = refill ? fetch(q0 + STAGES * bq) : 0.f;  // used after the tile
    const bf16* tQ = sQ + st * NC * ROWS * 64;
    const bf16* tdO = sdO + st * NC * ROWS * 64;
    mbar_wait(&bar_q[st], (t / STAGES) & 1);

    // S^T = K Q^T and dP^T = V dO^T
    float s[ROWS / 2], dp[ROWS / 2];
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      wgmma_ss_n64(s, desc_k(sK + (kk / 4) * BK * 64, kk % 4),
                   desc_k(tQ + (kk / 4) * ROWS * 64, kk % 4), kk > 0);
      wgmma_ss_n64(dp, desc_k(sV + (kk / 4) * BK * 64, kk % 4),
                   desc_k(tdO + (kk / 4) * ROWS * 64, kk % 4), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T and dS^T, P recomputed from the LSE
    const int nq_tile = min(bq, p.sq - q0);
    const bool edge = (p.causal && q0 + p.q_offset < k0 + BK - 1)
                      || (p.window && q0 + nq_tile - 1 + p.q_offset - k0 >= p.window);
    const float* tL = sL + st * ROWS;
    const float* tD = sD + st * ROWS;
    if (p.softcap != 0.f) {
      if (edge) tile_ds<true, true>(s, dp, p, k0 + kr, q0, lane, tL, tD);
      else tile_ds<true, false>(s, dp, p, k0 + kr, q0, lane, tL, tD);
    } else {
      if (edge) tile_ds<false, true>(s, dp, p, k0 + kr, q0, lane, tL, tD);
      else tile_ds<false, false>(s, dp, p, k0 + kr, q0, lane, tL, tD);
    }

    // dV += P^T dO and dK += dS^T Q, P^T and dS^T as bf16 hi + lo
    uint32_t ph[ROWS / 16][4], pl[ROWS / 16][4], dh[ROWS / 16][4], dl[ROWS / 16][4];
    acc_to_a_split<ROWS>(s, ph, pl);
    acc_to_a_split<ROWS>(dp, dh, dl);
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(dh);
    fence_regs(dl);
    fence_regs(dv);
    fence_regs(dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
      const uint64_t bdo = desc_mn(tdO + c0 * ROWS * 64, kk, Q_CHUNK);
      const uint64_t bq_ = desc_mn(tQ + c0 * ROWS * 64, kk, Q_CHUNK);
      if constexpr (HDO == 128) {
        wgmma_rs_n128_tb(dv, ph[kk], bdo, 1);
        wgmma_rs_n128_tb(dv, pl[kk], bdo, 1);
        wgmma_rs_n128_tb(dk, dh[kk], bq_, 1);
        wgmma_rs_n128_tb(dk, dl[kk], bq_, 1);
      } else {
        wgmma_rs_n64_tb(dv, ph[kk], bdo, 1);
        wgmma_rs_n64_tb(dv, pl[kk], bdo, 1);
        wgmma_rs_n64_tb(dk, dh[kk], bq_, 1);
        wgmma_rs_n64_tb(dk, dl[kk], bq_, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);

    __syncthreads();  // the warpgroup is done with this stage: refill it
    if (refill) {
      my_ld[st * ROWS + lr] = next;
      if (tid == 0) {
        const int qn = q0 + STAGES * bq;
        mbar_expect_tx(&bar_q[st], 2 * nc_live * 128 * box_rows);
        for (int c = 0; c < nc_live; ++c) {
          tma_load(sQ + (st * NC + c) * ROWS * 64, &p.tq, &bar_q[st], 64 * c, g * m, qn, bb);
          tma_load(sdO + (st * NC + c) * ROWS * 64, &p.tdo, &bar_q[st], 64 * c, g * m, qn, bb);
        }
      }
    }
  }

  // dK and dV as bf16 into K's and V's buffers (swizzled), then one TMA
  // store per chunk each. The last tile ended in a __syncthreads, and with
  // no tile the K/V loads completed above, so the buffers are free.
  char* ok = reinterpret_cast<char*>(sK);
  char* ov = reinterpret_cast<char*>(sV);
#pragma unroll
  for (int i = 0; i < HDO / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(ok + swz(BK, kr + 8 * h, col)) = pack_bf16(dk[i], dk[i + 1]);
    *reinterpret_cast<uint32_t*>(ov + swz(BK, kr + 8 * h, col)) = pack_bf16(dv[i], dv[i + 1]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < nco_live; ++c) {
      tma_store(&p.tdk, sK + c * BK * 64, 64 * (c0 + c), g, k0, bb);
      tma_store(&p.tdv, sV + c * BK * 64, 64 * (c0 + c), g, k0, bb);
    }
    tma_store_wait();
  }
}

template <int HDP, int KS, int HDO>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_dkv_sm90_kernel<HDP, KS, HDO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.sk + BK - 1) / BK) * p.nkv * p.b,
                  HDP / HDO);
  flash_dkv_sm90_kernel<HDP, KS, HDO><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. Returns a cudaError_t; 0 means launched.
extern "C" int flash_attention_dkv_sm90(
    const void* q, const void* k, const void* v, const void* dout,
    const float* lse, const float* delta, void* dk, void* dv,
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
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  const long long out_s = static_cast<long long>(nkv) * hd;
  cudaError_t err;
  if ((err = make_map(&p.tq, q, b, sq, nq, hd, qsb, qss, qsh, p.m, p.bq)) ||
      (err = make_map(&p.tdo, dout, b, sq, nq, hd, dsb, dss, dsh, p.m, p.bq)) ||
      (err = make_map(&p.tk, k, b, sk, nkv, hd, ksb, kss, ksh, 1, BK)) ||
      (err = make_map(&p.tv, v, b, sk, nkv, hd, vsb, vss, vsh, 1, BK)) ||
      (err = make_map(&p.tdk, dk, b, sk, nkv, hd, sk * out_s, out_s, hd, 1, BK)) ||
      (err = make_map(&p.tdv, dv, b, sk, nkv, hd, sk * out_s, out_s, hd, 1, BK)))
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

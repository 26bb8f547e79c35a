// Flash-attention forward (online softmax) for Hopper, bf16 on the tensor
// cores: wgmma on bf16 tiles, TMA loads into an mbarrier ring.
//
// Replaces the Pallas TPU kernel `_kernel` reached through
// `flash_attention_fwd` in src/repro/kernels/flash_attention.py, for bf16
// inputs (fp32 inputs take csrc/flash_attention_fwd.cu, whose products are
// exact fp32: wgmma would run fp32 as TF32, about three decimal digits). It
// computes the same function in the same layout:
//   q (b, sq, nq, hd), k/v (b, sk, nkv, hd) bf16, any strides with a unit
//   last stride, 16-byte aligned (TMA's terms; the wrapper checks them);
//   O (b, sq, nq, hd) contiguous bf16 and LSE (b, sq, nkv, m) contiguous
//   fp32 in natural log, m = nq / nkv. Masks: causal, sliding window, kv
//   padding, `q_offset` shift of the query positions; gemma2 logit softcap;
//   denom = max(l, 1e-30).
//
// What bounds it on an H100: at the serving shape (b 4, s 2048, 64 heads of
// 128, causal) the work is 2.75e11 FLOP against 0.27 GB of q/k/v/O/LSE, so
// the bound is the bf16 tensor-core rate (0.28 ms at 989 TFLOP/s).
//
// Design. One block of two warpgroups (256 threads) per tile of 128 rows,
// 64 rows to a warpgroup, where a row is one (query, GQA head) pair: row r
// is query q0 + r / m and head g*m + r % m, so the m query heads that share
// a kv head ride in one tile and each K/V tile is loaded once for all of
// them. Q is one TMA box (64 columns, m heads, 128/m queries) per 64-column
// chunk of head_dim, loaded once. K/V tiles of 64 keys go through a
// two-stage ring filled by TMA and completed on an mbarrier, so tile i+1
// loads while tile i computes; thread 0 refills a stage once both
// warpgroups have finished with it. Up to hd 128 two blocks fit an SM (96
// KB of shared memory each, at most 128 registers a thread), so four
// warpgroups share
// its tensor cores; one warpgroup a block measured slower at the serve
// shape (PERF.md).
//   S = Q K^T is a wgmma with both operands in shared memory (K-major).
//   The row max and sum reduce over the 4 lanes that share an accumulator
//   row; the scores are scaled by scale*log2(e) and exponentiated with
//   exp2, and the LSE is written back in natural log.
//   O += P V is a wgmma with P in registers (the accumulator fragment packs
//   pair for pair into the A fragment) and V as the transposed (MN-major)
//   B. P is split into a bf16 hi part and a bf16 lo part, two wgmmas, so
//   the product keeps about 16 bits of P: with P rounded once to bf16 the
//   error (2^-9 of each term) breaks the O bound 1e-4 + 1e-2|O| on rows
//   with few keys. The split costs half again the tensor work of one P V.
//   Whole tiles the causal or window mask empties are skipped through the
//   loop bounds, for each warpgroup's own rows; the mask is applied element
//   by element only on tiles that cross a mask edge or the end of the keys.
//   The query tile runs fastest through the block index, counting down: the
//   blocks in flight share a few heads' K/V in L2, and each head's longest
//   causal tiles start first.
//   head_dim: 64-column chunks (128 bytes, the 128B swizzle's row), padded
//   with TMA's zero fill past hd: hd <= 64 takes one chunk, up to 128 two,
//   up to 256 four. S runs hd rounded up to 16 (instances for 32, 64, 96,
//   128, 192 and 256); P V runs the padded width (hd 96 does 128 columns
//   of P V, a third more than it needs).
//   head_dim 129-256: O of 64 rows at 256 columns would take 128
//   accumulator registers a thread beside S and the P fragments, past the
//   255 a thread may have. So the output's head_dim is cut into two passes
//   of 128 columns (HDO), one block each (blockIdx.y): each keeps the hd-128
//   register budget (o[64]) and computes S over the full head again, about
//   1.5x the tensor work of one pass. A block holds Q and the K ring at the
//   full head and the V ring at its pass's 128 columns, 165 KB, so one
//   block fits an SM. Chunks wholly past hd (hd <= 192 at the 256 width)
//   are not loaded or stored; they feed only output columns past hd. Every wgmma loop is unrolled at compile time and the
//   softcap and mask branches are taken once a tile: a branch between two
//   wgmmas makes ptxas serialise them.
//   O is written through shared memory (Q's buffer, in the swizzled
//   layout) by a TMA store, which drops rows past sq and columns past hd.

#include "hopper.cuh"

#include <math.h>

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int WGS = 2;          // warpgroups per block, 64 rows each
constexpr int ROWS = 64 * WGS;  // (query, GQA head) rows per block
constexpr int BK = 64;        // keys per kv tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 128 * WGS;
constexpr float NEG_INF = -0.7f * 3.402823466e38f;  // as the reference
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Params {
  CUtensorMap tq, tk, tv, to;
  float* lse;
  int b, sq, sk, nkv, hd, m, bq, n_qt;
  int causal, window, q_offset;
  float softcap, scale;
};

template <int HDP, int HDO>
constexpr size_t smem_bytes() {
  return 1024 + sizeof(bf16) * 64 * ((HDP / 64) * (ROWS + STAGES * BK)
                                     + (HDO / 64) * STAGES * BK)
         + 8 * (1 + STAGES);
}

// The tile's scores in log2 units, masked with NEG_INF where EDGE: one
// variant per (softcap, edge) pair, chosen once a tile, so the loop over
// the thread's 32 scores has no branch.
template <bool CAP, bool EDGE>
__device__ __forceinline__ void log2_scores(float (&s)[BK / 2], const Params& p,
                                            int k0, int lane, const int (&qpos)[2]) {
  const float scale2 = p.scale * LOG2E, inv_cap = CAP ? 1.f / p.softcap : 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    float x = CAP ? p.softcap * tanhf(s[i] * p.scale * inv_cap) * LOG2E : s[i] * scale2;
    if (EDGE) {
      const int h = (i >> 1) & 1;
      const int kpos = k0 + 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
      const bool keep = (kpos < p.sk) & (!p.causal | (qpos[h] >= kpos))
                        & (!p.window | (qpos[h] - kpos < p.window));
      x = keep ? x : NEG_INF;
    }
    s[i] = x;
  }
}

// One K/V tile into a ring stage: the K chunks S reads and the V chunks of
// this pass, `bytes` announced on the stage's barrier (thread 0 only).
__device__ __forceinline__ void load_kv(bf16* dk, bf16* dv, const Params& p,
                                        uint64_t* bar, uint32_t bytes, int nk,
                                        int c0, int nv, int g, int k0, int bb) {
  mbar_expect_tx(bar, bytes);
  for (int c = 0; c < nk; ++c)
    tma_load(dk + c * BK * 64, &p.tk, bar, 64 * c, g, k0, bb);
  for (int c = 0; c < nv; ++c)
    tma_load(dv + c * BK * 64, &p.tv, bar, 64 * (c0 + c), g, k0, bb);
}

// HDP: head_dim padded to 64-column chunks; KS: k16 steps of S = Q K^T,
// head_dim rounded up to 16 (the columns past hd are TMA's zeros); HDO:
// the output columns of one pass (blockIdx.y picks the pass).
template <int HDP, int KS, int HDO>
__global__ void __launch_bounds__(THREADS, HDP > 128 ? 1 : 2)
flash_fwd_sm90_kernel(const __grid_constant__ Params p) {
  constexpr int NC = HDP / 64;          // 64-column chunks of head_dim
  constexpr int NCO = HDO / 64;         // chunks of V and O of one pass
  constexpr uint32_t KV_CHUNK = BK * 128;
  extern __shared__ char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(align1024(smem_raw));  // NC x ROWS x 64
  bf16* sK = sQ + NC * ROWS * 64;       // STAGES x NC x BK x 64
  bf16* sV = sK + STAGES * NC * BK * 64;  // STAGES x NCO x BK x 64
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(sV + STAGES * NCO * BK * 64);
  uint64_t* bar_kv = bar_q + 1;
  // This pass's first V/O chunk; the chunks TMA loads: those that start
  // before hd (the K/Q ones S reads, the V/O ones of the pass).
  // One pass (HDO == HDP, hd <= 128) loads every chunk, known at compile
  // time; past 128 the pass (blockIdx.y) and hd decide.
  constexpr bool SPLIT = HDO < HDP;
  const int c0 = SPLIT ? blockIdx.y * NCO : 0;
  const int nc_live = SPLIT ? min(NC, (p.hd + 63) / 64) : NC;
  const int nco_live = SPLIT ? min(NCO, max(0, nc_live - c0)) : NCO;
  const uint32_t kv_bytes = (nc_live + nco_live) * KV_CHUNK;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  // The query tile runs fastest through the block index, so the blocks in
  // flight share a few heads' K/V in L2; it counts down, so the longest
  // causal tiles of each head start first.
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
    mbar_expect_tx(bar_q, nc_live * 128 * m * p.bq);
    for (int c = 0; c < nc_live; ++c)
      tma_load(sQ + c * ROWS * 64, &p.tq, bar_q, 64 * c, g * m, q0, bb);
    for (int t = 0; t < STAGES && t < n_tiles; ++t)
      load_kv(sK + t * NC * BK * 64, sV + t * NCO * BK * 64, p, &bar_kv[t],
              kv_bytes, nc_live, c0, nco_live, g, kv_begin + t * BK, bb);
  }

  // This thread's two accumulator rows: r0 and r0 + 8. Warpgroup wg owns
  // rows 64 wg to 64 wg + 63 and skips the tiles its own rows do not see.
  const int r0 = 64 * wg + 16 * warp + (lane >> 2);
  const int wg_end = min(nrows, 64 * (wg + 1));
  const int wg_first_q = q0 + 64 * wg / m, wg_last_q = q0 + (wg_end - 1) / m;
  int wg_tiles = 0;
  if (wg_end > 64 * wg) {
    const int e = p.causal ? min(p.sk, wg_last_q + 1 + p.q_offset) : p.sk;
    wg_tiles = e > kv_begin ? (e - kv_begin + BK - 1) / BK : 0;
  }
  int qpos[2];
  float m_i[2], l_i[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qpos[h] = q0 + (r0 + 8 * h) / m + p.q_offset;
    m_i[h] = NEG_INF;
    l_i[h] = 0.f;
  }
  float o[HDO / 2];
#pragma unroll
  for (int i = 0; i < HDO / 2; ++i) o[i] = 0.f;

  const int min_qpos = wg_first_q + p.q_offset;
  const int max_qpos = wg_last_q + p.q_offset;
  const bf16* sQw = sQ + 64 * 64 * wg;
  mbar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int st = t % STAGES;
    const int k0 = kv_begin + t * BK;
    const bf16* tK = sK + st * NC * BK * 64;
    const bf16* tV = sV + st * NCO * BK * 64;
    if (t < wg_tiles) {  // the tiles this warpgroup's rows see
      mbar_wait(&bar_kv[st], (t / STAGES) & 1);

      // S = Q K^T
      float s[BK / 2];
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        wgmma_ss_n64(s, desc_k(sQw + (kk / 4) * ROWS * 64, kk % 4),
                     desc_k(tK + (kk / 4) * BK * 64, kk % 4), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

      // online softmax in log2 units
      const bool edge = k0 + BK > p.sk || (p.causal && k0 + BK - 1 > min_qpos)
                        || (p.window && k0 <= max_qpos - p.window);
      if (p.softcap != 0.f) {
        if (edge) log2_scores<true, true>(s, p, k0, lane, qpos);
        else log2_scores<true, false>(s, p, k0, lane, qpos);
      } else {
        if (edge) log2_scores<false, true>(s, p, k0, lane, qpos);
        else log2_scores<false, false>(s, p, k0, lane, qpos);
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m_i[h], mx[h]);
        alpha[h] = exp2_approx(m_i[h] - m_new);
        m_i[h] = m_new;
        l_i[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int h = (i >> 1) & 1;
        s[i] = exp2_approx(s[i] - m_i[h]);
        l_i[h] += s[i];  // this lane's part of the row sum; lanes reduce at the end
      }
#pragma unroll
      for (int i = 0; i < HDO / 2; ++i) o[i] *= alpha[(i >> 1) & 1];

      // O += P V, P as bf16 hi + lo
      uint32_t ph[BK / 16][4], pl[BK / 16][4];
      acc_to_a_split<BK>(s, ph, pl);
      fence_regs(ph);
      fence_regs(pl);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t dv = desc_mn(tV, kk, KV_CHUNK);
        if constexpr (HDO == 128) {
          wgmma_rs_n128_tb(o, ph[kk], dv, 1);
          wgmma_rs_n128_tb(o, pl[kk], dv, 1);
        } else {
          wgmma_rs_n64_tb(o, ph[kk], dv, 1);
          wgmma_rs_n64_tb(o, pl[kk], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
    }

    __syncthreads();  // both warpgroups are done with this stage: refill it
    if (tid == 0 && t + STAGES < n_tiles)
      load_kv(sK + st * NC * BK * 64, sV + st * NCO * BK * 64, p, &bar_kv[st],
              kv_bytes, nc_live, c0, nco_live, g, k0 + STAGES * BK, bb);
  }

  // O / max(l, 1e-30) as bf16 into Q's buffer (swizzled), then one TMA store
  // per chunk; the LSE from the lanes that hold column 0 of each row.
  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], 1);
    l_i[h] += __shfl_xor_sync(0xffffffffu, l_i[h], 2);
    const float denom = fmaxf(l_i[h], 1e-30f);
    inv[h] = 1.f / denom;
    const int r = r0 + 8 * h;
    if ((lane & 3) == 0 && r < nrows && blockIdx.y == 0) {
      const int qi = q0 + r / m, mi = r % m;
      p.lse[((static_cast<long long>(bb) * p.sq + qi) * p.nkv + g) * m + mi] =
          m_i[h] * LN2 + logf(denom);
    }
  }
  char* out = reinterpret_cast<char*>(sQ);
#pragma unroll
  for (int i = 0; i < HDO / 2; i += 2) {
    const int h = (i >> 1) & 1;
    const int col = 8 * (i >> 2) + 2 * (lane & 3);
    *reinterpret_cast<uint32_t*>(out + swz(ROWS, r0 + 8 * h, col)) =
        pack_bf16(o[i] * inv[h], o[i + 1] * inv[h]);
  }
  fence_proxy_async();
  __syncthreads();
  if (tid == 0) {
    for (int c = 0; c < nco_live; ++c)
      tma_store(&p.to, sQ + c * ROWS * 64, 64 * (c0 + c), g * m, q0, bb);
    tma_store_wait();
  }
}

template <int HDP, int KS, int HDO>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = smem_bytes<HDP, HDO>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_sm90_kernel<HDP, KS, HDO>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>(p.n_qt) * p.nkv * p.b, HDP / HDO);
  flash_fwd_sm90_kernel<HDP, KS, HDO><<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16 only. Returns a cudaError_t; 0 means launched.
extern "C" int flash_attention_fwd_sm90(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int b, int sq, int sk, int nq, int nkv, int hd,
    long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh,
    long long vsb, long long vss, long long vsh,
    int causal, int window, int q_offset, float softcap, float scale,
    void* stream) {
  if (hd < 8 || hd > 256 || hd % 8 || nkv < 1 || nq % nkv || nq / nkv > ROWS ||
      b < 1 || sq < 1 || sk < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.lse = lse;
  p.b = b; p.sq = sq; p.sk = sk; p.nkv = nkv; p.hd = hd;
  p.m = nq / nkv;
  p.bq = ROWS / p.m;
  p.n_qt = (sq + p.bq - 1) / p.bq;
  p.causal = causal; p.window = window; p.q_offset = q_offset;
  p.softcap = softcap; p.scale = scale;
  cudaError_t err;
  if ((err = make_map(&p.tq, q, b, sq, nq, hd, qsb, qss, qsh, p.m, p.bq)) ||
      (err = make_map(&p.tk, k, b, sk, nkv, hd, ksb, kss, ksh, 1, BK)) ||
      (err = make_map(&p.tv, v, b, sk, nkv, hd, vsb, vss, vsh, 1, BK)) ||
      (err = make_map(&p.to, o, b, sq, nq, hd, static_cast<long long>(sq) * nq * hd,
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

// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/contrib/multihead_attn/flash.py
// `_fwd_kernel` (reached through `_flash_fwd`): blockwise online-softmax
// attention over q (BH, Sq, D) pre-scaled, k/v (BH, Sk, D), with an additive
// fp32 bias (1|B, 1|Sq, Sk) indexed by bh / heads, causal masking (col <= row,
// masked scores = -1e30), dropout on the probabilities after the denominator
// is accumulated (the squirrel3 hash of flash.py `_dropout_keep` over global
// (bh, row, col) and seed), dead rows (max <= -5e29) written as 0 with
// lse = +1e30.  Emits out (BH, Sq, D) in q's dtype, lse (BH, Sq) fp32, and
// the backward's residual stats (BH, Sq, 2) fp32: the row max m and log l
// kept apart (lse = m + log l cannot carry log l where m is a large finite
// mask such as -1e9, whose fp32 step is 64); a dead row gives (+1e30, 0).
// Both row outputs are written, though lse is m + log l: lse is the public
// output (serving reads it), and deriving it from the stats would add one
// elementwise launch a call to a path that the host's launch rate bounds,
// for 4 bytes a row saved here.
//
// What bounds it: operations.  Attention does 4 BH Sq Sk D flops on ~4 BH S D
// elements: at the long-sequence shape (BH 64, S 4096, D 64, bf16) that is
// 275 GFLOP (0.28 ms at 989 TFLOP/s) against 134 MB (0.04 ms); at the
// training shape (BH 128, S 512) 8.6 GFLOP (8.7 us) against 34 MB (10 us),
// the two about even.  Only Hopper's warpgroup products (wgmma) reach that
// rate, and only when the tiles arrive while the tensor cores work on the
// last ones, so the fp16 and bf16 kernel (one template over the element
// type E) is built as Hopper wants it (`sm90_attn.cuh`):
//   * a producer warpgroup gives its registers to the consumers
//     (setmaxnreg), and its first warp keeps TMA loads of 128-key k and v
//     tiles in flight through a 2-stage ring of shared-memory stages
//     guarded by mbarriers (full: the bytes arrived; empty: every consumer
//     warp is done); it loads q once, and stages the tile's key bias
//     beside it;
//   * one or two consumer warpgroups of 64 query rows each: S = q k^T runs
//     on wgmma with q and k read from swizzled shared memory; the online
//     softmax runs on the accumulators in exp2 with log2(e) folded in; P is
//     rounded to E in registers and is the register A operand of O += P
//     v, where v is B as it lies, (keys, D), read MN-major; O stays in
//     registers until the epilogue;
//   * masks only where they bite: the per-key bias (a (1|B, 1, Sk) bias,
//     with -1e30 past Sk folded in, since a zero-filled key would score 0)
//     is read once per tile from the stage; a (B, Sq, Sk) bias is read per
//     element; the causal compare runs only on tiles that cross the
//     warpgroup's diagonal, and tiles wholly above it are not loaded;
//   * the grid: 128-row query tiles (two warpgroups) where they still fill
//     the 132 SMs, else 64 (serving's BH 16 x 512 causal gives 128 CTAs of
//     64 rows, not 64 of 128); causal grids take the longest rows first.
// fp32 at D <= 128 (`flash_fwd_tf32_kernel<D, W>`, the fp32 flagship's,
// the MoE step's and the elastic step's forward): the same TPU kernel, on
// the tensor cores in 3xTF32 (`sm90_tf32.cuh`), which keeps fp32's
// accuracy (one TF32 product would not: ~1e-3 of the output's peak).
//   * Bound: operations.  3 TF32 products a pair at 495 TFLOP/s: at BH 128
//     x 512^2 x 64, 3 x 8.59 GFLOP is 0.052 ms (0.128 ms of scalar fp32
//     FMA at 67 TFLOP/s) against 34 MB of fp32 in and out (0.010 ms).
//   * What held the scalar kernel (below, which fp32 ran until then) back:
//     one FMA per shared-memory load, q k^T summed lane by lane over D for
//     one key a lane; P v read P back through 32 shuffles a tile; k and v
//     reloaded from device memory for every 16-row q tile, with nothing
//     overlapping the loads.
//   * Design: W warps of 16 query rows (W = 16, 256 rows, where those fill
//     the card at D <= 64; else 8 where 128 rows do; else 4), q loaded
//     once; 64-key k / v tiles (and their key bias) through two
//     shared-memory stages filled by cp.async while the warps work on the
//     other, so each tile is read from device memory once per 64-256 rows
//     and the loads overlap the products.  S = q k^T and O += P v run on
//     mma.sync m16n8k8 TF32, each operand pair as three products (`mma3`).
//     Up to D = 64 the CTA splits each k / v stage into its TF32 halves
//     once (`split_tile`), so its W warps read the halves instead of each
//     splitting every fragment (at BH 128 x 512^2 x 64: 0.168 ms, against
//     0.211 splitting as read and 0.202 with 8 warps at most, `chip_smoke.py
//     --variants fp32`); q is split as read, P as
//     it leaves the accumulators, whose layout is the next product's A in
//     the permuted k order; rows are padded by 4 floats, so every fragment
//     read is conflict-free.  Masks, the online softmax in exp2, dropout
//     and the dead rows follow the 16-bit kernel; a causal tile wholly
//     above a warp's rows is skipped by that warp.
// Every dtype at D = 256 (whose k / v stages the 128-key ring cannot
// hold): one CTA of 4 warps per (bh, 16-row q tile), scalar FMA on fp32
// copies in shared memory, one lane per key of a 32-key tile; rows'
// running max/sum live in registers, the output accumulator in registers
// (D/32 per lane); P rounds to E before P v, as the plain version's
// `p.to(v.dtype)`.
// D > 256 (padded to a multiple of 128): the scalar kernel split over
// columns, one CTA per (bh, 16-row q tile, 128-column output chunk), q k^T
// summed over all of D in 128-wide pieces through shared memory
// (`flash_fwd_chunk_kernel`).  Right, not fast.
// Ragged Sq / Sk edges need no padding copies: the TMA maps are 3-D over
// (D, S, BH), so rows past S arrive as zeros and never from the next head.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "dropout.cuh"
#include "sm90_attn.cuh"
#include "sm90_tf32.cuh"

namespace {

using sm90::kNegInf;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeF16 = 2;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  float* lse;
  float* stats;            // (bh, sq, 2): m, log l
  int bh_count, sq, sk, heads;
  int bias_b, bias_q;      // bias shape (bias_b, bias_q, sk), bias_b in {1, B}
  int causal;
  uint32_t drop_threshold; // 0 = no dropout
  float keep_div;          // 1 - rate: kept probabilities are divided by it
  uint32_t seed;
};

// Score after bias, causal mask and ragged-edge mask (the TPU path pads Sk
// with a -1e30 bias; this is the same value without the copy).
__device__ __forceinline__ float masked_score(const Params& p, float s, int bh,
                                              int row, int col) {
  if (col >= p.sk || row >= p.sq) return kNegInf;  // rows >= sq are never stored
  if (p.bias != nullptr) {
    const int bb = p.bias_b == 1 ? 0 : bh / p.heads;
    const int br = p.bias_q == 1 ? 0 : row;
    s += p.bias[((size_t)bb * p.bias_q + br) * p.sk + col];
  }
  if (p.causal && col > row) s = kNegInf;
  return s;
}

// A row's lse and its (m, log l); sl is l, 1 where l is 0.
__device__ __forceinline__ void write_stats(const Params& p, int bh, int row,
                                            bool dead, float m, float sl) {
  const size_t r = (size_t)bh * p.sq + row;
  const float log_l = logf(sl);
  p.lse[r] = dead ? -kNegInf : m + log_l;
  reinterpret_cast<float2*>(p.stats)[r] =
      dead ? make_float2(-kNegInf, 0.f) : make_float2(m, log_l);
}

// ---------------------------------------------------------------------------
// fp16 / bf16: TMA + mbarrier ring + wgmma kernel, over the element type E
// ---------------------------------------------------------------------------

// C consumer warpgroups of 64 query rows each, then one producer
// warpgroup whose first warp starts the loads: q once, 2 stages of 128-key
// k/v tiles with their key bias.
template <int D, int C>
using FwdCfg = sm90::RingCfg<D, C, 2, 64 * C, 1, 128, 1>;

template <typename E, int D, int C>
__global__ void __launch_bounds__(FwdCfg<D, C>::kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                      const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, Params p) {
  using Cfg = FwdCfg<D, C>;
  using T = sm90::Tile<D>;
  using sm90::kLog2e;
  constexpr int kBq = Cfg::kResRows, kBk = Cfg::kStageRows;
  extern __shared__ unsigned char smem_raw[];
  const sm90::Ring<Cfg> ring(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_qt = (p.sq + kBq - 1) / kBq;
  const sm90::GridPos pos = sm90::grid_pos(n_qt);
  const int bh = pos.bh;
  // causal: the longest rows first, so the grid's tail is short tiles
  const int q0 = (p.causal ? n_qt - 1 - pos.tile : pos.tile) * kBq;
  int n_kt = (p.sk + kBk - 1) / kBk;
  if (p.causal) n_kt = min(n_kt, (q0 + kBq - 1) / kBk + 1);
  const float* bias_rows = p.bias + (size_t)(p.bias_b == 1 ? 0 : bh / p.heads) * p.bias_q * p.sk;
  const bool full_bias = p.bias_q != 1;

  ring.init();
  if (warp >= 4 * C) {
    // ---- producer: q once, then k/v tiles and their key bias
    sm90::producer_release_registers();
    if (warp == 4 * C) {
      const CUtensorMap* qmaps[1] = {&qmap};
      ring.produce(qmaps, q0, &kmap, &vmap, bh, 0, n_kt, lane,
                   sm90::KeyBias{full_bias ? nullptr : bias_rows, p.sk});
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64 wg .. + 63
  sm90::consumer_claim_registers<C>();
  const int wg = warp >> 2;
  const int t = lane & 3;   // thread in its accumulator row group
  const int wg_row0 = q0 + wg * 64;
  const int row_a = wg_row0 + (warp & 3) * 16 + (lane >> 2);  // this thread's two rows
  const int row_b = row_a + 8;
  const uint32_t q_addr = ring.res_addr(0);

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  ring.wait_res();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBk;
    ring.wait_full(kt);

    // S = q k^T: 64 rows x kBk keys, reducing over D
    float s[kBk / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      sm90::Wgmma<kBk, E>::ss(s, T::kmajor(q_addr, kBq, wg * 64, kk),
                              T::kmajor(ring.stage_addr(kt, 0), kBk, 0, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::mask_scores<kBk>(s, ring.vecs(kt), full_bias ? bias_rows : nullptr,
                           p.causal && k0 + kBk - 1 > wg_row0, row_a, k0, t,
                           p.sq, p.sk);

    // online softmax in exp2
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[4 * j], s[4 * j + 1]));
      mx_b = fmaxf(mx_b, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float sc_a = exp2f((m_a - mn_a) * kLog2e), sc_b = exp2f((m_b - mn_b) * kLog2e);
    float sum_a = 0.f, sum_b = 0.f;
    // exp2((s - max) log2(e)): the difference first, exact for scores near
    // the max, so the max's P is 1 even where the scores carry a large
    // finite mask (-1e9, whose fp32 step is 64); s log2(e) - max log2(e)
    // would round both products and could give P = 2^64, past fp16
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
      s[4 * j + 0] = exp2f((s[4 * j + 0] - mn_a) * kLog2e);
      s[4 * j + 1] = exp2f((s[4 * j + 1] - mn_a) * kLog2e);
      s[4 * j + 2] = exp2f((s[4 * j + 2] - mn_b) * kLog2e);
      s[4 * j + 3] = exp2f((s[4 * j + 3] - mn_b) * kLog2e);
      sum_a += s[4 * j] + s[4 * j + 1];
      sum_b += s[4 * j + 2] + s[4 * j + 3];
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
      sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
    }
    l_a = l_a * sc_a + sum_a;
    l_b = l_b * sc_b + sum_b;
    m_a = mn_a;
    m_b = mn_b;

    if (p.drop_threshold != 0u) {  // after the denominator, as on the TPU
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t row = e < 2 ? row_a : row_b;
          const uint32_t col = (uint32_t)(k0 + j * 8 + 2 * t + (e & 1));
          s[4 * j + e] = dropout_keep(p.seed, bh, row, col, p.drop_threshold)
                             ? s[4 * j + e] / p.keep_div : 0.f;
        }
      }
    }

#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[4 * n + 0] *= sc_a;
      o[4 * n + 1] *= sc_a;
      o[4 * n + 2] *= sc_b;
      o[4 * n + 3] *= sc_b;
    }

    // O += P v: P leaves the accumulators as A fragments rounded to E; v is
    // B as it lies, (keys, D), read MN-major
    uint32_t pa[kBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = sm90::pack<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      sm90::Wgmma<D, E>::rs(o, pa[kk], T::mnmajor(ring.stage_addr(kt, 1), kBk, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(o);
    ring.release(kt, lane);
  }

  // epilogue: normalise, dead rows -> 0 and lse = +1e30
  E* out = static_cast<E*>(p.out);
  const size_t qbase = (size_t)bh * p.sq * D;
  const bool dead_a = m_a <= kNegInf / 2, dead_b = m_b <= kNegInf / 2;
  const float sl_a = l_a == 0.f ? 1.f : l_a, sl_b = l_b == 0.f ? 1.f : l_b;
  const float r_a = 1.f / sl_a, r_b = 1.f / sl_b;
  if (row_a < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = dead_a ? 0.f : o[4 * n] * r_a;
      const float x1 = dead_a ? 0.f : o[4 * n + 1] * r_a;
      *reinterpret_cast<uint32_t*>(out + qbase + (size_t)row_a * D + n * 8 + 2 * t) = sm90::pack<E>(x0, x1);
    }
    if (t == 0) write_stats(p, bh, row_a, dead_a, m_a, sl_a);
  }
  if (row_b < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = dead_b ? 0.f : o[4 * n + 2] * r_b;
      const float x1 = dead_b ? 0.f : o[4 * n + 3] * r_b;
      *reinterpret_cast<uint32_t*>(out + qbase + (size_t)row_b * D + n * 8 + 2 * t) = sm90::pack<E>(x0, x1);
    }
    if (t == 0) write_stats(p, bh, row_b, dead_b, m_b, sl_b);
  }
}

// ---------------------------------------------------------------------------
// fp32, D <= 128: 3xTF32 on the tensor cores (`sm90_tf32.cuh`)
// ---------------------------------------------------------------------------

// W warps of 16 query rows each; 64-key k / v stages, two of them, filled
// by cp.async while the warps work on the other; q once, raw, in its own
// tile; each stage also holds its keys' bias (a (1|B, 1, Sk) bias).
constexpr int kTf32Bk = 64;

// kPre: each k / v stage split into TF32 halves once, by the CTA (hi in
// place, lo in planes of their own), rather than by every warp as it reads
// (up to D = 64; at 128 the planes would pass shared memory)
constexpr bool kTf32FwdPreSplit = true;

template <int D, int W>
struct Tf32FwdCfg {
  static constexpr int kRows = 16 * W;
  static constexpr int kThreads = 32 * W;
  static constexpr bool kPre = kTf32FwdPreSplit && D <= 64;
  static constexpr int kS = D + tf32::kPad;        // a row's floats
  static constexpr int kQFloats = kRows * kS;
  static constexpr int kKvFloats = kTf32Bk * kS;
  static constexpr int kStageFloats = 2 * kKvFloats + kTf32Bk;  // k, v, bias
  static constexpr int kSmem =
      (kQFloats + 2 * kStageFloats + (kPre ? 2 * kKvFloats : 0)) * 4;
};

template <int D, int W>
__global__ void __launch_bounds__(Tf32FwdCfg<D, W>::kThreads)
flash_fwd_tf32_kernel(Params p) {
  using Cfg = Tf32FwdCfg<D, W>;
  using sm90::kLog2e;
  constexpr int kRows = Cfg::kRows, kBk = kTf32Bk, kS = Cfg::kS;
  constexpr bool kPre = Cfg::kPre;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* stages = qs + Cfg::kQFloats;
  float* kvlo = stages + 2 * Cfg::kStageFloats;  // k's lo plane, then v's

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n_qt = (p.sq + kRows - 1) / kRows;
  const sm90::GridPos pos = sm90::grid_pos(n_qt);
  const int bh = pos.bh;
  // causal: the longest rows first, so the grid's tail is short tiles
  const int q0 = (p.causal ? n_qt - 1 - pos.tile : pos.tile) * kRows;
  int n_kt = (p.sk + kBk - 1) / kBk;
  if (p.causal) n_kt = min(n_kt, (q0 + kRows - 1) / kBk + 1);
  const float* bias_rows = p.bias == nullptr ? nullptr
      : p.bias + (size_t)(p.bias_b == 1 ? 0 : bh / p.heads) * p.bias_q * p.sk;
  const float* key_bias = p.bias_q == 1 ? bias_rows : nullptr;
  const float* full_bias = p.bias_q != 1 ? bias_rows : nullptr;
  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;

  auto load_stage = [&](int kt) {
    float* st = stages + (kt & 1) * Cfg::kStageFloats;
    const int k0 = kt * kBk;
    tf32::load_rows<D, Cfg::kThreads>(st, k + kbase, k0, kBk, p.sk);
    tf32::load_rows<D, Cfg::kThreads>(st + Cfg::kKvFloats, v + kbase, k0, kBk, p.sk);
    if (key_bias != nullptr)
      for (int i = tid; i < kBk; i += Cfg::kThreads)
        tf32::cp_async4(st + 2 * Cfg::kKvFloats + i, key_bias + min(k0 + i, p.sk - 1),
                        k0 + i < p.sk);
  };
  tf32::load_rows<D, Cfg::kThreads>(qs, q + qbase, q0, kRows, p.sq);
  load_stage(0);
  tf32::cp_async_commit();

  const int wr0 = q0 + warp * 16;  // the warp's first row
  const int row_a = wr0 + g, row_b = row_a + 8;  // this thread's two rows
  const float* qw = qs + (warp * 16 + g) * kS + t;
  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    if (kt + 1 < n_kt) load_stage(kt + 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();
    const int k0 = kt * kBk;
    float* ks = stages + (kt & 1) * Cfg::kStageFloats;
    const float* vs = ks + Cfg::kKvFloats;
    const float* kb = vs + Cfg::kKvFloats;
    const int kv_lo = (int)(kvlo - ks);
    if constexpr (kPre) {
      tf32::split_tile<Cfg::kThreads>(ks, kvlo, 2 * Cfg::kKvFloats);
      __syncthreads();
    }
    // a causal tile wholly above the warp's rows adds exact zeros to rows
    // that saw key 0, and nothing that outlives a dead row: skipped
    if (!(p.causal && k0 > wr0 + 15)) {
      // S = q k^T: 16 rows x kBk keys, reducing over D
      float s[kBk / 8][4];
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        tf32::FragA a;
        a.set(0, qw[kk * 8]);
        a.set(1, qw[8 * kS + kk * 8]);
        a.set(2, qw[kk * 8 + 4]);
        a.set(3, qw[8 * kS + kk * 8 + 4]);
#pragma unroll
        for (int n = 0; n < kBk / 8; ++n) {
          const int ko = (n * 8 + g) * kS + kk * 8 + t;
          tf32::FragB b;
          b.fetch<kPre>(0, ks, ko, kv_lo);
          b.fetch<kPre>(1, ks, ko + 4, kv_lo);
          tf32::mma3(s[n], a, b);
        }
      }

      // bias, the causal mask and the ragged edges, as masked_score; inside
      // the keys and off the diagonal, a key bias alone (rows past Sq are
      // never stored)
      if (full_bias == nullptr && k0 + kBk <= p.sk && !(p.causal && k0 + kBk - 1 > wr0)) {
        if (key_bias != nullptr)
#pragma unroll
          for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] += kb[n * 8 + 2 * t + (e & 1)];
      } else {
#pragma unroll
        for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int c = n * 8 + 2 * t + (e & 1);
            const int col = k0 + c, row = e < 2 ? row_a : row_b;
            float x = s[n][e];
            if (col >= p.sk || row >= p.sq) {
              x = kNegInf;
            } else {
              if (key_bias != nullptr) x += kb[c];
              else if (full_bias != nullptr) x += full_bias[(size_t)row * p.sk + col];
              if (p.causal && col > row) x = kNegInf;
            }
            s[n][e] = x;
          }
      }

      // online softmax in exp2, the difference first (as the 16-bit kernel)
      float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float sc_a = exp2f((m_a - mn_a) * kLog2e), sc_b = exp2f((m_b - mn_b) * kLog2e);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < kBk / 8; ++n) {
        s[n][0] = exp2f((s[n][0] - mn_a) * kLog2e);
        s[n][1] = exp2f((s[n][1] - mn_a) * kLog2e);
        s[n][2] = exp2f((s[n][2] - mn_b) * kLog2e);
        s[n][3] = exp2f((s[n][3] - mn_b) * kLog2e);
        sum_a += s[n][0] + s[n][1];
        sum_b += s[n][2] + s[n][3];
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, off);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, off);
      }
      l_a = l_a * sc_a + sum_a;
      l_b = l_b * sc_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;

      if (p.drop_threshold != 0u) {  // after the denominator, as on the TPU
#pragma unroll
        for (int n = 0; n < kBk / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const uint32_t row = e < 2 ? row_a : row_b;
            const uint32_t col = (uint32_t)(k0 + n * 8 + 2 * t + (e & 1));
            s[n][e] = dropout_keep(p.seed, bh, row, col, p.drop_threshold)
                          ? s[n][e] / p.keep_div : 0.f;
          }
      }

#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= sc_a;
        o[n][1] *= sc_a;
        o[n][2] *= sc_b;
        o[n][3] *= sc_b;
      }

      // O += P v: P is A as the accumulators hold it (keys in the permuted
      // k order), v's rows 2 t and 2 t + 1 the matching B
#pragma unroll
      for (int kk = 0; kk < kBk / 8; ++kk) {
        tf32::FragA a;
        a.from_acc(s[kk]);
        const int vo = (kk * 8 + 2 * t) * kS + g;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          tf32::FragB b;
          b.fetch<kPre>(0, vs, vo + n * 8, kv_lo);
          b.fetch<kPre>(1, vs, vo + kS + n * 8, kv_lo);
          tf32::mma3(o[n], a, b);
        }
      }
    }
    __syncthreads();  // the stage is refilled next
  }

  // epilogue: normalise, dead rows -> 0 and lse = +1e30
  float* out = static_cast<float*>(p.out);
  const bool dead_a = m_a <= kNegInf / 2, dead_b = m_b <= kNegInf / 2;
  const float sl_a = l_a == 0.f ? 1.f : l_a, sl_b = l_b == 0.f ? 1.f : l_b;
  if (row_a < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + qbase + (size_t)row_a * D + n * 8 + 2 * t) =
          dead_a ? make_float2(0.f, 0.f) : make_float2(o[n][0] / sl_a, o[n][1] / sl_a);
    if (t == 0) write_stats(p, bh, row_a, dead_a, m_a, sl_a);
  }
  if (row_b < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(out + qbase + (size_t)row_b * D + n * 8 + 2 * t) =
          dead_b ? make_float2(0.f, 0.f) : make_float2(o[n][2] / sl_b, o[n][3] / sl_b);
    if (t == 0) write_stats(p, bh, row_b, dead_b, m_b, sl_b);
  }
}

// ---------------------------------------------------------------------------
// D = 256, every dtype: scalar-FMA kernel
// ---------------------------------------------------------------------------

constexpr int kSimtBq = 16;     // q rows per CTA (4 warps x 4 rows)
constexpr int kSimtBk = 32;     // keys per tile = one per lane
constexpr int kSimtThreads = 128;
constexpr int kSimtRowsPerWarp = kSimtBq / (kSimtThreads / 32);

template <int D>
constexpr int fwd_simt_smem_bytes() {
  return (kSimtBq * D + kSimtBk * (D + 1) + kSimtBk * D) * 4;
}

template <typename E, int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_simt_kernel(Params p) {
  constexpr int kPer = D / 32;  // output columns per lane
  extern __shared__ float sm[];
  float (*qs)[D] = reinterpret_cast<float (*)[D]>(sm);
  // +1: lane-per-key reads hit distinct banks
  float (*ks)[D + 1] = reinterpret_cast<float (*)[D + 1]>(sm + kSimtBq * D);
  float (*vs)[D] = reinterpret_cast<float (*)[D]>(sm + kSimtBq * D + kSimtBk * (D + 1));

  const E* q = static_cast<const E*>(p.q);
  const E* k = static_cast<const E*>(p.k);
  const E* v = static_cast<const E*>(p.v);
  E* out = static_cast<E*>(p.out);
  using sm90::to_f32;

  const sm90::GridPos pos = sm90::grid_pos((p.sq + kSimtBq - 1) / kSimtBq);
  const int bh = pos.bh;
  const int q0 = pos.tile * kSimtBq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;

  for (int i = tid; i < kSimtBq * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    qs[r][c] = q0 + r < p.sq ? to_f32(q[qbase + (size_t)(q0 + r) * D + c]) : 0.f;
  }

  float m[kSimtRowsPerWarp], l[kSimtRowsPerWarp], o[kSimtRowsPerWarp][kPer];
#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) o[rr][c] = 0.f;
  }

  int n_tiles = (p.sk + kSimtBk - 1) / kSimtBk;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kSimtBq - 1) / kSimtBk + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kSimtBk;
    __syncthreads();
    for (int i = tid; i < kSimtBk * D; i += kSimtThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.sk;
      ks[r][c] = in ? to_f32(k[kbase + (size_t)(k0 + r) * D + c]) : 0.f;
      vs[r][c] = in ? to_f32(v[kbase + (size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    const int col = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
      const int lr = warp * kSimtRowsPerWarp + rr;
      const int row = q0 + lr;
      float s = 0.f;
#pragma unroll
      for (int d = 0; d < D; ++d) s = fmaf(qs[lr][d], ks[lane][d], s);
      s = masked_score(p, s, bh, row, col);
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[rr], mx);
      const float sc = expf(m[rr] - mn);
      float pr = expf(s - mn);
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[rr] = l[rr] * sc + sum;
      m[rr] = mn;
      if (p.drop_threshold != 0u)
        pr = dropout_keep(p.seed, bh, row, col, p.drop_threshold) ? pr / p.keep_div : 0.f;
      pr = sm90::round_to<E>(pr);
#pragma unroll
      for (int c = 0; c < kPer; ++c) o[rr][c] *= sc;
#pragma unroll
      for (int j = 0; j < kSimtBk; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < kPer; ++c) o[rr][c] = fmaf(pj, vs[j][lane + 32 * c], o[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    const int row = q0 + warp * kSimtRowsPerWarp + rr;
    if (row >= p.sq) continue;
    const bool dead = m[rr] <= kNegInf / 2;
    const float sl = l[rr] == 0.f ? 1.f : l[rr];
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      out[qbase + (size_t)row * D + lane + 32 * c] =
          sm90::from_f32<E>(dead ? 0.f : o[rr][c] / sl);
    if (lane == 0) write_stats(p, bh, row, dead, m[rr], sl);
  }
}

// ---------------------------------------------------------------------------
// D > 256: the column-chunked scalar kernel, every dtype
// ---------------------------------------------------------------------------

// Output columns a CTA owns (flash.py `CHUNK_D`): the wrapper pads D to a
// multiple of it, and the grid gains a chunk axis (tile, chunk, bh).
constexpr int kChunk = 128;

constexpr int fwd_chunk_smem_bytes() {
  return (kSimtBq * kChunk + kSimtBk * (kChunk + 1) + kSimtBk * kChunk) * 4;
}

// The scalar kernel above with q k^T summed over all of D in kChunk-wide
// pieces staged through shared memory (q and k held whole would pass it:
// 164 KB at D = 512), then P v over the CTA's own chunk of v alone.  The
// chunk CTAs of one (bh, q tile) run the same sums in the same order, so
// they agree on m, l and P bit for bit; chunk 0 alone writes lse and the
// (m, log l) residual.  d is the padded head dim, a multiple of kChunk.
template <typename E>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_chunk_kernel(Params p, int d) {
  constexpr int kPer = kChunk / 32;  // output columns per lane
  extern __shared__ float sm[];
  float (*qs)[kChunk] = reinterpret_cast<float (*)[kChunk]>(sm);
  float (*ks)[kChunk + 1] = reinterpret_cast<float (*)[kChunk + 1]>(sm + kSimtBq * kChunk);
  float (*vs)[kChunk] =
      reinterpret_cast<float (*)[kChunk]>(sm + kSimtBq * kChunk + kSimtBk * (kChunk + 1));

  const E* q = static_cast<const E*>(p.q);
  const E* k = static_cast<const E*>(p.k);
  const E* v = static_cast<const E*>(p.v);
  E* out = static_cast<E*>(p.out);
  using sm90::to_f32;

  const int n_chunks = d / kChunk;
  const sm90::GridPos pos = sm90::grid_pos((p.sq + kSimtBq - 1) / kSimtBq * n_chunks);
  const int bh = pos.bh;
  const int cc = pos.tile % n_chunks * kChunk;  // the CTA's first column
  const int q0 = pos.tile / n_chunks * kSimtBq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t qbase = (size_t)bh * p.sq * d;
  const size_t kbase = (size_t)bh * p.sk * d;

  float m[kSimtRowsPerWarp], l[kSimtRowsPerWarp], o[kSimtRowsPerWarp][kPer];
#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    m[rr] = kNegInf;
    l[rr] = 0.f;
#pragma unroll
    for (int c = 0; c < kPer; ++c) o[rr][c] = 0.f;
  }

  int n_tiles = (p.sk + kSimtBk - 1) / kSimtBk;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kSimtBq - 1) / kSimtBk + 1);

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kSimtBk;
    float s[kSimtRowsPerWarp];
#pragma unroll
    for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) s[rr] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      __syncthreads();
      for (int i = tid; i < kSimtBq * kChunk; i += kSimtThreads) {
        const int r = i / kChunk, c = i % kChunk;
        qs[r][c] = q0 + r < p.sq ? to_f32(q[qbase + (size_t)(q0 + r) * d + c0 + c]) : 0.f;
      }
      for (int i = tid; i < kSimtBk * kChunk; i += kSimtThreads) {
        const int r = i / kChunk, c = i % kChunk;
        ks[r][c] = k0 + r < p.sk ? to_f32(k[kbase + (size_t)(k0 + r) * d + c0 + c]) : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
        const int lr = warp * kSimtRowsPerWarp + rr;
        float a = s[rr];
#pragma unroll 16
        for (int c = 0; c < kChunk; ++c) a = fmaf(qs[lr][c], ks[lane][c], a);
        s[rr] = a;
      }
    }
    __syncthreads();
    for (int i = tid; i < kSimtBk * kChunk; i += kSimtThreads) {
      const int r = i / kChunk, c = i % kChunk;
      vs[r][c] = k0 + r < p.sk ? to_f32(v[kbase + (size_t)(k0 + r) * d + cc + c]) : 0.f;
    }
    __syncthreads();

    const int col = k0 + lane;
#pragma unroll
    for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
      const int row = q0 + warp * kSimtRowsPerWarp + rr;
      const float sv = masked_score(p, s[rr], bh, row, col);
      float mx = sv;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[rr], mx);
      const float sc = expf(m[rr] - mn);
      float pr = expf(sv - mn);
      float sum = pr;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[rr] = l[rr] * sc + sum;
      m[rr] = mn;
      if (p.drop_threshold != 0u)
        pr = dropout_keep(p.seed, bh, row, col, p.drop_threshold) ? pr / p.keep_div : 0.f;
      pr = sm90::round_to<E>(pr);
#pragma unroll
      for (int c = 0; c < kPer; ++c) o[rr][c] *= sc;
#pragma unroll
      for (int j = 0; j < kSimtBk; ++j) {
        const float pj = __shfl_sync(0xffffffffu, pr, j);
#pragma unroll
        for (int c = 0; c < kPer; ++c) o[rr][c] = fmaf(pj, vs[j][lane + 32 * c], o[rr][c]);
      }
    }
  }

#pragma unroll
  for (int rr = 0; rr < kSimtRowsPerWarp; ++rr) {
    const int row = q0 + warp * kSimtRowsPerWarp + rr;
    if (row >= p.sq) continue;
    const bool dead = m[rr] <= kNegInf / 2;
    const float sl = l[rr] == 0.f ? 1.f : l[rr];
#pragma unroll
    for (int c = 0; c < kPer; ++c)
      out[qbase + (size_t)row * d + cc + lane + 32 * c] =
          sm90::from_f32<E>(dead ? 0.f : o[rr][c] / sl);
    if (cc == 0 && lane == 0) write_stats(p, bh, row, dead, m[rr], sl);
  }
}

template <typename E, int D, int C>
cudaError_t launch_sm90(const Params& p, cudaStream_t stream) {
  using Cfg = FwdCfg<D, C>;
  static bool smem_ready = false;
  cudaError_t err = sm90::allow_smem(flash_fwd_sm90_kernel<E, D, C>, Cfg::kSmem, smem_ready);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, km, vm;
  if ((err = sm90::encode_map<E, D>(&qm, p.q, p.sq, p.bh_count, Cfg::kResRows)) != cudaSuccess ||
      (err = sm90::encode_map<E, D>(&km, p.k, p.sk, p.bh_count, Cfg::kStageRows)) != cudaSuccess ||
      (err = sm90::encode_map<E, D>(&vm, p.v, p.sk, p.bh_count, Cfg::kStageRows)) != cudaSuccess)
    return err;
  dim3 grid;
  if ((err = sm90::flat_grid((p.sq + Cfg::kResRows - 1) / Cfg::kResRows, p.bh_count, &grid)) !=
      cudaSuccess)
    return err;
  flash_fwd_sm90_kernel<E, D, C><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(qm, km, vm, p);
  return cudaGetLastError();
}

// one or two consumer warpgroups (`sm90::consumer_groups`)
template <typename E, int D>
cudaError_t launch_wgmma(const Params& p, cudaStream_t stream) {
  return sm90::consumer_groups(p.sq, p.bh_count) == 2 ? launch_sm90<E, D, 2>(p, stream)
                                                      : launch_sm90<E, D, 1>(p, stream);
}

template <int D, int W>
cudaError_t launch_tf32_w(const Params& p, cudaStream_t stream) {
  using Cfg = Tf32FwdCfg<D, W>;
  static bool smem_ready = false;
  cudaError_t err = sm90::allow_smem(flash_fwd_tf32_kernel<D, W>, Cfg::kSmem, smem_ready);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if ((err = sm90::flat_grid((p.sq + Cfg::kRows - 1) / Cfg::kRows, p.bh_count, &grid)) !=
      cudaSuccess)
    return err;
  flash_fwd_tf32_kernel<D, W><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p);
  return cudaGetLastError();
}

// The largest CTA whose tiles still fill the card's 132 SMs: 256 rows (16
// warps, up to D = 64, where the split k / v stages and q fit beside each
// other), 128 (the 16-bit kernel's rule, `sm90::consumer_groups`), else 64
template <int D>
cudaError_t launch_tf32(const Params& p, cudaStream_t stream) {
  if constexpr (D <= 64)
    if ((p.sq + 255) / 256 * p.bh_count >= 132) return launch_tf32_w<D, 16>(p, stream);
  return sm90::consumer_groups(p.sq, p.bh_count) == 2 ? launch_tf32_w<D, 8>(p, stream)
                                                      : launch_tf32_w<D, 4>(p, stream);
}

template <typename E, int D>
cudaError_t launch_simt(const Params& p, cudaStream_t stream) {
  static bool smem_ready = false;
  constexpr int bytes = fwd_simt_smem_bytes<D>();
  cudaError_t err = sm90::allow_smem(flash_fwd_simt_kernel<E, D>, bytes, smem_ready);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if ((err = sm90::flat_grid((p.sq + kSimtBq - 1) / kSimtBq, p.bh_count, &grid)) != cudaSuccess)
    return err;
  flash_fwd_simt_kernel<E, D><<<grid, kSimtThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_chunk(const Params& p, int d, cudaStream_t stream) {
  static bool smem_ready = false;
  constexpr int bytes = fwd_chunk_smem_bytes();
  cudaError_t err = sm90::allow_smem(flash_fwd_chunk_kernel<E>, bytes, smem_ready);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if ((err = sm90::flat_grid((p.sq + kSimtBq - 1) / kSimtBq * (d / kChunk), p.bh_count, &grid)) !=
      cudaSuccess)
    return err;
  flash_fwd_chunk_kernel<E><<<grid, kSimtThreads, bytes, stream>>>(p, d);
  return cudaGetLastError();
}

// Up to D = 128: fp16 / bf16 on the wgmma ring, fp32 in 3xTF32; every
// dtype at D = 256 on the scalar-FMA kernel
template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if constexpr (D <= 128) {
    if (dtype == kDtypeBF16) return launch_wgmma<__nv_bfloat16, D>(p, stream);
    if (dtype == kDtypeF16) return launch_wgmma<__half, D>(p, stream);
    return launch_tf32<D>(p, stream);
  } else {
    if (dtype == kDtypeBF16) return launch_simt<__nv_bfloat16, D>(p, stream);
    if (dtype == kDtypeF16) return launch_simt<__half, D>(p, stream);
    return launch_simt<float, D>(p, stream);
  }
}

}  // namespace

// q (bh, sq, d), k/v (bh, sk, d), out (bh, sq, d): contiguous, 16-byte
// aligned, of `dtype`.  bias: fp32 (bias_b, bias_q, sk) or null.
// lse: fp32 (bh, sq); stats: fp32 (bh, sq, 2) = (row max, log l).
// d in {32, 64, 128, 256}, or a multiple of 128 past 256 (the chunked
// kernel).  drop_threshold = rate * 2^32 (0 = no dropout), keep_div =
// 1 - rate.  Returns cudaSuccess (0) or the launch error.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* bias, void* out, void* lse,
                              void* stats, int bh_count, int sq, int sk, int d, int heads,
                              int bias_b, int bias_q, int causal,
                              unsigned int drop_threshold, float keep_div,
                              int seed, int dtype, void* stream) {
  if (bh_count <= 0 || sq <= 0 || sk <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != kDtypeF32 && dtype != kDtypeBF16 && dtype != kDtypeF16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.lse = static_cast<float*>(lse);
  p.stats = static_cast<float*>(stats);
  p.bh_count = bh_count;
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.bias_b = bias_b;
  p.bias_q = bias_q;
  p.causal = causal;
  p.drop_threshold = drop_threshold;
  p.keep_div = keep_div;
  p.seed = (uint32_t)seed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch<32>(p, dtype, s);
    case 64: return (int)launch<64>(p, dtype, s);
    case 128: return (int)launch<128>(p, dtype, s);
    case 256: return (int)launch<256>(p, dtype, s);
    default: break;
  }
  if (d <= 256 || d % kChunk) return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16) return (int)launch_chunk<__nv_bfloat16>(p, d, s);
  if (dtype == kDtypeF16) return (int)launch_chunk<__half>(p, d, s);
  return (int)launch_chunk<float>(p, d, s);
}

// Flash-attention backward (recompute) for Hopper (sm_90a): the fused
// kernel and the two kernels of the split route.
//
// Fused: replaces the TPU kernel apex_tpu/contrib/multihead_attn/flash.py
// `_bwd_fused_kernel` (reached through `_flash_bwd_fused`): from q (BH, Sq,
// D) pre-scaled, k/v (BH, Sk, D), the fp32 bias (1|B, 1|Sq, Sk), the
// forward's stats (BH, Sq, 2) = (row max m, log l) and delta = rowsum(dO *
// O) (BH, Sq), one recompute of P per (q tile, k tile) feeds all three
// gradients:
//   P  = exp((q k^T + bias - m) - log l) (causal: col > row gives P = 0)
//   Pd = P * keep / (1 - rate)          (keep: the forward's dropout hash)
//   dV += Pd^T dO
//   dP = (dO v^T) * keep / (1 - rate)
//   dS = P * (dP - delta)
//   dK += dS^T q
//   dQ partial[bh, k tile] = dS k       (fp32, summed over k tiles outside)
// m and log l are kept apart because lse = m + log l cannot carry log l
// where m is a large finite mask (-1e9, whose fp32 step is 64): P rebuilt
// from it would be l times too large on a row whose every visible key
// carries such a mask.  Dead rows (m = +1e30) and masked scores give P = 0.  Ragged Sq / Sk are
// masked inside the kernel.  The dq partials are the TPU layout (BH, nk,
// Sq, D) with nk = ceil(Sk / 128) (kPartKeys, flash.py BWD_K_TILE): every
// (k tile, q tile) block is written exactly once (zeros for a
// causal-skipped one), so the sum is deterministic and there are no
// atomics.
//
// Split route, taken where the dq partials would pass the wrapper's byte
// cap (long sequences: BH 64 x 4096 x 4096 x 64 gives 2.1 GB of them):
//   * dk/dv: replaces `_bwd_dkv_kernel` (via `_flash_bwd_dkv`).  It is the
//     fused kernel with its dq work compiled out (template flag kEmitDq =
//     false): the same recompute, in the same order, and the same dropout
//     draw, so the two routes' dk and dv are the same bits.
//   * dq: replaces `_bwd_dq_kernel` (via `_flash_bwd_dq`), below.
//
// What bounds them: operations.  At the training shape (BH 128, S 512, D
// 64, bf16) the fused kernel's five matrix products are 21.5 GFLOP (~22 us
// of tensor-core time) against ~59 MB of inputs and outputs (~18 us);
// its dq partials, 128 x 4 x 512 x 64 x 4 B = 67 MB, are written here and
// read again by the sum.  At BH 64 x 4096 x 4096 x 64 bf16 dq is 6 BH Sq
// Sk D = 412 GFLOP (0.42 ms at 989 TFLOP/s) against ~170 MB of inputs and
// outputs (0.05 ms); dk/dv 8 BH Sq Sk D = 550 GFLOP (0.56 ms).
//
// Design of the fused and dk/dv kernels, fp16 and bf16
// (`flash_bwd_kv_sm90_kernel`, a template over the element type E, on
// `sm90_attn.cuh`'s key-major ring): a CTA owns 128 keys of one head
// (grid: key tiles x BH; key tile 0, which every causal query row sees,
// first).  A producer warpgroup hands its registers to the consumers, and
// its first warp loads k and v of the CTA's keys once by TMA, then keeps a
// 2-stage mbarrier ring of 64-row q and dO tiles in flight, each stage
// with its rows' m, log l and delta.  Two consumer warpgroups
// own 64 keys each (wgmma's M); per q tile each runs
//   * S^T = k q^T and dP^T = v dO^T on wgmma from swizzled shared memory
//     (k / v the K-major A, q / dO the K-major B): 64 keys x 64 rows;
//   * P^T = exp2((S^T + bias - m) log2e - log l log2e) in registers, the key bias
//     read once per CTA (a (1|B, 1, Sk) bias is per key, so per
//     accumulator row; -1e30 past Sk), a (B, Sq, Sk) bias per element, the
//     causal compare only on tiles that cross the warpgroup's diagonal (q
//     tiles wholly above the CTA's keys are not loaded), dropout from the
//     accumulator's (key, row) pairs; Pd^T and dS^T round to E in
//     registers (the TPU kernel's `astype`s) and are the register A of dV
//     += Pd^T dO and dK += dS^T q, with dO and q as MN-major B;
//   * fused only: both warpgroups write dS^T into one E shared tile (two,
//     alternating by q tile, so one named barrier a tile suffices), then
//     each computes half of the dq-partial block, dS k over the 128 keys,
//     with dS^T as an MN-major A and its half of k's columns as an MN-major
//     B (k lies in chunks of D / 2 columns for this), and writes it once.
//   dK and dV stay in registers until the epilogue.
// Design of the fused and dk/dv kernels, fp32 at D <= 128
// (`flash_bwd_kv_tf32_kernel<D, kEmitDq>`, the fp32 flagship's, the MoE
// step's and the elastic step's backward): the same TPU kernels, on the
// tensor cores in 3xTF32 (`sm90_tf32.cuh`), which keeps fp32's accuracy.
//   * Bound: operations.  The five products are 10 BH Sq Sk D flops, 3 TF32
//     products a pair at 495 TFLOP/s: at BH 128 x 512^2 x 64, 3 x 21.5
//     GFLOP is 0.130 ms (0.320 ms of scalar fp32 FMA at 67 TFLOP/s),
//     against ~118 MB of fp32 in and out (0.035 ms) and the 67 MB of dq
//     partials.
//   * What held the scalar kernel (below, which fp32 ran until then) back:
//     all five products were scalar FMAs over shared memory, one load a
//     FMA, and the q / dO tiles were loaded with nothing overlapping them.
//   * Design: a CTA of 8 warps owns 128 keys (the dq-partial tile), k and v
//     loaded once; q and dO tiles of 32 rows (64 at D = 32), with their
//     rows' m, log l and delta, stream through two shared-memory stages
//     filled by cp.async while the warps work on the other.  Warp w owns
//     keys 16 w .. + 15: S^T = k q^T and dP^T = v dO^T, then P^T, Pd^T and
//     dS^T in registers (the 16-bit kernel's masks, exp2 and dropout),
//     then dV += Pd^T dO and dK += dS^T q with Pd^T and dS^T as A straight
//     from the accumulators (`kPermutedK`); dK and dV stay in registers.
//     The fused kernel stages dS^T in shared memory for its transposed
//     use, and the 8 warps split the (rows x D) dq-partial block dS k over
//     the 128 keys between them, each writing its part once.  All on
//     mma.sync m16n8k8 TF32, three products a pair (`mma3`).  Up to D = 64
//     the CTA splits k and v once and each q / dO stage as it arrives into
//     their TF32 halves (`split_tile`), so the 8 warps read halves instead
//     of each splitting every fragment (0.572 against 0.679 ms at BH 128 x
//     512^2 x 64, `chip_smoke.py --variants fp32`); at D = 128 the halves would pass shared memory and the
//     warps split as they read.  Rows are padded by 4 floats, so every
//     fragment read is conflict-free.  No atomics, one order of sums: a
//     call repeats its bits, and the fused and dk/dv kernels give the same
//     dk and dv.
// Every dtype at D = 256 (whose k / v and q / dO tiles the ring cannot
// hold): one CTA of 512 threads per (bh, 128-key tile), in passes of 64
// keys, q tiles of 32 rows, scalar FMA on fp32 copies in shared memory, Pd
// and dS rounded to E before their products.
// D > 256 (padded to a multiple of 128), every dtype, all three kernels:
// the scalar kernels split over columns (`flash_bwd_chunk_kernel`,
// `flash_bwd_dq_chunk_kernel`), one CTA per (tile, 128-column chunk, bh),
// S and dP summed over all of D in 128-wide pieces.  Right, not fast.

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
// keys per CTA of the fused and dk/dv kernels, both dtypes: the dq-partial
// tile (flash.py BWD_K_TILE)
constexpr int kPartKeys = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const float2* stats;  // (bh, sq): (row max m, log l)
  const float* delta;   // (bh, sq)
  float* dq_part;      // (bh, nk, sq, d): fused kernel only
  void* dq;            // (bh, sq, d): dq kernel only
  void* dk;
  void* dv;
  int bh_count, sq, sk, heads, nk;
  int bias_b, bias_q;  // bias shape (bias_b, bias_q, sk), bias_b in {1, B}
  int causal;
  uint32_t drop_threshold;  // 0 = no dropout
  float keep_div;           // 1 - rate
  uint32_t seed;
};

// Recomputed probability of (row, col): 0 outside the ragged edges and
// above the causal diagonal (exp(-1e30 - lse) underflows to 0 on the TPU).
__device__ __forceinline__ float prob(const Params& p, float s, float m,
                                      float log_l, int bh, int row, int col) {
  if (row >= p.sq || col >= p.sk) return 0.f;
  if (p.causal && col > row) return 0.f;
  if (p.bias != nullptr) {
    const int bb = p.bias_b == 1 ? 0 : bh / p.heads;
    const int br = p.bias_q == 1 ? 0 : row;
    s += p.bias[((size_t)bb * p.bias_q + br) * p.sk + col];
  }
  return expf((s - m) - log_l);
}

// A row's (m, log l); a row past Sq reads as dead (P = 0).
__device__ __forceinline__ float2 row_stats(const Params& p, int bh, int row) {
  return row < p.sq ? p.stats[(size_t)bh * p.sq + row] : make_float2(-kNegInf, 0.f);
}

// Dropout factor of (row, col): keep / (1 - rate), or 1 without dropout.
__device__ __forceinline__ float keep_factor(const Params& p, int bh, int row,
                                             int col) {
  if (p.drop_threshold == 0u) return 1.f;
  return dropout_keep(p.seed, bh, row, col, p.drop_threshold)
             ? 1.f / p.keep_div : 0.f;
}

// ---------------------------------------------------------------------------
// fp16 / bf16: the key-major kernel (TMA ring + wgmma), over the element
// type E
// ---------------------------------------------------------------------------

// Two consumer warpgroups of 64 keys each, then one producer warpgroup
// whose first warp starts the loads: k and v of the CTA's 128 keys once, in
// chunks of D / 2 columns, then stages of a q and a dO tile with their
// rows' m, log l and delta.  The fused kernel's own bytes: two dS^T tiles.
template <int D, bool kEmitDq>
using KvCfg = sm90::RingCfg<D, 2, sm90::kKvStages, kPartKeys, 2,
                            sm90::kKvStageRows, 3, D / 2,
                            kEmitDq ? 2 * kPartKeys * sm90::kKvStageRows * 2 : 0>;

// kEmitDq: the fused kernel (dk, dv and the dq partials); without it, the
// split route's dk/dv kernel.
template <typename E, int D, bool kEmitDq>
__global__ void __launch_bounds__(KvCfg<D, kEmitDq>::kThreads, 1)
flash_bwd_kv_sm90_kernel(const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap,
                         const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap, Params p) {
  using Cfg = KvCfg<D, kEmitDq>;
  using Tk = sm90::Tile<D, Cfg::kResAw>;   // k and v
  using Tq = sm90::Tile<D>;                // q and dO
  using Ts = sm90::Tile<Cfg::kStageRows>;  // dS^T: keys x query rows
  using sm90::kLog2e;
  constexpr int kBq = Cfg::kStageRows, kBk = Cfg::kResRows;
  // dQ = dS k is split between the two warpgroups by columns (D / 2 each,
  // one chunk of k) at 64-row q tiles, by rows (64 each) at 128
  constexpr bool kSplitRows = kBq == 128;
  constexpr int kDqN = kSplitRows ? D : D / 2;
  constexpr int kDsBytes = kBk * kBq * 2;
  extern __shared__ unsigned char smem_raw[];
  const sm90::Ring<Cfg> ring(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const sm90::GridPos pos = sm90::grid_pos(p.nk);
  const int bh = pos.bh;
  const int kt = pos.tile;
  const int k0 = kt * kBk;
  const int n_qt = (p.sq + kBq - 1) / kBq;
  // causal: q tiles whose every row lies above the CTA's first key are
  // neither loaded nor computed
  const int qt0 = p.causal ? min(k0 / kBq, n_qt) : 0;
  const int n = n_qt - qt0;
  float* dqp = kEmitDq ? p.dq_part + ((size_t)bh * p.nk + kt) * p.sq * D
                       : nullptr;

  ring.init();
  if (warp >= 8) {
    // ---- producer: k and v once, then q / dO tiles with m, log l, delta
    sm90::producer_release_registers();
    if (warp == 8) {
      const CUtensorMap* kv[2] = {&kmap, &vmap};
      const size_t rows = (size_t)bh * p.sq;
      ring.produce(kv, k0, &qmap, &domap, bh, qt0, n, lane,
                   sm90::QueryStats{p.stats + rows, p.delta + rows, p.sq});
    }
    return;
  }

  // ---- consumers: warpgroup wg owns keys k0 + 64 wg .. + 63
  sm90::consumer_claim_registers<2>();
  const int wg = warp >> 2;
  const int t = lane & 3;   // thread in its accumulator row group
  const int key_l = wg * 64 + (warp & 3) * 16 + (lane >> 2);  // tile row
  const int key_a = k0 + key_l, key_b = key_a + 8;  // this thread's keys
  const float* bias_rows = p.bias + (size_t)(p.bias_b == 1 ? 0 : bh / p.heads) * p.bias_q * p.sk;
  const bool full_bias = p.bias_q != 1;
  // the keys' bias, once: a (1|B, 1, Sk) bias's value, or 0 where a (B, Sq,
  // Sk) bias is added per element; -1e30 past Sk
  const float kb_a = key_a < p.sk ? (full_bias ? 0.f : bias_rows[key_a]) : kNegInf;
  const float kb_b = key_b < p.sk ? (full_bias ? 0.f : bias_rows[key_b]) : kNegInf;
  const float inv_keep = 1.f / p.keep_div;

  if constexpr (kEmitDq) {
    // the dq-partial rows of the q tiles the causal mask skips: zeros
    const int rows = min(qt0 * kBq, p.sq);
    for (int i = tid; i < rows * D / 4; i += 256)
      reinterpret_cast<float4*>(dqp)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_addr = ring.res_addr(0);
  const uint32_t v_addr = ring.res_addr(1);

  ring.wait_res();
  for (int i = 0; i < n; ++i) {
    const int q0 = (qt0 + i) * kBq;
    ring.wait_full(i);
    const uint32_t q_addr = ring.stage_addr(i, 0);
    const uint32_t do_addr = ring.stage_addr(i, 1);

    // S^T = k q^T and dP^T = v dO^T: 64 keys x kBq rows each, reducing
    // over D
    float s[kBq / 2], dp[kBq / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::Wgmma<kBq, E>::ss(s, Tk::kmajor(k_addr, kBk, wg * 64, kk),
                              Tq::kmajor(q_addr, kBq, 0, kk), kk > 0);
      sm90::Wgmma<kBq, E>::ss(dp, Tk::kmajor(v_addr, kBk, wg * 64, kk),
                              Tq::kmajor(do_addr, kBq, 0, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::mask_scores_t<kBq>(s, kb_a, kb_b, full_bias ? bias_rows : nullptr,
                             p.causal && q0 < k0 + wg * 64 + 63, key_a, q0, t,
                             p.sq, p.sk);

    // P^T = exp((S^T + bias - m) - log l), then Pd^T = P^T keep / (1 -
    // rate) (into s) and dS^T = P^T (dP^T keep / (1 - rate) - delta) (into
    // dp); m, log l log2(e) and delta are per column, read from the stage
    const float* mrow = ring.vecs(i);
    const float* ll2 = mrow + kBq;
    const float* delta = mrow + 2 * kBq;
#pragma unroll
    for (int j = 0; j < kBq / 8; ++j) {
      const float2 m2 = *reinterpret_cast<const float2*>(mrow + j * 8 + 2 * t);
      const float2 g2 = *reinterpret_cast<const float2*>(ll2 + j * 8 + 2 * t);
      const float2 dl = *reinterpret_cast<const float2*>(delta + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        // the difference first (as the forward's exp2((s - max) log2(e)))
        const float pr = exp2f(fmaf(s[4 * j + e] - ((e & 1) ? m2.y : m2.x), kLog2e,
                                    -((e & 1) ? g2.y : g2.x)));
        float kf = 1.f;
        if (p.drop_threshold != 0u)
          kf = dropout_keep(p.seed, bh, q0 + j * 8 + 2 * t + (e & 1),
                            e < 2 ? key_a : key_b, p.drop_threshold) ? inv_keep : 0.f;
        s[4 * j + e] = __fmul_rn(pr, kf);
        dp[4 * j + e] = __fmul_rn(pr, fmaf(dp[4 * j + e], kf, -((e & 1) ? dl.y : dl.x)));
      }
    }

    // dV += Pd^T dO and dK += dS^T q: Pd^T and dS^T round to E here (the
    // TPU kernel's `pd.astype(do.dtype)` and `ds.astype(q.dtype)`) and leave
    // the accumulators as A fragments; dO and q are B as they lie, (rows,
    // D), read MN-major
    uint32_t pa[kBq / 16][4], da[kBq / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] = sm90::pack<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] = sm90::pack<E>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
      sm90::Wgmma<D, E>::rs(dv, pa[kk], Tq::mnmajor(do_addr, kBq, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kBq / 16; ++kk)
      sm90::Wgmma<D, E>::rs(dk, da[kk], Tq::mnmajor(q_addr, kBq, kk), 1);
    sm90::wgmma_commit();

    if constexpr (kEmitDq) {
      // dS^T into this tile's shared buffer, in the 128-byte swizzle its
      // descriptor reads: chunks of 64 query rows; in a key's 128-byte
      // row, 16-byte unit u lands at u ^ (key & 7).  The two buffers
      // alternate: the other warpgroup may still be reading the last one.
      unsigned char* ds = ring.extra() + (i & 1) * kDsBytes;
      const int sw = key_l & 7;
#pragma unroll
      for (int j = 0; j < kBq / 8; ++j) {
        unsigned char* at = ds + (j / 8) * kBk * 128 + (((j % 8) ^ sw) << 4) + 4 * t;
        *reinterpret_cast<uint32_t*>(at + key_l * 128) = da[j >> 1][(j & 1) * 2];
        *reinterpret_cast<uint32_t*>(at + (key_l + 8) * 128) = da[j >> 1][(j & 1) * 2 + 1];
      }
      sm90::fence_async_shared();
      sm90::consumers_sync<2>();

      // dQ partial = dS k over the CTA's keys: A = dS (rows x keys), read
      // as dS^T with the transpose bit; B = k, read MN-major
      const uint32_t ds_addr = sm90::smem_u32(ds) + (kSplitRows ? wg * kBk * 128 : 0);
      const uint32_t kn_addr = k_addr + (kSplitRows ? 0 : wg * kBk * Tk::kRowBytes);
      float dq[kDqN / 2];
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)
        sm90::Wgmma<kDqN, E>::template ss<1, 1>(dq, Ts::mnmajor(ds_addr, kBk, kk),
                                                Tk::mnmajor(kn_addr, kBk, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait_all();
      sm90::fence_regs(dq);
      const int row_a = q0 + (kSplitRows ? wg * 64 : 0) + (warp & 3) * 16 + (lane >> 2);
      const int row_b = row_a + 8;
      const int c0 = kSplitRows ? 0 : wg * kDqN;
#pragma unroll
      for (int nn = 0; nn < kDqN / 8; ++nn) {
        const int c = c0 + nn * 8 + 2 * t;
        if (row_a < p.sq)
          *reinterpret_cast<float2*>(dqp + (size_t)row_a * D + c) =
              make_float2(dq[4 * nn], dq[4 * nn + 1]);
        if (row_b < p.sq)
          *reinterpret_cast<float2*>(dqp + (size_t)row_b * D + c) =
              make_float2(dq[4 * nn + 2], dq[4 * nn + 3]);
      }
    } else {
      sm90::wgmma_wait_all();
    }
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    ring.release(i, lane);
  }

  E* dk_out = static_cast<E*>(p.dk);
  E* dv_out = static_cast<E*>(p.dv);
  const size_t kbase = (size_t)bh * p.sk * D;
#pragma unroll
  for (int nn = 0; nn < D / 8; ++nn) {
    const int c = nn * 8 + 2 * t;
    if (key_a < p.sk) {
      *reinterpret_cast<uint32_t*>(dk_out + kbase + (size_t)key_a * D + c) =
          sm90::pack<E>(dk[4 * nn], dk[4 * nn + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + kbase + (size_t)key_a * D + c) =
          sm90::pack<E>(dv[4 * nn], dv[4 * nn + 1]);
    }
    if (key_b < p.sk) {
      *reinterpret_cast<uint32_t*>(dk_out + kbase + (size_t)key_b * D + c) =
          sm90::pack<E>(dk[4 * nn + 2], dk[4 * nn + 3]);
      *reinterpret_cast<uint32_t*>(dv_out + kbase + (size_t)key_b * D + c) =
          sm90::pack<E>(dv[4 * nn + 2], dv[4 * nn + 3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, D <= 128: the key-major kernel in 3xTF32 (`sm90_tf32.cuh`)
// ---------------------------------------------------------------------------

// q rows a stage: 32, or 64 at D = 32 (at D = 64, before the tiles were
// split in shared memory, 64 rows took 0.838 ms against 32 rows' 0.679 at
// BH 128 x 512^2, `chip_smoke.py --variants fp32`; with the split halves,
// and at D = 128, 64-row stages would pass shared memory)
template <int D>
__host__ __device__ constexpr int tf32_kv_rows() { return D > 32 ? 32 : 64; }

// k, v, q and dO split into TF32 halves once a tile, by the CTA, in shared
// memory (hi in place, lo in planes of their own), rather than by each of
// the 8 warps at each fragment read; at D = 128 the planes would pass
// shared memory, and the warps split as they read
constexpr bool kTf32PreSplit = true;

// Resident k and v of the CTA's 128 keys; two stages of a q and a dO tile
// with their rows' (m, log l) and delta; where kPre, the lo planes of k, v
// and the current q and dO; the fused kernel's dS^T tile (keys x rows).
// Rows padded by 4 floats (`tf32::kPad`).
template <int D, bool kEmitDq>
struct Tf32KvCfg {
  static constexpr int kBq = tf32_kv_rows<D>();
  static constexpr int kThreads = 256;             // 8 warps of 16 keys
  static constexpr bool kPre = kTf32PreSplit && D <= 64;
  static constexpr int kS = D + tf32::kPad;
  static constexpr int kTs = kBq + tf32::kPad;     // a dS^T row's floats
  static constexpr int kKvFloats = kPartKeys * kS;
  static constexpr int kRowFloats = kBq * kS;
  static constexpr int kStageFloats = 2 * kRowFloats + 3 * kBq;  // q, dO, (m, log l), delta
  static constexpr int kLoFloats = kPre ? 2 * kKvFloats + 2 * kRowFloats : 0;
  static constexpr int kDsFloats = kEmitDq ? kPartKeys * kTs : 0;
  static constexpr int kSmem =
      (2 * kKvFloats + 2 * kStageFloats + kLoFloats + kDsFloats) * 4;
};

// kEmitDq: the fused kernel (dk, dv and the dq partials); without it, the
// split route's dk/dv kernel: the same recompute in the same order, so the
// two give the same dk and dv bits.
template <int D, bool kEmitDq>
__global__ void __launch_bounds__(256, 1)
flash_bwd_kv_tf32_kernel(Params p) {
  using Cfg = Tf32KvCfg<D, kEmitDq>;
  using sm90::kLog2e;
  constexpr int kBq = Cfg::kBq, kBk = kPartKeys, kS = Cfg::kS, kTs = Cfg::kTs;
  constexpr bool kPre = Cfg::kPre;
  extern __shared__ float4 smem_f4[];
  float* ks = reinterpret_cast<float*>(smem_f4);
  float* vs = ks + Cfg::kKvFloats;
  float* stages = vs + Cfg::kKvFloats;
  float* klo = stages + 2 * Cfg::kStageFloats;  // k's lo plane, then v's
  float* qlo = klo + 2 * Cfg::kKvFloats;        // q's, then dO's
  float* dst = klo + Cfg::kLoFloats;            // dS^T: [key][row]
  constexpr int kKvLo = 2 * Cfg::kKvFloats + 2 * Cfg::kStageFloats;  // klo - ks

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const sm90::GridPos pos = sm90::grid_pos(p.nk);
  const int bh = pos.bh;
  const int kt = pos.tile;
  const int k0 = kt * kBk;
  const int n_qt = (p.sq + kBq - 1) / kBq;
  // causal: q tiles whose every row lies above the CTA's first key are
  // neither loaded nor computed
  const int qt0 = p.causal ? min(k0 / kBq, n_qt) : 0;
  const int n = n_qt - qt0;
  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;
  const float* stats = reinterpret_cast<const float*>(p.stats) + (size_t)bh * p.sq * 2;
  const float* delta = p.delta + (size_t)bh * p.sq;
  float* dqp = kEmitDq ? p.dq_part + ((size_t)bh * p.nk + kt) * p.sq * D : nullptr;

  auto load_stage = [&](int i) {
    float* st = stages + (i & 1) * Cfg::kStageFloats;
    const int q0 = (qt0 + i) * kBq;
    tf32::load_rows<D, 256>(st, q + qbase, q0, kBq, p.sq);
    tf32::load_rows<D, 256>(st + Cfg::kRowFloats, dout + qbase, q0, kBq, p.sq);
    float* vec = st + 2 * Cfg::kRowFloats;
    for (int r = tid; r < kBq; r += 256) {
      const bool in = q0 + r < p.sq;
      const int row = in ? q0 + r : 0;
      tf32::cp_async8(vec + 2 * r, stats + 2 * row, in);
      tf32::cp_async4(vec + 2 * kBq + r, delta + row, in);
    }
  };
  tf32::load_rows<D, 256>(ks, k + kbase, k0, kBk, p.sk);
  tf32::load_rows<D, 256>(vs, v + kbase, k0, kBk, p.sk);
  if (n > 0) load_stage(0);
  tf32::cp_async_commit();

  if constexpr (kEmitDq) {
    // the dq-partial rows of the q tiles the causal mask skips: zeros
    const int rows = min(qt0 * kBq, p.sq);
    for (int i = tid; i < rows * D / 4; i += 256)
      reinterpret_cast<float4*>(dqp)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  // warp w owns keys k0 + 16 w .. + 15; this thread's two
  const int key_l = warp * 16 + g;
  const int key_a = k0 + key_l, key_b = key_a + 8;
  const float* bias_rows = p.bias == nullptr ? nullptr
      : p.bias + (size_t)(p.bias_b == 1 ? 0 : bh / p.heads) * p.bias_q * p.sk;
  const float* full_bias = p.bias_q != 1 ? bias_rows : nullptr;
  // the keys' bias, once: a (1|B, 1, Sk) bias's value (0 for a (B, Sq, Sk)
  // one, added per element)
  const float kb_a = key_a < p.sk && bias_rows != nullptr && full_bias == nullptr
                         ? bias_rows[key_a] : 0.f;
  const float kb_b = key_b < p.sk && bias_rows != nullptr && full_bias == nullptr
                         ? bias_rows[key_b] : 0.f;
  const float inv_keep = 1.f / p.keep_div;
  const float* kw = ks + key_l * kS + t;  // this thread's A fragments of k and v
  const float* vw = vs + key_l * kS + t;

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[c][e] = dv[c][e] = 0.f;

  for (int i = 0; i < n; ++i) {
    if (i + 1 < n) load_stage(i + 1);
    tf32::cp_async_commit();
    tf32::cp_async_wait<1>();
    __syncthreads();
    const int q0 = (qt0 + i) * kBq;
    float* qs = stages + (i & 1) * Cfg::kStageFloats;
    const float* dos = qs + Cfg::kRowFloats;
    const float* mrow = dos + Cfg::kRowFloats;  // (m, log l) a row
    const float* drow = mrow + 2 * kBq;         // delta a row
    const int q_lo = (int)(qlo - qs);           // the q / dO tiles' lo planes
    if constexpr (kPre) {
      if (i == 0) tf32::split_tile<256>(ks, klo, 2 * Cfg::kKvFloats);
      tf32::split_tile<256>(qs, qlo, 2 * Cfg::kRowFloats);
      __syncthreads();
    }

    // S^T = k q^T and dP^T = v dO^T: 16 keys x kBq rows each, reducing
    // over D
    float s[kBq / 8][4], dp[kBq / 8][4];
#pragma unroll
    for (int c = 0; c < kBq / 8; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[c][e] = dp[c][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      tf32::FragA ak, av;
      ak.fetch<kPre>(0, kw, kk * 8, kKvLo);
      ak.fetch<kPre>(1, kw, 8 * kS + kk * 8, kKvLo);
      ak.fetch<kPre>(2, kw, kk * 8 + 4, kKvLo);
      ak.fetch<kPre>(3, kw, 8 * kS + kk * 8 + 4, kKvLo);
      av.fetch<kPre>(0, vw, kk * 8, kKvLo);
      av.fetch<kPre>(1, vw, 8 * kS + kk * 8, kKvLo);
      av.fetch<kPre>(2, vw, kk * 8 + 4, kKvLo);
      av.fetch<kPre>(3, vw, 8 * kS + kk * 8 + 4, kKvLo);
#pragma unroll
      for (int c = 0; c < kBq / 8; ++c) {
        const int o = (c * 8 + g) * kS + kk * 8 + t;
        tf32::FragB bq, bo;
        bq.fetch<kPre>(0, qs, o, q_lo);
        bq.fetch<kPre>(1, qs, o + 4, q_lo);
        bo.fetch<kPre>(0, dos, o, q_lo);
        bo.fetch<kPre>(1, dos, o + 4, q_lo);
        tf32::mma3(s[c], ak, bq);
        tf32::mma3(dp[c], av, bo);
      }
    }

    // P^T = exp((S^T + bias - m) - log l), 0 past the ragged edges and
    // above the causal diagonal; Pd^T = P^T keep / (1 - rate) into s, dS^T
    // = P^T (dP^T keep / (1 - rate) - delta) into dp
#pragma unroll
    for (int c = 0; c < kBq / 8; ++c) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = c * 8 + 2 * t + (e & 1);
        const int row = q0 + r;
        const int key = e < 2 ? key_a : key_b;
        const float2 st = *reinterpret_cast<const float2*>(mrow + 2 * r);
        float pr = 0.f;
        if (row < p.sq && key < p.sk && !(p.causal && key > row)) {
          float x = s[c][e] + (e < 2 ? kb_a : kb_b);
          if (full_bias != nullptr) x += full_bias[(size_t)row * p.sk + key];
          // the difference first (as the forward's exp2((s - max) log2(e)))
          pr = exp2f(fmaf(x - st.x, kLog2e, -st.y * kLog2e));
        }
        float kf = 1.f;
        if (p.drop_threshold != 0u)
          kf = dropout_keep(p.seed, bh, row, key, p.drop_threshold) ? inv_keep : 0.f;
        s[c][e] = __fmul_rn(pr, kf);
        dp[c][e] = __fmul_rn(pr, fmaf(dp[c][e], kf, -drow[r]));
      }
    }

    // dV += Pd^T dO and dK += dS^T q: Pd^T and dS^T are A as the
    // accumulators hold them (rows in the permuted k order), dO's and q's
    // rows 2 t and 2 t + 1 the matching B
#pragma unroll
    for (int kk = 0; kk < kBq / 8; ++kk) {
      tf32::FragA ap, ad;
      ap.from_acc(s[kk]);
      ad.from_acc(dp[kk]);
      const int o = (kk * 8 + 2 * t) * kS + g;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        tf32::FragB bo, bq;
        bo.fetch<kPre>(0, dos, o + c * 8, q_lo);
        bo.fetch<kPre>(1, dos, o + kS + c * 8, q_lo);
        bq.fetch<kPre>(0, qs, o + c * 8, q_lo);
        bq.fetch<kPre>(1, qs, o + kS + c * 8, q_lo);
        tf32::mma3(dv[c], ap, bo);
        tf32::mma3(dk[c], ad, bq);
      }
    }

    if constexpr (kEmitDq) {
      // dS^T into shared memory, then the dq-partial block dS k over the
      // CTA's 128 keys, each warp 16 rows x kCols columns of it
      float* dw = dst + key_l * kTs + 2 * t;
#pragma unroll
      for (int c = 0; c < kBq / 8; ++c) {
        *reinterpret_cast<float2*>(dw + c * 8) = make_float2(dp[c][0], dp[c][1]);
        *reinterpret_cast<float2*>(dw + 8 * kTs + c * 8) = make_float2(dp[c][2], dp[c][3]);
      }
      __syncthreads();
      constexpr int kRt = kBq / 16;          // row tiles: 2, or 4 at D = 32
      constexpr int kCols = D * kRt / 8;     // columns a warp
      const int r0 = (warp % kRt) * 16, c0 = (warp / kRt) * kCols;
      float dq[kCols / 8][4];
#pragma unroll
      for (int c = 0; c < kCols / 8; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[c][e] = 0.f;
#pragma unroll 4
      for (int kk = 0; kk < kBk / 8; ++kk) {
        // A = dS (rows x keys) from dS^T, keys in the permuted k order; B =
        // k's rows 2 t and 2 t + 1
        const float* dsp = dst + (kk * 8 + 2 * t) * kTs + r0 + g;
        tf32::FragA a;
        a.set(0, dsp[0]);
        a.set(1, dsp[8]);
        a.set(2, dsp[kTs]);
        a.set(3, dsp[kTs + 8]);
        const float* kp = ks + (kk * 8 + 2 * t) * kS + c0 + g;
#pragma unroll
        for (int c = 0; c < kCols / 8; ++c) {
          tf32::FragB b;
          b.fetch<kPre>(0, kp, c * 8, kKvLo);
          b.fetch<kPre>(1, kp, kS + c * 8, kKvLo);
          tf32::mma3(dq[c], a, b);
        }
      }
      const int row_a = q0 + r0 + g, row_b = row_a + 8;
#pragma unroll
      for (int c = 0; c < kCols / 8; ++c) {
        const int col = c0 + c * 8 + 2 * t;
        if (row_a < p.sq)
          *reinterpret_cast<float2*>(dqp + (size_t)row_a * D + col) = make_float2(dq[c][0], dq[c][1]);
        if (row_b < p.sq)
          *reinterpret_cast<float2*>(dqp + (size_t)row_b * D + col) = make_float2(dq[c][2], dq[c][3]);
      }
    }
    __syncthreads();  // the stage (and dS^T) is refilled next
  }
  tf32::cp_async_wait<0>();

  float* dk_out = static_cast<float*>(p.dk);
  float* dv_out = static_cast<float*>(p.dv);
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const int col = c * 8 + 2 * t;
    if (key_a < p.sk) {
      *reinterpret_cast<float2*>(dk_out + kbase + (size_t)key_a * D + col) = make_float2(dk[c][0], dk[c][1]);
      *reinterpret_cast<float2*>(dv_out + kbase + (size_t)key_a * D + col) = make_float2(dv[c][0], dv[c][1]);
    }
    if (key_b < p.sk) {
      *reinterpret_cast<float2*>(dk_out + kbase + (size_t)key_b * D + col) = make_float2(dk[c][2], dk[c][3]);
      *reinterpret_cast<float2*>(dv_out + kbase + (size_t)key_b * D + col) = make_float2(dv[c][2], dv[c][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// D = 256, every dtype: scalar-FMA kernel
// ---------------------------------------------------------------------------

constexpr int kSimtBq = 32;  // q rows per step
constexpr int kSimtKvThreads = 512;

// keys a pass of the scalar key-major kernel holds: 64 of the CTA's 128
// (at D = 256, 128 keys' fp32 k and v alone would pass shared memory)
constexpr int kSimtPassKeys = 64;

template <int D>
constexpr int simt_smem_bytes() {
  constexpr int kBk = kSimtPassKeys;
  return (2 * kBk * (D + 1) + 2 * kSimtBq * (D + 1) +
          2 * kSimtBq * (kBk + 1) + 3 * kSimtBq) * 4;
}

template <typename E, int D, bool kEmitDq>
__global__ void __launch_bounds__(kSimtKvThreads)
flash_bwd_simt_kernel(Params p) {
  constexpr int kBk = kSimtPassKeys;
  constexpr int kPasses = kPartKeys / kBk;
  constexpr int kGroups = kSimtKvThreads / kBk;   // 8
  constexpr int kS = D + 1;    // +1: lane-per-key reads hit distinct banks
  constexpr int kP = kBk + 1;
  constexpr int kPerThread = D / kGroups;  // dK / dV columns a thread owns
  using sm90::to_f32;
  using sm90::round_to;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kBk * kS;
  float* qs = vs + kBk * kS;
  float* dos = qs + kSimtBq * kS;
  float* pds = dos + kSimtBq * kS;  // Pd[q][key]
  float* dss = pds + kSimtBq * kP;  // dS[q][key]
  float* m_s = dss + kSimtBq * kP;
  float* ll_s = m_s + kSimtBq;
  float* delta_s = ll_s + kSimtBq;

  const E* q = static_cast<const E*>(p.q);
  const E* k = static_cast<const E*>(p.k);
  const E* v = static_cast<const E*>(p.v);
  const E* dout = static_cast<const E*>(p.dout);

  const sm90::GridPos pos = sm90::grid_pos(p.nk);
  const int bh = pos.bh;
  const int kt = pos.tile;
  const int tid = threadIdx.x;
  const int key_l = tid % kBk;
  const int grp = tid / kBk;  // one value per warp: broadcast reads
  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;
  float* dqp = kEmitDq ? p.dq_part + ((size_t)bh * p.nk + kt) * p.sq * D
                       : nullptr;
  const int n_qt = (p.sq + kSimtBq - 1) / kSimtBq;

  // each pass owns kBk of the CTA's keys: its own dK / dV, and a share of
  // the dq partials (the first pass writes them, a later one adds to them;
  // the same thread owns an element in every pass)
  for (int pass = 0; pass < kPasses; ++pass) {
    const int k0 = kt * kPartKeys + pass * kBk;
    __syncthreads();
    for (int i = tid; i < kBk * D; i += kSimtKvThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.sk;
      ks[r * kS + c] = in ? to_f32(k[kbase + (size_t)(k0 + r) * D + c]) : 0.f;
      vs[r * kS + c] = in ? to_f32(v[kbase + (size_t)(k0 + r) * D + c]) : 0.f;
    }

    float dk_acc[kPerThread], dv_acc[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) dk_acc[j] = dv_acc[j] = 0.f;

    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kSimtBq;
      if (p.causal && q0 + kSimtBq - 1 < k0) {
        if (!kEmitDq || pass > 0) continue;
        for (int i = tid; i < kSimtBq * D; i += kSimtKvThreads) {
          const int r = i / D;
          if (q0 + r < p.sq) dqp[(size_t)(q0 + r) * D + i % D] = 0.f;
        }
        continue;
      }
      __syncthreads();
      for (int i = tid; i < kSimtBq * D; i += kSimtKvThreads) {
        const int r = i / D, c = i % D;
        const bool in = q0 + r < p.sq;
        qs[r * kS + c] = in ? to_f32(q[qbase + (size_t)(q0 + r) * D + c]) : 0.f;
        dos[r * kS + c] = in ? to_f32(dout[qbase + (size_t)(q0 + r) * D + c]) : 0.f;
      }
      for (int r = tid; r < kSimtBq; r += kSimtKvThreads) {
        const float2 st = row_stats(p, bh, q0 + r);
        m_s[r] = st.x;
        ll_s[r] = st.y;
        delta_s[r] = q0 + r < p.sq ? p.delta[(size_t)bh * p.sq + q0 + r] : 0.f;
      }
      __syncthreads();

      for (int q_l = grp; q_l < kSimtBq; q_l += kGroups) {
        float s = 0.f, dp = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) {
          s = fmaf(qs[q_l * kS + d], ks[key_l * kS + d], s);
          dp = fmaf(dos[q_l * kS + d], vs[key_l * kS + d], dp);
        }
        const int row = q0 + q_l, col = k0 + key_l;
        const float pr = prob(p, s, m_s[q_l], ll_s[q_l], bh, row, col);
        const float kf = keep_factor(p, bh, row, col);
        pds[q_l * kP + key_l] = round_to<E>(pr * kf);
        dss[q_l * kP + key_l] = round_to<E>(pr * (dp * kf - delta_s[q_l]));
      }
      __syncthreads();

#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int d = grp + kGroups * j;
        float a = dv_acc[j], b = dk_acc[j];
        for (int q_l = 0; q_l < kSimtBq; ++q_l) {
          a = fmaf(pds[q_l * kP + key_l], dos[q_l * kS + d], a);
          b = fmaf(dss[q_l * kP + key_l], qs[q_l * kS + d], b);
        }
        dv_acc[j] = a;
        dk_acc[j] = b;
      }
      if (!kEmitDq) continue;
      for (int i = tid; i < kSimtBq * D; i += kSimtKvThreads) {
        const int q_l = i / D, d = i % D;
        if (q0 + q_l >= p.sq) continue;
        float s = 0.f;
#pragma unroll 16
        for (int kk = 0; kk < kBk; ++kk)
          s = fmaf(dss[q_l * kP + kk], ks[kk * kS + d], s);
        float* at = dqp + (size_t)(q0 + q_l) * D + d;
        *at = pass == 0 ? s : *at + s;
      }
    }

    E* dk = static_cast<E*>(p.dk);
    E* dv = static_cast<E*>(p.dv);
    if (k0 + key_l < p.sk) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const size_t o = kbase + (size_t)(k0 + key_l) * D + grp + kGroups * j;
        dk[o] = sm90::from_f32<E>(dk_acc[j]);
        dv[o] = sm90::from_f32<E>(dv_acc[j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// the split route's dq kernels
// ---------------------------------------------------------------------------

// One CTA per (bh, query tile) walks the k tiles, skipping those a causal
// mask hides wholly: S = q k^T and dP = dO v^T, P = exp((S + bias - m) -
// log l) (a dead row, m = +1e30, gives 0), dS = P * (dP * keep / (1 - rate) -
// delta) rounded to the input dtype (the TPU kernel's `ds.astype(k.dtype)`),
// dQ += dS k in fp32 registers, written once in q's dtype.  fp16 / bf16: the
// forward's query-major design (`sm90_attn.cuh`): the first warp of a
// producer warpgroup keeps TMA loads of 64-key k and v tiles and their key
// bias in flight through a 2-stage mbarrier ring after loading q and dO
// once; one or two consumer warpgroups of 64 query rows (the register split
// and the tile choice as the forward's) run S and dP on wgmma from swizzled
// shared memory, turn them into dS in registers in exp2 (the key bias read
// once per tile, the causal compare only on tiles crossing the diagonal),
// and feed dS as the register A operand of dQ += dS k with k's tile as an
// MN-major B.  fp32, and every dtype at D = 256: 256 threads of scalar FMA
// on fp32 copies, dS (rounded to E) through shared memory.

// k tiles a query tile at q0 of `rows` rows reads: under a causal mask,
// none past the tile's last row.
__device__ __forceinline__ int dq_k_tiles(const Params& p, int q0, int rows,
                                          int bk) {
  const int n = (p.sk + bk - 1) / bk;
  return p.causal ? min(n, (q0 + rows - 1) / bk + 1) : n;
}

// C consumer warpgroups of 64 query rows each, then one producer
// warpgroup whose first warp starts the loads: q and dO once, 64-key k/v
// stages (128 would give S and dP 128 fp32 registers a thread together,
// which spills even at 240 and measured slower).
template <int D, int C>
using DqCfg = sm90::RingCfg<D, C, 2, 64 * C, 2, 64, 1>;

template <typename E, int D, int C>
__global__ void __launch_bounds__(DqCfg<D, C>::kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, Params p) {
  using Cfg = DqCfg<D, C>;
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
  const int n_kt = dq_k_tiles(p, q0, kBq, kBk);
  const float* bias_rows = p.bias + (size_t)(p.bias_b == 1 ? 0 : bh / p.heads) * p.bias_q * p.sk;
  const bool full_bias = p.bias_q != 1;

  ring.init();
  if (warp >= 4 * C) {
    // ---- producer: q and dO once, then k/v tiles and their key bias
    sm90::producer_release_registers();
    if (warp == 4 * C) {
      const CUtensorMap* qmaps[2] = {&qmap, &domap};
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
  // (m, log l log2(e)) of each row; a row past Sq reads as dead (P = 0)
  const float2 st_a = row_stats(p, bh, row_a), st_b = row_stats(p, bh, row_b);
  const float m_a = st_a.x, m_b = st_b.x;
  const float ll2_a = st_a.y * kLog2e, ll2_b = st_b.y * kLog2e;
  const float del_a = row_a < p.sq ? p.delta[(size_t)bh * p.sq + row_a] : 0.f;
  const float del_b = row_b < p.sq ? p.delta[(size_t)bh * p.sq + row_b] : 0.f;
  const float inv_keep = 1.f / p.keep_div;
  const uint32_t q_addr = ring.res_addr(0);
  const uint32_t do_addr = ring.res_addr(1);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  ring.wait_res();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBk;
    ring.wait_full(kt);
    const uint32_t k_addr = ring.stage_addr(kt, 0);

    // S = q k^T and dP = dO v^T: 64 rows x kBk keys each, reducing over D
    float s[kBk / 2], dp[kBk / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::Wgmma<kBk, E>::ss(s, T::kmajor(q_addr, kBq, wg * 64, kk),
                              T::kmajor(k_addr, kBk, 0, kk), kk > 0);
      sm90::Wgmma<kBk, E>::ss(dp, T::kmajor(do_addr, kBq, wg * 64, kk),
                              T::kmajor(ring.stage_addr(kt, 1), kBk, 0, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::mask_scores<kBk>(s, ring.vecs(kt), full_bias ? bias_rows : nullptr,
                           p.causal && k0 + kBk - 1 > wg_row0, row_a, k0, t,
                           p.sq, p.sk);

    // P = exp((S + bias - m) - log l), dS = P * (dP * keep / (1 - rate) -
    // delta)
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float pr = exp2f(fmaf(s[4 * j + e] - (lo ? m_a : m_b), kLog2e,
                                    -(lo ? ll2_a : ll2_b)));
        float kf = 1.f;
        if (p.drop_threshold != 0u)
          kf = dropout_keep(p.seed, bh, lo ? row_a : row_b, k0 + j * 8 + 2 * t + (e & 1),
                            p.drop_threshold) ? inv_keep : 0.f;
        s[4 * j + e] = pr * (dp[4 * j + e] * kf - (lo ? del_a : del_b));
      }
    }

    // dQ += dS k: dS rounds to E here (the TPU kernel's
    // `ds.astype(k.dtype)`) and leaves the accumulators as A fragments; k is
    // B as it lies, (keys, D), read MN-major
    uint32_t da[kBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = sm90::pack<E>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      sm90::Wgmma<D, E>::rs(dq, da[kk], T::mnmajor(k_addr, kBk, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(dq);
    ring.release(kt, lane);
  }

  E* dq_out = static_cast<E*>(p.dq);
  const size_t qbase = (size_t)bh * p.sq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_a < p.sq)
      *reinterpret_cast<uint32_t*>(dq_out + qbase + (size_t)row_a * D + c) =
          sm90::pack<E>(dq[4 * n], dq[4 * n + 1]);
    if (row_b < p.sq)
      *reinterpret_cast<uint32_t*>(dq_out + qbase + (size_t)row_b * D + c) =
          sm90::pack<E>(dq[4 * n + 2], dq[4 * n + 3]);
  }
}

// query rows per CTA of the scalar dq kernel, and keys per k tile (equal:
// a thread's lane is a key for dS, then a query row for dQ): 64, or 32 at
// D = 256
template <int D>
__host__ __device__ constexpr int dq_simt_rows() { return D > 128 ? 32 : 64; }
constexpr int kSimtThreads = 256;

template <int D>
constexpr int dq_simt_smem_bytes() {
  constexpr int kB = dq_simt_rows<D>();
  return (4 * kB * (D + 1) + kB * (kB + 1) + 3 * kB) * 4;
}

template <typename E, int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dq_simt_kernel(Params p) {
  constexpr int kBq = dq_simt_rows<D>();
  constexpr int kBk = kBq;
  constexpr int kS = D + 1;  // +1: lane-per-row reads hit distinct banks
  constexpr int kP = kBk + 1;
  constexpr int kPerThread = kBq * D / kSimtThreads;  // dQ values
  constexpr int kGroups = kSimtThreads / kBq;         // 4, or 8 at D = 256
  using sm90::to_f32;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + kBq * kS;
  float* ks = dos + kBq * kS;
  float* vs = ks + kBk * kS;
  float* dss = vs + kBk * kS;  // dS[q][key]
  float* m_s = dss + kBq * kP;
  float* ll_s = m_s + kBq;
  float* delta_s = ll_s + kBq;

  const E* q = static_cast<const E*>(p.q);
  const E* k = static_cast<const E*>(p.k);
  const E* v = static_cast<const E*>(p.v);
  const E* dout = static_cast<const E*>(p.dout);

  const sm90::GridPos pos = sm90::grid_pos((p.sq + kBq - 1) / kBq);
  const int bh = pos.bh;
  const int q0 = pos.tile * kBq;
  const int tid = threadIdx.x;
  const int lane_l = tid % kBq;  // a key (dS), then a query row (dQ)
  const int grp = tid / kBq;     // one value per warp: broadcast reads
  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;

  for (int i = tid; i < kBq * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < p.sq;
    qs[r * kS + c] = in ? to_f32(q[qbase + (size_t)(q0 + r) * D + c]) : 0.f;
    dos[r * kS + c] = in ? to_f32(dout[qbase + (size_t)(q0 + r) * D + c]) : 0.f;
  }
  for (int r = tid; r < kBq; r += kSimtThreads) {
    const float2 st = row_stats(p, bh, q0 + r);
    m_s[r] = st.x;
    ll_s[r] = st.y;
    delta_s[r] = q0 + r < p.sq ? p.delta[(size_t)bh * p.sq + q0 + r] : 0.f;
  }

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;

  const int n_kt = dq_k_tiles(p, q0, kBq, kBk);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();
    for (int i = tid; i < kBk * D; i += kSimtThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.sk;
      ks[r * kS + c] = in ? to_f32(k[kbase + (size_t)(k0 + r) * D + c]) : 0.f;
      vs[r * kS + c] = in ? to_f32(v[kbase + (size_t)(k0 + r) * D + c]) : 0.f;
    }
    __syncthreads();

    for (int q_l = grp; q_l < kBq; q_l += kGroups) {
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[q_l * kS + d], ks[lane_l * kS + d], s);
        dp = fmaf(dos[q_l * kS + d], vs[lane_l * kS + d], dp);
      }
      const int row = q0 + q_l, col = k0 + lane_l;
      const float pr = prob(p, s, m_s[q_l], ll_s[q_l], bh, row, col);
      const float kf = keep_factor(p, bh, row, col);
      dss[q_l * kP + lane_l] = sm90::round_to<E>(pr * (dp * kf - delta_s[q_l]));
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int d = grp + kGroups * j;
      float a = acc[j];
      for (int kk = 0; kk < kBk; ++kk)
        a = fmaf(dss[lane_l * kP + kk], ks[kk * kS + d], a);
      acc[j] = a;
    }
  }

  E* dq_out = static_cast<E*>(p.dq);
  if (q0 + lane_l < p.sq) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      dq_out[qbase + (size_t)(q0 + lane_l) * D + grp + kGroups * j] =
          sm90::from_f32<E>(acc[j]);
  }
}

// ---------------------------------------------------------------------------
// D > 256: the column-chunked scalar kernels, every dtype
// ---------------------------------------------------------------------------

// Output columns a CTA owns (flash.py `CHUNK_D`): the wrapper pads D to a
// multiple of it, and each grid gains a chunk axis.  Every CTA forms S =
// q k^T and dP = dO v^T summed over all of D in kChunk-wide pieces staged
// through shared memory, then its own chunk of dq / dk / dv (and of the dq
// partials).  The chunk CTAs of one tile run the same sums in the same
// order, so they agree on P and dS bit for bit.  d is the padded head dim.
constexpr int kChunk = 128;
constexpr int kChunkS = kChunk + 1;  // +1: lane-per-row reads hit distinct banks
constexpr int kChunkRows = 32;       // q rows (and the dq kernel's keys) a step
constexpr int kChunkPassKeys = 64;   // keys a pass of the key-major kernel

constexpr int kv_chunk_smem_bytes() {
  return (2 * kChunkPassKeys * kChunkS + 2 * kChunkRows * kChunkS +
          2 * kChunkRows * (kChunkPassKeys + 1) + 3 * kChunkRows) * 4;
}

// Rows [r0, r0 + rows) of a (., d) tensor at base, columns [c0, c0 +
// kChunk), into dst (rows x kChunkS fp32); rows past n read as 0.
template <typename E, int kThreads>
__device__ __forceinline__ void stage_piece(float* dst, const E* src, size_t base, int r0,
                                            int rows, int n, int d, int c0) {
  for (int i = threadIdx.x; i < rows * kChunk; i += kThreads) {
    const int r = i / kChunk, c = i % kChunk;
    dst[r * kChunkS + c] =
        r0 + r < n ? sm90::to_f32(src[base + (size_t)(r0 + r) * d + c0 + c]) : 0.f;
  }
}

// The fused kernel (kEmitDq) or the split dk/dv kernel at D > 256: one CTA
// of 512 threads per (bh, 128-key tile, column chunk), in passes of 64
// keys, q tiles of 32 rows; the scalar key-major kernel above with the
// piecewise S and dP.
template <typename E, bool kEmitDq>
__global__ void __launch_bounds__(kSimtKvThreads)
flash_bwd_chunk_kernel(Params p, int d) {
  constexpr int kBk = kChunkPassKeys;
  constexpr int kPasses = kPartKeys / kBk;
  constexpr int kGroups = kSimtKvThreads / kBk;    // 8
  constexpr int kRows = kChunkRows / kGroups;      // S rows a thread
  constexpr int kPerThread = kChunk / kGroups;     // dK / dV columns a thread
  constexpr int kP = kBk + 1;
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kBk * kChunkS;
  float* qs = vs + kBk * kChunkS;
  float* dos = qs + kChunkRows * kChunkS;
  float* pds = dos + kChunkRows * kChunkS;  // Pd[q][key]
  float* dss = pds + kChunkRows * kP;       // dS[q][key]
  float* m_s = dss + kChunkRows * kP;
  float* ll_s = m_s + kChunkRows;
  float* delta_s = ll_s + kChunkRows;

  const E* q = static_cast<const E*>(p.q);
  const E* k = static_cast<const E*>(p.k);
  const E* v = static_cast<const E*>(p.v);
  const E* dout = static_cast<const E*>(p.dout);

  const int n_chunks = d / kChunk;
  const sm90::GridPos pos = sm90::grid_pos(p.nk * n_chunks);
  const int bh = pos.bh;
  const int cc = pos.tile % n_chunks * kChunk;  // the CTA's first column
  const int kt = pos.tile / n_chunks;
  const int tid = threadIdx.x;
  const int key_l = tid % kBk;
  const int grp = tid / kBk;  // one value per warp: broadcast reads
  const size_t qbase = (size_t)bh * p.sq * d;
  const size_t kbase = (size_t)bh * p.sk * d;
  float* dqp = kEmitDq ? p.dq_part + ((size_t)bh * p.nk + kt) * p.sq * d : nullptr;
  const int n_qt = (p.sq + kChunkRows - 1) / kChunkRows;

  for (int pass = 0; pass < kPasses; ++pass) {
    const int k0 = kt * kPartKeys + pass * kBk;
    float dk_acc[kPerThread], dv_acc[kPerThread];
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) dk_acc[j] = dv_acc[j] = 0.f;

    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kChunkRows;
      if (p.causal && q0 + kChunkRows - 1 < k0) {
        if (!kEmitDq || pass > 0) continue;
        for (int i = tid; i < kChunkRows * kChunk; i += kSimtKvThreads) {
          const int r = i / kChunk;
          if (q0 + r < p.sq) dqp[(size_t)(q0 + r) * d + cc + i % kChunk] = 0.f;
        }
        continue;
      }
      float s[kRows], dp[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
      for (int c0 = 0; c0 < d; c0 += kChunk) {
        __syncthreads();
        stage_piece<E, kSimtKvThreads>(ks, k, kbase, k0, kBk, p.sk, d, c0);
        stage_piece<E, kSimtKvThreads>(vs, v, kbase, k0, kBk, p.sk, d, c0);
        stage_piece<E, kSimtKvThreads>(qs, q, qbase, q0, kChunkRows, p.sq, d, c0);
        stage_piece<E, kSimtKvThreads>(dos, dout, qbase, q0, kChunkRows, p.sq, d, c0);
        if (c0 == 0) {
          for (int r = tid; r < kChunkRows; r += kSimtKvThreads) {
            const float2 st = row_stats(p, bh, q0 + r);
            m_s[r] = st.x;
            ll_s[r] = st.y;
            delta_s[r] = q0 + r < p.sq ? p.delta[(size_t)bh * p.sq + q0 + r] : 0.f;
          }
        }
        __syncthreads();
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const int q_l = grp + kGroups * i;
          float a = s[i], b = dp[i];
#pragma unroll 16
          for (int c = 0; c < kChunk; ++c) {
            a = fmaf(qs[q_l * kChunkS + c], ks[key_l * kChunkS + c], a);
            b = fmaf(dos[q_l * kChunkS + c], vs[key_l * kChunkS + c], b);
          }
          s[i] = a;
          dp[i] = b;
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q_l = grp + kGroups * i;
        const int row = q0 + q_l, col = k0 + key_l;
        const float pr = prob(p, s[i], m_s[q_l], ll_s[q_l], bh, row, col);
        const float kf = keep_factor(p, bh, row, col);
        pds[q_l * kP + key_l] = sm90::round_to<E>(pr * kf);
        dss[q_l * kP + key_l] = sm90::round_to<E>(pr * (dp[i] * kf - delta_s[q_l]));
      }
      __syncthreads();
      // the CTA's own chunk of q and dO (and of k, for the dq partials)
      stage_piece<E, kSimtKvThreads>(qs, q, qbase, q0, kChunkRows, p.sq, d, cc);
      stage_piece<E, kSimtKvThreads>(dos, dout, qbase, q0, kChunkRows, p.sq, d, cc);
      if (kEmitDq) stage_piece<E, kSimtKvThreads>(ks, k, kbase, k0, kBk, p.sk, d, cc);
      __syncthreads();

#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const int c = grp + kGroups * j;
        float a = dv_acc[j], b = dk_acc[j];
        for (int q_l = 0; q_l < kChunkRows; ++q_l) {
          a = fmaf(pds[q_l * kP + key_l], dos[q_l * kChunkS + c], a);
          b = fmaf(dss[q_l * kP + key_l], qs[q_l * kChunkS + c], b);
        }
        dv_acc[j] = a;
        dk_acc[j] = b;
      }
      if (!kEmitDq) continue;
      for (int i = tid; i < kChunkRows * kChunk; i += kSimtKvThreads) {
        const int q_l = i / kChunk, c = i % kChunk;
        if (q0 + q_l >= p.sq) continue;
        float a = 0.f;
#pragma unroll 16
        for (int kk = 0; kk < kBk; ++kk) a = fmaf(dss[q_l * kP + kk], ks[kk * kChunkS + c], a);
        float* at = dqp + (size_t)(q0 + q_l) * d + cc + c;
        *at = pass == 0 ? a : *at + a;
      }
    }

    E* dk = static_cast<E*>(p.dk);
    E* dv = static_cast<E*>(p.dv);
    if (k0 + key_l < p.sk) {
#pragma unroll
      for (int j = 0; j < kPerThread; ++j) {
        const size_t o = kbase + (size_t)(k0 + key_l) * d + cc + grp + kGroups * j;
        dk[o] = sm90::from_f32<E>(dk_acc[j]);
        dv[o] = sm90::from_f32<E>(dv_acc[j]);
      }
    }
  }
}

constexpr int dq_chunk_smem_bytes() {
  return (4 * kChunkRows * kChunkS + kChunkRows * (kChunkRows + 1) + 3 * kChunkRows) * 4;
}

// The split route's dq at D > 256: one CTA of 256 threads per (bh, 32-row
// q tile, column chunk) walking 32-key tiles; the scalar dq kernel above
// with the piecewise S and dP.
template <typename E>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dq_chunk_kernel(Params p, int d) {
  constexpr int kB = kChunkRows;                   // q rows = keys a tile
  constexpr int kGroups = kSimtThreads / kB;       // 8
  constexpr int kRows = kB / kGroups;              // S rows a thread
  constexpr int kPerThread = kChunk / kGroups;     // dQ columns a thread
  constexpr int kP = kB + 1;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + kB * kChunkS;
  float* ks = dos + kB * kChunkS;
  float* vs = ks + kB * kChunkS;
  float* dss = vs + kB * kChunkS;  // dS[q][key]
  float* m_s = dss + kB * kP;
  float* ll_s = m_s + kB;
  float* delta_s = ll_s + kB;

  const E* q = static_cast<const E*>(p.q);
  const E* k = static_cast<const E*>(p.k);
  const E* v = static_cast<const E*>(p.v);
  const E* dout = static_cast<const E*>(p.dout);

  const int n_chunks = d / kChunk;
  const sm90::GridPos pos = sm90::grid_pos((p.sq + kB - 1) / kB * n_chunks);
  const int bh = pos.bh;
  const int cc = pos.tile % n_chunks * kChunk;
  const int q0 = pos.tile / n_chunks * kB;
  const int tid = threadIdx.x;
  const int lane_l = tid % kB;  // a key (dS), then a query row (dQ)
  const int grp = tid / kB;     // one value per warp: broadcast reads
  const size_t qbase = (size_t)bh * p.sq * d;
  const size_t kbase = (size_t)bh * p.sk * d;

  for (int r = tid; r < kB; r += kSimtThreads) {
    const float2 st = row_stats(p, bh, q0 + r);
    m_s[r] = st.x;
    ll_s[r] = st.y;
    delta_s[r] = q0 + r < p.sq ? p.delta[(size_t)bh * p.sq + q0 + r] : 0.f;
  }

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;

  const int n_kt = dq_k_tiles(p, q0, kB, kB);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kB;
    float s[kRows], dp[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) s[i] = dp[i] = 0.f;
    for (int c0 = 0; c0 < d; c0 += kChunk) {
      __syncthreads();
      stage_piece<E, kSimtThreads>(qs, q, qbase, q0, kB, p.sq, d, c0);
      stage_piece<E, kSimtThreads>(dos, dout, qbase, q0, kB, p.sq, d, c0);
      stage_piece<E, kSimtThreads>(ks, k, kbase, k0, kB, p.sk, d, c0);
      stage_piece<E, kSimtThreads>(vs, v, kbase, k0, kB, p.sk, d, c0);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int q_l = grp + kGroups * i;
        float a = s[i], b = dp[i];
#pragma unroll 16
        for (int c = 0; c < kChunk; ++c) {
          a = fmaf(qs[q_l * kChunkS + c], ks[lane_l * kChunkS + c], a);
          b = fmaf(dos[q_l * kChunkS + c], vs[lane_l * kChunkS + c], b);
        }
        s[i] = a;
        dp[i] = b;
      }
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int q_l = grp + kGroups * i;
      const int row = q0 + q_l, col = k0 + lane_l;
      const float pr = prob(p, s[i], m_s[q_l], ll_s[q_l], bh, row, col);
      const float kf = keep_factor(p, bh, row, col);
      dss[q_l * kP + lane_l] = sm90::round_to<E>(pr * (dp[i] * kf - delta_s[q_l]));
    }
    __syncthreads();
    stage_piece<E, kSimtThreads>(ks, k, kbase, k0, kB, p.sk, d, cc);  // the own chunk of k
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int c = grp + kGroups * j;
      float a = acc[j];
      for (int kk = 0; kk < kB; ++kk) a = fmaf(dss[lane_l * kP + kk], ks[kk * kChunkS + c], a);
      acc[j] = a;
    }
  }

  E* dq_out = static_cast<E*>(p.dq);
  if (q0 + lane_l < p.sq) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      dq_out[qbase + (size_t)(q0 + lane_l) * d + cc + grp + kGroups * j] =
          sm90::from_f32<E>(acc[j]);
  }
}

using sm90::allow_smem;

template <typename E, int D, bool kEmitDq>
cudaError_t launch_kv_sm90(const Params& p, cudaStream_t stream) {
  using Cfg = KvCfg<D, kEmitDq>;
  static bool smem_ready = false;
  cudaError_t err = allow_smem(flash_bwd_kv_sm90_kernel<E, D, kEmitDq>, Cfg::kSmem, smem_ready);
  if (err != cudaSuccess) return err;
  CUtensorMap km, vm, qm, dom;
  if ((err = sm90::encode_map<E, D, Cfg::kResAw>(&km, p.k, p.sk, p.bh_count, Cfg::kResRows)) != cudaSuccess ||
      (err = sm90::encode_map<E, D, Cfg::kResAw>(&vm, p.v, p.sk, p.bh_count, Cfg::kResRows)) != cudaSuccess ||
      (err = sm90::encode_map<E, D>(&qm, p.q, p.sq, p.bh_count, Cfg::kStageRows)) != cudaSuccess ||
      (err = sm90::encode_map<E, D>(&dom, p.dout, p.sq, p.bh_count, Cfg::kStageRows)) != cudaSuccess)
    return err;
  dim3 grid;
  if ((err = sm90::flat_grid(p.nk, p.bh_count, &grid)) != cudaSuccess) return err;
  flash_bwd_kv_sm90_kernel<E, D, kEmitDq><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(km, vm, qm, dom, p);
  return cudaGetLastError();
}

template <int D, bool kEmitDq>
cudaError_t launch_kv_tf32(const Params& p, cudaStream_t stream) {
  using Cfg = Tf32KvCfg<D, kEmitDq>;
  static bool smem_ready = false;
  cudaError_t err = allow_smem(flash_bwd_kv_tf32_kernel<D, kEmitDq>, Cfg::kSmem, smem_ready);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if ((err = sm90::flat_grid(p.nk, p.bh_count, &grid)) != cudaSuccess) return err;
  flash_bwd_kv_tf32_kernel<D, kEmitDq><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <typename E, int D, bool kEmitDq>
cudaError_t launch_kv_simt(const Params& p, cudaStream_t stream) {
  static bool simt_ready = false;
  constexpr int bytes = simt_smem_bytes<D>();
  cudaError_t err = allow_smem(flash_bwd_simt_kernel<E, D, kEmitDq>, bytes, simt_ready);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if ((err = sm90::flat_grid(p.nk, p.bh_count, &grid)) != cudaSuccess) return err;
  flash_bwd_simt_kernel<E, D, kEmitDq><<<grid, kSimtKvThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// The fused kernel (kEmitDq) or the split route's dk/dv kernel: up to D =
// 128, fp16 / bf16 on the ring and fp32 in 3xTF32; every dtype at D = 256
// scalar.
template <int D, bool kEmitDq>
cudaError_t launch_kv(const Params& p, int dtype, cudaStream_t stream) {
  if constexpr (D <= 128) {
    if (dtype == kDtypeBF16) return launch_kv_sm90<__nv_bfloat16, D, kEmitDq>(p, stream);
    if (dtype == kDtypeF16) return launch_kv_sm90<__half, D, kEmitDq>(p, stream);
    return launch_kv_tf32<D, kEmitDq>(p, stream);
  } else {
    if (dtype == kDtypeBF16) return launch_kv_simt<__nv_bfloat16, D, kEmitDq>(p, stream);
    if (dtype == kDtypeF16) return launch_kv_simt<__half, D, kEmitDq>(p, stream);
    return launch_kv_simt<float, D, kEmitDq>(p, stream);
  }
}

template <typename E, int D, int C>
cudaError_t launch_dq_sm90(const Params& p, cudaStream_t stream) {
  using Cfg = DqCfg<D, C>;
  static bool smem_ready = false;
  cudaError_t err = sm90::allow_smem(flash_bwd_dq_sm90_kernel<E, D, C>, Cfg::kSmem, smem_ready);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, dom, km, vm;
  if ((err = sm90::encode_map<E, D>(&qm, p.q, p.sq, p.bh_count, Cfg::kResRows)) != cudaSuccess ||
      (err = sm90::encode_map<E, D>(&dom, p.dout, p.sq, p.bh_count, Cfg::kResRows)) != cudaSuccess ||
      (err = sm90::encode_map<E, D>(&km, p.k, p.sk, p.bh_count, Cfg::kStageRows)) != cudaSuccess ||
      (err = sm90::encode_map<E, D>(&vm, p.v, p.sk, p.bh_count, Cfg::kStageRows)) != cudaSuccess)
    return err;
  dim3 grid;
  if ((err = sm90::flat_grid((p.sq + Cfg::kResRows - 1) / Cfg::kResRows, p.bh_count, &grid)) !=
      cudaSuccess)
    return err;
  flash_bwd_dq_sm90_kernel<E, D, C><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(qm, dom, km, vm, p);
  return cudaGetLastError();
}

// one or two consumer warpgroups (`sm90::consumer_groups`)
template <typename E, int D>
cudaError_t launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  return sm90::consumer_groups(p.sq, p.bh_count) == 2 ? launch_dq_sm90<E, D, 2>(p, stream)
                                                      : launch_dq_sm90<E, D, 1>(p, stream);
}

template <typename E, int D>
cudaError_t launch_dq_simt(const Params& p, cudaStream_t stream) {
  static bool simt_ready = false;
  constexpr int bytes = dq_simt_smem_bytes<D>();
  constexpr int rows = dq_simt_rows<D>();
  cudaError_t err = allow_smem(flash_bwd_dq_simt_kernel<E, D>, bytes, simt_ready);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if ((err = sm90::flat_grid((p.sq + rows - 1) / rows, p.bh_count, &grid)) != cudaSuccess)
    return err;
  flash_bwd_dq_simt_kernel<E, D><<<grid, kSimtThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t stream) {
  if constexpr (D <= 128) {
    if (dtype == kDtypeBF16) return launch_dq_wgmma<__nv_bfloat16, D>(p, stream);
    if (dtype == kDtypeF16) return launch_dq_wgmma<__half, D>(p, stream);
  } else {
    if (dtype == kDtypeBF16) return launch_dq_simt<__nv_bfloat16, D>(p, stream);
    if (dtype == kDtypeF16) return launch_dq_simt<__half, D>(p, stream);
  }
  return launch_dq_simt<float, D>(p, stream);
}

enum class Route { kFused, kDkv, kDq };

template <typename E, bool kEmitDq>
cudaError_t launch_kv_chunk(const Params& p, int d, cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = kv_chunk_smem_bytes();
  cudaError_t err = allow_smem(flash_bwd_chunk_kernel<E, kEmitDq>, bytes, ready);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if ((err = sm90::flat_grid(p.nk * (d / kChunk), p.bh_count, &grid)) != cudaSuccess) return err;
  flash_bwd_chunk_kernel<E, kEmitDq><<<grid, kSimtKvThreads, bytes, stream>>>(p, d);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_dq_chunk(const Params& p, int d, cudaStream_t stream) {
  static bool ready = false;
  constexpr int bytes = dq_chunk_smem_bytes();
  cudaError_t err = allow_smem(flash_bwd_dq_chunk_kernel<E>, bytes, ready);
  if (err != cudaSuccess) return err;
  dim3 grid;
  if ((err = sm90::flat_grid((p.sq + kChunkRows - 1) / kChunkRows * (d / kChunk), p.bh_count,
                             &grid)) != cudaSuccess)
    return err;
  flash_bwd_dq_chunk_kernel<E><<<grid, kSimtThreads, bytes, stream>>>(p, d);
  return cudaGetLastError();
}

template <typename E>
cudaError_t launch_chunk(const Params& p, Route route, int d, cudaStream_t stream) {
  switch (route) {
    case Route::kFused: return launch_kv_chunk<E, true>(p, d, stream);
    case Route::kDkv: return launch_kv_chunk<E, false>(p, d, stream);
    default: return launch_dq_chunk<E>(p, d, stream);
  }
}

template <int D>
cudaError_t launch(const Params& p, Route route, int dtype,
                   cudaStream_t stream) {
  switch (route) {
    case Route::kFused: return launch_kv<D, true>(p, dtype, stream);
    case Route::kDkv: return launch_kv<D, false>(p, dtype, stream);
    default: return launch_dq<D>(p, dtype, stream);
  }
}

int run(const void* q, const void* k, const void* v, const void* bias,
        const void* dout, const void* stats, const void* delta, void* dq_part,
        void* dq, void* dk, void* dv, int bh_count, int sq, int sk, int d,
        int heads, int bias_b, int bias_q, int causal,
        unsigned int drop_threshold, float keep_div, int seed, int dtype,
        Route route, void* stream) {
  if (bh_count <= 0 || sq <= 0 || sk <= 0 || heads <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype != kDtypeF32 && dtype != kDtypeBF16 && dtype != kDtypeF16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.bias = static_cast<const float*>(bias);
  p.stats = static_cast<const float2*>(stats);
  p.delta = static_cast<const float*>(delta);
  p.dq_part = static_cast<float*>(dq_part);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.bh_count = bh_count;
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.nk = (sk + kPartKeys - 1) / kPartKeys;
  p.bias_b = bias_b;
  p.bias_q = bias_q;
  p.causal = causal;
  p.drop_threshold = drop_threshold;
  p.keep_div = keep_div;
  p.seed = (uint32_t)seed;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return (int)launch<32>(p, route, dtype, s);
    case 64: return (int)launch<64>(p, route, dtype, s);
    case 128: return (int)launch<128>(p, route, dtype, s);
    case 256: return (int)launch<256>(p, route, dtype, s);
    default: break;
  }
  if (d <= 256 || d % kChunk) return (int)cudaErrorInvalidValue;
  if (dtype == kDtypeBF16) return (int)launch_chunk<__nv_bfloat16>(p, route, d, s);
  if (dtype == kDtypeF16) return (int)launch_chunk<__half>(p, route, d, s);
  return (int)launch_chunk<float>(p, route, d, s);
}

}  // namespace

// q, dout (bh, sq, d), k/v (bh, sk, d), dk/dv (bh, sk, d): contiguous,
// 16-byte aligned, of `dtype`.  bias: fp32 (bias_b, bias_q, sk) or null.
// stats: fp32 (bh, sq, 2) = (row max m, log l), the forward's; delta: fp32
// (bh, sq).  dq_part: fp32 (bh, ceil(sk / 128), sq, d), fully written.  d in
// {32, 64, 128, 256}, or a multiple of 128 past 256 (the chunked kernels;
// their chunk CTAs write disjoint columns of dq_part).  drop_threshold =
// rate * 2^32 (0 = no dropout), keep_div = 1 - rate.  Returns cudaSuccess (0) or the launch
// error.
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* bias, const void* dout,
                              const void* stats, const void* delta,
                              void* dq_part, void* dk, void* dv,
                              int bh_count, int sq, int sk, int d, int heads,
                              int bias_b, int bias_q, int causal,
                              unsigned int drop_threshold, float keep_div,
                              int seed, int dtype, void* stream) {
  return run(q, k, v, bias, dout, stats, delta, dq_part, nullptr, dk, dv,
             bh_count, sq, sk, d, heads, bias_b, bias_q, causal,
             drop_threshold, keep_div, seed, dtype, Route::kFused, stream);
}

// The split route's dk/dv: as apex_flash_bwd without the dq partials.
extern "C" int apex_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* dout, const void* stats,
                                  const void* delta, void* dk, void* dv,
                                  int bh_count, int sq, int sk, int d,
                                  int heads, int bias_b, int bias_q,
                                  int causal, unsigned int drop_threshold,
                                  float keep_div, int seed, int dtype,
                                  void* stream) {
  return run(q, k, v, bias, dout, stats, delta, nullptr, nullptr, dk, dv,
             bh_count, sq, sk, d, heads, bias_b, bias_q, causal,
             drop_threshold, keep_div, seed, dtype, Route::kDkv, stream);
}

// The split route's dq: (bh, sq, d) of `dtype`, the inputs as above.
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* bias, const void* dout,
                                 const void* stats, const void* delta, void* dq,
                                 int bh_count, int sq, int sk, int d,
                                 int heads, int bias_b, int bias_q,
                                 int causal, unsigned int drop_threshold,
                                 float keep_div, int seed, int dtype,
                                 void* stream) {
  return run(q, k, v, bias, dout, stats, delta, nullptr, dq, nullptr, nullptr,
             bh_count, sq, sk, d, heads, bias_b, bias_q, causal,
             drop_threshold, keep_div, seed, dtype, Route::kDq, stream);
}

// Flash-attention backward (recompute) for Hopper (sm_90a): the fused
// kernel and the two kernels of the split route.
//
// Fused: replaces the TPU kernel apex_tpu/contrib/multihead_attn/flash.py
// `_bwd_fused_kernel` (reached through `_flash_bwd_fused`): from q (BH, Sq,
// D) pre-scaled, k/v (BH, Sk, D), the fp32 bias (1|B, 1|Sq, Sk), the
// forward's lse (BH, Sq) and delta = rowsum(dO * O) (BH, Sq), one recompute
// of P per (q tile, k tile) feeds all three gradients:
//   P  = exp(q k^T + bias - lse)        (causal: col > row gives P = 0)
//   Pd = P * keep / (1 - rate)          (keep: the forward's dropout hash)
//   dV += Pd^T dO
//   dP = (dO v^T) * keep / (1 - rate)
//   dS = P * (dP - delta)
//   dK += dS^T q
//   dQ partial[bh, k tile] = dS k       (fp32, summed over k tiles outside)
// Dead rows (lse = +1e30) and masked scores give P = 0.  Ragged Sq / Sk are
// masked inside the kernel.  The dq partials are the TPU layout (BH, nk,
// Sq, D) with nk = ceil(Sk / 64): every (k tile, q tile) block is written
// exactly once (zeros for a causal-skipped one), so the sum is
// deterministic and there are no atomics.
//
// What bounds it: at the training shape (BH 128, S 512, D 64, bf16) the
// five matrix products are 21.5 GFLOP (~22 us of tensor-core time) against
// ~59 MB of inputs and outputs (~18 us): operations, narrowly.  The dq
// partials are the trap: 128 x 8 x 512 x 64 x 4 B = 134 MB written here and
// read again by the sum, several times the kernel's own minimum traffic.
// Wider k tiles (fewer partials) or atomic dq are later work.
//
// Design:
//   * bf16: one CTA of 4 warps per (bh, 64-key tile); k and v of the tile,
//     and each 64-row q / dO tile in turn, sit in padded shared memory.
//     Each warp owns 16 keys: S^T and dP^T (16 keys x 64 q rows) run on
//     mma.sync.m16n8k16 (bf16 in, fp32 accumulate) with k / v as A
//     fragments; Pd and dS go from the accumulators straight into A
//     fragments for dV and dK, which stay in registers (fp32) across the q
//     sweep.  dS goes to shared memory once (bf16) so that each warp can
//     take 16 q rows of dQ = dS k.  The bf16 roundings of Pd and dS before
//     their products are the TPU kernel's (`astype(do.dtype)` etc.).
//   * fp32 (the numerics oracle): one CTA of 256 threads per (bh, 64-key
//     tile), q tiles of 32 rows, scalar FMA out of shared memory.
// Both use dynamic shared memory (up to ~113 KB for fp32 at D = 128).
//
// Split route, taken where the dq partials would pass the wrapper's byte
// cap (long sequences: BH 64 x 4096 x 4096 x 64 gives 4.3 GB of them):
//   * dk/dv: replaces `_bwd_dkv_kernel` (via `_flash_bwd_dkv`).  It is the
//     fused kernel above with its dq work compiled out (template flag
//     kEmitDq = false): the same recompute and the same dropout draw.
//   * dq: replaces `_bwd_dq_kernel` (via `_flash_bwd_dq`).  One CTA per
//     (bh, query tile) walks the k tiles, skipping those a causal mask
//     hides wholly: S = q k^T and dP = dO v^T, P = exp(S + bias - lse) (a
//     dead row, lse = +1e30, gives 0), dS = P * (dP * keep / (1 - rate) -
//     delta) rounded to the input dtype (the TPU kernel's
//     `ds.astype(k.dtype)`), dQ += dS k in fp32 registers, written once in
//     q's dtype.  bf16: the forward's Hopper design (`sm90_attn.cuh`): the
//     first warp of a producer warpgroup keeps TMA loads of 64-key k and v
//     tiles and their key bias in flight through a 2-stage mbarrier ring
//     after loading q and dO once; one or two consumer warpgroups of 64
//     query rows (the register split and the tile choice as the forward's)
//     run S and dP on wgmma from swizzled shared memory, turn them into dS
//     in registers in exp2 (the key bias read once per tile, the causal
//     compare only on tiles crossing the diagonal), and feed dS as the
//     register A operand of dQ += dS k with k's tile as an MN-major B.
//     fp32: 256 threads of scalar FMA, dS through shared memory.
// What bounds them: operations.  At BH 64 x 4096 x 4096 x 64 bf16 dq is
// 6 BH Sq Sk D = 412 GFLOP (0.42 ms at 989 TFLOP/s) against ~170 MB of
// inputs and outputs (0.05 ms); dk/dv 8 BH Sq Sk D = 550 GFLOP (0.56 ms).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dropout.cuh"
#include "sm90_attn.cuh"

namespace {

using sm90::kNegInf;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kBk = 64;  // keys per CTA, both kernels (the dq-partial tile)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* bias;
  const float* lse;    // (bh, sq)
  const float* delta;  // (bh, sq)
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
__device__ __forceinline__ float prob(const Params& p, float s, float lse,
                                      int bh, int row, int col) {
  if (row >= p.sq || col >= p.sk) return 0.f;
  if (p.causal && col > row) return 0.f;
  if (p.bias != nullptr) {
    const int bb = p.bias_b == 1 ? 0 : bh / p.heads;
    const int br = p.bias_q == 1 ? 0 : row;
    s += p.bias[((size_t)bb * p.bias_q + br) * p.sk + col];
  }
  return expf(s - lse);
}

// Dropout factor of (row, col): keep / (1 - rate), or 1 without dropout.
__device__ __forceinline__ float keep_factor(const Params& p, int bh, int row,
                                             int col) {
  if (p.drop_threshold == 0u) return 1.f;
  return dropout_keep(p.seed, bh, row, col, p.drop_threshold)
             ? 1.f / p.keep_div : 0.f;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync.m16n8k16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaBq = 64;  // q rows per step
constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_raw(__nv_bfloat16 lo,
                                                  __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment of rows r0..r0+15, cols c0..c0+15 of a row-major bf16 tile.
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const __nv_bfloat16* tile, int stride,
                                       int r0, int c0, int g, int t) {
  const __nv_bfloat16* base = tile + (r0 + g) * stride + c0 + 2 * t;
  a[0] = ld32(base);
  a[1] = ld32(base + 8 * stride);
  a[2] = ld32(base + 8);
  a[3] = ld32(base + 8 * stride + 8);
}

// B fragment (k = rows k0..k0+15, n = cols n0..n0+7) of a row-major tile
// whose rows are the reduction index.
__device__ __forceinline__ void load_b_rows(uint32_t& b0, uint32_t& b1,
                                            const __nv_bfloat16* tile,
                                            int stride, int k0, int n0, int g,
                                            int t) {
  const __nv_bfloat16* r = tile + (k0 + 2 * t) * stride + n0 + g;
  b0 = pack_bf16_raw(r[0], r[stride]);
  b1 = pack_bf16_raw(r[8 * stride], r[9 * stride]);
}

// Copy rows [r0, r0 + rows) of a (n_rows, D) bf16 matrix into a padded
// shared tile, zeros past n_rows.
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, int stride,
                                          const __nv_bfloat16* src, int r0,
                                          int rows, int n_rows, int tid,
                                          int threads) {
  constexpr int kVecPerRow = D / 8;
  for (int i = tid; i < rows * kVecPerRow; i += threads) {
    const int r = i / kVecPerRow;
    const int c = (i % kVecPerRow) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < n_rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c);
    *reinterpret_cast<uint4*>(dst + r * stride + c) = val;
  }
}

template <int D, bool kEmitDq>
constexpr int mma_smem_bytes() {
  return (2 * kBk * (D + 8) + 2 * kMmaBq * (D + 8) +
          (kEmitDq ? kMmaBq * (kBk + 8) : 0)) * 2 +
         2 * kMmaBq * 4;
}

// kEmitDq: the fused kernel (dk, dv and the dq partials); without it, the
// split route's dk/dv kernel.
template <int D, bool kEmitDq>
__global__ void __launch_bounds__(kMmaThreads)
flash_bwd_mma_kernel(Params p) {
  constexpr int kStride = D + 8;      // padded smem row (bf16 elements)
  constexpr int kDsStride = kBk + 8;  // dS tile row: keys
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* vs = ks + kBk * kStride;
  __nv_bfloat16* qs = vs + kBk * kStride;
  __nv_bfloat16* dos = qs + kMmaBq * kStride;
  __nv_bfloat16* dss = dos + kMmaBq * kStride;  // dS[q][key] (kEmitDq)
  float* lse_s = reinterpret_cast<float*>(
      kEmitDq ? dss + kMmaBq * kDsStride : dss);
  float* delta_s = lse_s + kMmaBq;

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  const __nv_bfloat16* dout = static_cast<const __nv_bfloat16*>(p.dout);

  const int bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * kBk;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int kr = warp * 16;  // this warp's keys in the tile (dK, dV rows)
  const int qw = warp * 16;  // this warp's q rows of a q tile (dQ rows)

  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;
  float* dqp = kEmitDq ? p.dq_part + ((size_t)bh * p.nk + kt) * p.sq * D
                       : nullptr;

  load_tile<D>(ks, kStride, k + kbase, k0, kBk, p.sk, tid, kMmaThreads);
  load_tile<D>(vs, kStride, v + kbase, k0, kBk, p.sk, tid, kMmaThreads);

  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qt = (p.sq + kMmaBq - 1) / kMmaBq;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kMmaBq;
    if (p.causal && q0 + kMmaBq - 1 < k0) {
      // every (row, col) of this step is above the diagonal: the step still
      // owns its dq-partial block, which must be defined
      if (!kEmitDq) continue;
      for (int i = tid; i < kMmaBq * D / 4; i += kMmaThreads) {
        const int r = i / (D / 4);
        const int c = (i % (D / 4)) * 4;
        if (q0 + r < p.sq)
          *reinterpret_cast<float4*>(dqp + (size_t)(q0 + r) * D + c) =
              make_float4(0.f, 0.f, 0.f, 0.f);
      }
      continue;
    }
    __syncthreads();  // the previous step's tiles fully consumed
    load_tile<D>(qs, kStride, q + qbase, q0, kMmaBq, p.sq, tid, kMmaThreads);
    load_tile<D>(dos, kStride, dout + qbase, q0, kMmaBq, p.sq, tid,
                 kMmaThreads);
    for (int r = tid; r < kMmaBq; r += kMmaThreads) {
      const bool in = q0 + r < p.sq;
      lse_s[r] = in ? p.lse[(size_t)bh * p.sq + q0 + r] : -kNegInf;
      delta_s[r] = in ? p.delta[(size_t)bh * p.sq + q0 + r] : 0.f;
    }
    __syncthreads();

    // S^T = k q^T and dP^T = v dO^T for this warp's 16 keys x 64 q rows
    float st[kMmaBq / 8][4], dpt[kMmaBq / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaBq / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t ka[4], va[4];
      load_a(ka, ks, kStride, kr, kk * 16, g, t);
      load_a(va, vs, kStride, kr, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < kMmaBq / 8; ++j) {
        const __nv_bfloat16* qr = qs + (j * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_bf16(st[j], ka, ld32(qr), ld32(qr + 8));
        const __nv_bfloat16* dr = dos + (j * 8 + g) * kStride + kk * 16 + 2 * t;
        mma_bf16(dpt[j], va, ld32(dr), ld32(dr + 8));
      }
    }

    // P, Pd and dS in place: st <- Pd^T, dpt <- dS^T
#pragma unroll
    for (int j = 0; j < kMmaBq / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key_l = kr + g + (e >= 2 ? 8 : 0);
        const int q_l = j * 8 + 2 * t + (e & 1);
        const int row = q0 + q_l, col = k0 + key_l;
        const float pr = prob(p, st[j][e], lse_s[q_l], bh, row, col);
        const float kf = keep_factor(p, bh, row, col);
        st[j][e] = pr * kf;
        dpt[j][e] = pr * (dpt[j][e] * kf - delta_s[q_l]);
        if (kEmitDq) dss[q_l * kDsStride + key_l] = __float2bfloat16(dpt[j][e]);
      }
    }

    // dV += Pd^T dO and dK += dS^T q, reducing over this step's 64 q rows
#pragma unroll
    for (int kk = 0; kk < kMmaBq / 16; ++kk) {
      uint32_t pa[4], sa[4];
      pa[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
      pa[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
      pa[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
      pa[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
      sa[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
      sa[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
      sa[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
      sa[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, dos, kStride, kk * 16, n * 8, g, t);
        mma_bf16(dv_acc[n], pa, b0, b1);
        load_b_rows(b0, b1, qs, kStride, kk * 16, n * 8, g, t);
        mma_bf16(dk_acc[n], sa, b0, b1);
      }
    }
    if (!kEmitDq) continue;
    __syncthreads();  // dS of all four warps in shared memory

    // dQ partial = dS k for this warp's 16 q rows, reducing over 64 keys
    float dq[D / 8][4];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t a[4];
      load_a(a, dss, kDsStride, qw, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, ks, kStride, kk * 16, n * 8, g, t);
        mma_bf16(dq[n], a, b0, b1);
      }
    }
    const int row_a = q0 + qw + g, row_b = row_a + 8;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      if (row_a < p.sq)
        *reinterpret_cast<float2*>(dqp + (size_t)row_a * D + n * 8 + 2 * t) =
            make_float2(dq[n][0], dq[n][1]);
      if (row_b < p.sq)
        *reinterpret_cast<float2*>(dqp + (size_t)row_b * D + n * 8 + 2 * t) =
            make_float2(dq[n][2], dq[n][3]);
    }
  }

  __nv_bfloat16* dk = static_cast<__nv_bfloat16*>(p.dk);
  __nv_bfloat16* dv = static_cast<__nv_bfloat16*>(p.dv);
  const int key_a = k0 + kr + g, key_b = key_a + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (key_a < p.sk) {
      *reinterpret_cast<uint32_t*>(dk + kbase + (size_t)key_a * D + c) =
          pack_bf16(dk_acc[n][0], dk_acc[n][1]);
      *reinterpret_cast<uint32_t*>(dv + kbase + (size_t)key_a * D + c) =
          pack_bf16(dv_acc[n][0], dv_acc[n][1]);
    }
    if (key_b < p.sk) {
      *reinterpret_cast<uint32_t*>(dk + kbase + (size_t)key_b * D + c) =
          pack_bf16(dk_acc[n][2], dk_acc[n][3]);
      *reinterpret_cast<uint32_t*>(dv + kbase + (size_t)key_b * D + c) =
          pack_bf16(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar-FMA kernel (the numerics oracle's path)
// ---------------------------------------------------------------------------

constexpr int kSimtBq = 32;  // q rows per step
constexpr int kSimtThreads = 256;
constexpr int kSimtGroups = kSimtThreads / kBk;  // 4 thread groups of 64

template <int D>
constexpr int simt_smem_bytes() {
  return (2 * kBk * (D + 1) + 2 * kSimtBq * (D + 1) + 2 * kSimtBq * (kBk + 1) +
          2 * kSimtBq) * 4;
}

template <int D, bool kEmitDq>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_simt_kernel(Params p) {
  constexpr int kS = D + 1;    // +1: lane-per-key reads hit distinct banks
  constexpr int kP = kBk + 1;
  constexpr int kPerThread = D / kSimtGroups;  // dK / dV columns a thread owns
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + kBk * kS;
  float* qs = vs + kBk * kS;
  float* dos = qs + kSimtBq * kS;
  float* pds = dos + kSimtBq * kS;  // Pd[q][key]
  float* dss = pds + kSimtBq * kP;  // dS[q][key]
  float* lse_s = dss + kSimtBq * kP;
  float* delta_s = lse_s + kSimtBq;

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);

  const int bh = blockIdx.y;
  const int kt = blockIdx.x;
  const int k0 = kt * kBk;
  const int tid = threadIdx.x;
  const int key_l = tid % kBk;
  const int grp = tid / kBk;  // one value per warp: broadcast reads
  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;
  float* dqp = kEmitDq ? p.dq_part + ((size_t)bh * p.nk + kt) * p.sq * D
                       : nullptr;

  for (int i = tid; i < kBk * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    const bool in = k0 + r < p.sk;
    ks[r * kS + c] = in ? k[kbase + (size_t)(k0 + r) * D + c] : 0.f;
    vs[r * kS + c] = in ? v[kbase + (size_t)(k0 + r) * D + c] : 0.f;
  }

  float dk_acc[kPerThread], dv_acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) dk_acc[j] = dv_acc[j] = 0.f;

  const int n_qt = (p.sq + kSimtBq - 1) / kSimtBq;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kSimtBq;
    if (p.causal && q0 + kSimtBq - 1 < k0) {
      if (!kEmitDq) continue;
      for (int i = tid; i < kSimtBq * D; i += kSimtThreads) {
        const int r = i / D;
        if (q0 + r < p.sq) dqp[(size_t)(q0 + r) * D + i % D] = 0.f;
      }
      continue;
    }
    __syncthreads();
    for (int i = tid; i < kSimtBq * D; i += kSimtThreads) {
      const int r = i / D, c = i % D;
      const bool in = q0 + r < p.sq;
      qs[r * kS + c] = in ? q[qbase + (size_t)(q0 + r) * D + c] : 0.f;
      dos[r * kS + c] = in ? dout[qbase + (size_t)(q0 + r) * D + c] : 0.f;
    }
    for (int r = tid; r < kSimtBq; r += kSimtThreads) {
      const bool in = q0 + r < p.sq;
      lse_s[r] = in ? p.lse[(size_t)bh * p.sq + q0 + r] : -kNegInf;
      delta_s[r] = in ? p.delta[(size_t)bh * p.sq + q0 + r] : 0.f;
    }
    __syncthreads();

    for (int q_l = grp; q_l < kSimtBq; q_l += kSimtGroups) {
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[q_l * kS + d], ks[key_l * kS + d], s);
        dp = fmaf(dos[q_l * kS + d], vs[key_l * kS + d], dp);
      }
      const int row = q0 + q_l, col = k0 + key_l;
      const float pr = prob(p, s, lse_s[q_l], bh, row, col);
      const float kf = keep_factor(p, bh, row, col);
      pds[q_l * kP + key_l] = pr * kf;
      dss[q_l * kP + key_l] = pr * (dp * kf - delta_s[q_l]);
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const int d = grp + kSimtGroups * j;
      float a = dv_acc[j], b = dk_acc[j];
      for (int q_l = 0; q_l < kSimtBq; ++q_l) {
        a = fmaf(pds[q_l * kP + key_l], dos[q_l * kS + d], a);
        b = fmaf(dss[q_l * kP + key_l], qs[q_l * kS + d], b);
      }
      dv_acc[j] = a;
      dk_acc[j] = b;
    }
    if (!kEmitDq) continue;
    for (int i = tid; i < kSimtBq * D; i += kSimtThreads) {
      const int q_l = i / D, d = i % D;
      if (q0 + q_l >= p.sq) continue;
      float s = 0.f;
#pragma unroll 16
      for (int kk = 0; kk < kBk; ++kk)
        s = fmaf(dss[q_l * kP + kk], ks[kk * kS + d], s);
      dqp[(size_t)(q0 + q_l) * D + d] = s;
    }
  }

  float* dk = static_cast<float*>(p.dk);
  float* dv = static_cast<float*>(p.dv);
  if (k0 + key_l < p.sk) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j) {
      const size_t o = kbase + (size_t)(k0 + key_l) * D + grp + kSimtGroups * j;
      dk[o] = dk_acc[j];
      dv[o] = dv_acc[j];
    }
  }
}

// ---------------------------------------------------------------------------
// the split route's dq kernels
// ---------------------------------------------------------------------------

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
using DqCfg = sm90::RingCfg<D, C, 64, 2>;

template <int D, int C>
__global__ void __launch_bounds__(DqCfg<D, C>::kThreads, 1)
flash_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap qmap,
                         const __grid_constant__ CUtensorMap domap,
                         const __grid_constant__ CUtensorMap kmap,
                         const __grid_constant__ CUtensorMap vmap, Params p) {
  using Cfg = DqCfg<D, C>;
  using T = sm90::Tile<D>;
  using sm90::kLog2e;
  constexpr int kBq = Cfg::kBq, kBk = Cfg::kBk;
  extern __shared__ unsigned char smem_raw[];
  const sm90::Ring<Cfg> ring(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int n_qt = (p.sq + kBq - 1) / kBq;
  // causal: the longest rows first, so the grid's tail is short tiles
  const int q0 = (p.causal ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x) * kBq;
  const int n_kt = dq_k_tiles(p, q0, kBq, kBk);
  const float* bias_rows = p.bias + (size_t)(p.bias_b == 1 ? 0 : bh / p.heads) * p.bias_q * p.sk;
  const bool full_bias = p.bias_q != 1;

  ring.init();
  if (warp >= 4 * C) {
    // ---- producer: q and dO once, then k/v tiles and their key bias
    sm90::producer_release_registers();
    if (warp == 4 * C) {
      const CUtensorMap* qmaps[2] = {&qmap, &domap};
      ring.produce(qmaps, &kmap, &vmap, full_bias ? nullptr : bias_rows, p.sk,
                   q0, bh, n_kt, lane);
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
  // lse in log2 units; a row past Sq reads as dead (P = 0)
  const float lse_a = (row_a < p.sq ? p.lse[(size_t)bh * p.sq + row_a] : -kNegInf) * kLog2e;
  const float lse_b = (row_b < p.sq ? p.lse[(size_t)bh * p.sq + row_b] : -kNegInf) * kLog2e;
  const float del_a = row_a < p.sq ? p.delta[(size_t)bh * p.sq + row_a] : 0.f;
  const float del_b = row_b < p.sq ? p.delta[(size_t)bh * p.sq + row_b] : 0.f;
  const float inv_keep = 1.f / p.keep_div;
  const uint32_t q_addr = ring.q_addr(0);
  const uint32_t do_addr = ring.q_addr(1);

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

  ring.wait_q();
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBk;
    ring.wait_full(kt);
    const uint32_t k_addr = ring.k_addr(kt);

    // S = q k^T and dP = dO v^T: 64 rows x kBk keys each, reducing over D
    float s[kBk / 2], dp[kBk / 2];
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      sm90::Wgmma<kBk>::ss(s, T::kmajor(q_addr, kBq, wg * 64, kk),
                           T::kmajor(k_addr, kBk, 0, kk), kk > 0);
      sm90::Wgmma<kBk>::ss(dp, T::kmajor(do_addr, kBq, wg * 64, kk),
                           T::kmajor(ring.v_addr(kt), kBk, 0, kk), kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    sm90::mask_scores<kBk>(s, ring.key_bias(kt), full_bias ? bias_rows : nullptr,
                           p.causal && k0 + kBk - 1 > wg_row0, row_a, k0, t,
                           p.sq, p.sk);

    // P = exp(S + bias - lse), dS = P * (dP * keep / (1 - rate) - delta)
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool lo = e < 2;
        const float pr = exp2f(fmaf(s[4 * j + e], kLog2e, -(lo ? lse_a : lse_b)));
        float kf = 1.f;
        if (p.drop_threshold != 0u)
          kf = dropout_keep(p.seed, bh, lo ? row_a : row_b, k0 + j * 8 + 2 * t + (e & 1),
                            p.drop_threshold) ? inv_keep : 0.f;
        s[4 * j + e] = pr * (dp[4 * j + e] * kf - (lo ? del_a : del_b));
      }
    }

    // dQ += dS k: dS rounds to bf16 here (the TPU kernel's
    // `ds.astype(k.dtype)`) and leaves the accumulators as A fragments; k is
    // B as it lies, (keys, D), read MN-major
    uint32_t da[kBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] = sm90::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk)
      sm90::Wgmma<D>::rs(dq, da[kk], T::mnmajor(k_addr, kBk, kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(dq);
    ring.release(kt, lane);
  }

  __nv_bfloat16* dq_out = static_cast<__nv_bfloat16*>(p.dq);
  const size_t qbase = (size_t)bh * p.sq * D;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (row_a < p.sq)
      *reinterpret_cast<uint32_t*>(dq_out + qbase + (size_t)row_a * D + c) =
          sm90::pack_bf16(dq[4 * n], dq[4 * n + 1]);
    if (row_b < p.sq)
      *reinterpret_cast<uint32_t*>(dq_out + qbase + (size_t)row_b * D + c) =
          sm90::pack_bf16(dq[4 * n + 2], dq[4 * n + 3]);
  }
}

constexpr int kSimtDqBq = 64;  // query rows per CTA of the fp32 dq kernel

template <int D>
constexpr int dq_simt_smem_bytes() {
  return (2 * kSimtDqBq * (D + 1) + 2 * kBk * (D + 1) + kSimtDqBq * (kBk + 1) +
          2 * kSimtDqBq) * 4;
}

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_bwd_dq_simt_kernel(Params p) {
  constexpr int kS = D + 1;  // +1: lane-per-row reads hit distinct banks
  constexpr int kP = kBk + 1;
  constexpr int kPerThread = kSimtDqBq * D / kSimtThreads;  // dQ values
  constexpr int kGroups = kSimtThreads / kSimtDqBq;         // 4
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + kSimtDqBq * kS;
  float* ks = dos + kSimtDqBq * kS;
  float* vs = ks + kBk * kS;
  float* dss = vs + kBk * kS;  // dS[q][key]
  float* lse_s = dss + kSimtDqBq * kP;
  float* delta_s = lse_s + kSimtDqBq;

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  const float* dout = static_cast<const float*>(p.dout);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kSimtDqBq;
  const int tid = threadIdx.x;
  const int lane_l = tid % kSimtDqBq;  // a key (dS), then a query row (dQ)
  const int grp = tid / kSimtDqBq;     // one value per warp: broadcast reads
  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;

  for (int i = tid; i < kSimtDqBq * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    const bool in = q0 + r < p.sq;
    qs[r * kS + c] = in ? q[qbase + (size_t)(q0 + r) * D + c] : 0.f;
    dos[r * kS + c] = in ? dout[qbase + (size_t)(q0 + r) * D + c] : 0.f;
  }
  for (int r = tid; r < kSimtDqBq; r += kSimtThreads) {
    const bool in = q0 + r < p.sq;
    lse_s[r] = in ? p.lse[(size_t)bh * p.sq + q0 + r] : -kNegInf;
    delta_s[r] = in ? p.delta[(size_t)bh * p.sq + q0 + r] : 0.f;
  }

  float acc[kPerThread];
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) acc[j] = 0.f;

  const int n_kt = dq_k_tiles(p, q0, kSimtDqBq, kBk);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();
    for (int i = tid; i < kBk * D; i += kSimtThreads) {
      const int r = i / D, c = i % D;
      const bool in = k0 + r < p.sk;
      ks[r * kS + c] = in ? k[kbase + (size_t)(k0 + r) * D + c] : 0.f;
      vs[r * kS + c] = in ? v[kbase + (size_t)(k0 + r) * D + c] : 0.f;
    }
    __syncthreads();

    for (int q_l = grp; q_l < kSimtDqBq; q_l += kGroups) {
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s = fmaf(qs[q_l * kS + d], ks[lane_l * kS + d], s);
        dp = fmaf(dos[q_l * kS + d], vs[lane_l * kS + d], dp);
      }
      const int row = q0 + q_l, col = k0 + lane_l;
      const float pr = prob(p, s, lse_s[q_l], bh, row, col);
      const float kf = keep_factor(p, bh, row, col);
      dss[q_l * kP + lane_l] = pr * (dp * kf - delta_s[q_l]);
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

  float* dq_out = static_cast<float*>(p.dq);
  if (q0 + lane_l < p.sq) {
#pragma unroll
    for (int j = 0; j < kPerThread; ++j)
      dq_out[qbase + (size_t)(q0 + lane_l) * D + grp + kGroups * j] = acc[j];
  }
}

using sm90::allow_smem;

// The fused kernel (kEmitDq) or the split route's dk/dv kernel.
template <int D, bool kEmitDq>
cudaError_t launch_kv(const Params& p, int dtype, cudaStream_t stream) {
  static bool mma_ready = false, simt_ready = false;
  dim3 grid(p.nk, p.bh_count);
  cudaError_t err;
  if (dtype == kDtypeBF16) {
    constexpr int bytes = mma_smem_bytes<D, kEmitDq>();
    err = allow_smem(flash_bwd_mma_kernel<D, kEmitDq>, bytes, mma_ready);
    if (err != cudaSuccess) return err;
    flash_bwd_mma_kernel<D, kEmitDq><<<grid, kMmaThreads, bytes, stream>>>(p);
  } else {
    constexpr int bytes = simt_smem_bytes<D>();
    err = allow_smem(flash_bwd_simt_kernel<D, kEmitDq>, bytes, simt_ready);
    if (err != cudaSuccess) return err;
    flash_bwd_simt_kernel<D, kEmitDq><<<grid, kSimtThreads, bytes, stream>>>(p);
  }
  return cudaGetLastError();
}

template <int D, int C>
cudaError_t launch_dq_sm90(const Params& p, cudaStream_t stream) {
  using Cfg = DqCfg<D, C>;
  static bool smem_ready = false;
  cudaError_t err = sm90::allow_smem(flash_bwd_dq_sm90_kernel<D, C>, Cfg::kSmem, smem_ready);
  if (err != cudaSuccess) return err;
  CUtensorMap qm, dom, km, vm;
  if ((err = sm90::encode_map<D>(&qm, p.q, p.sq, p.bh_count, Cfg::kBq)) != cudaSuccess ||
      (err = sm90::encode_map<D>(&dom, p.dout, p.sq, p.bh_count, Cfg::kBq)) != cudaSuccess ||
      (err = sm90::encode_map<D>(&km, p.k, p.sk, p.bh_count, Cfg::kBk)) != cudaSuccess ||
      (err = sm90::encode_map<D>(&vm, p.v, p.sk, p.bh_count, Cfg::kBk)) != cudaSuccess)
    return err;
  dim3 grid((p.sq + Cfg::kBq - 1) / Cfg::kBq, p.bh_count);
  flash_bwd_dq_sm90_kernel<D, C><<<grid, Cfg::kThreads, Cfg::kSmem, stream>>>(qm, dom, km, vm, p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == kDtypeBF16)
    return sm90::consumer_groups(p.sq, p.bh_count) == 2 ? launch_dq_sm90<D, 2>(p, stream)
                                                        : launch_dq_sm90<D, 1>(p, stream);
  static bool simt_ready = false;
  constexpr int bytes = dq_simt_smem_bytes<D>();
  const cudaError_t err = allow_smem(flash_bwd_dq_simt_kernel<D>, bytes, simt_ready);
  if (err != cudaSuccess) return err;
  dim3 grid((p.sq + kSimtDqBq - 1) / kSimtDqBq, p.bh_count);
  flash_bwd_dq_simt_kernel<D><<<grid, kSimtThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

enum class Route { kFused, kDkv, kDq };

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
        const void* dout, const void* lse, const void* delta, void* dq_part,
        void* dq, void* dk, void* dv, int bh_count, int sq, int sk, int d,
        int heads, int bias_b, int bias_q, int causal,
        unsigned int drop_threshold, float keep_div, int seed, int dtype,
        Route route, void* stream) {
  if (bh_count <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || bh_count > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != kDtypeF32 && dtype != kDtypeBF16) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.bias = static_cast<const float*>(bias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq_part = static_cast<float*>(dq_part);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.bh_count = bh_count;
  p.sq = sq;
  p.sk = sk;
  p.heads = heads;
  p.nk = (sk + kBk - 1) / kBk;
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
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, dout (bh, sq, d), k/v (bh, sk, d), dk/dv (bh, sk, d): contiguous,
// 16-byte aligned, of `dtype`.  bias: fp32 (bias_b, bias_q, sk) or null.
// lse, delta: fp32 (bh, sq).  dq_part: fp32 (bh, ceil(sk / 64), sq, d),
// fully written.  d in {32, 64, 128}.  drop_threshold = rate * 2^32 (0 = no
// dropout), keep_div = 1 - rate.  Returns cudaSuccess (0) or the launch
// error.
extern "C" int apex_flash_bwd(const void* q, const void* k, const void* v,
                              const void* bias, const void* dout,
                              const void* lse, const void* delta,
                              void* dq_part, void* dk, void* dv,
                              int bh_count, int sq, int sk, int d, int heads,
                              int bias_b, int bias_q, int causal,
                              unsigned int drop_threshold, float keep_div,
                              int seed, int dtype, void* stream) {
  return run(q, k, v, bias, dout, lse, delta, dq_part, nullptr, dk, dv,
             bh_count, sq, sk, d, heads, bias_b, bias_q, causal,
             drop_threshold, keep_div, seed, dtype, Route::kFused, stream);
}

// The split route's dk/dv: as apex_flash_bwd without the dq partials.
extern "C" int apex_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* bias,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  int bh_count, int sq, int sk, int d,
                                  int heads, int bias_b, int bias_q,
                                  int causal, unsigned int drop_threshold,
                                  float keep_div, int seed, int dtype,
                                  void* stream) {
  return run(q, k, v, bias, dout, lse, delta, nullptr, nullptr, dk, dv,
             bh_count, sq, sk, d, heads, bias_b, bias_q, causal,
             drop_threshold, keep_div, seed, dtype, Route::kDkv, stream);
}

// The split route's dq: (bh, sq, d) of `dtype`, the inputs as above.
extern "C" int apex_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* bias, const void* dout,
                                 const void* lse, const void* delta, void* dq,
                                 int bh_count, int sq, int sk, int d,
                                 int heads, int bias_b, int bias_q,
                                 int causal, unsigned int drop_threshold,
                                 float keep_div, int seed, int dtype,
                                 void* stream) {
  return run(q, k, v, bias, dout, lse, delta, nullptr, dq, nullptr, nullptr,
             bh_count, sq, sk, d, heads, bias_b, bias_q, causal,
             drop_threshold, keep_div, seed, dtype, Route::kDq, stream);
}

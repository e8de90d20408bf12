// Flash-attention forward for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/contrib/multihead_attn/flash.py
// `_fwd_kernel` (reached through `_flash_fwd`): blockwise online-softmax
// attention over q (BH, Sq, D) pre-scaled, k/v (BH, Sk, D), with an additive
// fp32 bias (1|B, 1|Sq, Sk) indexed by bh / heads, causal masking (col <= row,
// masked scores = -1e30), dropout on the probabilities after the denominator
// is accumulated (the squirrel3 hash of flash.py `_dropout_keep` over global
// (bh, row, col) and seed), dead rows (max <= -5e29) written as 0 with
// lse = +1e30.  Emits out (BH, Sq, D) in q's dtype and lse (BH, Sq) fp32.
//
// What bounds it: at the serving shape (BH = 16, S = 512, D = 64, causal,
// bf16) the kernel must move ~4 MB (q, k, v, out) and do ~0.54 GFLOP of
// matrix products, i.e. ~1.3 us of memory traffic against ~0.5 us of tensor
// core work: bytes bound, and short enough that the launch and the tail of
// the grid dominate.  The design keeps the (Sq, Sk) scores out of device
// memory entirely and reads each k/v tile once per q tile:
//   * bf16: one CTA of 4 warps per (bh, 64-row q tile); each warp owns 16 q
//     rows held as mma.sync A fragments in registers; k/v tiles of 64 keys
//     are staged in padded shared memory (no bank conflicts on fragment
//     loads); S = q k^T and O += P v run on mma.sync.m16n8k16 (bf16 in,
//     fp32 accumulate), and P is re-packed from the S accumulators straight
//     into A fragments without touching shared memory;
//   * fp32 (the numerics oracle): one CTA of 4 warps per (bh, 16-row q tile),
//     scalar FMA, one lane per key of a 32-key tile; rows' running max/sum
//     live in registers, the output accumulator in registers (D/32 per lane).
// Tiles wholly above the diagonal are skipped when causal; ragged Sq / Sk
// edges are masked inside the kernel (no padding copies).  Speed work
// (wgmma, TMA, warp specialisation) is for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "dropout.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  void* out;
  float* lse;
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

// ---------------------------------------------------------------------------
// bf16: mma.sync.m16n8k16 tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kMmaBq = 64;   // q rows per CTA (4 warps x 16)
constexpr int kMmaBk = 64;   // keys per k/v tile
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

template <int D>
__global__ void __launch_bounds__(kMmaThreads)
flash_fwd_mma_kernel(Params p) {
  constexpr int kStride = D + 8;  // padded smem row (bf16 elements)
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaBk * kStride];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaBk * kStride];

  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p.q);
  const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(p.k);
  const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(p.v);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaBq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread in group
  const int r0 = q0 + warp * 16;
  const int row_a = r0 + g;       // this thread's two q rows
  const int row_b = r0 + g + 8;

  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;

  // q A-fragments for the whole head dim, kept in registers
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = row_a < p.sq ? *reinterpret_cast<const uint32_t*>(q + qbase + (size_t)row_a * D + c) : 0u;
    qa[kk][1] = row_b < p.sq ? *reinterpret_cast<const uint32_t*>(q + qbase + (size_t)row_b * D + c) : 0u;
    qa[kk][2] = row_a < p.sq ? *reinterpret_cast<const uint32_t*>(q + qbase + (size_t)row_a * D + c + 8) : 0u;
    qa[kk][3] = row_b < p.sq ? *reinterpret_cast<const uint32_t*>(q + qbase + (size_t)row_b * D + c + 8) : 0u;
  }

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int n_tiles = (p.sk + kMmaBk - 1) / kMmaBk;
  if (p.causal) {
    const int last = (q0 + kMmaBq - 1) / kMmaBk + 1;  // tiles with k0 <= q-tile end
    n_tiles = min(n_tiles, last);
  }

  constexpr int kVecPerRow = D / 8;  // 16-byte vectors per k/v row
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kMmaBk;
    __syncthreads();  // previous tile fully consumed
    for (int i = tid; i < kMmaBk * kVecPerRow; i += kMmaThreads) {
      const int r = i / kVecPerRow;
      const int c = (i % kVecPerRow) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < p.sk) {
        kv = *reinterpret_cast<const uint4*>(k + kbase + (size_t)(k0 + r) * D + c);
        vv = *reinterpret_cast<const uint4*>(v + kbase + (size_t)(k0 + r) * D + c);
      }
      *reinterpret_cast<uint4*>(ks + r * kStride + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * kStride + c) = vv;
    }
    __syncthreads();

    // S = q k^T over this tile: 8 n-tiles of 8 keys
    float s[kMmaBk / 8][4];
#pragma unroll
    for (int j = 0; j < kMmaBk / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * kStride + kk * 16 + 2 * t;
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 8);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }

    // bias / masks, then the running max of each of this thread's two rows
    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int j = 0; j < kMmaBk / 8; ++j) {
      const int col = k0 + j * 8 + 2 * t;
      s[j][0] = masked_score(p, s[j][0], bh, row_a, col);
      s[j][1] = masked_score(p, s[j][1], bh, row_a, col + 1);
      s[j][2] = masked_score(p, s[j][2], bh, row_b, col);
      s[j][3] = masked_score(p, s[j][3], bh, row_b, col + 1);
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float sc_a = expf(m_a - mn_a), sc_b = expf(m_b - mn_b);

    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int j = 0; j < kMmaBk / 8; ++j) {
      s[j][0] = expf(s[j][0] - mn_a);
      s[j][1] = expf(s[j][1] - mn_a);
      s[j][2] = expf(s[j][2] - mn_b);
      s[j][3] = expf(s[j][3] - mn_b);
      sum_a += s[j][0] + s[j][1];
      sum_b += s[j][2] + s[j][3];
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
      for (int j = 0; j < kMmaBk / 8; ++j) {
        const uint32_t col = (uint32_t)(k0 + j * 8 + 2 * t);
        s[j][0] = dropout_keep(p.seed, bh, row_a, col, p.drop_threshold) ? s[j][0] / p.keep_div : 0.f;
        s[j][1] = dropout_keep(p.seed, bh, row_a, col + 1, p.drop_threshold) ? s[j][1] / p.keep_div : 0.f;
        s[j][2] = dropout_keep(p.seed, bh, row_b, col, p.drop_threshold) ? s[j][2] / p.keep_div : 0.f;
        s[j][3] = dropout_keep(p.seed, bh, row_b, col + 1, p.drop_threshold) ? s[j][3] / p.keep_div : 0.f;
      }
    }

#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= sc_a;
      o[n][1] *= sc_a;
      o[n][2] *= sc_b;
      o[n][3] *= sc_b;
    }

    // O += P v: P's C-fragments re-packed as A-fragments, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < kMmaBk / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const __nv_bfloat16* v0 = vs + (kk * 16 + 2 * t) * kStride + g;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const __nv_bfloat16* vr = v0 + n * 8;
        const uint32_t b0 = pack_bf16_raw(vr[0], vr[kStride]);
        const uint32_t b1 = pack_bf16_raw(vr[8 * kStride], vr[9 * kStride]);
        mma_bf16(o[n], pa, b0, b1);
      }
    }
  }

  // epilogue: normalise, dead rows -> 0 and lse = +1e30
  const bool dead_a = m_a <= kNegInf / 2, dead_b = m_b <= kNegInf / 2;
  const float sl_a = l_a == 0.f ? 1.f : l_a, sl_b = l_b == 0.f ? 1.f : l_b;
  if (row_a < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = dead_a ? 0.f : o[n][0] / sl_a;
      const float x1 = dead_a ? 0.f : o[n][1] / sl_a;
      *reinterpret_cast<uint32_t*>(out + qbase + (size_t)row_a * D + n * 8 + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0) p.lse[(size_t)bh * p.sq + row_a] = dead_a ? -kNegInf : m_a + logf(sl_a);
  }
  if (row_b < p.sq) {
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const float x0 = dead_b ? 0.f : o[n][2] / sl_b;
      const float x1 = dead_b ? 0.f : o[n][3] / sl_b;
      *reinterpret_cast<uint32_t*>(out + qbase + (size_t)row_b * D + n * 8 + 2 * t) = pack_bf16(x0, x1);
    }
    if (t == 0) p.lse[(size_t)bh * p.sq + row_b] = dead_b ? -kNegInf : m_b + logf(sl_b);
  }
}

// ---------------------------------------------------------------------------
// fp32: scalar-FMA kernel (the numerics oracle's path)
// ---------------------------------------------------------------------------

constexpr int kSimtBq = 16;     // q rows per CTA (4 warps x 4 rows)
constexpr int kSimtBk = 32;     // keys per tile = one per lane
constexpr int kSimtThreads = 128;
constexpr int kSimtRowsPerWarp = kSimtBq / (kSimtThreads / 32);

template <int D>
__global__ void __launch_bounds__(kSimtThreads)
flash_fwd_simt_kernel(Params p) {
  constexpr int kPer = D / 32;  // output columns per lane
  __shared__ float qs[kSimtBq][D];
  __shared__ float ks[kSimtBk][D + 1];  // +1: lane-per-key reads hit distinct banks
  __shared__ float vs[kSimtBk][D];

  const float* q = static_cast<const float*>(p.q);
  const float* k = static_cast<const float*>(p.k);
  const float* v = static_cast<const float*>(p.v);
  float* out = static_cast<float*>(p.out);

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kSimtBq;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t qbase = (size_t)bh * p.sq * D;
  const size_t kbase = (size_t)bh * p.sk * D;

  for (int i = tid; i < kSimtBq * D; i += kSimtThreads) {
    const int r = i / D, c = i % D;
    qs[r][c] = q0 + r < p.sq ? q[qbase + (size_t)(q0 + r) * D + c] : 0.f;
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
      ks[r][c] = in ? k[kbase + (size_t)(k0 + r) * D + c] : 0.f;
      vs[r][c] = in ? v[kbase + (size_t)(k0 + r) * D + c] : 0.f;
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
      out[qbase + (size_t)row * D + lane + 32 * c] = dead ? 0.f : o[rr][c] / sl;
    if (lane == 0) p.lse[(size_t)bh * p.sq + row] = dead ? -kNegInf : m[rr] + logf(sl);
  }
}

template <int D>
cudaError_t launch(const Params& p, int dtype, cudaStream_t stream) {
  if (dtype == kDtypeBF16) {
    dim3 grid((p.sq + kMmaBq - 1) / kMmaBq, p.bh_count);
    flash_fwd_mma_kernel<D><<<grid, kMmaThreads, 0, stream>>>(p);
  } else {
    dim3 grid((p.sq + kSimtBq - 1) / kSimtBq, p.bh_count);
    flash_fwd_simt_kernel<D><<<grid, kSimtThreads, 0, stream>>>(p);
  }
  return cudaGetLastError();
}

}  // namespace

// q (bh, sq, d), k/v (bh, sk, d), out (bh, sq, d): contiguous, 16-byte
// aligned, of `dtype`.  bias: fp32 (bias_b, bias_q, sk) or null.
// lse: fp32 (bh, sq).  d in {32, 64, 128}.  drop_threshold = rate * 2^32
// (0 = no dropout), keep_div = 1 - rate.  Returns cudaSuccess (0) or the
// launch error.
extern "C" int apex_flash_fwd(const void* q, const void* k, const void* v,
                              const void* bias, void* out, void* lse,
                              int bh_count, int sq, int sk, int d, int heads,
                              int bias_b, int bias_q, int causal,
                              unsigned int drop_threshold, float keep_div,
                              int seed, int dtype, void* stream) {
  if (bh_count <= 0 || sq <= 0 || sk <= 0 || heads <= 0 || bh_count > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype != kDtypeF32 && dtype != kDtypeBF16) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.lse = static_cast<float*>(lse);
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
    default: return (int)cudaErrorInvalidValue;
  }
}

// Fused dense layer: out = act(x @ w + b), for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/ops/fused_mlp.py `_kernel` (via
// `fused_dense_act`): x (M, K), w (K, N) in the JAX (in, out) layout, both
// row-major, b (N,) or none, out (M, N) in x's dtype; the product
// accumulates in fp32 and the epilogue (+ b in fp32, then relu
// `max(h, 0)` or sigmoid `1 / (1 + exp(-h))` in fp32, then the cast) runs
// while the accumulator tile is in registers, so the activated output is
// written once and no separate elementwise pass reads it back.
//
// What bounds it: operations.  A layer of the MLP at batch 8192 (8192 x
// 4096 @ 4096 x 4096 in fp16) is 275 GFLOP against 134 MB of traffic, far
// above the card's ~295 FLOP a byte, so the floor is 2 M N K / 989 TFLOP/s
// (0.278 ms there).
//
// Three kernels; the Python wrapper (`ops/fused_mlp.py` `_route`) picks one
// before the launch, and each entry point refuses what its kernel does not
// take:
//   * dense_act_sm90_kernel (`apex_dense_act_sm90`), fp16 / bf16 where TMA
//     takes the operands: K and N multiples of 8 (16-byte row strides), x,
//     w and out 16-byte aligned.  Built as Hopper wants a GEMM: a producer
//     warp keeps TMA loads of x (BM x 64, K-major, 128-byte swizzle) and w
//     (64 x BN as BN / 64 chunks of 64 columns, N-major as it lies: w is
//     never transposed in device memory) in flight through a ring of
//     kSmStages stages guarded by mbarriers (full: the bytes arrived;
//     empty: every consumer warp is done); two consumer warpgroups of 64
//     rows each (setmaxnreg: the producer warpgroup drops to 24 registers,
//     the consumers rise to 240) issue wgmma m64nBNk16 with fp32
//     accumulators, A K-major and B MN-major (the transpose bit), one
//     commit group a stage with the previous stage's group still running.
//     A 128 x 256 tile reads 48 KB a 64-deep step for 4.2 MFLOP, so at the
//     tensor cores' rate the SMs would pull ~11 TB/s out of L2: a cluster
//     of kSmCluster CTAs on vertically neighbouring tiles shares each tile
//     of w, every CTA loading 1 / kSmCluster of its chunks and multicasting
//     them to all, which cuts that traffic by a third at 2.  The grid is
//     persistent (one CTA an SM, whole clusters, walking tile groups in a
//     grouped order: kSmGroupM groups share w's columns while they are in
//     L2), so the producer loads the next tile's stages while the
//     consumers run this tile's epilogue.  The epilogue (bias from a
//     shared-memory vector loaded during the products, activation, cast)
//     writes the tile into a swizzled shared-memory buffer that TMA stores
//     drain while the next tile's products run: every CTA reaches its
//     epilogue at about the same time, and stores from registers stalled
//     the tensor cores behind that burst of writes.  Rows and columns past
//     M, N or K arrive from TMA as zeros and are left out by its stores:
//     the tails need no padding copies and no masks.
//   * dense_act_mma_kernel (`apex_dense_act`), the other fp16 / bf16
//     shapes (ragged K or N, unaligned views): mma.sync m16n8k16, a block
//     of 256 threads (8 warps, 2 x 4) owns a 128 x 128 tile, each warp 64
//     x 32, K in steps of 32 through two shared-memory stages; A with
//     ldmatrix, B (N-contiguous) with ldmatrix.trans; rows padded (40 and
//     136 elements) so the eight 16-byte rows one ldmatrix reads fall in
//     distinct banks.  When K and N are multiples of 8 and the pointers
//     16-byte aligned, tiles are copied with cp.async 16 bytes at a time
//     (zero-fill past the edge); otherwise every element is loaded on its
//     own, guarded.
//   * dense_act_f32_kernel (`apex_dense_act`), fp32: SIMT fmaf, 64 x 64
//     tiles, 4 x 4 outputs a thread.  TF32 would keep ~3 decimal digits and
//     break the fp32 parity with the JAX package.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeF16 = 2;
constexpr int kActNone = 0;
constexpr int kActRelu = 1;
constexpr int kActSigmoid = 2;

// ---- tensor-core kernel (fp16 / bf16) --------------------------------------

constexpr int BM = 128, BN = 128, BK = 32;
constexpr int kThreads = 256;              // 8 warps: 2 along M, 4 along N
constexpr int WM = 64, WN = 32;            // one warp's tile
constexpr int MI = WM / 16, NI = WN / 8;   // m16 x n8 tiles a warp
constexpr int A_LD = BK + 8;               // padded row of the A stage
constexpr int B_LD = BN + 8;               // padded row of the B stage

__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

__device__ __forceinline__ uint32_t bits16(__half v) { return __half_as_ushort(v); }
__device__ __forceinline__ uint32_t bits16(__nv_bfloat16 v) {
  return __bfloat16_as_ushort(v);
}

// bias, then the activation, in fp32 (the TPU kernel's epilogue order);
// relu keeps a NaN, as max(NaN, 0) does in XLA
__device__ __forceinline__ float epilogue(float h, float bias, int act) {
  h += bias;
  if (act == kActRelu) h = h < 0.f ? 0.f : h;
  else if (act == kActSigmoid) h = 1.f / (1.f + expf(-h));
  return h;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 zero-fills (past the edge)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

template <typename T> struct Mma;
template <> struct Mma<__half> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};
template <> struct Mma<__nv_bfloat16> {
  static __device__ __forceinline__ void run(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// One K-step's tiles of x (BM x BK) and w (BK x BN) into stage buffers.
// kVec: cp.async of 16-byte chunks (needs K, N multiples of 8 and aligned
// pointers; a chunk is wholly inside or wholly past the edge).  Otherwise
// guarded loads of single elements.
template <typename T, bool kVec>
__device__ __forceinline__ void load_tiles(T* As, T* Bs, const T* x,
                                           const T* w, int m, int n, int k,
                                           int m0, int n0, int k0) {
  const int tid = threadIdx.x;
  if (kVec) {
#pragma unroll
    for (int c = tid; c < BM * BK / 8; c += kThreads) {  // 512 chunks
      const int r = c / (BK / 8), col = (c % (BK / 8)) * 8;
      const int gr = m0 + r, gc = k0 + col;
      const bool ok = gr < m && gc < k;
      const T* src = ok ? x + (int64_t)gr * k + gc : x;
      cp_async16(As + r * A_LD + col, src, ok ? 16 : 0);
    }
#pragma unroll
    for (int c = tid; c < BK * BN / 8; c += kThreads) {  // 512 chunks
      const int r = c / (BN / 8), col = (c % (BN / 8)) * 8;
      const int gr = k0 + r, gc = n0 + col;
      const bool ok = gr < k && gc < n;
      const T* src = ok ? w + (int64_t)gr * n + gc : w;
      cp_async16(Bs + r * B_LD + col, src, ok ? 16 : 0);
    }
  } else {
    const T zero = from_f32<T>(0.f);
    for (int e = tid; e < BM * BK; e += kThreads) {
      const int r = e / BK, col = e % BK;
      const int gr = m0 + r, gc = k0 + col;
      As[r * A_LD + col] = (gr < m && gc < k) ? x[(int64_t)gr * k + gc] : zero;
    }
    for (int e = tid; e < BK * BN; e += kThreads) {
      const int r = e / BN, col = e % BN;
      const int gr = k0 + r, gc = n0 + col;
      Bs[r * B_LD + col] = (gr < k && gc < n) ? w[(int64_t)gr * n + gc] : zero;
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
dense_act_mma_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const T* __restrict__ b, T* __restrict__ out, int m,
                     int n, int k, int act) {
  __shared__ __align__(16) T As[2][BM * A_LD];
  __shared__ __align__(16) T Bs[2][BK * B_LD];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = (warp / 4) * WM, wn = (warp % 4) * WN;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  const int k_tiles = (k + BK - 1) / BK;
  load_tiles<T, kVec>(As[0], Bs[0], x, w, m, n, k, m0, n0, 0);
  cp_async_commit();
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < k_tiles) {
      load_tiles<T, kVec>(As[cur ^ 1], Bs[cur ^ 1], x, w, m, n, k, m0, n0,
                          (kt + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* A = As[cur];
    const T* B = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t af[MI][4];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        // lanes 0-15 address rows 0-15 at k, lanes 16-31 the same rows at
        // k + 8: the four 8 x 8 tiles of the m16k16 A fragment
        const int row = wm + i * 16 + (lane & 15);
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(af[i], A + row * A_LD + col);
      }
#pragma unroll
      for (int j = 0; j < NI; j += 2) {
        // lanes 0-15 address k rows kk..kk+15 at n, lanes 16-31 the same
        // rows at n + 8; transposed, they are the k16n8 B fragments of
        // two neighbouring n8 tiles
        uint32_t bf[4];
        const int krow = kk + (lane & 15);
        const int col = wn + j * 8 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bf, B + krow * B_LD + col);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          Mma<T>::run(acc[i][j], af[i], bf[0], bf[1]);
          Mma<T>::run(acc[i][j + 1], af[i], bf[2], bf[3]);
        }
      }
    }
    __syncthreads();   // the stage is overwritten by the next load
  }

  // epilogue: accumulator (row g / g + 8, cols 2 t, 2 t + 1) of each tile
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; ++j) {
    const int col = n0 + wn + j * 8 + 2 * t;
    const float b0 = (b != nullptr && col < n) ? to_f32(b[col]) : 0.f;
    const float b1 = (b != nullptr && col + 1 < n) ? to_f32(b[col + 1]) : 0.f;
#pragma unroll
    for (int i = 0; i < MI; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + i * 16 + g + half * 8;
        if (row >= m) continue;
        const T v0 = from_f32<T>(epilogue(acc[i][j][2 * half], b0, act));
        const T v1 = from_f32<T>(epilogue(acc[i][j][2 * half + 1], b1, act));
        T* o = out + (int64_t)row * n + col;
        if (kVec) {        // n even and col even: one aligned pair
          if (col < n)
            *reinterpret_cast<uint32_t*>(o) = bits16(v0) | (bits16(v1) << 16);
        } else {
          if (col < n) o[0] = v0;
          if (col + 1 < n) o[1] = v1;
        }
      }
    }
  }
}

// ---- TMA + wgmma kernel (fp16 / bf16) --------------------------------------

// The output tile (BM rows: two consumer warpgroups of 64; BN columns), the
// K step (64 elements: one 128-byte swizzle row of x and the rows of w's
// chunks), the ring's stages, the row tiles walked together (grouped order;
// 1 walks the tiles row by row), and the CTAs of a cluster: kSmCluster
// vertically neighbouring tiles share one tile of w, each CTA loading
// 1 / kSmCluster of its chunks and multicasting them to all.
// `chip_smoke.py --variants` times the other choices.
constexpr int kSmBM = 128;
constexpr int kSmBN = 256;
constexpr int kSmBK = 64;
constexpr int kSmStages = 3;
constexpr int kSmGroupM = 8;
constexpr int kSmCluster = 2;
constexpr int kSmThreads = 384;  // two consumer warpgroups, one producer

// A stage: x's BM x 64 box, then w's BN / 64 boxes of 64 k-rows x 64
// columns, each 1024-byte aligned (the 128-byte swizzle's period).  After
// the stages, the output tile as BN / 64 boxes of BM rows x 64 columns in
// the same swizzle (what the TMA store reads); the full and empty barriers
// of every stage; the tile's bias in fp32.
struct SmLayout {
  static constexpr int kABytes = kSmBM * kSmBK * 2;
  static constexpr int kBChunkBytes = kSmBK * 64 * 2;
  static constexpr int kBChunks = kSmBN / 64;
  static constexpr int kStageBytes = kABytes + kBChunks * kBChunkBytes;
  static constexpr int kOutOff = kSmStages * kStageBytes;
  static constexpr int kOutChunkBytes = kSmBM * 64 * 2;
  static constexpr int kBarOff = kOutOff + kBChunks * kOutChunkBytes;
  static constexpr int kBiasOff = kBarOff + 2 * kSmStages * 8;
  static constexpr int kSmem = 1024 + kBiasOff + kSmBN * 4;
};

// The output tile of CTA `rank` of a cluster for the cluster's `job`-th
// tile group: groups are kSmCluster row tiles x one column tile, walked in
// the grouped order (kSmGroupM groups down the rows, then the next column).
__device__ __forceinline__ void tile_coords(int job, int groups_m, int tiles_n,
                                            int rank, int& m0, int& n0) {
  const int per_band = kSmGroupM * tiles_n;
  const int first = job / per_band * kSmGroupM;
  const int rows = min(groups_m - first, kSmGroupM);
  const int in = job % per_band;
  m0 = ((first + in % rows) * kSmCluster + rank) * kSmBM;
  n0 = in / rows * kSmBN;
}

template <typename T>
__global__ void __launch_bounds__(kSmThreads, 1)
dense_act_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                      const __grid_constant__ CUtensorMap wmap,
                      const __grid_constant__ CUtensorMap outmap,
                      const T* __restrict__ b, int m, int n, int k, int act) {
  using L = SmLayout;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (sm90::smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBarOff);
  uint64_t* empty = full + kSmStages;
  float* bias_s = reinterpret_cast<float*>(smem + L::kBiasOff);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = kSmCluster > 1 ? (int)sm90::cluster_rank() : 0;
  const int cluster = blockIdx.x / kSmCluster;
  const int clusters = gridDim.x / kSmCluster;
  const int groups_m = (m + kSmCluster * kSmBM - 1) / (kSmCluster * kSmBM);
  const int tiles_n = (n + kSmBN - 1) / kSmBN;
  const int jobs = groups_m * tiles_n;
  const int k_steps = (k + kSmBK - 1) / kSmBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSmStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      // one arrival per consumer warp of every CTA the stage's w feeds
      sm90::mbar_init(&empty[s], 8 * kSmCluster);
    }
    sm90::mbar_fence_init();
  }
  if constexpr (kSmCluster > 1) sm90::cluster_sync();
  else __syncthreads();

  if (warp >= 8) {
    // ---- producer: one thread issues every load; stage i of the CTA's
    // sequence lives in slot i % kSmStages, its barriers' phase (i /
    // kSmStages) & 1.  The slot is free once the consumers of every CTA
    // of the cluster are done with it: w's chunks land in all of them.
    sm90::producer_release_registers();
    if (warp == 8 && lane == 0) {
      int i = 0;
      for (int job = cluster; job < jobs; job += clusters) {
        int m0, n0;
        tile_coords(job, groups_m, tiles_n, rank, m0, n0);
        // a row tile past M (a cluster's last) loads no x, and w's chunks
        // wholly past N are not loaded: those outputs are never stored
        const int a_bytes = m0 < m ? L::kABytes : 0;
        const int chunks = min(L::kBChunks, (n - n0 + 63) / 64);
        for (int ks = 0; ks < k_steps; ++ks, ++i) {
          const int s = i % kSmStages;
          unsigned char* st = smem + s * L::kStageBytes;
          sm90::mbar_wait(&empty[s], ((i / kSmStages) & 1) ^ 1);
          sm90::mbar_expect_tx(&full[s], a_bytes + chunks * L::kBChunkBytes);
          if (a_bytes) sm90::tma_load_2d(st, &xmap, ks * kSmBK, m0, &full[s]);
          for (int c = rank; c < chunks; c += kSmCluster) {
            unsigned char* dst = st + L::kABytes + c * L::kBChunkBytes;
            if constexpr (kSmCluster > 1)
              sm90::tma_load_2d_multicast(dst, &wmap, n0 + c * 64,
                                          ks * kSmBK, &full[s],
                                          (1u << kSmCluster) - 1);
            else
              sm90::tma_load_2d(dst, &wmap, n0 + c * 64, ks * kSmBK,
                                &full[s]);
          }
        }
      }
      // Stay until every consumer of the cluster has released the last
      // stages: their arrivals land on this CTA's barriers.
      if constexpr (kSmCluster > 1)
        for (int j = 0; j < kSmStages; ++j, ++i)
          sm90::mbar_wait(&empty[i % kSmStages], ((i / kSmStages) & 1) ^ 1);
    }
    return;
  }

  // ---- consumers: warpgroup wg owns rows m0 + 64 wg .. + 63 of each tile
  sm90::consumer_claim_registers<2>();
  const int wg = warp >> 2;
  float acc[kSmBN / 2];
  // a consumer warp's release of a slot: one arrival in every CTA
  auto release = [&](int slot) {
    if (lane != 0) return;
    if constexpr (kSmCluster > 1) {
      for (int c = 0; c < kSmCluster; ++c)
        sm90::mbar_arrive_cluster(&empty[slot], c);
    } else {
      sm90::mbar_arrive(&empty[slot]);
    }
  };
  int i = 0;
  for (int job = cluster; job < jobs; job += clusters) {
    int m0, n0;
    tile_coords(job, groups_m, tiles_n, rank, m0, n0);
    // one bias element a thread, loaded now and parked in shared memory
    // after the products: the epilogue's 64 reads a thread come from there
    const int bc = threadIdx.x;
    const float bias_v = b != nullptr && bc < kSmBN && n0 + bc < n
                             ? to_f32(b[n0 + bc]) : 0.f;
    for (int ks = 0; ks < k_steps; ++ks, ++i) {
      const int s = i % kSmStages;
      const uint32_t st = sm90::smem_u32(smem + s * L::kStageBytes);
      sm90::mbar_wait(&full[s], (i / kSmStages) & 1);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSmBK / 16; ++kk) {
        // A: the warpgroup's 64 rows, K-major, the 16 elements of step kk
        // 32 bytes into the swizzled row; 8-row groups 1024 bytes apart.
        // B: k-rows 16 kk.., MN-major, 64-column chunks LBO apart.
        const uint64_t da = sm90::smem_desc(st + wg * 64 * 128 + kk * 32, 1,
                                            1024 / 16, 1);
        const uint64_t db = sm90::smem_desc(st + L::kABytes + kk * 16 * 128,
                                            L::kBChunkBytes / 16, 1024 / 16, 1);
        sm90::WgmmaSS<kSmBN, T>::template run<0, 1>(acc, da, db,
                                                    ks > 0 || kk > 0);
      }
      sm90::wgmma_commit();
      // the previous stage's products are done: hand its slot back
      sm90::wgmma_wait<1>();
      if (ks > 0) release((i - 1) % kSmStages);
    }
    sm90::wgmma_wait<0>();
    sm90::fence_regs(acc);
    release((i - 1) % kSmStages);
    // every consumer read the previous tile's bias before the barrier that
    // ended its epilogue; the output buffer is free once the previous
    // tile's TMA store has read it
    if (bc < kSmBN) bias_s[bc] = bias_v;
    if (threadIdx.x == 0) sm90::bulk_wait_read<0>();
    sm90::consumers_sync<2>();

    // epilogue: this thread's tile rows r_a and r_a + 8, columns 8 j + 2 t
    // and + 1, into the output buffer (16-byte unit j % 8 of a row of
    // chunk j / 8 lies at unit (j % 8) ^ (row % 8)), then one thread hands
    // the chunks to TMA stores, which leave out what lies past M and N and
    // run on while the consumers start the next tile
    const int r_a = wg * 64 + (warp & 3) * 16 + (lane >> 2);
    const int t = lane & 3;
    unsigned char* out_s = smem + L::kOutOff;
#pragma unroll
    for (int j = 0; j < kSmBN / 8; ++j) {
      const float2 bb = *reinterpret_cast<const float2*>(bias_s + j * 8 + 2 * t);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = r_a + 8 * h;
        const T v0 = from_f32<T>(epilogue(acc[4 * j + 2 * h], bb.x, act));
        const T v1 = from_f32<T>(epilogue(acc[4 * j + 2 * h + 1], bb.y, act));
        *reinterpret_cast<uint32_t*>(
            out_s + (j / 8) * L::kOutChunkBytes + r * 128 +
            (((j % 8) ^ (r & 7)) << 4) + 4 * t) =
            bits16(v0) | (bits16(v1) << 16);
      }
    }
    sm90::fence_async_shared();
    sm90::consumers_sync<2>();
    if (threadIdx.x == 0 && m0 < m) {
      for (int c = 0; c < L::kBChunks && n0 + c * 64 < n; ++c)
        sm90::tma_store_2d(&outmap, out_s + c * L::kOutChunkBytes,
                           n0 + c * 64, m0);
      sm90::bulk_commit();
    }
  }
  if (threadIdx.x == 0) sm90::bulk_wait<0>();
}

// ---- SIMT kernel (fp32) ----------------------------------------------------

constexpr int SM = 64, SN = 64, SK = 16;   // 16 x 16 threads, 4 x 4 each

__global__ void __launch_bounds__(kThreads)
dense_act_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ b, float* __restrict__ out,
                     int m, int n, int k, int act) {
  __shared__ float As[SK][SM + 1];   // transposed, As[k][row]; padded so
                                     // the transposing stores spread banks
  __shared__ float Bs[SK][SN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * SM, n0 = blockIdx.x * SN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < k; k0 += SK) {
    for (int e = threadIdx.x; e < SM * SK; e += kThreads) {
      const int r = e / SK, c = e % SK;
      const int gr = m0 + r, gc = k0 + c;
      As[c][r] = (gr < m && gc < k) ? x[(int64_t)gr * k + gc] : 0.f;
    }
    for (int e = threadIdx.x; e < SK * SN; e += kThreads) {
      const int r = e / SN, c = e % SN;
      const int gr = k0 + r, gc = n0 + c;
      Bs[r][c] = (gr < k && gc < n) ? w[(int64_t)gr * n + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < SK; ++kk) {
      float a[4], bb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = n0 + tx + 16 * j;
    if (col >= n) continue;
    const float bias = b != nullptr ? b[col] : 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty + 16 * i;
      if (row < m) out[(int64_t)row * n + col] = epilogue(acc[i][j], bias, act);
    }
  }
}

template <typename T>
cudaError_t launch_mma(const void* x, const void* w, const void* b, void* out,
                       int m, int n, int k, int act, cudaStream_t s) {
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM);
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  const bool vec = k % 8 == 0 && n % 8 == 0 && (bits & 15) == 0;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* bt = static_cast<const T*>(b);
  T* ot = static_cast<T*>(out);
  if (vec)
    dense_act_mma_kernel<T, true><<<grid, kThreads, 0, s>>>(xt, wt, bt, ot, m,
                                                            n, k, act);
  else
    dense_act_mma_kernel<T, false><<<grid, kThreads, 0, s>>>(xt, wt, bt, ot,
                                                             m, n, k, act);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_sm90(const void* x, const void* w, const void* b,
                        void* out, int m, int n, int k, int act,
                        CUtensorMapDataType type, cudaStream_t s) {
  using L = SmLayout;
  // host state set once, outside the launches a CUDA graph may capture:
  // the shared-memory opt-in, and the CTAs the card holds at once (whole
  // clusters)
  static bool smem_ready = false;
  static int slots = 0;
  cudaError_t err = sm90::allow_smem(dense_act_sm90_kernel<T>, L::kSmem,
                                     smem_ready);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSmCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSmCluster);
  cfg.blockDim = dim3(kSmThreads);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (slots == 0) {
    int clusters = 0;
    if ((err = cudaOccupancyMaxActiveClusters(
             &clusters, dense_act_sm90_kernel<T>, &cfg)) != cudaSuccess)
      return err;
    if (clusters < 1) return cudaErrorLaunchOutOfResources;
    slots = clusters * kSmCluster;
  }
  CUtensorMap xm, wm, om;
  if ((err = sm90::encode_map_2d(&xm, x, type, k, m, kSmBK, kSmBM)) !=
          cudaSuccess ||
      (err = sm90::encode_map_2d(&wm, w, type, n, k, 64, kSmBK)) !=
          cudaSuccess ||
      (err = sm90::encode_map_2d(&om, out, type, n, m, 64, kSmBM)) !=
          cudaSuccess)
    return err;
  // one CTA a slot, each cluster walking its share of the tile groups
  const int64_t ctas = (int64_t)((m + kSmCluster * kSmBM - 1) /
                                 (kSmCluster * kSmBM)) *
                       ((n + kSmBN - 1) / kSmBN) * kSmCluster;
  cfg.gridDim = dim3((unsigned)(ctas < slots ? ctas : slots));
  err = cudaLaunchKernelEx(&cfg, dense_act_sm90_kernel<T>, xm, wm, om,
                           static_cast<const T*>(b), m, n, k, act);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace

// The mma.sync (fp16 / bf16) and SIMT (fp32) routes: x (m, k), w (k, n), b
// (n,) or null, out (m, n): contiguous, all of `dtype` (0 fp32, 1 bf16, 2
// fp16).  activation: 0 none, 1 relu, 2 sigmoid.  The grid's y extent is
// ceil(m / 128) (fp32: / 64), at most 65535.  Returns cudaSuccess (0) or
// the launch error.
extern "C" int apex_dense_act(const void* x, const void* w, const void* b,
                              void* out, int m, int n, int k, int activation,
                              int dtype, void* stream) {
  if (m <= 0 || n <= 0 || k <= 0 || activation < kActNone ||
      activation > kActSigmoid)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF16:
      return (int)launch_mma<__half>(x, w, b, out, m, n, k, activation, s);
    case kDtypeBF16:
      return (int)launch_mma<__nv_bfloat16>(x, w, b, out, m, n, k, activation,
                                            s);
    case kDtypeF32: {
      const dim3 grid((n + SN - 1) / SN, (m + SM - 1) / SM);
      dense_act_f32_kernel<<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(b), static_cast<float*>(out), m, n, k,
          activation);
      return (int)cudaGetLastError();
    }
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The TMA + wgmma route: x (m, k), w (k, n), b (n,) or null, out (m, n),
// contiguous, all of `dtype` (1 bf16, 2 fp16); k and n multiples of 8 and
// x, w, out 16-byte aligned (TMA's strides and base); anything else is
// refused with cudaErrorInvalidValue, never sent to another kernel.
// activation as for apex_dense_act.
extern "C" int apex_dense_act_sm90(const void* x, const void* w,
                                   const void* b, void* out, int m, int n,
                                   int k, int activation, int dtype,
                                   void* stream) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(w) |
                         reinterpret_cast<uintptr_t>(out);
  if (m <= 0 || n <= 0 || k <= 0 || k % 8 != 0 || n % 8 != 0 ||
      (bits & 15) != 0 || activation < kActNone || activation > kActSigmoid)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kDtypeF16:
      return (int)launch_sm90<__half>(x, w, b, out, m, n, k, activation,
                                      CU_TENSOR_MAP_DATA_TYPE_FLOAT16, s);
    case kDtypeBF16:
      return (int)launch_sm90<__nv_bfloat16>(
          x, w, b, out, m, n, k, activation, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
          s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

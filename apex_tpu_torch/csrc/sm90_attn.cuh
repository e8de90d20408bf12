// Hopper (sm_90a) building blocks shared by the fp16 and bf16 attention
// kernels, on top of the generic ones of `sm90_common.cuh` (the encode
// lookup, descriptors, mbarriers, the register split, wgmma's fence /
// commit / wait): TMA tensor maps over (D, S, BH) tensors of a 16-bit
// element type; the ring, an mbarrier-guarded ring of two-tile stages
// filled by a producer warp, with its shared-memory layout; the score
// masks; warpgroup matrix multiplies (`wgmma`, .f16 or .bf16 by the
// element type) reading their operands from swizzled shared memory (A also
// from registers); and the choice of one or two consumer warpgroups.  The
// two element types share every layout (both are 2 bytes): only the TMA
// data type, the wgmma instruction and the rounding of fp32 values
// (`pack<E>`) differ.
//
// The ring serves two shapes of kernel.  Query-major (the flash forward,
// the split dq): a CTA owns a tile of queries, its resident tiles are q (and
// dO), loaded once, and each stage brings a k and a v tile with their key
// bias.  Key-major (the fused backward, the split dk/dv): a CTA owns a tile
// of 128 keys, its resident tiles are k and v, and each stage brings a q and
// a dO tile with those rows' lse and delta.
//
// Tile layout.  A tile of `rows` rows of a (.., D) 16-bit tensor lies in
// shared memory as D / AW column chunks of (rows, AW), AW = min(D, 64)
// elements unless a kernel asks for narrower chunks: one 128-byte swizzle
// atom a row for AW = 64, one 64-byte atom for AW = 32, one 32-byte atom
// for AW = 16.  TMA writes each chunk with the matching swizzle
// (CU_TENSOR_MAP_SWIZZLE_128B / _64B / _32B), and the wgmma descriptors
// below read it back with the same swizzle:
//   * K-major (the reduction runs along D: q, k, dO, v as the operands of
//     S = q k^T and dP = dO v^T or of their transposes): the 16-element k
//     step advances the start address by 32 bytes inside the atom (and to
//     the next chunk every AW / 16 steps); 8-row groups are SBO = 8 * row
//     bytes apart;
//   * MN-major (the reduction runs along the rows: v in O += P v, k in dQ
//     += dS k, dO and q in dV += Pd^T dO and dK += dS^T q, dS^T as the A of
//     dQ += dS k; the instruction's transpose bit set): the 16-row step
//     advances 16 rows; 8-row groups are SBO = 8 * row bytes apart and the
//     column chunks LBO = rows * row bytes apart.  An operand that starts
//     at a chunk reads that chunk alone when its width is one chunk: the
//     key-major kernels keep k in chunks of D / 2 columns so that each
//     consumer warpgroup's dQ takes one chunk as its B.
// Every tile starts on a 1024-byte boundary, so the swizzle's base offset is
// 0.
//
// The maps are 3-D, (D, S, BH), so a box never reaches into the next head
// and rows past S arrive as zeros: ragged edges need no padding copies.
// `cuTensorMapEncodeTiled` is looked up through the CUDA runtime
// (cudaGetDriverEntryPoint), so the library links without -lcuda; the
// maps are encoded on the host at each call and passed by value as
// __grid_constant__ parameters.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace sm90 {

// ---------------------------------------------------------------------------
// host: tensor maps
// ---------------------------------------------------------------------------

// the default column chunk: one 128-byte row (64-byte at D = 32)
template <int D>
constexpr int default_aw() { return D < 64 ? D : 64; }

// The TMA data type of a 16-bit element type E (__half or __nv_bfloat16).
template <typename E>
constexpr CUtensorMapDataType map_type() {
  return std::is_same<E, __half>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// Map over a contiguous (bh, s, d) tensor of E whose box is one column
// chunk of AW columns and `box_rows` rows of one head.
template <typename E, int D, int AW = default_aw<D>()>
cudaError_t encode_map(CUtensorMap* map, const void* base, int s, int bh,
                       int box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)s, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)s * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)AW, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = fn(map, map_type<E>(), 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        AW == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                        : AW == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                   : CU_TENSOR_MAP_SWIZZLE_32B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// device: tile layout and wgmma descriptors
// ---------------------------------------------------------------------------

template <int D, int AW = default_aw<D>()>
struct Tile {
  static_assert(D == 32 || D == 64 || D == 128, "head dim 32, 64 or 128");
  static_assert((AW == 16 || AW == 32 || AW == 64) && D % AW == 0,
                "column chunks of 16, 32 or 64 elements");
  static constexpr int kAw = AW;                 // elements a chunk row
  static constexpr int kChunks = D / kAw;
  static constexpr int kRowBytes = kAw * 2;      // 32, 64 or 128
  // 128B / 64B / 32B swizzle
  static constexpr uint64_t kLayout = kAw == 64 ? 1 : kAw == 32 ? 2 : 3;
  static constexpr uint32_t kSbo = 8 * kRowBytes / 16;    // 8-row groups

  // the descriptor of a K-major operand: rows of a tile of `rows` rows, the
  // 16 elements of reduction step kk
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows,
                                                    int row0, int kk) {
    const uint32_t addr = tile + (kk * 16 / kAw) * rows * kRowBytes +
                          row0 * kRowBytes + (kk * 16 % kAw) * 2;
    return desc(addr, 1, kSbo);
  }
  // the descriptor of an MN-major operand: the 16 rows of reduction step
  // kk, every column chunk from `tile` on
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows,
                                                     int kk) {
    return desc(tile + kk * 16 * kRowBytes, rows * kRowBytes / 16, kSbo);
  }
  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                                  uint32_t sbo) {
    return smem_desc(addr, lbo, sbo, kLayout);
  }
};

// the column chunks of rows [row0, row0 + rows) of head bh into `dst`
template <int D, int AW = default_aw<D>()>
__device__ __forceinline__ void tma_tile(void* dst, const CUtensorMap* map,
                                         int row0, int bh, int rows,
                                         uint64_t* bar) {
  using T = Tile<D, AW>;
  const uint32_t d = smem_u32(dst), b = smem_u32(bar);
  const uint64_t m = reinterpret_cast<uint64_t>(map);
#pragma unroll
  for (int c = 0; c < T::kChunks; ++c) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
        "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(
            d + c * rows * T::kRowBytes),
        "l"(m), "r"(c * T::kAw), "r"(row0), "r"(bh), "r"(b)
        : "memory");
  }
}

// ---------------------------------------------------------------------------
// the ring
// ---------------------------------------------------------------------------

constexpr float kNegInf = -1e30f;  // a masked score
constexpr float kLog2e = 1.4426950408889634f;

// Consumer warpgroups a query-major CTA takes: two (128-row query tiles)
// where those still fill the card's 132 SMs, else one (64 rows).
// A CTA's (tile, batch-head) on the kernels' one-dimensional grid of
// `tiles` x bh CTAs: any number of batch-heads fits (gridDim.y stops at
// 65,535), and a batch-head's tiles stay adjacent in launch order, as they
// were with the batch-heads on gridDim.y.
struct GridPos {
  int tile, bh;
};
__device__ __forceinline__ GridPos grid_pos(int tiles) {
  return {(int)(blockIdx.x % (unsigned)tiles), (int)(blockIdx.x / (unsigned)tiles)};
}
inline cudaError_t flat_grid(int tiles, int bh, dim3* grid) {
  const long long n = (long long)tiles * bh;
  if (n <= 0 || n > 0x7fffffffLL) return cudaErrorInvalidValue;
  *grid = dim3((unsigned)n);
  return cudaSuccess;
}

inline int consumer_groups(int sq, int bh) {
  return (sq + 127) / 128 * bh >= 132 ? 2 : 1;
}

// The key-major kernels' stages: query rows a stage, and stages.  128
// rows give S^T and dP^T 128 fp32 registers a thread together, which
// spills and ran slower; a third stage bought nothing (`chip_smoke.py
// --variants`).
constexpr int kKvStageRows = 64;
constexpr int kKvStages = 2;

// The shared memory of a kernel of C consumer warpgroups and one producer
// warpgroup: ResTiles resident tiles of ResRows rows (in chunks of ResAw
// columns), loaded once; Stages stages of two tiles of StageRows rows each
// (default chunks); ExtraBytes of the kernel's own (1024-byte aligned);
// StageVecs fp32 vectors of StageRows a stage; the barriers (full and empty
// a stage, one for the resident tiles).
template <int D, int C, int Stages, int ResRows, int ResTiles, int StageRows,
          int StageVecs, int ResAw = default_aw<D>(), int ExtraBytes = 0>
struct RingCfg {
  static constexpr int kD = D;
  static constexpr int kC = C;
  static constexpr int kStages = Stages;
  static constexpr int kThreads = 128 * (C + 1);
  static constexpr int kResRows = ResRows;
  static constexpr int kResTiles = ResTiles;
  static constexpr int kResAw = ResAw;
  static constexpr int kStageRows = StageRows;
  static constexpr int kStageVecs = StageVecs;
  static constexpr int kResBytes = ResRows * D * 2;       // one resident tile
  static constexpr int kTileBytes = StageRows * D * 2;    // one stage tile
  static constexpr int kStageOff = ResTiles * kResBytes;  // stage s: 2 tiles
  static constexpr int kExtraOff = kStageOff + Stages * 2 * kTileBytes;
  static constexpr int kVecOff = kExtraOff + ExtraBytes;
  static constexpr int kBarOff = kVecOff + Stages * StageVecs * StageRows * 4;
  static constexpr int kSmem = 1024 + kBarOff + (2 * Stages + 1) * 8;
};

// A query-major kernel's stage vector: the key bias of the stage's keys,
// `row` (the per-key row of a (1|B, 1, Sk) bias) or 0 where the consumers
// add a (B, Sq, Sk) bias per element (`row` null), with -1e30 past Sk
// folded in: a zero-filled key would otherwise score 0.
struct KeyBias {
  const float* row;
  int sk;
  __device__ void operator()(float* v, int rows, int col0, int lane) const {
    for (int i = lane; i < rows; i += 32) {
      const int col = col0 + i;
      v[i] = col < sk ? (row != nullptr ? row[col] : 0.f) : kNegInf;
    }
  }
};

// A key-major kernel's stage vectors: the stage's query rows' max m, their
// log l times log2(e), then their delta (P = exp2((s - m) log2(e) - log l
// log2(e))); a row past Sq reads as dead (m = +1e30, so P = 0) with delta 0.
struct QueryStats {
  const float2* stats;  // this head's (Sq,) rows: (m, log l)
  const float* delta;
  int sq;
  __device__ void operator()(float* v, int rows, int row0, int lane) const {
    for (int i = lane; i < rows; i += 32) {
      const int row = row0 + i;
      const float2 st = row < sq ? stats[row] : make_float2(-kNegInf, 0.f);
      v[i] = st.x;
      v[rows + i] = st.y * kLog2e;
      v[2 * rows + i] = row < sq ? delta[row] : 0.f;
    }
  }
};

template <class Cfg>
struct Ring {
  static constexpr int kStages = Cfg::kStages, kRows = Cfg::kStageRows;
  // every part at a fixed offset from one 1024-byte aligned base (TMA's
  // 128-byte swizzle wants it), so the ring costs one register
  unsigned char* smem;

  __device__ explicit Ring(unsigned char* raw)
      : smem(raw + ((1024 - (smem_u32(raw) & 1023)) & 1023)) {}
  __device__ float* vecs_of(int stage) const {
    return reinterpret_cast<float*>(smem + Cfg::kVecOff) +
           stage * Cfg::kStageVecs * kRows;
  }
  // full[s]: a stage's bytes arrived; empty[s]: every consumer warp is done
  // with it; resbar: the resident tiles arrived
  __device__ uint64_t* full(int s) const {
    return reinterpret_cast<uint64_t*>(smem + Cfg::kBarOff) + s;
  }
  __device__ uint64_t* empty(int s) const { return full(kStages + s); }
  __device__ uint64_t* resbar() const { return full(2 * kStages); }

  // every thread of the CTA: thread 0 sets the barriers up
  __device__ void init() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kStages; ++s) {
        mbar_init(full(s), 1);
        mbar_init(empty(s), 4 * Cfg::kC);  // one arrival per consumer warp
      }
      mbar_init(resbar(), 1);
      mbar_fence_init();
    }
    __syncthreads();
  }

  // The producer warp: the resident tiles of rows res_row0.. once, then for
  // each of n stages, i = 0 .. n - 1, the stage's vectors (`fill`, over
  // rows (first + i) kRows ..) and its two tiles (map0, map1).  Stage i
  // lives in slot i % kStages; the phase of its barriers is (i / kStages)
  // & 1.
  template <class Fill>
  __device__ void produce(const CUtensorMap* const (&res_maps)[Cfg::kResTiles],
                          int res_row0, const CUtensorMap* map0,
                          const CUtensorMap* map1, int bh, int first, int n,
                          int lane, const Fill& fill) const {
    constexpr int D = Cfg::kD;
    if (lane == 0) {
      mbar_expect_tx(resbar(), Cfg::kResTiles * Cfg::kResBytes);
      for (int i = 0; i < Cfg::kResTiles; ++i)
        tma_tile<D, Cfg::kResAw>(smem + i * Cfg::kResBytes, res_maps[i],
                                 res_row0, bh, Cfg::kResRows, resbar());
    }
    for (int i = 0; i < n; ++i) {
      const int stage = i % kStages;
      const int row0 = (first + i) * kRows;
      mbar_wait(empty(stage), ((i / kStages) & 1) ^ 1);
      fill(vecs_of(stage), kRows, row0, lane);
      __syncwarp();
      if (lane == 0) {
        unsigned char* st = smem + Cfg::kStageOff + stage * 2 * Cfg::kTileBytes;
        mbar_expect_tx(full(stage), 2 * Cfg::kTileBytes);
        tma_tile<D>(st, map0, row0, bh, kRows, full(stage));
        tma_tile<D>(st + Cfg::kTileBytes, map1, row0, bh, kRows, full(stage));
      }
    }
  }

  // the consumers' side
  __device__ uint32_t res_addr(int i) const { return smem_u32(smem) + i * Cfg::kResBytes; }
  __device__ uint32_t stage_addr(int i, int tile) const {
    return smem_u32(smem + Cfg::kStageOff + ((i % kStages) * 2 + tile) * Cfg::kTileBytes);
  }
  __device__ unsigned char* extra() const { return smem + Cfg::kExtraOff; }
  __device__ const float* vecs(int i) const { return vecs_of(i % kStages); }
  __device__ void wait_res() const { mbar_wait(resbar(), 0); }
  __device__ void wait_full(int i) const {
    mbar_wait(full(i % kStages), (i / kStages) & 1);
  }
  __device__ void release(int i, int lane) const {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(i % kStages));
  }
};

// ---------------------------------------------------------------------------
// the score masks
// ---------------------------------------------------------------------------

// The masks of a query-major 64 x N score accumulator of keys k0.. (the
// thread's rows row_a and row_a + 8, in the accumulator layout below): the
// stage's key bias `bs` once per tile; a (B, Sq, Sk) bias per element where
// `bias_rows` (its rows for this head) is not null; the causal compare only
// where `diag` says the tile crosses the warpgroup's diagonal.
template <int N>
__device__ __forceinline__ void mask_scores(float (&s)[N / 2], const float* bs,
                                            const float* bias_rows, bool diag,
                                            int row_a, int k0, int t, int sq,
                                            int sk) {
  const int row_b = row_a + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int c = j * 8 + 2 * t;
    const float2 b = *reinterpret_cast<const float2*>(bs + c);
    s[4 * j + 0] += b.x;
    s[4 * j + 1] += b.y;
    s[4 * j + 2] += b.x;
    s[4 * j + 3] += b.y;
    if (bias_rows != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? row_a : row_b, col = k0 + c + (e & 1);
        if (row < sq && col < sk) s[4 * j + e] += bias_rows[(size_t)row * sk + col];
      }
    }
    if (diag) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + c + (e & 1) > (e < 2 ? row_a : row_b)) s[4 * j + e] = kNegInf;
    }
  }
}

// The same for a key-major 64 x N accumulator of S^T (rows are the
// thread's keys key_a and key_a + 8, columns the query rows q0..): the
// keys' bias kb_a / kb_b, held in registers for the whole CTA (-1e30 past
// Sk folded in), once per element; a (B, Sq, Sk) bias per element where
// `bias_rows` is not null; the causal compare only where `diag` says the
// tile crosses the warpgroup's diagonal.
template <int N>
__device__ __forceinline__ void mask_scores_t(float (&s)[N / 2], float kb_a,
                                              float kb_b,
                                              const float* bias_rows, bool diag,
                                              int key_a, int q0, int t, int sq,
                                              int sk) {
  const int key_b = key_a + 8;
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int r = q0 + j * 8 + 2 * t;
    s[4 * j + 0] += kb_a;
    s[4 * j + 1] += kb_a;
    s[4 * j + 2] += kb_b;
    s[4 * j + 3] += kb_b;
    if (bias_rows != nullptr) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = e < 2 ? key_a : key_b, row = r + (e & 1);
        if (row < sq && key < sk) s[4 * j + e] += bias_rows[(size_t)row * sk + key];
      }
    }
    if (diag) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if ((e < 2 ? key_a : key_b) > r + (e & 1)) s[4 * j + e] = kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// device: fp16 / bf16 wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_half(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);  // .x = lo (low half)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two fp32 values rounded to E (__half or __nv_bfloat16), lo in the low
// half: a register A fragment's pair, or two neighbouring output elements.
template <typename E>
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) return pack_half(lo, hi);
  else return pack_bf16(lo, hi);
}

// The scalar-FMA kernels' element conversions: E (float, __half or
// __nv_bfloat16) to fp32 and back (to nearest), and an fp32 value rounded
// to E (the plain versions' `.to(dtype).float()` before a product).
template <typename E>
__device__ __forceinline__ float to_f32(E x) {
  if constexpr (std::is_same<E, float>::value) return x;
  else if constexpr (std::is_same<E, __half>::value) return __half2float(x);
  else return __bfloat162float(x);
}

template <typename E>
__device__ __forceinline__ E from_f32(float x) {
  if constexpr (std::is_same<E, float>::value) return x;
  else if constexpr (std::is_same<E, __half>::value) return __float2half_rn(x);
  else return __float2bfloat16_rn(x);
}

template <typename E>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<E>(from_f32<E>(x));
}

// Accumulator layout of m64nNk16 (fp32): thread t of the warpgroup holds
// d[4 j + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e],
// the mma.sync C fragment of each 8-column block for its warp's 16 rows.
// The register A fragment of a 16-column slice kk is the same four pairs:
// {d[8kk], d[8kk+1]}, {d[8kk+2], d[8kk+3]}, {d[8kk+4], d[8kk+5]},
// {d[8kk+6], d[8kk+7]}, each packed by `pack<E>` (the same order for .f16
// and .bf16: the lower column in the low half).

#define SM90_ATTN_SS_16(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %10, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                        \
      "}, %8, %9, p, 1, 1, %11, %12;\n}\n"                                    \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                        \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

#define SM90_ATTN_SS_32(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %18, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15"                                  \
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                    \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

#define SM90_ATTN_RS_32(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %21, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15"                                  \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

#define SM90_ATTN_SS_64(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %34, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                \
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

#define SM90_ATTN_RS_64(TY)                                                   \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %37, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"            \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))

#define SM90_ATTN_SS_128(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %66, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                                  \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

#define SM90_ATTN_RS_128(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\n"                                                    \
      "setp.ne.b32 p, %69, 0;\n"                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                      \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                              \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                              \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                              \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                              \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                              \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                       \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                       \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                     \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                   \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                   \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                   \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                   \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                   \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                   \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                   \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                   \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                   \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                   \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                   \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                    \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d))


// D (64 x N) (+)= A (64 x 16) * B, A and B of type E (__half: .f16,
// __nv_bfloat16: .bf16).  ss: A from shared memory, B (N x 16) from shared
// memory; TA / TB set: the operand is MN-major (transposed).  rs: A from
// registers (packed by `pack<E>`), B (16 x N) from shared memory,
// MN-major.  scale_d 0 overwrites D.
template <int N, typename E>
struct Wgmma {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "N 16 to 128");
  static_assert(std::is_same<E, __half>::value ||
                    std::is_same<E, __nv_bfloat16>::value,
                "fp16 or bf16 operands");
  static constexpr bool kF16 = std::is_same<E, __half>::value;

  template <int TA = 0, int TB = 0>
  static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a,
                                            uint64_t b, int scale_d) {
    if constexpr (N == 16) {
      if constexpr (kF16) SM90_ATTN_SS_16("f16"); else SM90_ATTN_SS_16("bf16");
    } else if constexpr (N == 32) {
      if constexpr (kF16) SM90_ATTN_SS_32("f16"); else SM90_ATTN_SS_32("bf16");
    } else if constexpr (N == 64) {
      if constexpr (kF16) SM90_ATTN_SS_64("f16"); else SM90_ATTN_SS_64("bf16");
    } else {
      if constexpr (kF16) SM90_ATTN_SS_128("f16"); else SM90_ATTN_SS_128("bf16");
    }
  }

  static __device__ __forceinline__ void rs(float (&d)[N / 2],
                                            const uint32_t (&a)[4], uint64_t b,
                                            int scale_d) {
    static_assert(N != 16, "no register-A product at N = 16");
    if constexpr (N == 32) {
      if constexpr (kF16) SM90_ATTN_RS_32("f16"); else SM90_ATTN_RS_32("bf16");
    } else if constexpr (N == 64) {
      if constexpr (kF16) SM90_ATTN_RS_64("f16"); else SM90_ATTN_RS_64("bf16");
    } else if constexpr (N == 128) {
      if constexpr (kF16) SM90_ATTN_RS_128("f16"); else SM90_ATTN_RS_128("bf16");
    }
  }
};

#undef SM90_ATTN_SS_16
#undef SM90_ATTN_SS_32
#undef SM90_ATTN_SS_64
#undef SM90_ATTN_SS_128
#undef SM90_ATTN_RS_32
#undef SM90_ATTN_RS_64
#undef SM90_ATTN_RS_128

}  // namespace sm90

// Label-smoothed softmax cross-entropy forward for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/contrib/xentropy/softmax_xentropy.py
// `_fwd_kernel` (reached through `_xent_fwd_pallas`): for logits (N, V) and
// int64 labels (N,), one pass over each row gives
//   lse_i  = log sum_j exp(x_ij)
//   loss_i = (1 - s) * (lse_i - x_i[label_i]) + s * (lse_i - mean_j x_ij),
// both (N,) fp32.  A label outside [0, V) (the padding rows) contributes a
// gold logit of 0, as on the TPU; the caller zeroes those rows' loss.
//
// What bounds it: bytes.  Each logit is read once (~5 flops and one exp an
// element): at the byte mLSTM's 32,768 x 256 fp16 the least time is ~5 us,
// at BERT's 4096 x 30,592 bf16 ~75 us.  The Python wrapper picks one of two
// designs from (V, dtype) and passes it in (`_xent_plan` in
// apex_tpu_torch/contrib/xentropy/softmax_xentropy.py):
//   * small rows (at most 128 16-byte vectors, 2 KB): 8, 16 or 32 lanes a
//     row, each holding up to 4 vectors, so a warp reduces up to 4 rows at
//     once and a row costs few shuffles; several rows a block.  The row
//     groups are persistent: each walks rows with a stride and issues the
//     next row's loads before it reduces the current one.  The row's max
//     goes first, then each lane's terms against it, so the reductions are
//     shuffles of sums with no exp in them.  The lane that holds the label's
//     column contributes the gold logit, so nothing is left to load after
//     the reduction.
//   * wide rows: persistent 256-thread blocks stream their rows through a
//     ring of 4 x 16 KB stages in shared memory, filled by 1-D bulk copies
//     (`cp.async.bulk`) that complete on mbarriers; the ring runs on from
//     one row into the next, so the next row's first chunks load while this
//     row reduces.  The gold logit is fetched at the row's start.  Each
//     thread takes the max of its part of a chunk first, so it rescales its
//     running sum once a chunk, not once a vector.
// exp is the special-function unit's exp2 of log2(e)-scaled differences
// from the max throughout, and 16-bit logits take their max in pairs.  Rows that are not
// 16-byte aligned (V not a multiple of the vector) take a vector body with
// a scalar head and tail.  An inf or NaN logit is read as it is, so the
// loss is what the plain version gives.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_common.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeF16 = 2;

// the plan codes (`XENT_PATHS` in the Python wrapper): lanes a row x 16-byte
// vectors a lane, then the ring
constexpr int kPathLanes8x1 = 0;
constexpr int kPathLanes8x2 = 1;
constexpr int kPathLanes8x4 = 2;
constexpr int kPathLanes16x4 = 3;
constexpr int kPathLanes32x4 = 4;
constexpr int kPathWide = 5;

constexpr int kWarpBlock = 128;    // threads of a small-row block
constexpr int kWideThreads = 256;  // threads of a wide-row block
constexpr int kChunk = 16384;      // bytes of a ring stage
constexpr int kStages = 4;         // ring stages: 64 KB in flight a block
constexpr int kChunkVecs = kChunk / 16;
constexpr int kVecsPerThread = kChunkVecs / kWideThreads;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
struct Vec16 {
  static constexpr int kN = 16 / (int)sizeof(T);
  uint4 raw;
  __device__ __forceinline__ float operator[](int j) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[j]);
  }
  // the largest of the 16 bytes' elements (16-bit pairs compared packed; a
  // NaN loses to a number, as in fmaxf)
  __device__ __forceinline__ float max() const {
    if constexpr (sizeof(T) == 4) {
      return fmaxf(fmaxf((*this)[0], (*this)[1]), fmaxf((*this)[2], (*this)[3]));
    } else {
      using T2 = typename std::conditional<std::is_same<T, __half>::value, __half2,
                                           __nv_bfloat162>::type;
      const T2* p = reinterpret_cast<const T2*>(&raw);
      const T2 m = __hmax2(__hmax2(p[0], p[1]), __hmax2(p[2], p[3]));
      return fmaxf(to_f32(m.x), to_f32(m.y));
    }
  }
};

// Running softmax state: max m, sum of exp(x - m), sum of x, and the gold
// logit where this thread saw it.  exp(x - m) is exp2((x - m) log2(e)):
// the difference first, exact for logits near the max, so the max's term is
// exactly 1.
struct Acc {
  float m, s, xsum, gold;
};

__device__ __forceinline__ Acc acc_init() { return {kNegInf, 0.f, 0.f, 0.f}; }

// 2^y by the special-function unit alone (ex2.approx.ftz: a result below
// fp32's normal range is 0, which no sum here can see)
__device__ __forceinline__ float ex2(float y) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(y));
  return r;
}

__device__ __forceinline__ float exp_rel(float x, float m) { return ex2((x - m) * kLog2e); }

// Fold one logit in (the scalar head and tail of an unaligned row).
__device__ __forceinline__ void fold(Acc& a, float x) {
  const float m = fmaxf(a.m, x);
  a.s = a.s * exp_rel(a.m, m) + exp_rel(x, m);
  a.m = m;
  a.xsum += x;
}

__device__ __forceinline__ Acc merge(Acc a, Acc b) {
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * exp_rel(a.m, m) + b.s * exp_rel(b.m, m), a.xsum + b.xsum,
          a.gold + b.gold};
}

// Where a row's 16-byte aligned body lies: `head` elements before it (read
// as scalars), `nb` vectors, then `ntail` elements after it.
template <typename T>
struct RowSplit {
  int head, nb, tail0, ntail;
  __device__ __forceinline__ RowSplit(const T* p, int v) {
    constexpr int kVec = 16 / (int)sizeof(T);
    const int mis = (int)(reinterpret_cast<uintptr_t>(p) & 15);
    head = ((16 - mis) & 15) / (int)sizeof(T);
    if (head > v) head = v;
    nb = (v - head) / kVec;
    tail0 = head + nb * kVec;
    ntail = v - tail0;
  }
};

__device__ __forceinline__ void write_row(float* loss, float* lse_out, int row,
                                          const Acc& a, int v,
                                          float smoothing) {
  const float lse = a.m + logf(a.s);
  const float nll = lse - a.gold;
  const float smooth = lse - a.xsum / (float)v;
  loss[row] = (1.f - smoothing) * nll + smoothing * smooth;
  lse_out[row] = lse;
}

// ---------------------------------------------------------------------------
// small rows: 8, 16 or 32 lanes a row, persistent
// ---------------------------------------------------------------------------

// One row's share of a lane, as loaded: up to MAXV body vectors, one head
// and one tail scalar, and the row's label.
template <typename T, int LPR, int MAXV>
struct LaneRow {
  Vec16<T> vec[MAXV];
  T head_x, tail_x;
  int64_t label;

  __device__ __forceinline__ void load(const T* logits, const int64_t* labels,
                                       int row, int v, int lane) {
    const T* p = logits + (size_t)row * v;
    const RowSplit<T> sp(p, v);
    const uint4* body = reinterpret_cast<const uint4*>(p + sp.head);
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int vi = lane + i * LPR;
      if (vi < sp.nb) vec[i].raw = __ldg(body + vi);
    }
    if (lane < sp.head) head_x = p[lane];
    if (lane < sp.ntail) tail_x = p[sp.tail0 + lane];
    label = labels[row];
  }
};

// Sum across the LPR lanes of a row group (`mask` its lanes).
template <int LPR>
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
#pragma unroll
  for (int off = LPR / 2; off > 0; off >>= 1) v += __shfl_xor_sync(mask, v, off);
  return v;
}

template <typename T, int LPR, int MAXV>
__global__ void __launch_bounds__(kWarpBlock)
xent_warp_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                 float* __restrict__ loss, float* __restrict__ lse_out, int n,
                 int v, float smoothing) {
  constexpr int kVec = Vec16<T>::kN;
  const int lane = threadIdx.x % LPR;
  const int group = (blockIdx.x * blockDim.x + threadIdx.x) / LPR;
  const int n_groups = gridDim.x * blockDim.x / LPR;
  // a row group of fewer than 32 lanes shuffles within its lanes
  const unsigned mask = LPR == 32 ? 0xffffffffu
                                  : ((1u << LPR) - 1u) << ((threadIdx.x & 31) & ~(LPR - 1));
  int row = group;
  if (row >= n) return;

  LaneRow<T, LPR, MAXV> cur;
  cur.load(logits, labels, row, v, lane);
  while (true) {
    const int next_row = row + n_groups;
    const bool more = next_row < n;
    LaneRow<T, LPR, MAXV> nxt;
    if (more) nxt.load(logits, labels, next_row, v, lane);

    // the row's max first (shuffles of one value), then every lane's terms
    // against it: no rescale, and no exp, in the reductions
    const RowSplit<T> sp(logits + (size_t)row * v, v);
    const bool has_head = lane < sp.head, has_tail = lane < sp.ntail;
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < MAXV; ++i)
      if (lane + i * LPR < sp.nb) mx = fmaxf(mx, cur.vec[i].max());
    if (has_head) mx = fmaxf(mx, to_f32(cur.head_x));
    if (has_tail) mx = fmaxf(mx, to_f32(cur.tail_x));
#pragma unroll
    for (int off = LPR / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(mask, mx, off));

    Acc a = acc_init();
    a.m = mx;
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      const int vi = lane + i * LPR;
      if (vi < sp.nb) {
        const int col0 = sp.head + vi * kVec;
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float x = cur.vec[i][j];
          a.s += exp_rel(x, mx);
          a.xsum += x;
          if (col0 + j == cur.label) a.gold = x;
        }
      }
    }
    if (has_head) {
      const float x = to_f32(cur.head_x);
      a.s += exp_rel(x, mx);
      a.xsum += x;
      if (lane == cur.label) a.gold = x;
    }
    if (has_tail) {
      const float x = to_f32(cur.tail_x);
      a.s += exp_rel(x, mx);
      a.xsum += x;
      if (sp.tail0 + lane == cur.label) a.gold = x;
    }
    a.s = group_sum<LPR>(a.s, mask);
    a.xsum = group_sum<LPR>(a.xsum, mask);
    a.gold = group_sum<LPR>(a.gold, mask);
    if (lane == 0) write_row(loss, lse_out, row, a, v, smoothing);
    if (!more) break;
    row = next_row;
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// wide rows: persistent blocks over a ring of bulk copies
// ---------------------------------------------------------------------------

// The k-th chunk of this block's stream: its row, its index in the row,
// and the byte range of the row's aligned body it covers.
template <typename T>
struct Chunk {
  int row, c, bytes;
  const unsigned char* src;
  __device__ __forceinline__ Chunk(const T* logits, int k, int nc, int v) {
    row = blockIdx.x + (k / nc) * gridDim.x;
    c = k % nc;
    const T* p = logits + (size_t)row * v;
    const RowSplit<T> sp(p, v);
    const int body = sp.nb * 16;
    const int off = c * kChunk;
    const int left = body - off;
    bytes = left < 0 ? 0 : (left < kChunk ? left : kChunk);
    src = reinterpret_cast<const unsigned char*>(p + sp.head) + off;
  }
};

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
xent_wide_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                 float* __restrict__ loss, float* __restrict__ lse_out, int n,
                 int v, float smoothing, int nc) {
  constexpr int kVec = Vec16<T>::kN;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(8) uint64_t full[kStages];
  __shared__ Acc red[kWideThreads / 32];
  const int tid = threadIdx.x;
  const int rows_mine = (int)blockIdx.x < n ? (n - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int n_chunks = rows_mine * nc;

  // thread 0 fills stage k % kStages with chunk k; an empty chunk (past a
  // short row's body) still completes its phase
  auto issue = [&](int k) {
    if (k >= n_chunks) return;
    const Chunk<T> ch(logits, k, nc, v);
    uint64_t* bar = &full[k % kStages];
    if (ch.bytes > 0) {
      sm90::mbar_expect_tx(bar, (uint32_t)ch.bytes);
      sm90::bulk_load_1d(ring + (k % kStages) * kChunk, ch.src, (uint32_t)ch.bytes, bar);
    } else {
      sm90::mbar_arrive(bar);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) sm90::mbar_init(&full[s], 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0)
    for (int k = 0; k < kStages; ++k) issue(k);

  Acc acc = acc_init();
  for (int k = 0; k < n_chunks; ++k) {
    const Chunk<T> ch(logits, k, nc, v);
    if (ch.c == 0) {
      // the row's start: its scalar head and tail, and the gold logit
      const T* p = logits + (size_t)ch.row * v;
      const RowSplit<T> sp(p, v);
      acc = acc_init();
      if (tid < sp.head) fold(acc, to_f32(p[tid]));
      if (tid < sp.ntail) fold(acc, to_f32(p[sp.tail0 + tid]));
      if (tid == 0) {
        const int64_t label = labels[ch.row];
        acc.gold = (label >= 0 && label < v) ? to_f32(p[label]) : 0.f;
      }
    }
    const int stage = k % kStages;
    sm90::mbar_wait(&full[stage], (uint32_t)((k / kStages) & 1));
    const uint4* sv = reinterpret_cast<const uint4*>(ring + stage * kChunk);
    const int nvec = ch.bytes / 16;
    Vec16<T> e[kVecsPerThread];
    float mx = kNegInf;
#pragma unroll
    for (int u = 0; u < kVecsPerThread; ++u) {
      const int vi = tid + u * kWideThreads;
      if (vi < nvec) {
        e[u].raw = sv[vi];
        mx = fmaxf(mx, e[u].max());
      }
    }
    const float m = fmaxf(acc.m, mx);
    float s = acc.s * exp_rel(acc.m, m);
#pragma unroll
    for (int u = 0; u < kVecsPerThread; ++u) {
      if (tid + u * kWideThreads < nvec) {
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float x = e[u][j];
          s += exp_rel(x, m);
          acc.xsum += x;
        }
      }
    }
    acc.m = m;
    acc.s = s;
    __syncthreads();  // every thread is done with this stage
    if (tid == 0) issue(k + kStages);

    if (ch.c == nc - 1) {
      // the row's end: warps by shuffles, then across the block's warps
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const Acc o = {__shfl_xor_sync(0xffffffffu, acc.m, off),
                       __shfl_xor_sync(0xffffffffu, acc.s, off),
                       __shfl_xor_sync(0xffffffffu, acc.xsum, off),
                       __shfl_xor_sync(0xffffffffu, acc.gold, off)};
        acc = merge(acc, o);
      }
      if ((tid & 31) == 0) red[tid >> 5] = acc;
      __syncthreads();
      if (tid == 0) {
        Acc total = red[0];
#pragma unroll
        for (int w = 1; w < kWideThreads / 32; ++w) total = merge(total, red[w]);
        write_row(loss, lse_out, ch.row, total, v, smoothing);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T, int LPR, int MAXV>
cudaError_t launch_warp(const T* x, const int64_t* labels, float* loss,
                        float* lse, int n, int v, float smoothing,
                        cudaStream_t stream) {
  constexpr int kGroups = kWarpBlock / LPR;
  auto kernel = xent_warp_kernel<T, LPR, MAXV>;
  static int per_sm = 0;
  int resident = 0;
  const cudaError_t err = sm90::resident_blocks(kernel, kWarpBlock, 0, per_sm, &resident);
  if (err != cudaSuccess) return err;
  const int groups = sm90::even_groups(n, resident * kGroups);
  kernel<<<(groups + kGroups - 1) / kGroups, kWarpBlock, 0, stream>>>(
      x, labels, loss, lse, n, v, smoothing);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_wide(const T* x, const int64_t* labels, float* loss,
                        float* lse, int n, int v, float smoothing,
                        cudaStream_t stream) {
  auto kernel = xent_wide_kernel<T>;
  constexpr int kSmem = kStages * kChunk;
  // the ring passes 48 KB: opt in once (a host call kept out of the
  // launches a CUDA graph may capture)
  static bool smem_ready = false;
  cudaError_t err = sm90::allow_smem(kernel, kSmem, smem_ready);
  if (err != cudaSuccess) return err;
  static int per_sm = 0;
  int resident = 0;
  err = sm90::resident_blocks(kernel, kWideThreads, kSmem, per_sm, &resident);
  if (err != cudaSuccess) return err;
  const long long row_bytes = (long long)v * sizeof(T);
  const int nc = (int)((row_bytes + kChunk - 1) / kChunk);
  kernel<<<sm90::even_groups(n, resident), kWideThreads, kSmem, stream>>>(
      x, labels, loss, lse, n, v, smoothing, nc);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* logits, const int64_t* labels, float* loss,
                   float* lse, int n, int v, float smoothing, int path,
                   cudaStream_t stream) {
  const T* x = static_cast<const T*>(logits);
  // vectors a row spans: what each path holds
  const long long loads = ((long long)v * sizeof(T) + 15) / 16;
  switch (path) {
    case kPathLanes8x1:
      if (loads > 8) return cudaErrorInvalidValue;
      return launch_warp<T, 8, 1>(x, labels, loss, lse, n, v, smoothing, stream);
    case kPathLanes8x2:
      if (loads > 16) return cudaErrorInvalidValue;
      return launch_warp<T, 8, 2>(x, labels, loss, lse, n, v, smoothing, stream);
    case kPathLanes8x4:
      if (loads > 32) return cudaErrorInvalidValue;
      return launch_warp<T, 8, 4>(x, labels, loss, lse, n, v, smoothing, stream);
    case kPathLanes16x4:
      if (loads > 64) return cudaErrorInvalidValue;
      return launch_warp<T, 16, 4>(x, labels, loss, lse, n, v, smoothing, stream);
    case kPathLanes32x4:
      if (loads > 128) return cudaErrorInvalidValue;
      return launch_warp<T, 32, 4>(x, labels, loss, lse, n, v, smoothing, stream);
    case kPathWide:
      return launch_wide<T>(x, labels, loss, lse, n, v, smoothing, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// logits: (n, v) contiguous, of `dtype`.  labels: (n,) int64.  loss, lse:
// (n,) fp32.  path: the plan code (0-4 the small-row instances, 5 the
// ring).  Returns cudaSuccess (0) or the launch error.
extern "C" int apex_xent_fwd(const void* logits, const void* labels,
                             void* loss, void* lse, int n, int v,
                             float smoothing, int dtype, int path,
                             void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == kDtypeF32)
    return (int)launch<float>(logits, lab, lo, ls, n, v, smoothing, path, s);
  if (dtype == kDtypeBF16)
    return (int)launch<__nv_bfloat16>(logits, lab, lo, ls, n, v, smoothing, path, s);
  if (dtype == kDtypeF16)
    return (int)launch<__half>(logits, lab, lo, ls, n, v, smoothing, path, s);
  return (int)cudaErrorInvalidValue;
}

// Layer-norm forward and backward for Hopper (sm_90a), at any row width.
//
// Replaces the TPU kernels apex_tpu/ops/layer_norm.py `_fwd_kernel` (reached
// through `ln_fwd_pallas`) and `_bwd_kernel` (through `ln_bwd_pallas`).
// Forward: row layer norm over x (N, H) with an optional affine (weight,
// bias), emitting out (N, H) in x's dtype plus the fp32 residuals mean
// (N, 1) and invvar (N, 1).  Backward: from the saved residuals, per row
//   x^ = (x - mean) * invvar,  gw = g * w (g when non-affine),
//   dx = (gw - mean(gw) - x^ * mean(gw * x^)) * invvar,
// written in x's dtype; dw and db are column sums the caller takes.
//
// What bounds both: bytes.  Each element is read once and written once and
// costs ~8 (forward) or ~12 (backward) flops, far below the card's ~295
// flops/byte balance point, so the least time is the bytes over 3.35 TB/s.
// Numerics are the TPU kernel's: fp32 mean first, then the variance of the
// centred row (no E[x^2] - mean^2); both backward row means in fp32.
//
// The Python wrapper picks one of three paths from (N, H, dtype, alignment)
// and passes it in (`_ln_plan` in apex_tpu_torch/ops/layer_norm.py):
//   * kPathWarp: a row in registers, one warp a row.  The backward's warps
//     are persistent: each walks rows with a stride, holds its columns'
//     weights in registers (loaded once, as 16-byte vectors, not per
//     element), loads the next row's g, x, mean and invvar while it reduces
//     and stores the current one, and takes both row sums through one
//     interleaved shuffle tree.
//   * kPathBlock: a row in registers, one 256-thread block a row, one
//     shared-memory step across its warps; the backward's weights in
//     16-byte vectors too.
//   Both forward register paths read the weight and bias as 16-byte
//   vectors, and are built apart for the affine and the plain norm.
//   * kPathWideSmem / kPathWideReread: any wider row, one 512-thread block
//     a row.  The row (x, or g and x) is kept in dynamic shared memory when
//     it fits in a block's 227 KB, else re-read from device memory (L2) in
//     the later passes.
// Each path takes 16-byte vectors (8 fp16 / bf16 or 4 fp32) when H is a
// multiple of the vector and every row pointer is 16-byte aligned, and
// element loads otherwise (`vec` = 0): odd widths and unaligned views are
// right first; their speed is later work.
//
// The C entry points take raw device pointers and the caller's stream and
// return cudaGetLastError(); the Python wrapper checks shapes and dtypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include "sm90_common.cuh"

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeF16 = 2;

constexpr int kPathWarp = 0;
constexpr int kPathBlock = 1;
constexpr int kPathWideSmem = 2;    // the row staged in shared memory
constexpr int kPathWideReread = 3;  // the row re-read from device memory

constexpr int kBlockThreads = 256;  // kPathBlock: threads a row
constexpr int kWideThreads = 512;   // the wide paths: threads a row
constexpr int kMaxv = 4;            // register paths: vectors a thread holds
constexpr int kWarpRows = 4;        // kPathWarp: rows (warps) a block
// a block's shared memory on Hopper (232,448 bytes) less the static
// reduction scratch
constexpr int kMaxSmem = 232448 - 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) { *dst = __float2bfloat16(v); }
// round to nearest: past fp16's range the value becomes inf, as the plain
// version's cast gives it
__device__ __forceinline__ void from_f32(float v, __half* dst) { *dst = __float2half_rn(v); }

template <typename T>
struct Type { using type = T; };

// f(Type<element>) for a dtype code (fp32, bf16 or fp16);
// cudaErrorInvalidValue for another code.
template <class F>
cudaError_t with_type(int dtype, F f) {
  switch (dtype) {
    case kDtypeF32: return f(Type<float>{});
    case kDtypeBF16: return f(Type<__nv_bfloat16>{});
    case kDtypeF16: return f(Type<__half>{});
    default: return cudaErrorInvalidValue;
  }
}

// f(Type<x's element>, Type<w's element>)
template <class F>
cudaError_t with_types(int x_dtype, int w_dtype, F f) {
  return with_type(x_dtype, [&](auto xt) {
    return with_type(w_dtype, [&](auto wt) { return f(xt, wt); });
  });
}

// An unsigned integer type of B bytes, B in {2, 4, 8, 16}.
template <int B> struct Raw;
template <> struct Raw<2> { using type = unsigned short; };
template <> struct Raw<4> { using type = unsigned int; };
template <> struct Raw<8> { using type = uint2; };
template <> struct Raw<16> { using type = uint4; };

// N elements of `p` (aligned to N * sizeof(T), or to 16 bytes past that) as
// raw words: 16-byte loads where the N elements span 16 bytes or more.
template <typename T, int N>
struct Pack {
  static constexpr int kBytes = N * (int)sizeof(T);
  static constexpr int kWord = kBytes >= 16 ? 16 : kBytes;
  using W = typename Raw<kWord>::type;
  W w[kBytes / kWord];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < kBytes / kWord; ++i) w[i] = __ldg(reinterpret_cast<const W*>(p) + i);
  }
  __device__ __forceinline__ void load_shared(const T* p) {
#pragma unroll
    for (int i = 0; i < kBytes / kWord; ++i) w[i] = reinterpret_cast<const W*>(p)[i];
  }
  __device__ __forceinline__ void store(T* p) const {
#pragma unroll
    for (int i = 0; i < kBytes / kWord; ++i) reinterpret_cast<W*>(p)[i] = w[i];
  }
  __device__ __forceinline__ float operator[](int j) const {
    return to_f32(reinterpret_cast<const T*>(w)[j]);
  }
  __device__ __forceinline__ void set(int j, float v) {
    from_f32(v, reinterpret_cast<T*>(w) + j);
  }
};

// Sums across the TPR threads that share a row, two values at once (their
// shuffles interleaved).  TPR == 32: shuffles only.  TPR > 32: shuffles,
// then one shared-memory exchange across the row's warps (the block then
// holds exactly one row, blockDim = TPR).
template <int TPR>
__device__ __forceinline__ void row_sum2(float& a, float& b, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a += __shfl_xor_sync(0xffffffffu, a, off);
    b += __shfl_xor_sync(0xffffffffu, b, off);
  }
  if constexpr (TPR > 32) {
    constexpr int kWarps = TPR / 32;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // red[] may still be read from the previous reduction
    if (lane == 0) red[warp] = make_float2(a, b);
    __syncthreads();
    a = 0.f;
    b = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      a += red[w].x;
      b += red[w].y;
    }
  }
}

template <int TPR>
__device__ __forceinline__ float row_sum(float v, float2* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (TPR > 32) {
    constexpr int kWarps = TPR / 32;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // red[] may still be read from the previous reduction
    if (lane == 0) red[warp].x = v;
    __syncthreads();
    v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w].x;
  }
  return v;
}

// ---------------------------------------------------------------------------
// forward, register paths
// ---------------------------------------------------------------------------

// T: x/out element type.  WT: weight/bias element type.  TPR: threads per
// row.  VEC: elements a load (16 / sizeof(T), or 1 for element loads).
// The row must fit in TPR * kMaxv loads.
template <typename T, typename WT, int TPR, int VEC, bool kAffine>
__global__ void __launch_bounds__(TPR == 32 ? 32 * kWarpRows : TPR)
ln_fwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
              const WT* __restrict__ b, T* __restrict__ out,
              float* __restrict__ mean_out, float* __restrict__ invvar_out,
              int n_rows, int h, float eps) {
  __shared__ float2 red[TPR > 32 ? TPR / 32 : 1];

  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;  // whole row groups leave together (TPR==32)
  const int tid = threadIdx.x;
  const int nvec = h / VEC;

  // every load of the row issued before any is used: one memory latency a
  // row, not one a vector.  A warp's weight and bias load with it; a
  // block's, whose registers hold fewer rows an SM, after the reductions.
  constexpr bool kEarlyAffine = kAffine && TPR == 32;
  const T* xr = x + (size_t)row * h;
  Pack<T, VEC> xin[kMaxv];
  Pack<WT, VEC> wv[kAffine ? kMaxv : 1], bv[kAffine ? kMaxv : 1];
#pragma unroll
  for (int i = 0; i < kMaxv; ++i) {
    const int vi = tid + i * TPR;
    if (vi < nvec) {
      xin[i].load(xr + vi * VEC);
      if constexpr (kEarlyAffine) {
        wv[i].load(w + vi * VEC);
        bv[i].load(b + vi * VEC);
      }
    }
  }
  float vals[kMaxv][VEC];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxv; ++i) {
    if (tid + i * TPR < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        vals[i][j] = xin[i][j];
        sum += vals[i][j];
      }
    }
  }
  const float inv_h = 1.f / (float)h;
  const float mean = row_sum<TPR>(sum, red) * inv_h;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxv; ++i) {
    const int vi = tid + i * TPR;
    if (vi < nvec) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = vals[i][j] - mean;
        vals[i][j] = c;
        sq += c * c;
      }
    }
  }
  const float var = row_sum<TPR>(sq, red) * inv_h;
  const float invvar = rsqrtf(var + eps);

  T* orow = out + (size_t)row * h;
#pragma unroll
  for (int i = 0; i < kMaxv; ++i) {
    const int vi = tid + i * TPR;
    if (vi < nvec) {
      Pack<T, VEC> raw;
      if constexpr (kAffine) {
        if constexpr (!kEarlyAffine) {
          wv[i].load(w + vi * VEC);
          bv[i].load(b + vi * VEC);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) raw.set(j, vals[i][j] * invvar * wv[i][j] + bv[i][j]);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) raw.set(j, vals[i][j] * invvar);
      }
      raw.store(orow + vi * VEC);
    }
  }
  if (tid == 0) {
    mean_out[row] = mean;
    invvar_out[row] = invvar;
  }
}

// ---------------------------------------------------------------------------
// backward, register paths: persistent row groups
// ---------------------------------------------------------------------------

// One row's inputs as loaded: g and x raw, mean and invvar.
template <typename T, int VEC>
struct BwdRow {
  Pack<T, VEC> g[kMaxv], x[kMaxv];
  float mean, invvar;

  __device__ __forceinline__ void load(const T* gp, const T* xp, const float* m,
                                       const float* iv, int row, int h,
                                       int tid, int tpr) {
    const size_t off = (size_t)row * h;
    const int nvec = h / VEC;
#pragma unroll
    for (int i = 0; i < kMaxv; ++i) {
      const int vi = tid + i * tpr;
      if (vi < nvec) {
        g[i].load(gp + off + vi * VEC);
        x[i].load(xp + off + vi * VEC);
      }
    }
    mean = __ldg(m + row);
    invvar = __ldg(iv + row);
  }
};

// A row group (a warp, TPR 32, with kWarpRows groups a block; or a block,
// TPR 256) takes row `group`.  kPersist (the warps): the group walks rows
// group, group + n_groups, ... over a grid sized to the card's resident
// blocks, loading the next row while it reduces this one; a block of 256
// takes one row (its neighbours on the SM overlap its loads, and a second
// row in registers would halve them).  kAffine: a weight is given (its
// columns are loaded once into registers, as 16-byte vectors).
template <typename T, typename WT, int TPR, int VEC, bool kAffine,
          bool kPersist = (TPR == 32)>
__global__ void __launch_bounds__(TPR == 32 ? 32 * kWarpRows : TPR)
ln_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
              const float* __restrict__ mean_in,
              const float* __restrict__ invvar_in, const WT* __restrict__ w,
              T* __restrict__ dx, int n_rows, int h) {
  __shared__ float2 red[TPR > 32 ? TPR / 32 : 1];
  const int tid = threadIdx.x;
  const int nvec = h / VEC;
  const int group = blockIdx.x * blockDim.y + threadIdx.y;
  const int n_groups = gridDim.x * blockDim.y;
  int row = group;
  if (row >= n_rows) return;  // whole row groups leave together

  const float inv_h = 1.f / (float)h;
  BwdRow<T, VEC> cur;
  cur.load(g, x, mean_in, invvar_in, row, h, tid, TPR);
  // the weights after the first row's loads are in flight (their
  // conversion would otherwise hold those loads back)
  float wf[kAffine ? kMaxv : 1][VEC];
  if constexpr (kAffine) {
    Pack<WT, VEC> wv[kMaxv];
#pragma unroll
    for (int i = 0; i < kMaxv; ++i)
      if (tid + i * TPR < nvec) wv[i].load(w + (tid + i * TPR) * VEC);
#pragma unroll
    for (int i = 0; i < kMaxv; ++i) {
      if (tid + i * TPR < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) wf[i][j] = wv[i][j];
      }
    }
  }

  while (true) {
    const int next_row = row + n_groups;
    const bool more = kPersist && next_row < n_rows;
    BwdRow<T, VEC> nxt;
    if constexpr (kPersist) {
      if (more) nxt.load(g, x, mean_in, invvar_in, next_row, h, tid, TPR);
    }

    // the block path keeps g w and x^ from the sums for dx; the warps,
    // with a second row in registers, take them again from the raw row
    float gw_c[kPersist ? 1 : kMaxv][VEC], xh_c[kPersist ? 1 : kMaxv][VEC];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxv; ++i) {
      const int vi = tid + i * TPR;
      if (vi < nvec) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float gj = cur.g[i][j];
          if constexpr (kAffine) gj *= wf[i][j];
          const float xj = (cur.x[i][j] - cur.mean) * cur.invvar;
          if constexpr (!kPersist) {
            gw_c[i][j] = gj;
            xh_c[i][j] = xj;
          }
          s1 += gj;
          s2 += gj * xj;
        }
      }
    }
    row_sum2<TPR>(s1, s2, red);
    const float m1 = s1 * inv_h, m2 = s2 * inv_h;

    T* drow = dx + (size_t)row * h;
#pragma unroll
    for (int i = 0; i < kMaxv; ++i) {
      const int vi = tid + i * TPR;
      if (vi < nvec) {
        Pack<T, VEC> raw;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          float gj, xj;
          if constexpr (kPersist) {
            gj = cur.g[i][j];
            if constexpr (kAffine) gj *= wf[i][j];
            xj = (cur.x[i][j] - cur.mean) * cur.invvar;
          } else {
            gj = gw_c[i][j];
            xj = xh_c[i][j];
          }
          raw.set(j, (gj - m1 - xj * m2) * cur.invvar);
        }
        raw.store(drow + vi * VEC);
      }
    }
    if (!more) break;
    row = next_row;
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// the wide path: a 512-thread block a row, the row in shared memory or
// re-read from device memory
// ---------------------------------------------------------------------------

// Element i (in loads of VEC) of a row that lives in `global` and, when
// `stage` is not null, also in shared memory.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> reread(const T* global, const T* stage, int vi) {
  Pack<T, VEC> p;
  if (stage != nullptr) p.load_shared(stage + vi * VEC);
  else p.load(global + vi * VEC);
  return p;
}

template <typename T, typename WT, int VEC>
__global__ void __launch_bounds__(kWideThreads)
ln_fwd_wide_kernel(const T* __restrict__ x, const WT* __restrict__ w,
                   const WT* __restrict__ b, T* __restrict__ out,
                   float* __restrict__ mean_out, float* __restrict__ invvar_out,
                   int h, float eps, bool in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float2 red[kWideThreads / 32];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int nvec = h / VEC;
  const T* xr = x + (size_t)row * h;
  T* stage = in_smem ? reinterpret_cast<T*>(smem_raw) : nullptr;

  float sum = 0.f;
#pragma unroll 4
  for (int vi = tid; vi < nvec; vi += kWideThreads) {
    Pack<T, VEC> p;
    p.load(xr + vi * VEC);
    if (stage != nullptr) p.store(stage + vi * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) sum += p[j];
  }
  const float inv_h = 1.f / (float)h;
  const float mean = row_sum<kWideThreads>(sum, red) * inv_h;

  float sq = 0.f;
#pragma unroll 4
  for (int vi = tid; vi < nvec; vi += kWideThreads) {
    const Pack<T, VEC> p = reread<T, VEC>(xr, stage, vi);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float c = p[j] - mean;
      sq += c * c;
    }
  }
  const float invvar = rsqrtf(row_sum<kWideThreads>(sq, red) * inv_h + eps);

  T* orow = out + (size_t)row * h;
#pragma unroll 4
  for (int vi = tid; vi < nvec; vi += kWideThreads) {
    const Pack<T, VEC> p = reread<T, VEC>(xr, stage, vi);
    Pack<T, VEC> o;
    if (w != nullptr) {
      Pack<WT, VEC> wv, bv;
      wv.load(w + vi * VEC);
      bv.load(b + vi * VEC);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.set(j, (p[j] - mean) * invvar * wv[j] + bv[j]);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) o.set(j, (p[j] - mean) * invvar);
    }
    o.store(orow + vi * VEC);
  }
  if (tid == 0) {
    mean_out[row] = mean;
    invvar_out[row] = invvar;
  }
}

template <typename T, typename WT, int VEC>
__global__ void __launch_bounds__(kWideThreads)
ln_bwd_wide_kernel(const T* __restrict__ g, const T* __restrict__ x,
                   const float* __restrict__ mean_in,
                   const float* __restrict__ invvar_in,
                   const WT* __restrict__ w, T* __restrict__ dx, int h,
                   bool in_smem) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ float2 red[kWideThreads / 32];
  const int tid = threadIdx.x;
  const int row = blockIdx.x;
  const int nvec = h / VEC;
  const size_t off = (size_t)row * h;
  const T* gr = g + off;
  const T* xr = x + off;
  // g at the start, x after it (h rounded up to 16 bytes)
  const int h_pad = (h * (int)sizeof(T) + 15) / 16 * 16 / (int)sizeof(T);
  T* g_stage = in_smem ? reinterpret_cast<T*>(smem_raw) : nullptr;
  T* x_stage = in_smem ? g_stage + h_pad : nullptr;
  const float mean = mean_in[row], invvar = invvar_in[row];

  float s1 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int vi = tid; vi < nvec; vi += kWideThreads) {
    Pack<T, VEC> gp, xp;
    gp.load(gr + vi * VEC);
    xp.load(xr + vi * VEC);
    if (in_smem) {
      gp.store(g_stage + vi * VEC);
      xp.store(x_stage + vi * VEC);
    }
    Pack<WT, VEC> wv;
    if (w != nullptr) wv.load(w + vi * VEC);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float gj = w != nullptr ? gp[j] * wv[j] : gp[j];
      s1 += gj;
      s2 += gj * (xp[j] - mean) * invvar;
    }
  }
  row_sum2<kWideThreads>(s1, s2, red);
  const float inv_h = 1.f / (float)h;
  const float m1 = s1 * inv_h, m2 = s2 * inv_h;

  T* drow = dx + off;
#pragma unroll 4
  for (int vi = tid; vi < nvec; vi += kWideThreads) {
    const Pack<T, VEC> gp = reread<T, VEC>(gr, g_stage, vi);
    const Pack<T, VEC> xp = reread<T, VEC>(xr, x_stage, vi);
    Pack<WT, VEC> wv;
    if (w != nullptr) wv.load(w + vi * VEC);
    Pack<T, VEC> o;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float gj = w != nullptr ? gp[j] * wv[j] : gp[j];
      const float xj = (xp[j] - mean) * invvar;
      o.set(j, (gj - m1 - xj * m2) * invvar);
    }
    o.store(drow + vi * VEC);
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

// Bytes of shared memory the wide path stages `rows` rows of h elements
// in, each rounded up to 16 bytes (kPathWideSmem; the wrapper's plan takes
// it where this is at most kMaxSmem).
template <typename T>
long long wide_smem_bytes(int h, int rows) {
  return (long long)rows * (((long long)h * sizeof(T) + 15) / 16 * 16);
}

template <typename T, typename WT, int VEC>
cudaError_t launch_fwd(const T* x, const WT* w, const WT* b, T* out,
                       float* mean, float* invvar, int n_rows, int h,
                       float eps, int path, cudaStream_t stream) {
  if (h % VEC != 0) return cudaErrorInvalidValue;
  const int nvec = h / VEC;
  if (path == kPathWarp) {
    if (nvec > 32 * kMaxv) return cudaErrorInvalidValue;
    // one warp per row, four rows per 128-thread block
    dim3 block(32, kWarpRows);
    dim3 grid((n_rows + kWarpRows - 1) / kWarpRows);
    auto kernel = w != nullptr ? ln_fwd_kernel<T, WT, 32, VEC, true>
                               : ln_fwd_kernel<T, WT, 32, VEC, false>;
    kernel<<<grid, block, 0, stream>>>(x, w, b, out, mean, invvar, n_rows, h, eps);
  } else if (path == kPathBlock) {
    if (nvec > kBlockThreads * kMaxv) return cudaErrorInvalidValue;
    auto kernel = w != nullptr ? ln_fwd_kernel<T, WT, kBlockThreads, VEC, true>
                               : ln_fwd_kernel<T, WT, kBlockThreads, VEC, false>;
    kernel<<<n_rows, dim3(kBlockThreads, 1), 0, stream>>>(x, w, b, out, mean, invvar, n_rows,
                                                          h, eps);
  } else if (path == kPathWideSmem || path == kPathWideReread) {
    const long long bytes = path == kPathWideSmem ? wide_smem_bytes<T>(h, 1) : 0;
    if (bytes > kMaxSmem) return cudaErrorInvalidValue;
    auto kernel = ln_fwd_wide_kernel<T, WT, VEC>;
    // a block's whole shared memory, opted into once (a host call kept out
    // of the launches a CUDA graph may capture)
    static bool smem_ready = false;
    const cudaError_t err = sm90::allow_smem(kernel, kMaxSmem, smem_ready);
    if (err != cudaSuccess) return err;
    kernel<<<n_rows, kWideThreads, (int)bytes, stream>>>(x, w, b, out, mean, invvar, h, eps,
                                                         bytes > 0);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename WT, int TPR, int VEC, bool kAffine>
cudaError_t launch_bwd_rows(const T* g, const T* x, const float* mean,
                            const float* invvar, const WT* w, T* dx,
                            int n_rows, int h, cudaStream_t stream) {
  auto kernel = ln_bwd_kernel<T, WT, TPR, VEC, kAffine>;
  if constexpr (TPR != 32) {
    // a block a row
    kernel<<<n_rows, dim3(TPR, 1), 0, stream>>>(g, x, mean, invvar, w, dx, n_rows, h);
    return cudaGetLastError();
  }
  const int rows_a_block = kWarpRows;
  static int per_sm = 0;
  int resident = 0;
  const cudaError_t err =
      sm90::resident_blocks(kernel, TPR * rows_a_block, 0, per_sm, &resident);
  if (err != cudaSuccess) return err;
  const int groups = sm90::even_groups(n_rows, resident * rows_a_block);
  const int grid = (groups + rows_a_block - 1) / rows_a_block;
  kernel<<<grid, dim3(TPR, rows_a_block), 0, stream>>>(g, x, mean, invvar, w, dx, n_rows, h);
  return cudaGetLastError();
}

template <typename T, typename WT, int VEC>
cudaError_t launch_bwd(const T* g, const T* x, const float* mean,
                       const float* invvar, const WT* w, T* dx, int n_rows,
                       int h, int path, cudaStream_t stream) {
  if (h % VEC != 0) return cudaErrorInvalidValue;
  const int nvec = h / VEC;
  if (path == kPathWarp) {
    if (nvec > 32 * kMaxv) return cudaErrorInvalidValue;
    return w != nullptr
        ? launch_bwd_rows<T, WT, 32, VEC, true>(g, x, mean, invvar, w, dx, n_rows, h, stream)
        : launch_bwd_rows<T, WT, 32, VEC, false>(g, x, mean, invvar, w, dx, n_rows, h, stream);
  }
  if (path == kPathBlock) {
    if (nvec > kBlockThreads * kMaxv) return cudaErrorInvalidValue;
    return w != nullptr
        ? launch_bwd_rows<T, WT, kBlockThreads, VEC, true>(g, x, mean, invvar, w, dx, n_rows, h, stream)
        : launch_bwd_rows<T, WT, kBlockThreads, VEC, false>(g, x, mean, invvar, w, dx, n_rows, h, stream);
  }
  if (path == kPathWideSmem || path == kPathWideReread) {
    const long long bytes = path == kPathWideSmem ? wide_smem_bytes<T>(h, 2) : 0;
    if (bytes > kMaxSmem) return cudaErrorInvalidValue;
    auto kernel = ln_bwd_wide_kernel<T, WT, VEC>;
    // a block's whole shared memory, opted into once (a host call kept out
    // of the launches a CUDA graph may capture)
    static bool smem_ready = false;
    const cudaError_t err = sm90::allow_smem(kernel, kMaxSmem, smem_ready);
    if (err != cudaSuccess) return err;
    kernel<<<n_rows, kWideThreads, (int)bytes, stream>>>(g, x, mean, invvar, w, dx, h,
                                                         bytes > 0);
    return cudaGetLastError();
  }
  return cudaErrorInvalidValue;
}

// f(Type<char[VEC]>) for VEC the elements a load: 16 bytes' worth (vec !=
// 0) or one (element loads).
template <typename T, class F>
cudaError_t with_vec(int vec, F f) {
  if (vec) return f(Type<char[16 / sizeof(T)]>{});
  return f(Type<char[1]>{});
}

}  // namespace

// x, out: (n_rows, h) contiguous, of x_dtype.  w, b: (h,) of w_dtype, or
// both null for the non-affine norm.  mean, invvar: (n_rows,) fp32.
// path: 0 a warp a row (h <= 128 loads), 1 a block a row (h <= 1024
// loads), 2 the wide path with the row in shared memory (h * size at most
// 227 KB less 1 KB), 3 the wide path re-reading the row (any h).  vec: 1 for 16-byte loads (h a multiple
// of 16 bytes' elements, x, out, w and b 16-byte aligned), 0 for element
// loads.  Returns cudaSuccess (0) or the launch error.
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* out, void* mean, void* invvar, int n_rows,
                           int h, float eps, int x_dtype, int w_dtype,
                           int path, int vec, void* stream) {
  if (n_rows <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* iv = static_cast<float*>(invvar);
  return (int)with_types(x_dtype, w_dtype, [&](auto xt, auto wt) {
    using T = typename decltype(xt)::type;
    using WT = typename decltype(wt)::type;
    return with_vec<T>(vec, [&](auto vt) {
      constexpr int VEC = sizeof(typename decltype(vt)::type);
      return launch_fwd<T, WT, VEC>(
          static_cast<const T*>(x), static_cast<const WT*>(w),
          static_cast<const WT*>(b), static_cast<T*>(out), m, iv, n_rows, h,
          eps, path, s);
    });
  });
}

// g, x, dx: (n_rows, h) contiguous, of x_dtype.  mean, invvar: (n_rows,)
// fp32 from the forward.  w: (h,) of w_dtype, or null for the non-affine
// norm.  path and vec as for apex_ln_fwd (vec: g, x, dx and w 16-byte
// aligned).
extern "C" int apex_ln_bwd(const void* g, const void* x, const void* mean,
                           const void* invvar, const void* w, void* dx,
                           int n_rows, int h, int x_dtype, int w_dtype,
                           int path, int vec, void* stream) {
  if (n_rows <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(invvar);
  return (int)with_types(x_dtype, w_dtype, [&](auto xt, auto wt) {
    using T = typename decltype(xt)::type;
    using WT = typename decltype(wt)::type;
    return with_vec<T>(vec, [&](auto vt) {
      constexpr int VEC = sizeof(typename decltype(vt)::type);
      return launch_bwd<T, WT, VEC>(
          static_cast<const T*>(g), static_cast<const T*>(x), m, iv,
          static_cast<const WT*>(w), static_cast<T*>(dx), n_rows, h, path, s);
    });
  });
}

// Message for an error code returned by any entry point of this library.
extern "C" const char* apex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

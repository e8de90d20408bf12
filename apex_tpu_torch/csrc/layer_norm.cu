// Layer-norm forward and backward for Hopper (sm_90a).  The backward
// (`ln_bwd_kernel`, `apex_ln_bwd`) is described where it is defined.
//
// Replaces the TPU kernel apex_tpu/ops/layer_norm.py `_fwd_kernel` (reached
// through `ln_fwd_pallas`): row layer norm over x (N, H) with an optional
// affine (weight, bias), emitting out (N, H) in x's dtype plus the fp32
// residuals mean (N, 1) and invvar (N, 1).
//
// What bounds it: bytes.  Each element is read once and written once and
// costs ~8 flops, far below the card's ~295 flops/byte balance point, so the
// least time is (2 * N * H * sizeof(T)) / 3.35 TB/s.  At the serving shapes
// (512 x 1024 and 8 x 1024 bf16) that is under a microsecond, so the launch
// itself dominates; the design keeps one launch per call and one pass over
// device memory:
//   * a row is held in registers, loaded with 16-byte vector loads
//     (8 fp16 / bf16 or 4 fp32 per load), so x is read from device memory
//     once;
//   * narrow rows (<= 128 vectors) take one warp per row and reduce with
//     warp shuffles only; wider rows take a 256-thread block per row and
//     add one shared-memory step across its warps;
//   * mean first, then the variance of the centred row, both in fp32 — the
//     same two-pass numerics as the TPU kernel (no E[x^2] - mean^2).
//
// The C entry point takes raw device pointers and the caller's stream and
// returns cudaGetLastError(); the Python wrapper checks shapes and dtypes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeF16 = 2;

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

// Sum across the TPR threads that share a row.  TPR == 32: shuffles only.
// TPR > 32: shuffles, then one shared-memory exchange across the row's warps
// (the block then holds exactly one row, blockDim = (TPR, 1)).
template <int TPR>
__device__ __forceinline__ float row_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if constexpr (TPR > 32) {
    constexpr int kWarps = TPR / 32;
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    __syncthreads();  // red[] may still be read from the previous reduction
    if (lane == 0) red[warp] = v;
    __syncthreads();
    v = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v += red[w];
  }
  return v;
}

// T: x/out element type.  WT: weight/bias element type.  TPR: threads per
// row.  MAXV: 16-byte vectors a thread holds (the row must fit in
// TPR * MAXV vectors).
template <typename T, typename WT, int TPR, int MAXV>
__global__ void __launch_bounds__(128 > TPR ? 128 : TPR)
ln_fwd_kernel(const T* __restrict__ x, const WT* __restrict__ w,
              const WT* __restrict__ b, T* __restrict__ out,
              float* __restrict__ mean_out, float* __restrict__ invvar_out,
              int n_rows, int h, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[TPR > 32 ? TPR / 32 : 1];

  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;  // whole row groups leave together (TPR==32)
  const int tid = threadIdx.x;
  const int nvec = h / VEC;

  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * h);
  float vals[MAXV][VEC];

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = tid + i * TPR;
    if (vi < nvec) {
      uint4 raw = __ldg(xv + vi);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        vals[i][j] = to_f32(e[j]);
        sum += vals[i][j];
      }
    }
  }
  const float inv_h = 1.f / (float)h;
  const float mean = row_sum<TPR>(sum, red) * inv_h;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
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

  uint4* ov = reinterpret_cast<uint4*>(out + (size_t)row * h);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = tid + i * TPR;
    if (vi < nvec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float y = vals[i][j] * invvar;
        if (w != nullptr) {
          const int col = vi * VEC + j;
          y = y * to_f32(w[col]) + to_f32(b[col]);
        }
        from_f32(y, e + j);
      }
      ov[vi] = raw;
    }
  }
  if (tid == 0) {
    mean_out[row] = mean;
    invvar_out[row] = invvar;
  }
}

// Backward: replaces apex_tpu/ops/layer_norm.py `_bwd_kernel` (reached
// through `ln_bwd_pallas`).  From the saved residuals, per row:
//   x^ = (x - mean) * invvar,  gw = g * w (g when non-affine),
//   dx = (gw - mean(gw) - x^ * mean(gw * x^)) * invvar,
// written in x's dtype.  dw and db are column sums the caller takes.
// Bytes bound like the forward (g and x read once, dx written once, ~12
// flops an element); same layout: a row in registers, one warp (or one
// 256-thread block) per row, both row means in fp32 with shuffles.
template <typename T, typename WT, int TPR, int MAXV>
__global__ void __launch_bounds__(128 > TPR ? 128 : TPR)
ln_bwd_kernel(const T* __restrict__ g, const T* __restrict__ x,
              const float* __restrict__ mean_in,
              const float* __restrict__ invvar_in, const WT* __restrict__ w,
              T* __restrict__ dx, int n_rows, int h) {
  constexpr int VEC = 16 / sizeof(T);
  __shared__ float red[TPR > 32 ? TPR / 32 : 1];

  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  if (row >= n_rows) return;
  const int tid = threadIdx.x;
  const int nvec = h / VEC;
  const float mean = mean_in[row];
  const float invvar = invvar_in[row];

  const uint4* gv = reinterpret_cast<const uint4*>(g + (size_t)row * h);
  const uint4* xv = reinterpret_cast<const uint4*>(x + (size_t)row * h);
  float gw[MAXV][VEC], xh[MAXV][VEC];

  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = tid + i * TPR;
    if (vi < nvec) {
      uint4 graw = __ldg(gv + vi), xraw = __ldg(xv + vi);
      const T* ge = reinterpret_cast<const T*>(&graw);
      const T* xe = reinterpret_cast<const T*>(&xraw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float gj = to_f32(ge[j]);
        if (w != nullptr) gj *= to_f32(w[vi * VEC + j]);
        const float xj = (to_f32(xe[j]) - mean) * invvar;
        gw[i][j] = gj;
        xh[i][j] = xj;
        s1 += gj;
        s2 += gj * xj;
      }
    }
  }
  const float inv_h = 1.f / (float)h;
  const float m1 = row_sum<TPR>(s1, red) * inv_h;
  const float m2 = row_sum<TPR>(s2, red) * inv_h;

  uint4* dv = reinterpret_cast<uint4*>(dx + (size_t)row * h);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int vi = tid + i * TPR;
    if (vi < nvec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        from_f32((gw[i][j] - m1 - xh[i][j] * m2) * invvar, e + j);
      dv[vi] = raw;
    }
  }
}

template <typename T, typename WT>
cudaError_t launch_bwd(const void* g, const void* x, const float* mean,
                       const float* invvar, const void* w, void* dx,
                       int n_rows, int h, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = h / VEC;
  const T* gp = static_cast<const T*>(g);
  const T* xp = static_cast<const T*>(x);
  const WT* wp = static_cast<const WT*>(w);
  T* dp = static_cast<T*>(dx);
  if (nvec <= 32 * 4) {
    dim3 block(32, 4);
    dim3 grid((n_rows + 3) / 4);
    ln_bwd_kernel<T, WT, 32, 4><<<grid, block, 0, stream>>>(
        gp, xp, mean, invvar, wp, dp, n_rows, h);
  } else if (nvec <= 256 * 4) {
    dim3 block(256, 1);
    dim3 grid(n_rows);
    ln_bwd_kernel<T, WT, 256, 4><<<grid, block, 0, stream>>>(
        gp, xp, mean, invvar, wp, dp, n_rows, h);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

template <typename T, typename WT>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   float* mean, float* invvar, int n_rows, int h, float eps,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int nvec = h / VEC;
  const T* xp = static_cast<const T*>(x);
  const WT* wp = static_cast<const WT*>(w);
  const WT* bp = static_cast<const WT*>(b);
  T* op = static_cast<T*>(out);
  if (nvec <= 32 * 4) {
    // one warp per row, four rows per 128-thread block
    dim3 block(32, 4);
    dim3 grid((n_rows + 3) / 4);
    ln_fwd_kernel<T, WT, 32, 4><<<grid, block, 0, stream>>>(
        xp, wp, bp, op, mean, invvar, n_rows, h, eps);
  } else if (nvec <= 256 * 4) {
    // one 256-thread block per row
    dim3 block(256, 1);
    dim3 grid(n_rows);
    ln_fwd_kernel<T, WT, 256, 4><<<grid, block, 0, stream>>>(
        xp, wp, bp, op, mean, invvar, n_rows, h, eps);
  } else {
    return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

// x, out: (n_rows, h) contiguous, 16-byte aligned, of x_dtype.
// w, b: (h,) of w_dtype, or both null for the non-affine norm.
// mean, invvar: (n_rows,) fp32.  h must be a multiple of 8.
// Returns cudaSuccess (0) or the launch error.
extern "C" int apex_ln_fwd(const void* x, const void* w, const void* b,
                           void* out, void* mean, void* invvar, int n_rows,
                           int h, float eps, int x_dtype, int w_dtype,
                           void* stream) {
  if (n_rows <= 0 || h <= 0 || h % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mean);
  float* iv = static_cast<float*>(invvar);
  return (int)with_types(x_dtype, w_dtype, [&](auto xt, auto wt) {
    using T = typename decltype(xt)::type;
    using WT = typename decltype(wt)::type;
    return launch<T, WT>(x, w, b, out, m, iv, n_rows, h, eps, s);
  });
}

// g, x, dx: (n_rows, h) contiguous, 16-byte aligned, of x_dtype.
// mean, invvar: (n_rows,) fp32 from the forward.  w: (h,) of w_dtype, or
// null for the non-affine norm.  h must be a multiple of 8.
extern "C" int apex_ln_bwd(const void* g, const void* x, const void* mean,
                           const void* invvar, const void* w, void* dx,
                           int n_rows, int h, int x_dtype, int w_dtype,
                           void* stream) {
  if (n_rows <= 0 || h <= 0 || h % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mean);
  const float* iv = static_cast<const float*>(invvar);
  return (int)with_types(x_dtype, w_dtype, [&](auto xt, auto wt) {
    using T = typename decltype(xt)::type;
    using WT = typename decltype(wt)::type;
    return launch_bwd<T, WT>(g, x, m, iv, w, dx, n_rows, h, s);
  });
}

// Message for an error code returned by any entry point of this library.
extern "C" const char* apex_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

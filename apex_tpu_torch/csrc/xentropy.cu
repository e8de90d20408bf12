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
// element); at the training shape (4096 x 30592 bf16, 250.6 MB) the least
// time is ~75 us.  Design: one 256-thread block per row walks the vocab in
// 16-byte vectors (8 fp16 / bf16 or 4 fp32; scalar loads when rows are not
// 16-byte aligned, i.e. V not a multiple of the vector), each thread
// keeping an online (max, sum of exp) pair, the row sum and the gold logit
// in fp32; the pairs merge by warp shuffles and one shared-memory step.
// Columns past V in the last vector are masked.  An fp16 logit that is inf
// or NaN is read as it is, so the loss is what the plain version gives.
// Speed work is for later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeF16 = 2;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

struct Acc {
  float m, s, xsum;  // running max, sum of exp(x - m), sum of x
};

__device__ __forceinline__ Acc merge(Acc a, Acc b) {
  const float m = fmaxf(a.m, b.m);
  return {m, a.s * expf(a.m - m) + b.s * expf(b.m - m), a.xsum + b.xsum};
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
xent_fwd_kernel(const T* __restrict__ logits, const int64_t* __restrict__ labels,
                float* __restrict__ loss, float* __restrict__ lse_out,
                int v, float smoothing) {
  __shared__ Acc red[kThreads / 32];
  const int row = blockIdx.x;
  const int tid = threadIdx.x;
  const T* x = logits + (size_t)row * v;

  Acc acc = {kNegInf, 0.f, 0.f};
  const int nvec = (v + VEC - 1) / VEC;
  for (int vi = tid; vi < nvec; vi += kThreads) {
    float e[VEC];
    if constexpr (VEC > 1) {
      // rows are 16-byte aligned (v % VEC == 0), so a vector never
      // straddles the row's end
      const uint4 raw = __ldg(reinterpret_cast<const uint4*>(x) + vi);
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) e[j] = to_f32(t[j]);
    } else {
      e[0] = to_f32(x[vi]);
    }
    float mx = kNegInf, xs = 0.f;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      if (vi * VEC + j < v) {
        mx = fmaxf(mx, e[j]);
        xs += e[j];
      }
    }
    const float m = fmaxf(acc.m, mx);
    float s = acc.s * expf(acc.m - m);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      if (vi * VEC + j < v) s += expf(e[j] - m);
    acc = {m, s, acc.xsum + xs};
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Acc o = {__shfl_xor_sync(0xffffffffu, acc.m, off),
             __shfl_xor_sync(0xffffffffu, acc.s, off),
             __shfl_xor_sync(0xffffffffu, acc.xsum, off)};
    acc = merge(acc, o);
  }
  if ((tid & 31) == 0) red[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    Acc total = red[0];
#pragma unroll
    for (int w = 1; w < kThreads / 32; ++w) total = merge(total, red[w]);
    const float lse = total.m + logf(total.s);
    const int64_t label = labels[row];
    const float gold = (label >= 0 && label < v) ? to_f32(x[label]) : 0.f;
    const float nll = lse - gold;
    const float smooth = lse - total.xsum / (float)v;
    loss[row] = (1.f - smoothing) * nll + smoothing * smooth;
    lse_out[row] = lse;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const int64_t* labels, float* loss,
                   float* lse, int n, int v, float smoothing,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* x = static_cast<const T*>(logits);
  if (v % VEC == 0) {
    xent_fwd_kernel<T, VEC><<<n, kThreads, 0, stream>>>(x, labels, loss, lse,
                                                        v, smoothing);
  } else {
    xent_fwd_kernel<T, 1><<<n, kThreads, 0, stream>>>(x, labels, loss, lse,
                                                      v, smoothing);
  }
  return cudaGetLastError();
}

}  // namespace

// logits: (n, v) contiguous, 16-byte aligned, of `dtype`.  labels: (n,)
// int64.  loss, lse: (n,) fp32.  Returns cudaSuccess (0) or the launch
// error.
extern "C" int apex_xent_fwd(const void* logits, const void* labels,
                             void* loss, void* lse, int n, int v,
                             float smoothing, int dtype, void* stream) {
  if (n <= 0 || v <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* lab = static_cast<const int64_t*>(labels);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  if (dtype == kDtypeF32)
    return (int)launch<float>(logits, lab, lo, ls, n, v, smoothing, s);
  if (dtype == kDtypeBF16)
    return (int)launch<__nv_bfloat16>(logits, lab, lo, ls, n, v, smoothing, s);
  if (dtype == kDtypeF16)
    return (int)launch<__half>(logits, lab, lo, ls, n, v, smoothing, s);
  return (int)cudaErrorInvalidValue;
}

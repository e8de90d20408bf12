// Multi-tensor L2 norm over a flat buffer for Hopper (sm_90a).
//
// Replaces the TPU kernel apex_tpu/multi_tensor_apply/kernels.py
// `multi_tensor_l2norm`: sqrt(sum x^2) over the flat (total,) buffer the
// TreeFlattener packs, read in its own dtype (bf16 or fp32) and
// accumulated in fp32.  FusedLAMB's global-grad-norm clip rides on it.
//
// What bounds it: bytes.  Each element is read once for 2 flops; the
// BERT-large flat fp32 buffer (334,233,600 values, 1.34 GB) takes at least
// ~0.40 ms at 3.35 TB/s.  The TPU kernel sums into one scratch cell across
// a sequential grid; blocks on Hopper run in no order, so the reduction is
// two launches:
//   1. a fixed grid of blocks walks the buffer grid-stride in 16-byte
//      vectors (a scalar tail for a length that is not a whole number of
//      vectors), one fp32 accumulator per vector lane, a block reduction,
//      one fp32 partial per block;
//   2. one block adds the partials in a fixed order (in fp64) and takes
//      the square root.
// No float atomics: the grid depends only on the length, so two calls on
// the same buffer return the same bits, and a training step's clip
// coefficient does not wander between runs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename V>
__device__ __forceinline__ V block_sum(V v) {
  __shared__ V red[kThreads / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  V total = 0;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  }
  return total;  // valid in thread 0
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_partials_kernel(const T* __restrict__ x, int64_t n,
                      float* __restrict__ partials) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t nvec = n / VEC;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < nvec;
       i += stride) {
    const uint4 raw = __ldg(xv + i);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_f32(e[j]);
      acc[j] = fmaf(f, f, acc[j]);
    }
  }
  if (blockIdx.x == 0) {  // the tail past the last whole vector
    for (int64_t i = nvec * VEC + threadIdx.x; i < n; i += kThreads) {
      const float f = to_f32(x[i]);
      acc[0] = fmaf(f, f, acc[0]);
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < VEC; ++j) s += acc[j];
  s = block_sum(s);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
finish_kernel(const float* __restrict__ partials, int n_partials,
              float* __restrict__ out) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n_partials; i += kThreads) s += partials[i];
  s = block_sum(s);
  if (threadIdx.x == 0) out[0] = (float)sqrt(s);
}

template <typename T>
cudaError_t launch(const void* x, int64_t n, float* partials, int n_blocks,
                   float* out, cudaStream_t stream) {
  sumsq_partials_kernel<T><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), n, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  finish_kernel<<<1, kThreads, 0, stream>>>(partials, n_blocks, out);
  return cudaGetLastError();
}

}  // namespace

// x: (n,) contiguous, 16-byte aligned, of `dtype`.  partials: (n_blocks,)
// fp32 scratch (the first pass runs n_blocks blocks of 256 threads).
// out: one fp32.  Returns cudaSuccess (0) or the launch error.
extern "C" int apex_l2norm(const void* x, long long n, void* partials,
                           int n_blocks, void* out, int dtype, void* stream) {
  if (n <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* p = static_cast<float*>(partials);
  float* o = static_cast<float*>(out);
  if (dtype == kDtypeF32) return (int)launch<float>(x, n, p, n_blocks, o, s);
  if (dtype == kDtypeBF16)
    return (int)launch<__nv_bfloat16>(x, n, p, n_blocks, o, s);
  return (int)cudaErrorInvalidValue;
}

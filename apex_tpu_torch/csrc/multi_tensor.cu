// The multi-tensor engine's kernels over flat buffers, for Hopper (sm_90a).
//
// 1. L2 norm.  Replaces the TPU kernel apex_tpu/multi_tensor_apply/
// kernels.py `multi_tensor_l2norm`: sqrt(sum x^2) over the flat (total,)
// buffer the TreeFlattener packs, read in its own dtype (fp32, bf16 or
// fp16) and accumulated in fp32.  FusedLAMB's global-grad-norm clip rides
// on it.
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
//
// 2. Adam / AdamW and 3. LAMB stage 1, the ZeRO optimizers' elementwise
// updates on their flat fp32 shards.  They replace `fused_adam_flat` and
// `fused_lamb_stage1_flat` of the same file:
//   adam:  g = g * s;  m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g;
//          u = (m rc1) / (sqrt(v rc2) + eps);  p -= lr u   (+ wd p: in g
//          for Adam, in u for AdamW), optional fp32 / bf16 / fp16 copy
//          of p;
//   lamb1: g = g * inv_scale * clip; m = b1 m + beta3 g; v as above;
//          u as above (+ wd p likewise) -> (u, m, v).
// The hyperparameters come from a device buffer (8 / 9 fp32, the TPU
// kernels' SMEM layout), so a clip or bias correction computed on the
// card never passes through the host.  Every product and sum is an
// explicitly rounded IEEE operation (__fmul_rn, __fadd_rn: no contraction
// into FMAs) in the TPU kernels' order, sqrtf and the division are IEEE
// (no fast-math), so the kernels give the bits of the plain PyTorch
// versions.  What bounds them: bytes.  Adam reads g, p, m, v and writes p,
// m, v (28 B an fp32 element, 30 with a 16-bit copy); at the BERT-large
// flat size (334,233,600) that is at least ~2.79 ms at 3.35 TB/s.  One
// grid-stride pass in 16-byte vectors, a scalar tail for a length that is
// not a whole number of vectors.
//
// 4. Scale and axpby with the overflow flag.  They replace
// `multi_tensor_scale` and `multi_tensor_axpby` of the same file (through
// its `_grid_call`): out = x s, or out = x a + y b, in fp32, cast to the
// output dtype (fp32, bf16 or fp16 in and out), and a flag that is 1 when
// any element of the OUTPUT, after the cast, is not finite (the TPU
// code's `_overflow_flag`: fp32 70000 into fp16 is inf, so it counts).
// The TPU code checks the flag in a second XLA pass over the output; here
// it is fused into the same pass: the wrapper zeroes the flag on the
// stream, and a thread that has seen a non-finite output stores 1 once at
// its end, which is idempotent and needs no atomics.  The scalars come
// from a device pointer when one is given (the optimizer's 1 / loss_scale
// stays on the card), else by value.  Products and the sum are explicitly
// rounded (__fmul_rn, __fadd_rn: no FMA contraction) in the TPU order, so
// the output is bit-identical to the plain PyTorch version.  What bounds
// them: bytes, 8 B an element for the fp32 scale and 12 B for the fp32
// axpby; 134,217,728 fp32 elements take at least 0.32 / 0.48 ms at
// 3.35 TB/s.  One grid-stride pass over 4-element vectors (16 B of fp32,
// 8 B of a 16-bit type), a scalar tail.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
constexpr int kDtypeF16 = 2;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

// round-to-nearest-even into T
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

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

// ---------------------------------------------------------------------------
// Adam / AdamW and LAMB stage 1
// ---------------------------------------------------------------------------

constexpr int kCopyNone = -1;  // Adam's model copy: none, fp32, bf16 or fp16
constexpr int kCopyF32 = kDtypeF32;
constexpr int kCopyBF16 = kDtypeBF16;
constexpr int kCopyF16 = kDtypeF16;

struct Hyper {
  float lr, b1, b2, eps, wd, rc1, rc2, scale, clip, c1, c2;
};

// Adam scalars [lr, b1, b2, eps, wd, rc1, rc2, scale]; LAMB stage-1
// scalars [b1, b2, eps, wd, rc1, rc2, clip, inv_scale, beta3].
template <bool kLamb>
__device__ __forceinline__ Hyper load_hyper(const float* __restrict__ s) {
  Hyper h;
  if (kLamb) {
    h.lr = 0.f;
    h.b1 = s[0]; h.b2 = s[1]; h.eps = s[2]; h.wd = s[3];
    h.rc1 = s[4]; h.rc2 = s[5]; h.clip = s[6]; h.scale = s[7];
    h.c1 = s[8];                       // beta3
  } else {
    h.lr = s[0]; h.b1 = s[1]; h.b2 = s[2]; h.eps = s[3]; h.wd = s[4];
    h.rc1 = s[5]; h.rc2 = s[6]; h.scale = s[7];
    h.clip = 1.f;
    h.c1 = __fsub_rn(1.f, h.b1);       // 1 - b1
  }
  h.c2 = __fsub_rn(1.f, h.b2);
  return h;
}

// One element: new m and v, and Adam's new p or LAMB's direction u.
template <bool kLamb>
__device__ __forceinline__ void update_elem(const Hyper& h, bool adam_w,
                                            float g, float p, float m,
                                            float v, float& out, float& m_out,
                                            float& v_out) {
  g = __fmul_rn(g, h.scale);
  if (kLamb) g = __fmul_rn(g, h.clip);
  if (!adam_w) g = __fadd_rn(g, __fmul_rn(h.wd, p));  // classic L2
  m_out = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.c1, g));
  v_out = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.c2, g), g));
  float u = __fdiv_rn(__fmul_rn(m_out, h.rc1),
                      __fadd_rn(__fsqrt_rn(__fmul_rn(v_out, h.rc2)), h.eps));
  if (adam_w) u = __fadd_rn(u, __fmul_rn(h.wd, p));  // decoupled decay
  out = kLamb ? u : __fsub_rn(p, __fmul_rn(h.lr, u));
}

__device__ __forceinline__ void store_copy4(void* copy, int64_t i,
                                            const float (&x)[4], int kind) {
  if (kind == kCopyF32) {
    reinterpret_cast<float4*>(copy)[i] = make_float4(x[0], x[1], x[2], x[3]);
  } else if (kind == kCopyBF16) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(x[0], x[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(x[2], x[3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    reinterpret_cast<uint2*>(copy)[i] = w;
  } else {  // fp16, round to nearest (inf past its range, as the cast)
    __half2 lo = __floats2half2_rn(x[0], x[1]);
    __half2 hi = __floats2half2_rn(x[2], x[3]);
    uint2 w;
    w.x = *reinterpret_cast<uint32_t*>(&lo);
    w.y = *reinterpret_cast<uint32_t*>(&hi);
    reinterpret_cast<uint2*>(copy)[i] = w;
  }
}

// out0 = Adam's new p or LAMB's u; `copy` (Adam only, kCopy != none) the
// new p in fp32, bf16 or fp16.
template <bool kLamb, int kCopy>
__global__ void __launch_bounds__(kThreads)
flat_update_kernel(const float* __restrict__ g, const float* __restrict__ p,
                   const float* __restrict__ m, const float* __restrict__ v,
                   const float* __restrict__ scalars,
                   float* __restrict__ out0, float* __restrict__ m_out,
                   float* __restrict__ v_out, void* __restrict__ copy,
                   int64_t n, int adam_w) {
  const Hyper h = load_hyper<kLamb>(scalars);
  const bool aw = adam_w != 0;
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t i = first; i < nvec; i += stride) {
    const float4 g4 = __ldg(reinterpret_cast<const float4*>(g) + i);
    const float4 p4 = __ldg(reinterpret_cast<const float4*>(p) + i);
    const float4 m4 = __ldg(reinterpret_cast<const float4*>(m) + i);
    const float4 v4 = __ldg(reinterpret_cast<const float4*>(v) + i);
    const float gs[4] = {g4.x, g4.y, g4.z, g4.w};
    const float ps[4] = {p4.x, p4.y, p4.z, p4.w};
    const float ms[4] = {m4.x, m4.y, m4.z, m4.w};
    const float vs[4] = {v4.x, v4.y, v4.z, v4.w};
    float o[4], mo[4], vo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      update_elem<kLamb>(h, aw, gs[j], ps[j], ms[j], vs[j], o[j], mo[j],
                         vo[j]);
    reinterpret_cast<float4*>(out0)[i] = make_float4(o[0], o[1], o[2], o[3]);
    reinterpret_cast<float4*>(m_out)[i] =
        make_float4(mo[0], mo[1], mo[2], mo[3]);
    reinterpret_cast<float4*>(v_out)[i] =
        make_float4(vo[0], vo[1], vo[2], vo[3]);
    if (kCopy != kCopyNone) store_copy4(copy, i, o, kCopy);
  }
  for (int64_t i = nvec * 4 + first; i < n; i += stride) {  // the tail
    float o, mo, vo;
    update_elem<kLamb>(h, aw, g[i], p[i], m[i], v[i], o, mo, vo);
    out0[i] = o;
    m_out[i] = mo;
    v_out[i] = vo;
    if (kCopy == kCopyF32) static_cast<float*>(copy)[i] = o;
    if (kCopy == kCopyBF16)
      static_cast<__nv_bfloat16*>(copy)[i] = __float2bfloat16(o);
    if (kCopy == kCopyF16) static_cast<__half*>(copy)[i] = __float2half_rn(o);
  }
}

template <bool kLamb, int kCopy>
cudaError_t launch_update(const void* g, const void* p, const void* m,
                          const void* v, const void* scalars, void* out0,
                          void* m_out, void* v_out, void* copy, int64_t n,
                          int n_blocks, int adam_w, cudaStream_t stream) {
  flat_update_kernel<kLamb, kCopy><<<n_blocks, kThreads, 0, stream>>>(
      static_cast<const float*>(g), static_cast<const float*>(p),
      static_cast<const float*>(m), static_cast<const float*>(v),
      static_cast<const float*>(scalars), static_cast<float*>(out0),
      static_cast<float*>(m_out), static_cast<float*>(v_out), copy, n,
      adam_w);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// scale and axpby
// ---------------------------------------------------------------------------

// Four consecutive elements of T as one load / store: 16 B of fp32, 8 B of
// a 16-bit type.
template <typename T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<__nv_bfloat16> { using type = uint2; };
template <> struct Vec4<__half> { using type = uint2; };

template <typename T>
__device__ __forceinline__ void load4(const T* __restrict__ p, int64_t i,
                                      float (&f)[4]) {
  const typename Vec4<T>::type raw =
      __ldg(reinterpret_cast<const typename Vec4<T>::type*>(p) + i);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < 4; ++j) f[j] = to_f32(e[j]);
}

// Stores the four values rounded into T; true when one of the stored
// values is not finite.
template <typename T>
__device__ __forceinline__ bool store4(T* __restrict__ p, int64_t i,
                                       const float (&f)[4]) {
  typename Vec4<T>::type raw;
  T* e = reinterpret_cast<T*>(&raw);
  bool bad = false;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    e[j] = from_f32<T>(f[j]);
    bad |= !isfinite(to_f32(e[j]));
  }
  reinterpret_cast<typename Vec4<T>::type*>(p)[i] = raw;
  return bad;
}

template <bool kAxpby>
__device__ __forceinline__ float scale_axpby(float x, float y, float a,
                                             float b) {
  return kAxpby ? __fadd_rn(__fmul_rn(x, a), __fmul_rn(y, b))
                : __fmul_rn(x, a);
}

// out = x a (+ y b); *flag = 1 when an output is not finite.  a (b) is
// read from a_ptr (b_ptr) when that is not null.
template <typename Tin, typename Tout, bool kAxpby>
__global__ void __launch_bounds__(kThreads)
scale_axpby_kernel(const Tin* __restrict__ x, const Tin* __restrict__ y,
                   const float* __restrict__ a_ptr, float a,
                   const float* __restrict__ b_ptr, float b,
                   Tout* __restrict__ out, int* __restrict__ flag,
                   int64_t n) {
  if (a_ptr != nullptr) a = *a_ptr;
  if (kAxpby && b_ptr != nullptr) b = *b_ptr;
  const int64_t nvec = n / 4;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t first = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  bool bad = false;
  for (int64_t i = first; i < nvec; i += stride) {
    float xs[4], ys[4] = {0.f, 0.f, 0.f, 0.f}, o[4];
    load4(x, i, xs);
    if (kAxpby) load4(y, i, ys);
#pragma unroll
    for (int j = 0; j < 4; ++j) o[j] = scale_axpby<kAxpby>(xs[j], ys[j], a, b);
    bad |= store4(out, i, o);
  }
  for (int64_t i = nvec * 4 + first; i < n; i += stride) {  // the tail
    const float yv = kAxpby ? to_f32(y[i]) : 0.f;
    const Tout o = from_f32<Tout>(scale_axpby<kAxpby>(to_f32(x[i]), yv, a, b));
    out[i] = o;
    bad |= !isfinite(to_f32(o));
  }
  if (bad) *flag = 1;
}

template <typename Tin, typename Tout>
cudaError_t launch_scale_axpby(const void* x, const void* y,
                               const float* a_ptr, float a,
                               const float* b_ptr, float b, void* out,
                               int* flag, int64_t n, int n_blocks,
                               cudaStream_t stream) {
  if (y != nullptr) {
    scale_axpby_kernel<Tin, Tout, true><<<n_blocks, kThreads, 0, stream>>>(
        static_cast<const Tin*>(x), static_cast<const Tin*>(y), a_ptr, a,
        b_ptr, b, static_cast<Tout*>(out), flag, n);
  } else {
    scale_axpby_kernel<Tin, Tout, false><<<n_blocks, kThreads, 0, stream>>>(
        static_cast<const Tin*>(x), nullptr, a_ptr, a, nullptr, 0.f,
        static_cast<Tout*>(out), flag, n);
  }
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t dispatch_out(int out_dtype, const void* x, const void* y,
                         const float* a_ptr, float a, const float* b_ptr,
                         float b, void* out, int* flag, int64_t n,
                         int n_blocks, cudaStream_t s) {
  switch (out_dtype) {
    case kDtypeF32:
      return launch_scale_axpby<Tin, float>(x, y, a_ptr, a, b_ptr, b, out,
                                            flag, n, n_blocks, s);
    case kDtypeBF16:
      return launch_scale_axpby<Tin, __nv_bfloat16>(x, y, a_ptr, a, b_ptr, b,
                                                    out, flag, n, n_blocks, s);
    case kDtypeF16:
      return launch_scale_axpby<Tin, __half>(x, y, a_ptr, a, b_ptr, b, out,
                                             flag, n, n_blocks, s);
    default:
      return cudaErrorInvalidValue;
  }
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
  if (dtype == kDtypeF16) return (int)launch<__half>(x, n, p, n_blocks, o, s);
  return (int)cudaErrorInvalidValue;
}

// g, p, m, v, p_out, m_out, v_out: (n,) fp32, contiguous, 16-byte aligned,
// outputs distinct from the inputs.  scalars: 8 fp32 on the card [lr, b1,
// b2, eps, wd, rc1, rc2, scale].  copy: (n,) of copy_dtype (0 fp32, 1 bf16,
// 2 fp16; 16-byte aligned) or null with copy_dtype -1.  The kernel runs
// n_blocks blocks of 256 threads.  Returns cudaSuccess (0) or the launch
// error.
extern "C" int apex_fused_adam(const void* g, const void* p, const void* m,
                               const void* v, const void* scalars,
                               void* p_out, void* m_out, void* v_out,
                               void* copy, long long n, int n_blocks,
                               int adam_w, int copy_dtype, void* stream) {
  if (n <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (copy_dtype) {
    case kCopyNone:
      return (int)launch_update<false, kCopyNone>(
          g, p, m, v, scalars, p_out, m_out, v_out, nullptr, n, n_blocks,
          adam_w, s);
    case kCopyF32:
      return (int)launch_update<false, kCopyF32>(
          g, p, m, v, scalars, p_out, m_out, v_out, copy, n, n_blocks,
          adam_w, s);
    case kCopyBF16:
      return (int)launch_update<false, kCopyBF16>(
          g, p, m, v, scalars, p_out, m_out, v_out, copy, n, n_blocks,
          adam_w, s);
    case kCopyF16:
      return (int)launch_update<false, kCopyF16>(
          g, p, m, v, scalars, p_out, m_out, v_out, copy, n, n_blocks,
          adam_w, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// As apex_fused_adam, writing (u, m, v); scalars: 9 fp32 on the card [b1,
// b2, eps, wd, rc1, rc2, clip, inv_scale, beta3].
extern "C" int apex_lamb_stage1(const void* g, const void* p, const void* m,
                                const void* v, const void* scalars, void* u,
                                void* m_out, void* v_out, long long n,
                                int n_blocks, int adam_w, void* stream) {
  if (n <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  return (int)launch_update<true, kCopyNone>(
      g, p, m, v, scalars, u, m_out, v_out, nullptr, n, n_blocks, adam_w,
      static_cast<cudaStream_t>(stream));
}

// out = x a (y null: multi_tensor_scale) or x a + y b (axpby).  x, y: (n,)
// of in_dtype, out: (n,) of out_dtype (0 fp32, 1 bf16, 2 fp16), all
// contiguous and 16-byte aligned.  a_ptr / b_ptr: one fp32 on the card, or
// null to take a / b by value.  flag: one int32, zeroed by the caller on
// the stream; set to 1 when an output is not finite.  The kernel runs
// n_blocks blocks of 256 threads.  Returns cudaSuccess (0) or the launch
// error.
extern "C" int apex_mt_scale_axpby(const void* x, const void* y,
                                   const void* a_ptr, float a,
                                   const void* b_ptr, float b, void* out,
                                   void* flag, long long n, int n_blocks,
                                   int in_dtype, int out_dtype,
                                   void* stream) {
  if (n <= 0 || n_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a_ptr);
  const float* bp = static_cast<const float*>(b_ptr);
  int* f = static_cast<int*>(flag);
  switch (in_dtype) {
    case kDtypeF32:
      return (int)dispatch_out<float>(out_dtype, x, y, ap, a, bp, b, out, f,
                                      n, n_blocks, s);
    case kDtypeBF16:
      return (int)dispatch_out<__nv_bfloat16>(out_dtype, x, y, ap, a, bp, b,
                                              out, f, n, n_blocks, s);
    case kDtypeF16:
      return (int)dispatch_out<__half>(out_dtype, x, y, ap, a, bp, b, out, f,
                                       n, n_blocks, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

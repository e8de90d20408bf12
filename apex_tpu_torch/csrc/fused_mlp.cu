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
// Design.  fp16 and bf16 run on the tensor cores through mma.sync
// m16n8k16 with fp32 accumulators: a block of 256 threads (8 warps, 2 x 4)
// owns a 128 x 128 output tile, each warp 64 x 32 of it, and walks K in
// steps of 32 through two shared-memory stages (the next tile's copy in
// flight while the current one is multiplied).  A is read from shared
// memory with ldmatrix; w is K-major in device memory (its N is the
// contiguous axis, the opposite of the K-contiguous columns the B operand
// wants), so B is read with ldmatrix.trans, which transposes the 8 x 8
// tiles on the way into registers: w is never transposed in device
// memory.  Rows of both stages are padded (40 and 136 elements) so that
// the eight 16-byte rows one ldmatrix reads fall in distinct banks.
// Ragged shapes: any M, N, K >= 1.  Edge tiles are zero-filled and the
// epilogue masks its stores.  When K and N are multiples of 8 and the
// pointers 16-byte aligned, tiles are copied with cp.async 16 bytes at a
// time (zero-fill past the edge); otherwise every element is loaded on
// its own, guarded.  The choice is made here, in the dispatch.
// fp32 is a SIMT instance (fmaf, 64 x 64 tiles, 4 x 4 outputs a thread):
// TF32 would keep ~3 decimal digits and break the fp32 parity with the
// JAX package.
// First version: mma.sync, not wgmma / TMA (the card's full tensor-core
// rate needs those); its time against the bound is in PERF.md.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

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

}  // namespace

// x (m, k), w (k, n), b (n,) or null, out (m, n): contiguous, all of
// `dtype` (0 fp32, 1 bf16, 2 fp16).  activation: 0 none, 1 relu, 2
// sigmoid.  The grid's y extent is ceil(m / 128) (fp32: / 64), at most
// 65535.  Returns cudaSuccess (0) or the launch error.
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

// Hopper (sm_90a) building blocks shared by the port's TMA + wgmma
// kernels, the bf16 attention kernels (`sm90_attn.cuh`), the fp16 / bf16
// fused dense kernel (`fused_mlp.cu`) and the cross-entropy kernel
// (`xentropy.cu`):
//   * host: the runtime lookup of `cuTensorMapEncodeTiled` (through
//     cudaGetDriverEntryPoint, so the library links without -lcuda); 2-D
//     tensor maps over a row-major matrix of 16-bit elements with a 128-byte
//     swizzle, whose type (fp16 or bf16) is a parameter; the opt-in to more
//     than 48 KB of dynamic shared memory; a persistent grid's size;
//   * device: shared-memory matrix descriptors for wgmma; mbarriers (a wait
//     that lasts 4 s traps instead of hanging the card); 1-D bulk copies
//     into shared memory (the cross-entropy kernel's ring); 2-D TMA loads that
//     complete on an mbarrier, also multicast to the CTAs of a cluster, and
//     2-D TMA stores in bulk groups; a cluster's rank, barrier and remote
//     mbarrier arrivals; the setmaxnreg split between a producer warpgroup
//     and the consumer warpgroups; the consumers' named barrier; the
//     async-proxy fence; wgmma's fence / commit / wait; and `WgmmaSS<N,
//     T>`, D (64 x N, fp32) (+)= A * B with both operands in shared memory
//     and fp16 or bf16 inputs, at the N the GEMM takes.
// Attention-specific parts (3-D maps over (D, S, BH), the ring of two-tile
// stages, the score masks, the bf16 `Wgmma<N>` with register A) stay in
// `sm90_attn.cuh`.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace sm90 {

// ---------------------------------------------------------------------------
// host: tensor maps and the shared-memory opt-in
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &res);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &res);
#endif
    if (res == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// Map over a row-major (outer, inner) matrix of 16-bit elements of `type`
// (CU_TENSOR_MAP_DATA_TYPE_FLOAT16 or _BFLOAT16), inner contiguous, whose
// box is box_inner (at most 64: one 128-byte swizzle row) x box_outer.
// Elements past either edge arrive as zeros.  The base must be 16-byte
// aligned and inner a multiple of 8 (the row stride a multiple of 16 bytes).
inline cudaError_t encode_map_2d(CUtensorMap* map, const void* base,
                                 CUtensorMapDataType type, uint64_t inner,
                                 uint64_t outer, uint32_t box_inner,
                                 uint32_t box_outer) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, type, 2, const_cast<void*>(base), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Opt a kernel in to `bytes` of dynamic shared memory, once per kernel (a
// host call kept out of the launches a CUDA graph may capture).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

// Blocks of `threads` (with `smem` dynamic bytes) the card holds at once
// for `kernel`: a persistent kernel's grid.  `per_sm`, the caller's cache
// for this kernel, and the SM count are read once (a process drives one
// card).
template <typename Kernel>
cudaError_t resident_blocks(Kernel kernel, int threads, int smem, int& per_sm,
                            int* blocks) {
  static int sms = 0;
  cudaError_t err = cudaSuccess;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) {
      sms = 0;
      return err;
    }
  }
  if (per_sm == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
    if (err != cudaSuccess) {
      per_sm = 0;
      return err;
    }
    if (per_sm < 1) per_sm = 1;
  }
  *blocks = sms * per_sm;
  return cudaSuccess;
}

// Row groups to launch for n rows when the card holds `resident` groups at
// once: as many as give every group the same number of rows, give or take
// the last.
inline int even_groups(int n, int resident) {
  const int rows_each = (n + resident - 1) / resident;
  return (n + rows_each - 1) / rows_each;
}

// ---------------------------------------------------------------------------
// device: descriptors
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The wgmma descriptor of a shared-memory operand at byte address `addr`:
// lbo and sbo in 16-byte units; layout 1 = 128-byte swizzle, 2 = 64-byte,
// 3 = 32-byte.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(lbo & 0x3FFF) << 16) |
         ((uint64_t)(sbo & 0x3FFF) << 32) | (layout << 62);
}

// ---------------------------------------------------------------------------
// device: mbarriers, TMA, the producer's register release
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that lasts
// 4 s traps: a fault in the ring's phases ends the kernel with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0, spins = 0;
  uint64_t t0 = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if ((++spins & 1023u) == 0u) {
      uint64_t now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

// One box of a 2-D map, element coordinates (c0 inner, c1 outer), into
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16) of device memory at `src` into shared memory at
// `dst`, both 16-byte aligned, completing on `bar` (a 1-D bulk copy).
__device__ __forceinline__ void bulk_load_1d(void* dst, const void* src,
                                             uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// The same box into `dst` of every CTA of the cluster in `mask`, completing
// on the mbarrier at `bar`'s offset in each of them.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst,
                                                      const CUtensorMap* map,
                                                      int c0, int c1,
                                                      uint64_t* bar,
                                                      uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "h"(mask),
      "r"(c0), "r"(c1)
      : "memory");
}

// One box of shared memory at `src` into a 2-D map at element coordinates
// (c0 inner, c1 outer); the parts of the box past the map's edges are not
// written.  `bulk_commit` closes this thread's group of stores,
// `bulk_wait_read<N>` waits until at most N groups still read their
// sources, `bulk_wait<N>` until at most N are still writing.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%1, %2}], "
      "[%3];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1), "r"(smem_u32(src))
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// device: clusters
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (a superset of __syncthreads).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One arrival on the mbarrier at `bar`'s offset in CTA `cta` of the
// cluster.  The arrival keeps the default release at CTA scope: with
// `.release.cluster` every stage of the dense kernel waited out a
// cluster-wide fence, which serialised its ring.
__device__ __forceinline__ void mbar_arrive_cluster(uint64_t* bar,
                                                    uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
      ::"r"(smem_u32(bar)), "r"(cta) : "memory");
}

// The register split.  A kernel of C consumer warpgroups and one producer
// warpgroup is launched with 65536 / (128 (C + 1)) registers a thread: 168
// at C = 2, the 255 cap at C = 1.  The producer's four warps drop to 24
// (one of them starts the loads, the other three leave), and at C = 2 the
// 128 x 144 registers they free are what the two consumer warpgroups need
// to rise from 168 to 240 for their accumulators and fragments.
// setmaxnreg acts on a whole warpgroup: every warp of it runs the same
// instruction.
__device__ __forceinline__ void producer_release_registers() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
}
template <int C>
__device__ __forceinline__ void consumer_claim_registers() {
  if constexpr (C == 2)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
}

// The consumer warpgroups alone (threads 0 .. 128 C - 1) at named barrier
// 1: the producer warpgroup has left the loop.
template <int C>
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * C) : "memory");
}

// Make this thread's st.shared visible to the async proxy (wgmma, TMA)
// before a barrier hands the tile to it.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// device: wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void wgmma_wait_all() { wgmma_wait<0>(); }
// keep the compiler from touching accumulator registers across an
// asynchronous wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (64 x N, fp32) (+)= A (64 x 16, smem) * B (N x 16, smem), A and B of
// type T (__half: .f16, __nv_bfloat16: .bf16); TA / TB set: the operand is
// MN-major (transposed); scale_d 0 overwrites D.  Accumulator layout as for
// `Wgmma<N>` in sm90_attn.cuh: thread t of the warpgroup holds
// d[4 j + 2 h + e] = D[16 (t / 32) + (t % 32) / 4 + 8 h][8 j + 2 (t % 4) + e].
#define SM90_WGMMA_SS_128(TY)                                                \
  asm volatile(                                                              \
      "{\n.reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %66, 0;\n"                                             \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63"                               \
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"                                 \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                  \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

#define SM90_WGMMA_SS_256(TY)                                                \
  asm volatile(                                                              \
      "{\n.reg .pred p;\n"                                                   \
      "setp.ne.b32 p, %130, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                     \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                               \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                             \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                             \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                             \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                             \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                             \
      "%56, %57, %58, %59, %60, %61, %62, %63, "                             \
      "%64, %65, %66, %67, %68, %69, %70, %71, "                             \
      "%72, %73, %74, %75, %76, %77, %78, %79, "                             \
      "%80, %81, %82, %83, %84, %85, %86, %87, "                             \
      "%88, %89, %90, %91, %92, %93, %94, %95, "                             \
      "%96, %97, %98, %99, %100, %101, %102, %103, "                         \
      "%104, %105, %106, %107, %108, %109, %110, %111, "                     \
      "%112, %113, %114, %115, %116, %117, %118, %119, "                     \
      "%120, %121, %122, %123, %124, %125, %126, %127"                       \
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                      \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                    \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                  \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                  \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                  \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                  \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                  \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                  \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                  \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                  \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                  \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                  \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                  \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                  \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),                  \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),                  \
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),                  \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),                  \
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),                  \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),                  \
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),                  \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),                  \
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),                  \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),                  \
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),              \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),              \
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),              \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),              \
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),              \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),              \
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])               \
      : "l"(a), "l"(b), "r"(scale_d), "n"(TA), "n"(TB))

template <int N, typename T>
struct WgmmaSS {
  static_assert(N == 128 || N == 256, "the GEMM's tile widths");
  static_assert(std::is_same<T, __half>::value ||
                    std::is_same<T, __nv_bfloat16>::value,
                "fp16 or bf16 operands");
  static constexpr bool kF16 = std::is_same<T, __half>::value;
  template <int TA, int TB>
  static __device__ __forceinline__ void run(float (&d)[N / 2], uint64_t a,
                                             uint64_t b, int scale_d) {
    if constexpr (N == 128) {
      if constexpr (kF16) SM90_WGMMA_SS_128("f16");
      else SM90_WGMMA_SS_128("bf16");
    } else {
      if constexpr (kF16) SM90_WGMMA_SS_256("f16");
      else SM90_WGMMA_SS_256("bf16");
    }
  }
};

#undef SM90_WGMMA_SS_128
#undef SM90_WGMMA_SS_256

}  // namespace sm90

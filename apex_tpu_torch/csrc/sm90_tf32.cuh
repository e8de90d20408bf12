// fp32 products on Hopper's tensor cores in 3xTF32, for the fp32 attention
// kernels (`flash_fwd_tf32_kernel` in flash_fwd.cu, `flash_bwd_kv_tf32_kernel`
// in flash_bwd.cu), with the asynchronous copies that feed them.
//
// TF32 keeps fp32's exponent and 10 of its 23 mantissa bits.  One TF32
// product per operand pair puts an attention output ~1e-3 of its peak from
// float64, past the fp32 kernels' 1e-4 limit; the compensated split keeps
// fp32's accuracy (CUTLASS's `OpMultiplyAddFastF32`): x = hi + lo with hi
// = x rounded to TF32 (to nearest) and lo = x - hi (exact in fp32) rounded
// to TF32, and a b = a_lo b_hi + a_hi b_lo + a_hi b_hi, the two small
// cross terms first, all accumulated in fp32 by the tensor core; a_lo b_lo
// (~2^-22 relative) is dropped.
//
// The products are `mma.sync.m16n8k8` TF32: `wgmma` takes a TF32 B operand
// K-major only (its transpose bits are for 16-bit types), which q k^T
// would meet but P v, P^T dO, dS^T q and dS k would not without a
// transposed copy of each tile.  mma.sync reads its fragments from
// registers, so each kernel loads them from any shared-memory layout
// (rows padded by 4 floats: every fragment read below is conflict-free)
// and takes an accumulator as the A of the next product directly, by
// reading the next product's k index in the order the accumulator holds
// it (`kPermutedK`).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tf32 {

// floats of padding a shared-memory row of D (or rows) floats carries: with
// a row stride of 4 (mod 32) banks, lane (g, t) of a fragment read at row
// g, column t hits bank 4 g + t, and at row 2 t, column g bank 8 t + g
constexpr int kPad = 4;

__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = round_tf32(x);
  lo = round_tf32(x - __uint_as_float(hi));
}

// Element o of x as (hi, lo): split here, or (kPre: x was split in place
// by `split_tile`) hi read from x and lo from x + lo_off.
template <bool kPre>
__device__ __forceinline__ void fetch(uint32_t& hi, uint32_t& lo, const float* x, int o,
                                      int lo_off) {
  if constexpr (kPre) {
    hi = __float_as_uint(x[o]);
    lo = __float_as_uint(x[o + lo_off]);
  } else {
    split(x[o], hi, lo);
  }
}

// n floats at x (16-byte aligned, n a multiple of 4) split by the CTA's
// kThreads threads: hi in place, lo at lo
template <int kThreads>
__device__ __forceinline__ void split_tile(float* x, float* lo, int n) {
  for (int i = threadIdx.x; i < n / 4; i += kThreads) {
    float4 a = reinterpret_cast<float4*>(x)[i];
    uint32_t h[4], l[4];
    split(a.x, h[0], l[0]);
    split(a.y, h[1], l[1]);
    split(a.z, h[2], l[2]);
    split(a.w, h[3], l[3]);
    reinterpret_cast<uint4*>(x)[i] = make_uint4(h[0], h[1], h[2], h[3]);
    reinterpret_cast<uint4*>(lo)[i] = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

// The m16n8k8 fragments, split.  Thread (g, t) = (lane / 4, lane % 4) of a
// warp holds A (16 x 8) at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4);
// B (8 x 8, k x n) at (t, g), (t + 4, g); C (16 x 8) at (g, 2 t), (g, 2 t +
// 1), (g + 8, 2 t), (g + 8, 2 t + 1).
//
// kPermutedK: a product whose A is an accumulator reads its k index j in
// the order j = t -> 2 t, j = t + 4 -> 2 t + 1, so the accumulator's four
// values are A's four as they lie (`FragA::from_acc`), and its B rows 2 t
// and 2 t + 1 are loaded where t and t + 4 would be.
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(int i, float x) { split(x, hi[i], lo[i]); }
  template <bool kPre>
  __device__ __forceinline__ void fetch(int i, const float* x, int o, int lo_off) {
    tf32::fetch<kPre>(hi[i], lo[i], x, o, lo_off);
  }
  // A from the accumulator c of a 16 x 8 tile, in the permuted k order
  __device__ __forceinline__ void from_acc(const float* c) {
    set(0, c[0]);
    set(1, c[2]);
    set(2, c[1]);
    set(3, c[3]);
  }
};

struct FragB {
  uint32_t hi[2], lo[2];
  template <bool kPre>
  __device__ __forceinline__ void fetch(int i, const float* x, int o, int lo_off) {
    tf32::fetch<kPre>(hi[i], lo[i], x, o, lo_off);
  }
};

__device__ __forceinline__ void mma(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c (16 x 8, fp32) += a b in 3xTF32
__device__ __forceinline__ void mma3(float* c, const FragA& a, const FragB& b) {
  mma(c, a.lo, b.hi);
  mma(c, a.hi, b.lo);
  mma(c, a.hi, b.hi);
}

// ---------------------------------------------------------------------------
// cp.async: device memory into shared memory without a register round trip;
// a false `in` fills the destination with zeros and reads nothing (`src`
// must still be a valid address: the callers pass the tensor's base)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [r0, r0 + rows) of a (n, D) fp32 tensor at `base` into `dst` (rows x
// (D + kPad)), 16 bytes a copy, rows past n as zeros
template <int D, int kThreads>
__device__ __forceinline__ void load_rows(float* dst, const float* base, int r0,
                                          int rows, int n) {
  constexpr int kVec = D / 4;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 4;
    const bool in = r0 + r < n;
    cp_async16(dst + r * (D + kPad) + c, in ? base + (size_t)(r0 + r) * D + c : base, in);
  }
}

}  // namespace tf32

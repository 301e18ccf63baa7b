// Tensor-core and copy primitives shared by the critic tail's kernels on
// Hopper (sm_90a): the tuned forward (tail_forward.cu) and the wide route's
// products (wide_common.cuh's tc_mainloop, used by tail_wide.cu).
//
// 3xTF32: each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (split_tf32), and a product is a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, which
// keeps float32-level error (|x - hi - lo| <= 2^-22 |x|; the dropped
// a_lo*b_lo is below 2^-22 of the product). The products run on wgmma
// (warpgroup MMA): on the H100 mma.sync reaches only about half of the TF32
// rate (scripts/probe_tf32_rates.py).
//
// wgmma's TF32 operands in shared memory must be K-major. B is staged in
// the no-swizzle core-matrix layout: core matrices of 8 rows n x 4 floats k
// (128 bytes), the NB row groups of a 4-column group adjacent (SBO 128
// bytes), the 4-column groups NB * 128 bytes apart (LBO): element (n, k) at
// b_offset<NB>(n, k) floats. A comes from registers (any layout in shared
// memory, read by the caller into the fragment layout of wgmma_tf32).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// 16-byte asynchronous copy from device to shared memory (cached in L2
// only). Reads src_bytes (0..16) and fills the rest of the 16 bytes with
// zeros; with src_bytes 0 nothing is read.
__device__ inline void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4-byte asynchronous copy from device to shared memory.
__device__ inline void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ inline void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most Pending groups of this thread's copies are in flight.
template <int Pending>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// Makes this thread's shared-memory stores visible to wgmma's reads.
__device__ inline void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x rounded to TF32 (10 mantissa bits; to nearest, ties away from zero),
// as float bits whose 13 low mantissa bits are zero.
__device__ inline uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo + O(2^-22 |x|), both TF32.
__device__ inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_round(x);
  lo = tf32_round(x - __uint_as_float(hi));
}

// Offset, in floats, of element (row n, column k) of a B operand of NB n8
// blocks in the core-matrix layout, and its inverse for offsets q.
template <int NB>
__host__ __device__ inline int b_offset(int n, int k) {
  return ((k / 4 * NB + n / 8) * 8 + n % 8) * 4 + k % 4;
}
template <int NB>
__device__ inline int b_row(int q) { return q / 32 % NB * 8 + q / 4 % 8; }
template <int NB>
__device__ inline int b_col(int q) { return q / (NB * 32) * 4 + q % 4; }

// Shared-memory descriptor of a K-major, no-swizzle wgmma operand of NB n8
// blocks at p (16-byte aligned).
template <int NB>
__device__ inline uint64_t smem_desc(const float* p) {
  const uint64_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  constexpr uint64_t lbo = NB * 128, sbo = 128;  // bytes
  return ((addr & 0x3FFFF) >> 4) | ((lbo >> 4) << 16) | ((sbo >> 4) << 32);
}

__device__ inline void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ inline void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 8 NB) += a (64 x 8, this warpgroup's registers) * b (8 x 8 NB,
// the descriptor's shared memory), in TF32 with a float32 accumulator, for
// NB = 5 (m64n40k8) or 10 (m64n80k8); L = 4 NB accumulators a thread. a
// holds, for warp w of the warpgroup, a0 = (16 w + g, t), a1 = (16 w + g +
// 8, t), a2 = (16 w + g, t + 4), a3 = (16 w + g + 8, t + 4) (g = lane / 4,
// t = lane % 4); d[4 j + q] is element (16 w + g + 8 (q / 2), 8 j + 2 t +
// q % 2).
template <int L>
__device__ inline void wgmma_tf32(float (&d)[L], const uint32_t (&a)[4], uint64_t b) {
  static_assert(L == 20 || L == 40, "wgmma_tf32 takes n = 40 or 80");
  if constexpr (L == 40) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
        "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
        "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),
          "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),
          "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
          "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n40k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19}, "
        "{%20, %21, %22, %23}, %24, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
          "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),
          "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
  }
}

}  // namespace tc

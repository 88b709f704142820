// Split-precision float32 products on the tensor cores (3xTF32) for NVIDIA
// Hopper (sm_90a): the split, K-major swizzled wgmma operands and wgmma's
// synchronization, shared by both routes of the SSD scan (ssd_scan.cu,
// ssd_wide.cu), and the wide route's m64n128k8 product.
//
// A TF32 operand keeps 10 of float32's 23 mantissa bits, so one TF32 product
// is good to ~3 decimal digits: plain TF32 missed the SSD scan's 3e-3
// tolerance by ~75x at a contraction of only 64 (zamba2's state) on an H100.
// Split each operand as x = hi + lo, hi the top 10 mantissa bits (a TF32
// value, exact) and lo = x - hi (exact in float32; the tensor core reads its
// top 10 bits), and take a b ~ a_hi b_hi + a_hi b_lo + a_lo b_hi: three
// products, the small terms first, float32 accumulation, a relative error of
// ~2^-21 per term. Split after any scaling (a decay) has been applied, so
// that a lo part of an inf or a NaN never forms.
//
// TF32 fragments in registers (per warp, g = lane / 4, t = lane % 4), as
// mma.sync.m16n8k8 lays them out:
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   C/D (16 x 8):    c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)

#pragma once

#include <stdint.h>

namespace tf32x3 {

// hi keeps the top 10 mantissa bits (a TF32 value), lo the rest.
__device__ __forceinline__ float tf32_hi(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  const float h = tf32_hi(x);
  hi = __float_as_uint(h);
  lo = __float_as_uint(x - h);
}

// --- wgmma (TF32, A from registers, B from shared memory) -------------------
//
// A warpgroup's m64nNk8 product takes A (64 x 8) from registers in the
// layout above, warp w of the warpgroup holding rows [16 w, 16 w
// + 16), and B (8 x N) K-major from shared memory: a row of 32 floats (128
// bytes) per column n, 16-byte chunks XOR-permuted by n % 8 (the 128-byte
// swizzle); a tile of `rows` columns and more than 32 values of k is blocks
// of 32 k one after the other (a block is rows x 128 bytes), every block
// 1,024-byte aligned. The f32 accumulator holds, per warp, rows 16 w + g
// and 16 w + g + 8 of each n8 block j in d[4 j .. 4 j + 3], as C/D above.

// Offset in floats of (k, row n) in a K-major 128-byte-swizzled tile of `rows` rows.
__device__ __forceinline__ int km_offset(int row, int k, int rows) {
  return (((k >> 5) * rows + row) * 32 + (k & 31)) ^ ((row & 7) << 2);
}

// Descriptor of a K-major 128-byte-swizzled operand at shared address addr.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | static_cast<uint64_t>(1) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | static_cast<uint64_t>(1) << 62;
}
// Descriptor of k-step ks (8 values of k) of a tile of `rows` rows, rows
// [row0, row0 + N) of it.
__device__ __forceinline__ uint64_t desc_k8(const float* tile, int rows, int row0, int ks) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return desc_sw128(a + ((ks >> 2) * rows + row0) * 128 + (ks & 3) * 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving reads or writes of registers across an
// asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, f32) += A (64 x 8, tf32, registers) B (8 x 128, tf32, shared, K-major).
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, 1, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b));
}

}  // namespace tf32x3

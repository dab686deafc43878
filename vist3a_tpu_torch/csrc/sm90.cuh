// Hopper (sm_90a) building blocks shared by the wgmma + TMA flash-attention
// kernels (`flash_attention_{fwd,bwd}_sm90.cu` in bf16,
// `flash_attention_{fwd,bwd}_f32_sm90.cu` in fp32 on 3×TF32): mbarriers,
// TMA tensor loads and bulk copies, wgmma descriptors and products (bf16
// and tf32), the tf32 mma.sync product, the 3×TF32 split, the kernel that
// writes an fp32 tensor's split planes, register reallocation, and the
// host-side encoding of the tensor maps: a 4-D (d, n, h, b) map for a
// (B, N, H, D) bf16 tensor with any strides, a 2-D map over fp32 planes.
// Raw PTX, no CUTLASS, so a source that includes this builds in seconds.
//
// Shared-memory tiles are what a TMA load with CU_TENSOR_MAP_SWIZZLE_128B
// writes: rows of 64 bf16 (128 bytes), 8-row groups of 1024 bytes, the 16-
// byte chunks of row r XOR-permuted by r % 8; a D = 64 row is one such
// 64-column half, a D = 128 row two, stored one after the other
// ([half][row][64]).  A tile's base is 1024-byte aligned.  The descriptors
// below read such tiles:
//   * K-major (the product's depth runs along the 64 contiguous columns):
//     SBO = 1024 bytes between 8-row groups, LBO unused; the k-th 16-deep
//     slice of a half starts 32·k bytes in;
//   * MN-major (the depth runs along the rows; wgmma transposes the tile,
//     trans-b 1): SBO = 1024 bytes between groups of 8 depth rows, LBO =
//     the distance between the two 64-column halves (unused at N = 64,
//     which one half spans); the k-th 16-deep slice starts 16 rows = 2048
//     bytes in.
// An fp32 tile has the same bytes: rows of 32 floats (128 bytes) with the
// same swizzle, a 64-column row as two 32-column halves ([half][row][32]).
// tf32 wgmma has no transpose bits, so both of its shared-memory operands
// are K-major; its k-th 8-deep slice of a half starts 32·k bytes in, as a
// bf16 16-deep slice does.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// ---- TMA -------------------------------------------------------------------

// A box of the 4-D tensor map at coordinates (c0 = column, c1 = row, c2 =
// head, c3 = batch) into shared memory; completion counts on `bar`.  Rows
// beyond the tensor's extent arrive as zeros.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

// A box of a 2-D tensor map at (c0 = column, c1 = row) into shared memory;
// completion counts on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// `bytes` (a multiple of 16, both addresses 16-byte aligned) from global to
// shared memory; completion counts on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)),
         "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// ---- registers -------------------------------------------------------------

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}

// Keeps the compiler from moving reads or writes of x across the
// asynchronous wgmma that owns it (the wgmma wait does not name x).
template <int N>
__device__ __forceinline__ void fence_regs(float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(x[i]) :: "memory");
}

// ---- wgmma -----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// A shared-memory matrix descriptor with the 128-byte swizzle; offsets in
// bytes.
__device__ __forceinline__ uint64_t desc_sw128(const void* base,
                                               uint32_t offset,
                                               uint32_t lbo, uint32_t sbo) {
  const uint32_t addr = smem_u32(base) + offset;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16)
         | (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32)
         | (1ull << 62);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A and B from shared memory,
// both K-major; bf16 in, fp32 out.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A and B from shared memory,
// both K-major; bf16 in, fp32 out.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 128] (+)= A[64 x 16] * B[16 x 128]: A from registers (each warp's
// 16 rows in the m16n8k16 A-fragment layout), B from shared memory MN-major
// (trans-b 1: the instruction transposes it); bf16 in, fp32 out.
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64]: A from registers, B from shared
// memory MN-major (trans-b 1), as wgmma_rs_n128; bf16 in, fp32 out.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// The register-A product whose N is the accumulator's width: the head dim
// (64 or 128) of an O, dQ, dK or dV accumulator of D / 2 floats a thread.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  wgmma_rs_n64(d, a, desc_b, scale_d);
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  wgmma_rs_n128(d, a, desc_b, scale_d);
}

// ---- 3×TF32 ----------------------------------------------------------------
//
// An fp32 product a·b on the TF32 tensor cores to about fp32 accuracy: each
// operand is split as x = big + small, big = x rounded to TF32 (10 mantissa
// bits; round to nearest, ties away from zero) and small = x − big rounded
// the same way, and a·b ≈ a_big·b_big + a_big·b_small + a_small·b_big, the
// three products summed in fp32.  `kernels/flash_attention.py::tf32_split`
// is the same split in plain PyTorch.

__device__ __forceinline__ float tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r & 0xFFFFE000u);
}

// (big, small) of x as TF32 bit patterns.
__device__ __forceinline__ void tf32_split(float x, uint32_t& big,
                                           uint32_t& small) {
  const float b = tf32_round(x);
  big = __float_as_uint(b);
  small = __float_as_uint(tf32_round(x - b));
}

// D[64 x 64] (+)= A[64 x 8] * B[8 x 64], tf32 in, fp32 out: A and B from
// shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_tf32(float (&d)[32], uint64_t desc_a,
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D[64 x 64] (+)= A[64 x 8] * B[8 x 64], tf32 in, fp32 out: A from
// registers (each warp's 16 rows: a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
// a3 (g + 8, t + 4), g = lane / 4, t = lane % 4), B from shared memory,
// K-major.
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// C[16 x 8] += A[16 x 8] * B[8 x 8], tf32 in, fp32 out, one warp: A as for
// wgmma_rs_tf32, b0 (k = t, n = g), b1 (k = t + 4, n = g); c0 (g, 2t),
// c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// D (+)= A·B as 3×TF32 on wgmma, with `Corrections` (2; fewer only to
// plant a fault) of the correction products; `scale_d` 0 overwrites D.  A
// from registers (big, small) and B's planes in shared memory ...
template <int Corrections>
__device__ __forceinline__ void product3_rs(float (&d)[32],
                                            const uint32_t (&a_big)[4],
                                            const uint32_t (&a_small)[4],
                                            uint64_t b_big, uint64_t b_small,
                                            int scale_d) {
  wgmma_rs_tf32(d, a_big, b_big, scale_d);
  if (Corrections >= 1) wgmma_rs_tf32(d, a_big, b_small, 1);
  if (Corrections >= 2) wgmma_rs_tf32(d, a_small, b_big, 1);
}

// ... or both operands' planes in shared memory.
template <int Corrections>
__device__ __forceinline__ void product3_ss(float (&d)[32], uint64_t a_big,
                                            uint64_t a_small, uint64_t b_big,
                                            uint64_t b_small, int scale_d) {
  wgmma_ss_tf32(d, a_big, b_big, scale_d);
  if (Corrections >= 1) wgmma_ss_tf32(d, a_big, b_small, 1);
  if (Corrections >= 2) wgmma_ss_tf32(d, a_small, b_big, 1);
}

// The split A fragments of rows row0, row0 + 8 of an fp32 (N, d) slice
// (row stride `sn`), zero from n_rows and from column d: k-step kk holds
// (row0, 8kk + t), (row0 + 8, 8kk + t), (row0, 8kk + t + 4) and
// (row0 + 8, 8kk + t + 4).  The fp32 kernels call it for every tile:
// fragments held in registers across tiles were overwritten (ptxas gave a
// later wgmma group's A fragments their registers).
__device__ __forceinline__ void load_a_split(uint32_t (&big)[8][4],
                                             uint32_t (&small)[8][4],
                                             const float* src, long long sn,
                                             int row0, int n_rows, int d,
                                             int t) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = row0 + 8 * (r & 1), col = 8 * kk + t + 4 * (r >> 1);
      const float x = row < n_rows && col < d ? src[row * sn + col] : 0.f;
      tf32_split(x, big[kk][r], small[kk][r]);
    }
}

// The byte offset of element (row, col) in a [half][rows][32] fp32 tile
// with the 128-byte swizzle (`rows` rows a half; the base 1024-aligned).
__device__ __forceinline__ uint32_t sw128_f32(int rows, int row, int col) {
  return (col >> 5) * rows * 128 + row * 128
         + ((((col & 31) >> 2) ^ (row & 7)) << 4) + ((col & 3) << 2);
}

// The split planes of an fp32 (B, N, H, d) tensor x with element strides
// (sb, sn, sh, 1), d ≤ 64 a multiple of 4: planes (2, B·H, n_pad, 64),
// plane 0 the bigs and plane 1 the smalls, row n of head (b, h) at row
// (b·H + h)·n_pad + n; rows from N and columns from d are zeros.  One
// thread a float4; grid (ceil(n_pad·16 / 256), B·H).
__global__ void __launch_bounds__(256)
    tf32_split_planes_kernel(const float* __restrict__ x, float* planes,
                             int n, int n_pad, int heads, int d,
                             long long sb, long long sn, long long sh,
                             long long plane_stride) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= (long long)n_pad * 16) return;
  const int row = static_cast<int>(i >> 4), col = static_cast<int>(i & 15) * 4;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row < n && col < d)
    v = *reinterpret_cast<const float4*>(x + b * sb + row * sn + h * sh + col);
  const float e[4] = {v.x, v.y, v.z, v.w};
  float big[4], small[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    big[j] = tf32_round(e[j]);
    small[j] = tf32_round(e[j] - big[j]);
  }
  float* dst = planes + ((long long)bh * n_pad + row) * 64 + col;
  *reinterpret_cast<float4*>(dst) = make_float4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<float4*>(dst + plane_stride) =
      make_float4(small[0], small[1], small[2], small[3]);
}

}  // namespace sm90

// ---- host: tensor maps -------------------------------------------------------

namespace sm90_host {

// cuTensorMapEncodeTiled lives in libcuda; it is fetched through the
// runtime's entry-point query, so that the library needs no -lcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                  void*, const cuuint64_t*, const cuuint64_t*,
                                  const cuuint32_t*, const cuuint32_t*,
                                  CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

// A refused tensor map returns its CUresult offset by this, to tell it from
// the runtime's errors.
constexpr int kTensorMapErrorBase = 10000;

inline int encode_fn(EncodeTiledFn* out) {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess) return static_cast<int>(err);
    if (found != cudaDriverEntryPointSuccess || ptr == nullptr)
      return static_cast<int>(cudaErrorSymbolNotFound);
    fn = reinterpret_cast<EncodeTiledFn>(ptr);
  }
  *out = fn;
  return 0;
}

// A 4-D map (d, n, h, b) over a (B, N, H, D) bf16 tensor (D = 64 or 128)
// with element strides (sb, sn, sh, 1), read in boxes of 64 columns ×
// `box_rows` rows with the 128-byte swizzle; rows beyond N read as zeros.
// 0 on success.
inline int encode_bnhd(CUtensorMap* map, const void* ptr, int batch, int n,
                       int heads, int head_dim, long long sb, long long sn,
                       long long sh, int box_rows) {
  EncodeTiledFn fn;
  const int err = encode_fn(&fn);
  if (err) return err;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(head_dim),
                              static_cast<cuuint64_t>(n),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sn) * 2,
                                 static_cast<cuuint64_t>(sh) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapErrorBase + static_cast<int>(res);
}


// A 2-D map over fp32 rows of `cols` floats (`row_bytes` apart, a multiple
// of 16), `rows` of them, read in boxes of 32 columns (128 bytes) × 64 rows
// with the 128-byte swizzle.  0 on success.
inline int encode_f32_rows(CUtensorMap* map, const void* ptr, long long cols,
                           long long rows, long long row_bytes) {
  EncodeTiledFn fn;
  const int err = encode_fn(&fn);
  if (err) return err;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(row_bytes)};
  const cuuint32_t box[2] = {32, 64};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE,
                          CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kTensorMapErrorBase + static_cast<int>(res);
}

}  // namespace sm90_host

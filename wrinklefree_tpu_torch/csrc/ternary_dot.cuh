// Warp-level pieces of the packed-ternary dot on Hopper's int8 mma.sync
// path, shared by the decode GEMV (ternary_gemv.cu: K1 and K7 at <= 8 rows)
// and the streamed dots of the MLP block (ternary.cu: K2, and K8's MLP half):
// 16-byte weight loads that bypass L1, the unpack of four packed weight
// bytes to four A registers of unsigned codes, and mma.sync m16n8k32
// u8 x s8 -> s32.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// 16 bytes of streamed weights, not kept in L1
__device__ __forceinline__ uint4 ld_stream(const uint8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// The unsigned codes of the four weight bytes of `word` as four A registers:
// a[c] byte p = code p of byte c.
__device__ __forceinline__ void unpack4(uint32_t word, uint32_t (&a)[4]) {
  const uint32_t m = 0x03030303u;
  const uint32_t p0 = word & m, p1 = (word >> 2) & m, p2 = (word >> 4) & m, p3 = (word >> 6) & m;
  const uint32_t lo01 = __byte_perm(p0, p1, 0x5140), hi01 = __byte_perm(p2, p3, 0x5140);
  const uint32_t lo23 = __byte_perm(p0, p1, 0x7362), hi23 = __byte_perm(p2, p3, 0x7362);
  a[0] = __byte_perm(lo01, hi01, 0x5410);
  a[1] = __byte_perm(lo01, hi01, 0x7632);
  a[2] = __byte_perm(lo23, hi23, 0x5410);
  a[3] = __byte_perm(lo23, hi23, 0x7632);
}

__device__ __forceinline__ void mma_u8s8(int (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

}  // namespace

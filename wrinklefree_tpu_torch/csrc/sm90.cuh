// Hopper building blocks shared by the paged flash decode (K6,
// flash_decode.cu), the paged flash prefill (K4, flash_paged_prefill.cu) and
// the causal flash prefill (K9, flash_prefill.cu): mbarriers, copy-engine
// (TMA) and cp.async loads, ldmatrix, mma.sync m16n8k16 bf16 or fp16 and
// m16n8k8 TF32 -> f32, the TF32 pieces of f32 values (the f32 pools'
// 3xTF32 products), the 16-bit types' pairs (packing, scaling), and the
// tensor maps, all in the 128-byte swizzle, of [rows, KV*128] bf16, fp16 or
// f32 arrays in boxes of 16 rows x 128 bytes and of [batch, rows, KV*D]
// bf16 or f32 arrays in boxes of n rows x 128 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Pool codes of the paged flash kernels' entry points: the type of the pool
// (and, in K4, of q, the chunk's keys and the output).
constexpr int ELEM_BF16 = 0, ELEM_F16 = 1, ELEM_F32 = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// arrive on bar, which then also waits for `bytes` from the copy engine
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `phase` of the barrier has completed. A
// wait of more than ~2^34 cycles (seconds) traps, so that a fault in the ring
// fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int phase) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  long long t0 = 0;
  do {
    if (t0 == 0)
      t0 = clock64();
    else if (clock64() - t0 > (1ll << 34))
      __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(a), "r"(phase)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// 2-D copy-engine load of one box at (c0 elements, c1 rows) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// 3-D copy-engine load of one box at (c0 elements, c1 rows, c2 batch row);
// elements outside the array arrive as zeros.
__device__ __forceinline__ void tma_load3(void* dst, const CUtensorMap* map, int c0, int c1,
                                          int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// bar also waits for this thread's cp.async copies issued so far
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// this thread's arrival on bar, made when its cp.async copies so far land
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_addr(bar))
               : "memory");
}

// order this thread's shared-memory writes before later copy-engine writes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 inputs, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with fp16 inputs (the product of two fp16 values, subnormals
// included, is exact in f32)
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a (16x8, row) * b (8x8, col), TF32 inputs (f32 registers whose low
// 13 mantissa bits the tensor cores ignore), f32 accumulators. Every bf16
// and every fp16 value, subnormals included, is exact in TF32, and the
// product of a bf16 and an fp16 value is exact in f32.
__device__ __forceinline__ void mma_tf32(float (&d)[4], float a0, float a1, float a2, float a3,
                                         float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)));
}

// d = a * b with the accumulators' input zero: the first product of a
// fresh accumulator
__device__ __forceinline__ void mma_tf32_first(float (&d)[4], float a0, float a1, float a2,
                                               float a3, float b0, float b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(__float_as_uint(a0)), "r"(__float_as_uint(a1)), "r"(__float_as_uint(a2)),
        "r"(__float_as_uint(a3)), "r"(__float_as_uint(b0)), "r"(__float_as_uint(b1)),
        "f"(0.f));
}

// The TF32 pieces of an f32 value x, as the f32 pools' kernels hand them to
// mma_tf32 (ops/flash_attention.py::tf32_split models them bit for bit):
// hi keeps x's sign, exponent and top 10 mantissa bits (truncation, so the
// largest finite values cannot round up to infinity); the rest r = x - hi is
// exact in f32 and below 2^-10 of |x|.
// - split2: hi and lo = r rounded to the nearest TF32 value (ties away from
//   zero, subnormals kept): |x - hi - lo| <= 2^-22 |x| where lo is normal.
//   A product of two such values as hi*hi + hi*lo + lo*hi (3xTF32) leaves
//   out lo*lo, below 2^-20 of it.
// - split3: hi, mid = r truncated to TF32, and lo = r - mid, which has at
//   most two significant bits: hi + mid + lo = x exactly, where x is a
//   multiple of TF32's least subnormal 2^-136 (every |x| >= 2^-113).
//   Each piece times a bf16 value is exact in f32.
__device__ __forceinline__ float tf32_trunc(float x) {
  return __uint_as_float(__float_as_uint(x) & 0xFFFFE000u);
}
__device__ __forceinline__ float tf32_round(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}
__device__ __forceinline__ void split2(float x, float& hi, float& lo) {
  hi = tf32_trunc(x);
  lo = tf32_round(x - hi);
}
__device__ __forceinline__ void split3(float x, float& hi, float& mid, float& lo) {
  hi = tf32_trunc(x);
  const float r = x - hi;
  mid = tf32_trunc(r);
  lo = r - mid;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (lo, hi) rounded to fp16 to nearest even, subnormals kept
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The tensor-core kernels' 16-bit element T (__nv_bfloat16 or __half): its
// mma, its pair packed from two floats, and a pair scaled in T.
template <typename T>
struct F16Ops;
template <>
struct F16Ops<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  // the pair x times the scalar s rounded to T, correctly rounded
  static __device__ __forceinline__ uint32_t scale(uint32_t x, float s) {
    const __nv_bfloat162 y = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(&x),
                                     __bfloat162bfloat162(__float2bfloat16_rn(s)));
    return *reinterpret_cast<const uint32_t*>(&y);
  }
};
template <>
struct F16Ops<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_f16(d, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  static __device__ __forceinline__ uint32_t scale(uint32_t x, float s) {
    const __half2 y = __hmul2(*reinterpret_cast<const __half2*>(&x),
                              __half2half2(__float2half_rn(s)));
    return *reinterpret_cast<const uint32_t*>(&y);
  }
};

// Byte offset of the 16-byte chunk c (dims 8c..8c+7 of 16-bit rows, 4c..4c+3
// of f32 rows) of row r (0-15) of a 16-row group: [128-byte column of
// boxes][16 rows][128 bytes] in the copy engine's
// 128-byte swizzle (chunk c & 7 of a row stored at (c & 7) ^ (r & 7) within
// each 1 KB), so that ldmatrix's eight 16-byte rows hit distinct banks. The
// group must start on 1024 bytes.
__device__ __forceinline__ int swz(int r, int c) {
  return (((c >> 3) * 16 + r) << 7) + (((c & 7) ^ (r & 7)) << 4);
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime's entry-point
// query, so that the library needs no -lcuda.
cudaError_t encode_tiled(EncodeTiled* out) {
  static EncodeTiled enc = nullptr;
  if (enc == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e != cudaSuccess) return e;
    if (q != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    enc = reinterpret_cast<EncodeTiled>(p);
  }
  *out = enc;
  return cudaSuccess;
}

// A bf16, fp16 or f32 array [rows, cols] (rows of cols elements,
// contiguous; elem ELEM_BF16, ELEM_F16 or ELEM_F32) as boxes of 16 rows x
// 128 bytes (64 elements, or 32 in f32) in the 128-byte swizzle. The map
// names the element type, though a copy without conversion or fill moves
// the same bytes for either 16-bit type.
cudaError_t rows_map(CUtensorMap* map, const void* base, long long rows, int cols, int elem) {
  EncodeTiled enc;
  const cudaError_t e = encode_tiled(&enc);
  if (e != cudaSuccess) return e;
  const cuuint64_t eb = elem == ELEM_F32 ? 4 : 2;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * eb};
  const cuuint32_t box[2] = {(cuuint32_t)(128 / eb), 16};
  const cuuint32_t one[2] = {1, 1};
  CUresult r = enc(map,
                   elem == ELEM_F32   ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : elem == ELEM_F16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   2, const_cast<void*>(base), dims, strides, box, one,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A bf16 (elem_bytes 2) or f32 (4) array [batch, rows, cols] as boxes of
// box_rows rows x 128 bytes of one batch row in the 128-byte swizzle: a
// box's rows from `rows` on arrive as zeros.
cudaError_t batched_rows_map(CUtensorMap* map, const void* base, int batch, long long rows,
                             int cols, int elem_bytes, int box_rows) {
  EncodeTiled enc;
  const cudaError_t e = encode_tiled(&enc);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem_bytes,
                                 (cuuint64_t)rows * cols * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  CUresult r = enc(map,
                   elem_bytes == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                   3, const_cast<void*>(base), dims, strides, box, elem,
                   CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace

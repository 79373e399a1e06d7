// The packed-ternary GEMM of the prefill rows (above 8 rows): K1's and K7's
// dot on Hopper's int8 tensor cores, with TMA loads into an mbarrier ring
// and wgmma s8 x s8 -> s32.
//
// It serves ternary_matmul_stacked_fused (K1, after k1_prologue), and
// ternary_matmul_pallas / ternary_matmul_pallas_stacked (K7, after
// k7_interleave) of wrinklefree_tpu/ops/ternary_pallas.py above 8 rows; the
// <= 8-row decode dots are the GEMV of ternary_gemv.cu.
//
// What it computes: out[m, n] = float(dot) * (1/(sx[m] * sw[n*sw_stride]))
// as bf16 or f32, or the exact int32 dot, where dot is the signed integer
// product of row m of the interleaved codes x4 [B, K] with column n of the
// packed weights w [K/4, N] (the same epilogue as ternary_gemv.cu's emit_out, so
// the output is bit for bit that of the CUDA-core dot it replaced). x4 holds
// x4[m, 4r+p] = x[m, p*K/4 + r], and weight byte w[r, n] holds the 2-bit
// codes (+1) of exactly those four k, so packed rows r0..r0+31 meet one
// contiguous 128-byte slice of x4: each byte unpacks to four signed int8
// codes {-1, 0, 1} (__vsub4 of the spread byte and 0x01010101), and the
// product needs no row-sum correction.
//
// Bound: by operations at the prefill chunks (2*B*K*N int8 operations over
// the 1979 TOP/s dense peak; a 512-row chunk is 20-100x above the H100's
// bytes-per-operation line), by the weight bytes at a few dozen rows. This
// first version reaches neither (its tensor-core share is in PERF.md): each
// block runs its stages one after another (unpack, wgmma group, wait for
// the group) with both warpgroups in step, so the chain of stages sets a
// floor per call whatever the tile's width, and small grids (few rows or
// columns) leave most SMs idle; a split over K and a persistent grid are
// the next steps.
//
// Design (swap-AB): the wgmma M side is the weights, the N side the tokens.
// - A block owns 128 weight columns (two consumer warpgroups of 64) and BT
//   tokens: 128 where that still gives half the SMs a block, else 64.
// - One producer thread keeps a ring of four stages in flight with TMA:
//   per stage the x4 tile [BT x 128 B] and the packed weight tile
//   [32 rows x 128 B], both with the 128-byte swizzle, completion on the
//   stage's `full` mbarrier; consumers release a stage on its `empty` one.
// - The unpack costs no shared-memory store: wgmma takes A from registers,
//   and one 32-bit s8 A-fragment register holds 4 consecutive k of one row,
//   which is exactly one packed weight byte spread to four codes. Each
//   thread reads one 16-bit pair of weight bytes per packed row (columns
//   2g and 2g+1 of its warp's 16, conflict-free through the swizzle): A row
//   g of the warp is weight column 2g, A row g+8 is column 2g+1, so the
//   epilogue holds two adjacent columns per token and stores them as a pair.
// - x4 is the B operand (K-major, as wgmma requires for 8-bit types) read
//   from shared memory through a 128B-swizzle descriptor; a stage is four
//   m64 x BT x k32 wgmmas per warpgroup.
// - A ragged K/4 (not a multiple of 32), N or B edge is zero-filled by TMA:
//   a zero x4 byte meets the zero-filled weight byte's code -1, product 0,
//   and columns or rows beyond N or B are never stored.
// TMA needs 16-byte aligned row strides and bases: K and N multiples of 16
// (every configuration of the repo; the wrappers raise otherwise).
//
// The tensor maps are built on the host per call (the layer or expert
// pointer changes on every call) through cuTensorMapEncodeTiled, looked up
// through the CUDA runtime's entry-point query so that the library needs
// no -lcuda.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;                     // weight columns per block
constexpr int KR = 32;                      // packed rows per stage (128 k)
constexpr int STAGES = 4;                   // the ring: 48 KB (64 tokens) or 80 KB
constexpr int CONSUMERS = 256;              // two warpgroups
constexpr int THREADS = CONSUMERS + 32;     // + the producer warp
constexpr int W_TILE = KR * BN;             // bytes of a packed weight tile

constexpr int OUT_BF16 = 0;  // the modes of ternary_gemv.cu's emit_out
constexpr int OUT_F32 = 1;
constexpr int OUT_I32 = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

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

// 2-D TMA load of one box at (c0 bytes, c1 rows) into shared memory.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

// wgmma shared-memory descriptor of a K-major tile of 128-byte rows in the
// 128-byte swizzle (8-row atoms 1024 bytes apart; the base 1024-aligned).
__device__ __forceinline__ uint64_t desc_sw128(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// The four signed codes {-1, 0, 1} of one packed byte, one per byte lane
// (lane p is input p*K/4 + r of the byte's row r).
__device__ __forceinline__ uint32_t signed_codes(uint32_t b) {
  return __vsub4((b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u, 0x01010101u);
}

template <int NACC>
__device__ __forceinline__ void fence_acc(int (&d)[NACC]) {
#pragma unroll
  for (int i = 0; i < NACC; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

#define WF_D8(i)                                                                     \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), "+r"(d[i + 4]),       \
      "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d[64 x BT] += A[64 x 32] (registers a0..a3) * B[32 x BT] (descriptor).
template <int BT>
__device__ __forceinline__ void wgmma_rs(int (&d)[BT / 2], const uint32_t* a, uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<64>(int (&d)[32], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p;\n"
      "}\n"
      : WF_D8(0), WF_D8(8), WF_D8(16), WF_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(int (&d)[64], const uint32_t* a, uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p;\n"
      "}\n"
      : WF_D8(0), WF_D8(8), WF_D8(16), WF_D8(24), WF_D8(32), WF_D8(40), WF_D8(48), WF_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

#undef WF_D8

template <int BT>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (BT * 128 + W_TILE) + 2 * STAGES * sizeof(uint64_t) + 1024;
}

// Store the pair (columns n, n+1) of token m.
template <int MODE>
__device__ __forceinline__ void store_pair(void* out, size_t idx, int d0, int d1, float sx,
                                           float sw0, float sw1) {
  if constexpr (MODE == OUT_I32) {
    *reinterpret_cast<int2*>(static_cast<int*>(out) + idx) = make_int2(d0, d1);
  } else {
    const float y0 = (float)d0 * (1.f / (sx * sw0));
    const float y1 = (float)d1 * (1.f / (sx * sw1));
    if constexpr (MODE == OUT_F32)
      *reinterpret_cast<float2*>(static_cast<float*>(out) + idx) = make_float2(y0, y1);
    else
      *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + idx) =
          __floats2bfloat162_rn(y0, y1);
  }
}

template <int BT, int MODE>
__global__ void __launch_bounds__(THREADS, 1)
    k_ternary_gemm(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                   const float* __restrict__ sx, const float* __restrict__ sw, int sw_stride,
                   int B, int K4, int N, void* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* xs = reinterpret_cast<uint8_t*>(((uintptr_t)smem_raw + 1023) & ~(uintptr_t)1023);
  uint8_t* ws = xs + STAGES * BT * 128;
  uint64_t* full = reinterpret_cast<uint64_t*>(ws + STAGES * W_TILE);
  uint64_t* empty = full + STAGES;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BT;
  const int stages = (K4 + KR - 1) / KR;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {  // the producer warp: one thread issues the loads
    if (threadIdx.x == CONSUMERS) {
      for (int it = 0; it < stages; ++it) {
        const int s = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
        mbar_expect_tx(&full[s], BT * 128 + W_TILE);
        tma_load(xs + s * BT * 128, &xmap, it * 128, m0, &full[s]);
        tma_load(ws + s * W_TILE, &wmap, n0, it * KR, &full[s]);
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int chunk = wg * 4 + warp;  // this warp's 16 weight columns in the 128-byte row
  int acc[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = 0;

  for (int it = 0; it < stages; ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint8_t* wt = ws + s * W_TILE;
    uint32_t a[16];
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // fragment a[4ks + 2h + c]: k bytes 16h + 4tq.. of step ks = packed row r,
        // A row g (c = 0: column 2g) or g + 8 (c = 1: column 2g + 1)
        const int r = ks * 8 + h * 4 + tq;
        const uint32_t v = *reinterpret_cast<const uint16_t*>(
            wt + r * BN + ((chunk ^ (r & 7)) << 4) + 2 * g);
        a[ks * 4 + h * 2] = signed_codes(v & 0xffu);
        a[ks * 4 + h * 2 + 1] = signed_codes(v >> 8);
      }
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    const uint64_t desc = desc_sw128(xs + s * BT * 128);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_rs<BT>(acc, a + 4 * ks, desc + 2 * ks);  // +32 bytes
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_acc(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // acc[4j + c]: token m0 + 8j + 2tq + (c & 1), A row g + 8 (c >> 1)
  const int n = n0 + wg * 64 + warp * 16 + 2 * g;
  if (n >= N) return;  // N % 16 == 0: column n + 1 exists with n
  float sw0 = 0.f, sw1 = 0.f;
  if constexpr (MODE != OUT_I32) {
    sw0 = sw[n * sw_stride];
    sw1 = sw[(n + 1) * sw_stride];
  }
#pragma unroll
  for (int j = 0; j < BT / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * tq + e;
      if (m < B)
        store_pair<MODE>(out, (size_t)m * N + n, acc[4 * j + e], acc[4 * j + 2 + e],
                         MODE == OUT_I32 ? 0.f : sx[m], sw0, sw1);
    }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encoder(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
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
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Map of a row-major uint8 matrix [rows, cols] (row stride cols bytes) in
// boxes of box_rows x 128 bytes, 128-byte swizzle, zero fill out of bounds.
cudaError_t make_map(CUtensorMap* map, const void* base, int cols, int rows, int box_rows) {
  EncodeTiled enc;
  cudaError_t e = encoder(&enc);
  if (e != cudaSuccess) return e;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols};
  const cuuint32_t box[2] = {128, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides,
                   box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int BT, int MODE>
cudaError_t launch(const void* x4, int B, int K, const float* sx, const void* w, const float* sw,
                   int sw_stride, int N, void* out, cudaStream_t st) {
  CUtensorMap xmap, wmap;
  cudaError_t e;
  if ((e = make_map(&xmap, x4, K, B, BT)) != cudaSuccess) return e;
  if ((e = make_map(&wmap, w, N, K / 4, KR)) != cudaSuccess) return e;
  constexpr size_t smem = smem_bytes<BT>();
  e = cudaFuncSetAttribute(k_ternary_gemm<BT, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + BN - 1) / BN, (B + BT - 1) / BT);
  k_ternary_gemm<BT, MODE><<<grid, THREADS, smem, st>>>(xmap, wmap, sx, sw, sw_stride, B, K / 4,
                                                        N, out);
  return cudaGetLastError();
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      sms = 132;
  }
  return sms;
}

// 128 tokens per block where that still gives at least half the SMs a block
// (each weight tile then serves twice the tokens), else 64 (twice the blocks).
template <int MODE>
cudaError_t launch_mode(const void* x4, int B, int K, const float* sx, const void* w,
                        const float* sw, int sw_stride, int N, void* out, cudaStream_t st) {
  const int col_tiles = (N + BN - 1) / BN;
  if (B > 64 && 2 * col_tiles * ((B + 127) / 128) >= sm_count())
    return launch<128, MODE>(x4, B, K, sx, w, sw, sw_stride, N, out, st);
  return launch<64, MODE>(x4, B, K, sx, w, sw, sw_stride, N, out, st);
}

}  // namespace

extern "C" {

// out[B,N] = the packed-ternary dot of interleaved int8 codes x4[B,K] with
// w[K/4,N]: mode 0 bf16, mode 1 f32 of float(dot) * (1/(sx[b]*sw[n*sw_stride]))
// (sw_stride 1: per column, 0: one scalar); mode 2 the exact int32 dot (sx,
// sw unused). K and N multiples of 16, x4 and w 16-byte aligned.
int wf_ternary_gemm(const void* x4, int B, int K, const void* sx, const void* w, const void* sw,
                    int sw_stride, int N, int mode, void* out, void* stream) {
  if (B <= 0) return 0;
  if (K <= 0 || K % 16 || N <= 0 || N % 16 || (uintptr_t)x4 % 16 || (uintptr_t)w % 16)
    return cudaErrorInvalidValue;
  const float* s = (const float*)sx;
  const float* swf = (const float*)sw;
  cudaStream_t st = (cudaStream_t)stream;
  if (mode == OUT_BF16) return launch_mode<OUT_BF16>(x4, B, K, s, w, swf, sw_stride, N, out, st);
  if (mode == OUT_F32) return launch_mode<OUT_F32>(x4, B, K, s, w, swf, sw_stride, N, out, st);
  if (mode == OUT_I32) return launch_mode<OUT_I32>(x4, B, K, s, w, swf, sw_stride, N, out, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

// The packed-ternary GEMV of the decode rows (1-8): K1's and K7's dot at 8
// rows or fewer, on Hopper's int8 mma.sync tensor-core path with the weights
// streamed from HBM in 16-byte loads.
//
// It replaces, at 8 rows or fewer, wrinklefree_tpu/ops/ternary_pallas.py::
// ternary_matmul_stacked_fused :353 (K1, after k1_prologue in ternary.cu),
// ternary_matmul_pallas :132 and ternary_matmul_pallas_stacked :228 (K7, on
// the caller's codes in natural order). Above 8 rows both end in
// ternary_gemm.cu.
//
// What it computes: out[m, n] = float(dot) * (1/(sx[m] * sw[n*sw_stride]))
// as bf16 (round to nearest even) or f32, or the exact int32 dot, where dot
// is the signed integer product of row m of the int8 codes with column n of
// the packed weights w [K/4, N] (wf plane-major format: byte w[r, n] holds
// the 2-bit codes (+1) of inputs k = r, K/4+r, 2K/4+r, 3K/4+r). The dot is
// exact, so its split over blocks changes no bit: the output is that of the
// GEMM above 8 rows (ternary_gemm.cu, the same epilogue).
//
// Bound: the weight stream, K*N/4 bytes per call (2.5 MB for BitNet-2B's
// fused qkv, 8.8 MB for gateup) over 3.35 TB/s, 0.4-2.7 us; the row count
// hardly matters (2*B*K*N int8 operations are 1-2% of the tensor cores' peak
// time). What it takes to get near it, and what the design does:
// - Bytes in flight. Each thread issues 16-byte loads (ld.global.nc, no L1
//   allocation) of 16 contiguous columns of one packed row and keeps a ring
//   of eight (four k-steps) in flight, each refilled as soon as it is used:
//   4 KB per warp, several MB card-wide, all of a 2B decode matrix at once
//   for the narrow shapes.
// - Enough blocks. A block owns 128 columns and a slice of K/4; `split`
//   blocks (1-8, a power of two chosen on the host: the largest whose grid
//   stays within one block per SM) share a column tile as one thread-block
//   cluster. Each block sums its eight warps' int32 partials in shared
//   memory; the other blocks of the cluster write their 1024 sums into
//   rank 0's shared memory (distributed shared memory), and rank 0 adds
//   them up and stores the tile: deterministic, no global scratch, no
//   counters, safe in a CUDA graph.
// - The unpack on the tensor cores' side. mma.sync m16n8k32 u8 x s8 -> s32
//   takes the weights as A (16 columns x 32 k) and the codes as B (32 k x 8
//   rows). One A register holds 4 consecutive k of one column; with the k
//   order 4r + p one weight byte is exactly one register (its four codes
//   spread to bytes), and one B register is the word (x[r], x[K/4+r],
//   x[2K/4+r], x[3K/4+r]) of one row: K1's prologue writes its codes in that
//   order, and K7's natural-order codes are gathered into it while the
//   block stages its slice. Thread (g, t) of a warp loads packed rows t and
//   t+4 of a k-step at columns 16g..16g+15, so a warp-wide load reads four
//   full 128-byte lines, and the 32 bytes it holds are the A fragments of
//   eight mmas (columns 2j, 2j+1 as A rows g, g+8). A loaded word unpacks to
//   four registers with three shifts, four masks and eight byte permutes.
//   The codes stay unsigned (w+1 in {0,1,2}); each warp subtracts the sum of
//   the row's codes over the k it covered (two __dp4a per k-step on the B
//   registers) from its partials, so nothing outside needs a row sum.
// - No serial start. A block waits for the previous grid (griddepcontrol.
//   wait: the launch allows programmatic stream serialization, and K1's
//   prologue lets this grid be scheduled at once), issues the loads of its
//   slice's codes (at most 8 rows, 16 bytes = 4 packed rows of one row per
//   item, up to 4 items per thread at once), then its weight ring, then
//   stores the codes to shared memory: the slice takes one round of L2
//   loads, not one per word, and does not queue behind the weights.
// - The shared-memory limit is raised once per process, and only when a
//   shape needs more than the default 48 KB.
// How close it comes to the bound, shape by shape, is in PERF.md.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() or the launch's error.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TN = 128;               // weight columns per block: 8 lane groups x 16
constexpr int STEP = 8;               // packed rows per k-step (one mma's 32 k)
constexpr int UNR = 4;                // k-steps whose loads a warp keeps in flight
constexpr int STAGE = 4;              // staged code items a thread loads at once
constexpr int ROWS = 8;               // the mma's N: at most 8 rows of codes
constexpr int MAX_SPLIT = 8;          // blocks per cluster (the portable limit)
constexpr int OUTS = TN * ROWS;       // int32 partials per block
constexpr int DEFAULT_SMEM = 48 * 1024;

constexpr int OUT_BF16 = 0;  // the modes of emit_out, below
constexpr int OUT_F32 = 1;
constexpr int OUT_I32 = 2;

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

// Store one output of the signed dot `dot` (row scale sxm, column scale swn).
template <int MODE>
__device__ __forceinline__ void emit_out(void* out, size_t idx, int dot, float sxm, float swn) {
  if constexpr (MODE == OUT_I32) {
    static_cast<int*>(out)[idx] = dot;
  } else {
    const float y = (float)dot * (1.f / (sxm * swn));
    if constexpr (MODE == OUT_F32)
      static_cast<float*>(out)[idx] = y;
    else
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
  }
}

// Partial o = (4j + c) * 32 + lane of a block (mma j, accumulator c, lane
// g*4 + t) is column n0 + 16g + 2j + c/2, row 2t + c%2.
__device__ __forceinline__ int out_col(int n0, int o) {
  const int i = o >> 5, l = o & 31;
  return n0 + 16 * (l >> 2) + 2 * (i >> 2) + ((i & 3) >> 1);
}
__device__ __forceinline__ int out_row(int o) { return 2 * ((o & 31) & 3) + ((o >> 5) & 1); }

// Grid (split, ceil(N/128)); cluster (split, 1, 1). codes: B rows of K int8,
// interleaved (word r of a row is (x[r], x[K/4+r], x[2K/4+r], x[3K/4+r]): K1's
// prologue) or in natural order (NATURAL: K7). sp: the row stride of the
// staged slice in words (sp % 32 == 4: the B-fragment reads are free of bank
// conflicts). The codes and sx may be written by the previous grid while
// this one starts (programmatic dependent launch), so they are read after
// griddepcontrol.wait through L2 (ld.global.cg), never the non-coherent path.
template <int MODE, bool NATURAL>
__global__ void __launch_bounds__(THREADS, 2)
k_ternary_gemv(const int8_t* codes, int B, int K, const float* sx,
               const uint8_t* __restrict__ w, const float* __restrict__ sw, int sw_stride, int N,
               int split, int sp, void* __restrict__ out) {
  // the slice's codes [ROWS][sp], then the warps' partials [WARPS][OUTS]; in
  // rank 0 of a cluster, then the other ranks' sums [split - 1][OUTS]
  extern __shared__ int smem[];
  __shared__ float sxs[ROWS];
  const int K4 = K / 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rank = split > 1 ? (int)cg::this_cluster().block_rank() : 0;
  // tells the cluster this block has started (its shared memory may be written)
  if (split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  const int n0 = blockIdx.y * TN;
  const int steps = (K4 + STEP - 1) / STEP;
  const int s0 = rank * steps / split;
  const int nsb = (rank + 1) * steps / split - s0;  // this block's k-steps
  const int r0 = s0 * STEP;                         // its first packed row
  const int col = n0 + 16 * g;
  const bool col_ok = col < N;

  // The codes and sx are the previous grid's output (K1's prologue). The
  // slice's codes go to shared memory in items of 4 packed rows of one row
  // (16 bytes): one 16-byte load of interleaved codes, or four 4-byte loads
  // of natural-order codes (4 consecutive k of each plane, transposed to 4
  // words when stored). A thread's first STAGE items are loaded before the
  // weights, all at once, so that they do not queue behind them.
  asm volatile("griddepcontrol.wait;" ::: "memory");
  if (MODE != OUT_I32 && threadIdx.x < B) sxs[threadIdx.x] = __ldcg(sx + threadIdx.x);
  const int groups = nsb * STEP / 4, items = ROWS * groups;
  auto load_item = [&](int i) {
    const int m = i / groups, r = r0 + (i - m * groups) * 4;
    if (m >= B || r >= K4) return make_uint4(0u, 0u, 0u, 0u);  // K4 % 4 == 0: all 4 or none
    if constexpr (NATURAL) {
      const unsigned int* x = reinterpret_cast<const unsigned int*>(codes + (size_t)m * K + r);
      return make_uint4(__ldcg(x), __ldcg(x + K4 / 4), __ldcg(x + K4 / 2), __ldcg(x + 3 * K4 / 4));
    } else {
      return __ldcg(reinterpret_cast<const uint4*>(codes + (size_t)m * K + 4 * r));
    }
  };
  auto store_item = [&](int i, uint4 v) {
    const int m = i / groups, j = (i - m * groups) * 4;
    if constexpr (NATURAL) {  // plane words -> the words of 4 packed rows
      const uint32_t lo01 = __byte_perm(v.x, v.y, 0x5140), lo23 = __byte_perm(v.z, v.w, 0x5140);
      const uint32_t hi01 = __byte_perm(v.x, v.y, 0x7362), hi23 = __byte_perm(v.z, v.w, 0x7362);
      v = make_uint4(__byte_perm(lo01, lo23, 0x5410), __byte_perm(lo01, lo23, 0x7632),
                     __byte_perm(hi01, hi23, 0x5410), __byte_perm(hi01, hi23, 0x7632));
    }
    *reinterpret_cast<uint4*>(smem + m * sp + j) = v;
  };
  uint4 xv[STAGE];
#pragma unroll
  for (int q = 0; q < STAGE; ++q) {
    const int i = threadIdx.x + q * THREADS;
    xv[q] = i < items ? load_item(i) : make_uint4(0u, 0u, 0u, 0u);
  }

  // a ring of UNR k-steps in flight: slot u holds packed rows t and t+4 of
  // the warp's step warp + (i*UNR + u)*WARPS in round i and, as soon as it
  // is used, is refilled with its step of round i+1
  uint4 wl[UNR], wh[UNR];
  auto load = [&](int u, int s) {
    const int r = r0 + s * STEP + t;
    const bool ok = col_ok && s < nsb;
    wl[u] = ok && r < K4 ? ld_stream(w + (size_t)r * N + col) : make_uint4(0u, 0u, 0u, 0u);
    wh[u] = ok && r + 4 < K4 ? ld_stream(w + (size_t)(r + 4) * N + col)
                             : make_uint4(0u, 0u, 0u, 0u);
  };
#pragma unroll
  for (int u = 0; u < UNR; ++u) load(u, warp + u * WARPS);

  // rank 0 stores all 1024 outputs, 4 per thread: their column scales now
  float swv[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = out_col(n0, threadIdx.x + q * THREADS);
    swv[q] = MODE != OUT_I32 && rank == 0 && n < N ? __ldg(sw + n * sw_stride) : 0.f;
  }

#pragma unroll
  for (int q = 0; q < STAGE; ++q)
    if (threadIdx.x + q * THREADS < items) store_item(threadIdx.x + q * THREADS, xv[q]);
  for (int i = threadIdx.x + STAGE * THREADS; i < items; i += THREADS) store_item(i, load_item(i));
  __syncthreads();

  int acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0;
  int rs = 0;  // row g's code sum over the k this warp covers
  for (int first = warp; first < nsb; first += WARPS * UNR) {
#pragma unroll
    for (int u = 0; u < UNR; ++u) {
      const int s = first + u * WARPS;
      if (s < nsb) {
        const int* xr = smem + g * sp + s * STEP + t;
        const uint32_t b0 = (uint32_t)xr[0], b1 = (uint32_t)xr[4];
        rs = __dp4a((int)b0, 0x01010101, rs);
        rs = __dp4a((int)b1, 0x01010101, rs);
        const uint32_t lo[4] = {wl[u].x, wl[u].y, wl[u].z, wl[u].w};
        const uint32_t hi[4] = {wh[u].x, wh[u].y, wh[u].z, wh[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          uint32_t al[4], ah[4];
          unpack4(lo[i], al);
          unpack4(hi[i], ah);
          mma_u8s8(acc[2 * i], al[0], al[1], ah[0], ah[1], b0, b1);
          mma_u8s8(acc[2 * i + 1], al[2], al[3], ah[2], ah[3], b0, b1);
        }
        load(u, s + WARPS * UNR);
      }
    }
  }

  // unsigned codes -> the signed dot: subtract the rows' code sums (this
  // thread's accumulators are rows 2t and 2t+1; group g holds row g's sum)
  rs += __shfl_xor_sync(0xffffffffu, rs, 1);
  rs += __shfl_xor_sync(0xffffffffu, rs, 2);
  const int rs0 = __shfl_sync(0xffffffffu, rs, 8 * t), rs1 = __shfl_sync(0xffffffffu, rs, 8 * t + 4);
  __syncthreads();  // every warp is done with the staged codes
  int* part = smem + warp * OUTS;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    part[(4 * j + 0) * 32 + lane] = acc[j][0] - rs0;
    part[(4 * j + 1) * 32 + lane] = acc[j][1] - rs1;
    part[(4 * j + 2) * 32 + lane] = acc[j][2] - rs0;
    part[(4 * j + 3) * 32 + lane] = acc[j][3] - rs1;
  }
  __syncthreads();
  // the block's sums of outputs threadIdx.x + q*THREADS
  int dot[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dot[q] = 0;
#pragma unroll
    for (int p = 0; p < WARPS; ++p) dot[q] += smem[p * OUTS + threadIdx.x + q * THREADS];
  }

  // the other ranks of the cluster write their sums into rank 0's shared
  // memory (after every block has started), and rank 0 adds them up
  if (split > 1) {
    int* recv = smem + (ROWS * sp > WARPS * OUTS ? ROWS * sp : WARPS * OUTS);
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    if (rank != 0) {
      int* dst = cg::this_cluster().map_shared_rank(recv, 0) + (rank - 1) * OUTS;
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[threadIdx.x + q * THREADS] = dot[q];
    }
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (rank != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    for (int r = 1; r < split; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) dot[q] += recv[(r - 1) * OUTS + threadIdx.x + q * THREADS];
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int o = threadIdx.x + q * THREADS, n = out_col(n0, o), m = out_row(o);
    if (m < B && n < N) emit_out<MODE>(out, (size_t)m * N + n, dot[q], sxs[m], swv[q]);
  }
}

template <int MODE, bool NATURAL>
cudaError_t launch_gemv(const void* codes, int B, int K, const void* sx, const void* w,
                        const void* sw, int sw_stride, int N, int split, void* out,
                        cudaStream_t st) {
  static int smem_limit = DEFAULT_SMEM;  // raised once per process when a shape needs it
  const int steps = (K / 4 + STEP - 1) / STEP;
  const int rows = (steps + split - 1) / split * STEP;  // the largest slice
  const int sp = (rows + 27) / 32 * 32 + 4;
  const int words = (ROWS * sp > WARPS * OUTS ? ROWS * sp : WARPS * OUTS) +
                    (split > 1 ? (split - 1) * OUTS : 0);  // rank 0's receive slots
  const int smem = words * 4;
  cudaError_t e;
  if (smem > smem_limit) {
    if ((e = cudaFuncSetAttribute(k_ternary_gemv<MODE, NATURAL>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
        cudaSuccess)
      return e;
    smem_limit = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + TN - 1) / TN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute at[2];
  at[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  at[0].val.programmaticStreamSerializationAllowed = 1;
  at[1].id = cudaLaunchAttributeClusterDimension;
  at[1].val.clusterDim.x = split;
  at[1].val.clusterDim.y = 1;
  at[1].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = split > 1 ? 2 : 1;
  e = cudaLaunchKernelEx(&cfg, k_ternary_gemv<MODE, NATURAL>, (const int8_t*)codes, B, K,
                         (const float*)sx, (const uint8_t*)w, (const float*)sw, sw_stride, N,
                         split, sp, out);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out[B, N] (B <= 8) = the packed-ternary dot of the int8 codes (natural
// order if `natural`, else interleaved as K1's prologue writes them) with
// w[K/4, N]; mode 0: bf16 and 1: f32 of float(dot) * (1/(sx[b] *
// sw[n*sw_stride])), 2: the exact int32 dot (sx, sw unused). split: blocks
// per 128-column tile (1-8). Needs K and N multiples of 16 and 16-byte
// aligned codes and w.
int wf_ternary_gemv(const void* codes, int natural, int B, int K, const void* sx, const void* w,
                    const void* sw, int sw_stride, int N, int mode, int split, void* out,
                    void* stream) {
  if (B <= 0) return 0;
  if (B > ROWS || K <= 0 || K % 16 || N <= 0 || N % 16 || reinterpret_cast<uintptr_t>(w) % 16 ||
      reinterpret_cast<uintptr_t>(codes) % 16 || split < 1 || split > MAX_SPLIT)
    return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (!natural && mode == OUT_BF16)
    return launch_gemv<OUT_BF16, false>(codes, B, K, sx, w, sw, sw_stride, N, split, out, st);
  if (natural && mode == OUT_BF16)
    return launch_gemv<OUT_BF16, true>(codes, B, K, sx, w, sw, sw_stride, N, split, out, st);
  if (natural && mode == OUT_F32)
    return launch_gemv<OUT_F32, true>(codes, B, K, sx, w, sw, sw_stride, N, split, out, st);
  if (natural && mode == OUT_I32)
    return launch_gemv<OUT_I32, true>(codes, B, K, sx, w, sw, sw_stride, N, split, out, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

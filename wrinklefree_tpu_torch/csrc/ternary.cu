// Fused packed-ternary linear (K1), the one-launch MLP block (K2), the
// one-launch batch-1 attention block (K5), the one-launch batch-1 decode layer
// (K8: K5's stages then K2's, see its section) and the prologue-free
// packed-ternary matmul of caller-quantized codes (K7, see its section) for
// Hopper.
//
// K1 replaces wrinklefree_tpu/ops/ternary_pallas.py::ternary_matmul_stacked_fused
// (kernel body _matmul_kernel_stacked_fused). K2 replaces mlp_block_megakernel
// (_mlp_megakernel / _mlp_megakernel_manual). K5 replaces attn_block_megakernel
// (_attn_megakernel, joint-dot form) and attn_block_megakernel_manual_stacked
// (_attn_megakernel_manual): one function over the 5-D or the flat cache,
// which are the same bytes here. K5's bound is the weight stream (qkv + o,
// 4.1 MB at BitNet-2B) plus 2*(pos+1)*KV*D*2 bytes of cache; its eight
// stages sit behind seven grid barriers, which cost more than the stream.
//
// Math, per row: x = act(h) -> optional RMS norm (f32 variance, IEEE 1/sqrt,
// bf16 rounding, bf16 weight multiply) -> int8 absmax quant (127/clip(absmax,
// 1e-5), round half to even, clip to [-128,127]) -> packed-ternary dot in
// int32 -> y = bf16_rne(float(acc) * (1/(sx*sw[n]))). Weights are the wf
// "plane-major K" format: byte w[r,n] holds the 2-bit codes (w+1) of inputs
// k = r, K/4+r, 2K/4+r, 3K/4+r. The prologue stores each row's int8 codes
// interleaved as x4[r] = (x[r], x[K/4+r], x[2K/4+r], x[3K/4+r]), so that the
// four activations of one weight byte sit in one word, as the dots' mma.sync
// B fragments take them (same algebra as the TPU kernel's _planes_dot).
//
// Bound: at decode (<= 8 rows) the work is bound by the weight stream
// (K*N/4 bytes per call). K1 and K7 run their <= 8-row dot in the GEMV of
// ternary_gemv.cu (16-byte weight loads in flight, a split over K/4 in
// thread-block clusters, mma.sync on the codes in this interleaved order)
// and above 8 rows in the tensor-core GEMM of ternary_gemm.cu (TMA, an
// mbarrier ring and wgmma s8 x s8 -> s32; bound by operations). The dots of
// K2 and K5 (and so of K8, which runs both bodies) stream the weights over
// the whole grid on the GEMV's warp-level pieces (ternary_dot.cuh; see
// stream_dot). None of them needs a row sum of the codes.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "ternary_dot.cuh"

namespace cg = cooperative_groups;

// ternary_gemm.cu: the tensor-core dot of interleaved codes above 8 rows
extern "C" int wf_ternary_gemm(const void* x4, int B, int K, const void* sx, const void* w,
                               const void* sw, int sw_stride, int N, int mode, void* out,
                               void* stream);
// ternary_gemv.cu: the dot of 1-8 rows of interleaved or natural-order codes
extern "C" int wf_ternary_gemv(const void* codes, int natural, int B, int K, const void* sx,
                               const void* w, const void* sw, int sw_stride, int N, int mode,
                               int split, void* out, void* stream);

namespace {

constexpr int ACT_NONE = 0;
constexpr int ACT_RELU2 = 1;
constexpr int ACT_SILU = 2;

constexpr int THREADS = 256;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Block-wide reductions in a fixed order (deterministic run to run).
__device__ float block_sum(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.f;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

__device__ float block_max(float v, float* red) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    float t = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : -INFINITY;
    for (int o = 16; o > 0; o >>= 1) t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, o));
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// One row's prologue, run by a whole block. h: the row ([K] or [gate|up] of
// 2K); nw: the bf16 norm weight row or null; xs: shared scratch of K floats.
// Writes the interleaved int8 codes (K bytes, a word x4[r] = (x[r], x[K/4+r],
// x[2K/4+r], x[3K/4+r]) per store) and the scale. The sums of squares keep
// their order; the absmax, a max, and the per-element quantization do not
// depend on theirs.
__device__ void prologue_row(const __nv_bfloat16* h, int K, int act,
                             int norm, const __nv_bfloat16* __restrict__ nw, float eps,
                             float* xs, float* red, int8_t* __restrict__ x4,
                             float* __restrict__ sx) {
  const int K4 = K / 4;
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float x;
    if (act == ACT_NONE) {
      x = __bfloat162float(h[k]);
    } else {
      float g = __bfloat162float(h[k]);
      float u = __bfloat162float(h[K + k]);
      if (act == ACT_RELU2) {
        float m = fmaxf(g, 0.f);
        x = bf16r(bf16r(m * m) * u);
      } else {
        float sg = 1.f / (1.f + expf(-g));
        x = bf16r(bf16r(g * sg) * u);
      }
    }
    xs[k] = x;
    ss += x * x;
  }
  float am = 0.f;
  if (norm) {
    float var = block_sum(ss, red) / (float)K;
    float r = 1.f / sqrtf(var + eps);
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float x = bf16r(xs[k] * r);
      if (nw != nullptr) x = bf16r(x * __bfloat162float(nw[k]));
      xs[k] = x;
      am = fmaxf(am, fabsf(x));
    }
  } else {
    for (int k = threadIdx.x; k < K; k += blockDim.x) am = fmaxf(am, fabsf(xs[k]));
  }
  am = fmaxf(block_max(am, red), 1e-5f);
  const float s = 127.f / am;
  for (int r = threadIdx.x; r < K4; r += blockDim.x) {
    uint32_t word = 0;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const int qi = (int)fminf(fmaxf(rintf(xs[p * K4 + r] * s), -128.f), 127.f);
      word |= (uint32_t)(qi & 0xff) << (8 * p);
    }
    reinterpret_cast<uint32_t*>(x4)[r] = word;
  }
  if (threadIdx.x == 0) *sx = s;
  __syncthreads();
}

// The epilogue of every dot here: bf16_rne(float(acc) * (1/(sx*sw))), as K1's.
__device__ __forceinline__ __nv_bfloat16 rescale(int acc, float sx, float sw) {
  float inv = 1.f / (sx * sw);
  return __float2bfloat16_rn((float)acc * inv);
}

// K1's and K7's output modes (their epilogues are in ternary_gemv.cu and
// ternary_gemm.cu)
constexpr int OUT_BF16 = 0;  // float(dot) * (1/(sx*sw)), rounded to nearest-even bf16
constexpr int OUT_F32 = 1;   // the same product, stored as f32
constexpr int OUT_I32 = 2;   // the exact int32 dot (sx and sw unused)

// ---------------------------------------------------------------- K1 ------

// Start copying n bf16 values from global to shared memory: cp.async, 16
// bytes a copy, all in flight at once (where both are 16-byte aligned),
// else plain loads. The caller waits with cp.async.wait_all.
__device__ void copy_row_async(const __nv_bfloat16* __restrict__ src, int n,
                               __nv_bfloat16* dst) {
  if (reinterpret_cast<uintptr_t>(src) % 16 == 0 && n % 8 == 0) {
    for (int i = threadIdx.x; i < n / 8; i += blockDim.x)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(dst + 8 * i))),
                   "l"(src + 8 * i)
                   : "memory");
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// Shared memory of stage_prologue for K codes of a kin-wide input row: the
// reduction scratch, the f32 row, and the staged input and norm rows.
size_t prologue_smem(int kin, int K) { return (size_t)(32 + K) * 4 + ((kin + 7) / 8 * 8 + K) * 2; }

// prologue_row on copies of the row and of the norm row in shared memory
// (all their loads in flight at once, where prologue_row's loops would wait
// for one global load per iteration; the arithmetic and its order are
// prologue_row's), run by a whole block. The copies go through L2
// (cp.async.cg), so the row may have been written earlier in the same
// launch. smem: prologue_smem(kin, K) bytes.
__device__ void stage_prologue(const __nv_bfloat16* h, int kin, int K, int act, int norm,
                               const __nv_bfloat16* __restrict__ nw, float eps, float* smem,
                               int8_t* __restrict__ x4, float* __restrict__ sx) {
  float* red = smem;
  float* xs = smem + 32;
  __nv_bfloat16* hs = reinterpret_cast<__nv_bfloat16*>(xs + K);
  __nv_bfloat16* ns = hs + (kin + 7) / 8 * 8;
  copy_row_async(h, kin, hs);
  if (nw != nullptr) copy_row_async(nw, K, ns);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();
  prologue_row(hs, K, act, norm, nw == nullptr ? nullptr : ns, eps, xs, red, x4, sx);
}

// One block per row: stage_prologue. The decode GEMV is launched after this
// grid with programmatic stream serialization: it may start streaming its
// weights at once, and waits for this grid's stores before it reads the codes.
__global__ void k1_prologue(const __nv_bfloat16* __restrict__ h, int kin, int K, int act,
                            int norm, const __nv_bfloat16* __restrict__ nw, float eps,
                            int8_t* __restrict__ x4, float* __restrict__ sx) {
  asm volatile("griddepcontrol.launch_dependents;");
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  stage_prologue(h + (size_t)b * kin, kin, K, act, norm, nw, eps, smem, x4 + (size_t)b * K,
                 sx + b);
}

// ---------------------------------------------------------------- K7 ------

// The packed-ternary dot of caller-quantized int8 codes (no prologue):
// replaces ternary_matmul_pallas (_matmul_kernel, _matmul_int_kernel) and
// ternary_matmul_pallas_stacked (_matmul_kernel_stacked,
// _matmul_kernel_stacked_rowscale). The layer, or the expert, is a byte
// offset into the stack, computed by the caller. At <= 8 rows the GEMV of
// ternary_gemv.cu gathers each block's slice of x_q (natural order) into
// the interleaved words itself; above 8 rows a small pre-pass (B*K bytes
// read and written) interleaves the codes for ternary_gemm.cu, whose TMA
// loads can copy tiles but not interleave them.

// Pre-pass of the GEMM path: one block per row writes the interleaved codes,
// one 4-byte word x4[r] = (x[r], x[K/4+r], x[2K/4+r], x[3K/4+r]) per thread.
__global__ void k7_interleave(const int8_t* __restrict__ xq, int K, int8_t* __restrict__ x4) {
  const int b = blockIdx.x, K4 = K / 4;
  const uint8_t* x = reinterpret_cast<const uint8_t*>(xq) + (size_t)b * K;
  uint32_t* o = reinterpret_cast<uint32_t*>(x4 + (size_t)b * K);
  for (int r = threadIdx.x; r < K4; r += blockDim.x)
    o[r] = (uint32_t)x[r] | ((uint32_t)x[K4 + r] << 8) | ((uint32_t)x[2 * K4 + r] << 16) |
           ((uint32_t)x[3 * K4 + r] << 24);
}

// ---------------------------------------------------------------- K2 ------

// Whole MLP block in one cooperative launch:
//   A-prologue (norm+quant of h, one block per row; every block zeroes its
//   share of the int32 accumulators)                            | grid barrier |
//   gateup: streamed dot into int32 sums                         | grid barrier |
//   gateup epilogue: bf16 gu = float(sum) * (1/(sx*sw)), over the whole grid
//                                                               | grid barrier |
//   B-prologue (act + sub-norm + quant of gu, one block per row) | grid barrier |
//   down: streamed dot into int32 sums                           | grid barrier |
//   down epilogue: out = h + bf16 rescale, over the whole grid.
// The B-prologue runs once per row behind its own barrier rather than being
// recomputed by every block: it needs the whole gu row, and recomputing it
// in each of the ~100+ resident blocks would multiply the gu reads and the
// reductions by the block count for the price of one barrier saved. Each
// prologue works on copies of its row and norm row in shared memory
// (stage_prologue, as K1's).
//
// The streamed dot (stream_dot). Each matrix is cut into work items of one
// 128-column tile and one slice of its K/4 packed rows. A tile has as many
// slices as the grid has blocks per tile, and the first (grid % tiles) tiles
// one more, so that each block has exactly one item in every dot whatever
// the grid's size (K8's holds one block per SM, K2's and K5's two), as long
// as it holds one block per tile (a smaller grid deals whole tiles out): at
// 264 blocks the gateup's 108 tiles take 2-3 slices of 27-40 k-steps, the
// down's 20 tiles 13-14 slices of 15-17 k-steps, K5's qkv 30 tiles 8-9
// slices of 8-10 k-steps and its o 20 tiles 13-14 slices of 5-7 k-steps.
// Within an item each warp takes every 8th k-step of 8 packed rows x 128
// columns (1 KB) and keeps four in flight, as the GEMV of ternary_gemv.cu
// does: 16-byte ld.global.nc weight loads, and beside them the two code
// words of the lane's row (read through L2: the prologue wrote them in this
// launch), so no code is staged in shared memory. The weights are unpacked
// to unsigned codes for mma.sync m16n8k32 u8 x s8 -> s32, and each warp
// subtracts its rows' code sums over the k it covered: no row sum is needed.
// The eight warps' partials are summed in shared memory and added to the
// dot's int32 sums with red.global.add: an integer sum, so the result does
// not depend on the order of arrival. A barrier, then the epilogue over the
// whole grid: that costs less than a per-tile arrival counter whose last
// block applies the epilogue (a fence, the counter and the reload in a
// chain: 35.8 against 32.1 us at 8 rows on an H100, PERF.md). The sums are
// zeroed by the kernel's first stage: no host memset, and nothing is left
// for the next launch, so a CUDA graph may replay it.
//
// The body is a device function so that K8 can run it after K5's body in one
// launch; there h is written by the attention stages of the same launch, so
// it is not declared __restrict__ (no read-only cache path).

constexpr int WARPS = THREADS / 32;
constexpr int ST_TN = 128;   // columns per streamed tile: 8 lane groups x 16
constexpr int ST_STEP = 8;   // packed rows per k-step (one mma's 32 k)
constexpr int ST_UNR = 4;    // k-steps whose loads a warp keeps in flight

// Slot of (row m, tile column cc) in a warp's partials: row-major, the low
// five column bits XOR-swizzled so that the warps' stores (lanes over 8
// column groups x 4 row pairs) and the sums' loads (lanes over 32 columns of
// one row) are both free of bank conflicts.
__device__ __forceinline__ int part_slot(int m, int cc) {
  return m * ST_TN + (cc & 96) + ((cc & 31) ^ (((cc >> 5) & 3) | (((m >> 1) & 3) << 2)));
}

__device__ __forceinline__ void red_add(int* p, int v) {
  asm volatile("red.global.add.s32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// One streamed dot (above): acc [B, N] += the signed dot of the rows'
// interleaved codes x4 [B, 4*K4] (written earlier in this launch) with w
// [K4, N]. part: WARPS * R * ST_TN ints of shared memory. Needs N % 16 == 0
// and 16-byte aligned weight rows.
template <int R>
__device__ void stream_dot(const uint8_t* __restrict__ w, int K4, int N, const int8_t* x4, int B,
                           int* acc, int* part) {
  const int tiles = (N + ST_TN - 1) / ST_TN, steps = (K4 + ST_STEP - 1) / ST_STEP;
  // slices per tile: base, and base + 1 for the first `extra` tiles
  int base = (int)gridDim.x / tiles, extra = (int)gridDim.x % tiles;
  if (base == 0 || base >= steps) {
    base = base == 0 ? 1 : steps;
    extra = 0;
  }
  const int big = extra * (base + 1);  // the items of those first tiles
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // the lane's row of codes for the B fragments (row g; zeros past the rows)
  const int* xr = g < R && g < B ? reinterpret_cast<const int*>(x4 + (size_t)g * 4 * K4) : nullptr;
  for (int it = blockIdx.x; it < big + (tiles - extra) * base; it += gridDim.x) {
    const bool in_big = it < big;
    const int split = in_big ? base + 1 : base;
    const int tile = in_big ? it / split : extra + (it - big) / split;
    const int sl = in_big ? it % split : (it - big) % split;
    const int n0 = tile * ST_TN, col = n0 + 16 * g;
    const int s0 = sl * steps / split, nsb = (sl + 1) * steps / split - s0;
    const int r0 = s0 * ST_STEP;
    // a ring of ST_UNR k-steps: slot u holds packed rows t and t+4 of the
    // warp's step warp + (i*ST_UNR + u)*WARPS in round i, refilled with its
    // step of round i+1 as soon as it is used
    uint4 wl[ST_UNR], wh[ST_UNR];
    uint32_t xl[ST_UNR], xh[ST_UNR];
    auto load = [&](int u, int s) {
      const int r = r0 + s * ST_STEP + t;
      const bool lo = s < nsb && r < K4, hi = s < nsb && r + 4 < K4;
      const uint4 z = make_uint4(0u, 0u, 0u, 0u);
      wl[u] = lo && col < N ? ld_stream(w + (size_t)r * N + col) : z;
      wh[u] = hi && col < N ? ld_stream(w + (size_t)(r + 4) * N + col) : z;
      xl[u] = lo && xr != nullptr ? (uint32_t)__ldcg(xr + r) : 0u;
      xh[u] = hi && xr != nullptr ? (uint32_t)__ldcg(xr + r + 4) : 0u;
    };
#pragma unroll
    for (int u = 0; u < ST_UNR; ++u) load(u, warp + u * WARPS);

    int a[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) a[j][c] = 0;
    int rs = 0;  // row g's code sum over the k this warp covers
    for (int first = warp; first < nsb; first += WARPS * ST_UNR) {
#pragma unroll
      for (int u = 0; u < ST_UNR; ++u) {
        const int s = first + u * WARPS;
        if (s < nsb) {
          const uint32_t b0 = xl[u], b1 = xh[u];
          rs = __dp4a((int)b0, 0x01010101, rs);
          rs = __dp4a((int)b1, 0x01010101, rs);
          const uint32_t lo[4] = {wl[u].x, wl[u].y, wl[u].z, wl[u].w};
          const uint32_t hi[4] = {wh[u].x, wh[u].y, wh[u].z, wh[u].w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            uint32_t al[4], ah[4];
            unpack4(lo[i], al);
            unpack4(hi[i], ah);
            mma_u8s8(a[2 * i], al[0], al[1], ah[0], ah[1], b0, b1);
            mma_u8s8(a[2 * i + 1], al[2], al[3], ah[2], ah[3], b0, b1);
          }
          load(u, s + WARPS * ST_UNR);
        }
      }
    }

    // unsigned codes -> the signed dot: subtract the rows' code sums (this
    // thread's accumulators are rows 2t and 2t+1; group g holds row g's sum);
    // accumulator c of mma j is column 16g + 2j + c/2, row 2t + c%2
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    const int rs0 = __shfl_sync(0xffffffffu, rs, 8 * t), rs1 = __shfl_sync(0xffffffffu, rs, 8 * t + 4);
    __syncthreads();  // the previous item's partials have been summed
    int* pw = part + warp * R * ST_TN;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int m = 2 * t + (c & 1);
        if (m < R) pw[part_slot(m, 16 * g + 2 * j + (c >> 1))] = a[j][c] - (c & 1 ? rs1 : rs0);
      }
    __syncthreads();
    for (int o = threadIdx.x; o < R * ST_TN; o += THREADS) {
      const int m = o / ST_TN, cc = o % ST_TN;
      if (m < B && n0 + cc < N) {
        const int slot = part_slot(m, cc);
        int sum = 0;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) sum += part[q * R * ST_TN + slot];
        red_add(acc + (size_t)m * N + n0 + cc, sum);
      }
    }
  }
}

// acc: int32 scratch [B, 2I + H]: the gateup's sums, then the down's (zeroed here).
template <int R>
__device__ void mlp_block(float* smem, const __nv_bfloat16* h, int B, int H, int I, int act,
                          const __nv_bfloat16* __restrict__ post_ln,
                          const __nv_bfloat16* __restrict__ ffn_sub, float eps,
                          const uint8_t* __restrict__ gw, const float* __restrict__ gsw,
                          int gsw_stride, const uint8_t* __restrict__ dw,
                          const float* __restrict__ dsw, int dsw_stride,
                          int8_t* __restrict__ x4a, float* __restrict__ sxa,
                          __nv_bfloat16* __restrict__ gu, int8_t* __restrict__ x4b,
                          float* __restrict__ sxb, int* __restrict__ acc,
                          __nv_bfloat16* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const int NG = 2 * I;
  int* accg = acc;
  int* accd = accg + B * NG;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B * (NG + H); i += gridDim.x * THREADS)
    acc[i] = 0;

  for (int b = blockIdx.x; b < B; b += gridDim.x)
    stage_prologue(h + b * H, H, H, ACT_NONE, 1, post_ln, eps, smem, x4a + b * H, sxa + b);
  grid.sync();

  int* part = reinterpret_cast<int*>(smem);
  stream_dot<R>(gw, H / 4, NG, x4a, B, accg, part);
  grid.sync();
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B * NG; i += gridDim.x * THREADS)
    gu[i] = rescale(__ldcg(accg + i), __ldcg(sxa + i / NG), gsw[i % NG * gsw_stride]);
  grid.sync();

  for (int b = blockIdx.x; b < B; b += gridDim.x)
    stage_prologue(gu + b * NG, NG, I, act, ffn_sub != nullptr, ffn_sub, eps, smem, x4b + b * I,
                   sxb + b);
  grid.sync();

  stream_dot<R>(dw, I / 4, H, x4b, B, accd, part);
  grid.sync();
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < B * H; i += gridDim.x * THREADS) {
    const float y =
        __bfloat162float(rescale(__ldcg(accd + i), __ldcg(sxb + i / H), dsw[i % H * dsw_stride]));
    out[i] = __float2bfloat16_rn(__bfloat162float(h[i]) + y);
  }
}

template <int R>
__global__ void __launch_bounds__(THREADS, 2)
k2_mlp(const __nv_bfloat16* __restrict__ h, int B, int H, int I, int act,
       const __nv_bfloat16* __restrict__ post_ln, const __nv_bfloat16* __restrict__ ffn_sub,
       float eps, const uint8_t* __restrict__ gw, const float* __restrict__ gsw, int gsw_stride,
       const uint8_t* __restrict__ dw, const float* __restrict__ dsw, int dsw_stride,
       int8_t* __restrict__ x4a, float* __restrict__ sxa, __nv_bfloat16* __restrict__ gu,
       int8_t* __restrict__ x4b, float* __restrict__ sxb, int* __restrict__ acc,
       __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  mlp_block<R>(smem, h, B, H, I, act, post_ln, ffn_sub, eps, gw, gsw, gsw_stride, dw, dsw,
               dsw_stride, x4a, sxa, gu, x4b, sxb, acc, out);
}

// ---------------------------------------------------------------- K5 ------

constexpr int HD = 128;     // head dim of the attention stages
constexpr int ATT_CH = 64;  // cache rows per attention work unit
constexpr int MAX_G = 8;    // query heads per KV head

// Element d of a RoPE'd head row x (rotate-half), every op rounded to bf16.
__device__ __forceinline__ float rope_at(const __nv_bfloat16* x, int d,
                                         const __nv_bfloat16* __restrict__ cs,
                                         const __nv_bfloat16* __restrict__ sn) {
  const int half = HD / 2;
  float xv = __bfloat162float(x[d]);
  float rot = d < half ? -__bfloat162float(x[d + half]) : __bfloat162float(x[d - half]);
  return bf16r(bf16r(xv * __bfloat162float(cs[d])) + bf16r(rot * __bfloat162float(sn[d])));
}

// The residual attention block of one decode token in one cooperative launch
// (replaces attn_block_megakernel / attn_block_megakernel_manual_stacked), on
// every resident block:
//   A0: every block zeroes its share of both dots' int32 sums; one block:
//       norm+quant of h (stage_prologue) -> codes in global scratch
//                                                                | barrier |
//   A1: qkv: streamed dot (stream_dot) into int32 sums           | barrier |
//   B:  per (KV head, 64-row chunk of rows 0..pos): the qkv epilogue of the
//       head's G q heads, k and v (K1's rescale), RoPE of the q heads; the
//       chunk holding pos also stores the head's columns of the bf16 qkv row
//       to scratch and writes the roped k row and the raw v row into the
//       cache in place; f32 scores * 1/sqrt(D)                   | barrier |
//   C:  per unit: row max and sum over rows 0..pos (fixed-order block
//       reductions), p = bf16(e / sum), f32 PV partials of the chunk
//                                                                | barrier |
//   D:  fixed-order sum of the chunk partials -> bf16 attention row in
//       global scratch, over the whole grid                      | barrier |
//   E0: one block: sub-norm+quant of the attention row (stage_prologue)
//       -> codes in global scratch                               | barrier |
//   E1: o: streamed dot into int32 sums                          | barrier |
//   E2: out = h + bf16 rescale, over the whole grid.
// Seven barriers. Each prologue runs once behind its barrier (K2's reasoning:
// recomputing it in each of ~264 blocks multiplies its reads and
// reductions). B applies the qkv epilogue itself, as it needs only its
// head's (G+2)*128 columns, so no barrier stands between them. D's combine
// reads nch*Q f32 partials (61 KB at pos 327, 328 KB at pos 2047): in the
// one block that quantizes the row it saves a barrier but costs as much up
// to 6 chunks and 3 us more at 32 (PERF.md), so the grid does it. The dots'
// sums are exact integers in any order of arrival and every rounding point
// is K1's, so the qkv row is bit for bit K1(h) and the output bit for bit
// h + K1(attention row).
// The two-pass softmax keeps the TPU kernel's rounding points (probabilities
// normalised, then rounded to bf16); an online softmax would move them. Only
// cache rows 0..pos are read. Everything written inside this launch (codes,
// scales, sums, scores, partials, the cache row at pos) is read through L2
// (__ldcg, cp.async.cg), never through the read-only path.
//
// A measurement build for bench/attn_block.py --stamps, off in the port:
// with WF_K5_STAMPS, block 0 adds the ns from its start to the end of each
// stage (after each barrier, and at its own end) into k5_stamps[1..8], and
// counts the launches in k5_stamps[0], until wf_k5_stamps reads and clears
// them.
#ifdef WF_K5_STAMPS
__device__ unsigned long long k5_stamps[9];
__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define WF_K5_STAMP(i) \
  if (blockIdx.x == 0 && threadIdx.x == 0) k5_stamps[i] += globaltimer() - stamp0
#else
#define WF_K5_STAMP(i)
#endif

#define WF_K5_PARAMS                                                                       \
  const __nv_bfloat16 *__restrict__ h, int H, int Q, int NH, int KV, int T, int layer,        \
      const int *__restrict__ pos_p, const __nv_bfloat16 *__restrict__ input_ln,              \
      const __nv_bfloat16 *__restrict__ attn_sub, int norm2, float eps,                       \
      const uint8_t *__restrict__ qw, const float *__restrict__ qsw, int qsw_stride,          \
      const uint8_t *__restrict__ ow, const float *__restrict__ osw, int osw_stride,          \
      const __nv_bfloat16 *__restrict__ cs, const __nv_bfloat16 *__restrict__ sn, float scale, \
      __nv_bfloat16 *ck, __nv_bfloat16 *cv, __nv_bfloat16 *qkv, float *sc, float *part,       \
      __nv_bfloat16 *attn, int8_t *x4, float *sx, int *acc, __nv_bfloat16 *out
#define WF_K5_ARGS                                                                          \
  h, H, Q, NH, KV, T, layer, pos_p, input_ln, attn_sub, norm2, eps, qw, qsw, qsw_stride, ow, \
      osw, osw_stride, cs, sn, scale, ck, cv, qkv, sc, part, attn, x4, sx, acc, out

// Shared memory of stages B and C: the reduction scratch, the roped q heads,
// the probabilities, the PV halves and the bf16 qkv columns of one KV head.
constexpr size_t ATT_SMEM = (32 + 2 * MAX_G * HD + MAX_G * ATT_CH) * 4 + (MAX_G + 2) * HD * 2;

// Scratch (the caller's): x4 [H + Q] int8 (the codes of h, then of the
// attention row), sx [2] f32 (their scales), acc [Q + 2*KV*128 + H] int32
// (the qkv dot's sums, then the o dot's; zeroed here).
__device__ void attn_block(float* smem, WF_K5_PARAMS) {
  cg::grid_group grid = cg::this_grid();
  const int G = NH / KV;
  const int NQKV = Q + 2 * KV * HD;
  const int pos = min(max(*pos_p, 0), T - 1);
  const int nch = pos / ATT_CH + 1;  // chunks covering rows 0..pos
  const int units = KV * nch;
  const size_t row0 = (size_t)layer * T;  // this layer's first cache row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = blockIdx.x * THREADS + threadIdx.x, nthr = gridDim.x * THREADS;
  int* accq = acc;         // [NQKV]
  int* acco = acc + NQKV;  // [H]
  int8_t* x4q = x4;        // [H]
  int8_t* x4o = x4 + H;    // [Q]
  float* red = smem;                                                          // 32
  float* qs = red + 32;                                                       // MAX_G * HD
  float* ps = qs + MAX_G * HD;                                                // MAX_G * ATT_CH
  float* pv = ps + MAX_G * ATT_CH;                                            // MAX_G * HD
  __nv_bfloat16* hq = reinterpret_cast<__nv_bfloat16*>(pv + MAX_G * HD);      // (MAX_G + 2) * HD
  int* dpart = reinterpret_cast<int*>(smem);  // the streamed dots' partials
#ifdef WF_K5_STAMPS
  const unsigned long long stamp0 = globaltimer();
  if (blockIdx.x == 0 && threadIdx.x == 0) k5_stamps[0] += 1;
#endif

  // A0: the sums, the codes of h
  for (int i = tid; i < NQKV + H; i += nthr) acc[i] = 0;
  if (blockIdx.x == 0)
    stage_prologue(h, H, H, ACT_NONE, 1, input_ln, eps, smem, x4q, sx);
  grid.sync();
  WF_K5_STAMP(1);

  // A1: qkv
  stream_dot<1>(qw, H / 4, NQKV, x4q, 1, accq, dpart);
  grid.sync();
  WF_K5_STAMP(2);

  // B: the qkv epilogue, RoPE, the qkv row and cache-row writes, scores
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int kvh = u / nch, c = u % nch;
    const int t0 = c * ATT_CH, t1 = min(t0 + ATT_CH, pos + 1);
    const bool at_pos = pos < t1;  // this chunk holds row pos
    const float sxq = __ldcg(sx);
    // the head's columns: its G q heads, then its k head, then its v head
    for (int i = threadIdx.x; i < (G + 2) * HD; i += blockDim.x) {
      const int n = i < G * HD ? kvh * G * HD + i : Q + (i / HD - G) * KV * HD + kvh * HD + i % HD;
      const __nv_bfloat16 y = rescale(__ldcg(accq + n), sxq, qsw[n * qsw_stride]);
      hq[i] = y;
      if (at_pos) qkv[n] = y;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * HD; i += blockDim.x)
      qs[i] = rope_at(hq + (i / HD) * HD, i % HD, cs, sn);
    if (at_pos) {
      const size_t row = ((row0 + pos) * KV + kvh) * HD;
      for (int d = threadIdx.x; d < HD; d += blockDim.x) {
        ck[row + d] = __float2bfloat16_rn(rope_at(hq + G * HD, d, cs, sn));
        cv[row + d] = hq[(G + 1) * HD + d];
      }
    }
    __syncthreads();
    for (int t = t0 + warp; t < t1; t += WARPS) {
      const uint2 raw =
          __ldcg(reinterpret_cast<const uint2*>(ck + ((row0 + t) * KV + kvh) * HD + lane * 4));
      const __nv_bfloat16* k4 = reinterpret_cast<const __nv_bfloat16*>(&raw);
      const float k0 = __bfloat162float(k4[0]), k1 = __bfloat162float(k4[1]);
      const float k2 = __bfloat162float(k4[2]), k3 = __bfloat162float(k4[3]);
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * HD + lane * 4;
        float s = qg[0] * k0 + qg[1] * k1 + qg[2] * k2 + qg[3] * k3;
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        if (lane == 0) sc[(size_t)(kvh * G + g) * T + t] = s * scale;
      }
    }
    __syncthreads();
  }
  grid.sync();
  WF_K5_STAMP(3);

  // C: softmax over rows 0..pos, PV partials of each chunk
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int kvh = u / nch, c = u % nch;
    const int t0 = c * ATT_CH, n = min(ATT_CH, pos + 1 - t0);
    for (int g = 0; g < G; ++g) {
      const float* srow = sc + (size_t)(kvh * G + g) * T;
      float m = -INFINITY;
      for (int t = threadIdx.x; t <= pos; t += blockDim.x) m = fmaxf(m, __ldcg(srow + t));
      m = block_max(m, red);
      float l = 0.f;
      for (int t = threadIdx.x; t <= pos; t += blockDim.x) l += expf(__ldcg(srow + t) - m);
      l = block_sum(l, red);
      for (int j = threadIdx.x; j < n; j += blockDim.x)
        ps[g * ATT_CH + j] = bf16r(expf(__ldcg(srow + t0 + j) - m) / l);
    }
    __syncthreads();
    const int d = threadIdx.x % HD, half = threadIdx.x / HD;  // two row halves
    float pacc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) pacc[g] = 0.f;
    for (int j = half; j < n; j += 2) {
      const float v = __bfloat162float(__ldcg(cv + ((row0 + t0 + j) * KV + kvh) * HD + d));
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) pacc[g] += ps[g * ATT_CH + j] * v;
    }
    if (half == 1) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) pv[g * HD + d] = pacc[g];
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) part[((size_t)c * NH + kvh * G + g) * HD + d] = pacc[g] + pv[g * HD + d];
    }
    __syncthreads();
  }
  grid.sync();
  WF_K5_STAMP(4);

  // D: combine the chunks in order
  for (int i = tid; i < Q; i += nthr) {
    float s = 0.f;
    for (int c = 0; c < nch; ++c) s += __ldcg(part + (size_t)c * Q + i);
    attn[i] = __float2bfloat16_rn(s);
  }
  grid.sync();
  WF_K5_STAMP(5);

  // E0: the codes of the attention row
  if (blockIdx.x == 0)
    stage_prologue(attn, Q, Q, ACT_NONE, norm2, attn_sub, eps, smem, x4o, sx + 1);
  grid.sync();
  WF_K5_STAMP(6);

  // E1: o
  stream_dot<1>(ow, Q / 4, H, x4o, 1, acco, dpart);
  grid.sync();
  WF_K5_STAMP(7);

  // E2: the o epilogue and the residual
  for (int i = tid; i < H; i += nthr) {
    const float d = __bfloat162float(rescale(__ldcg(acco + i), __ldcg(sx + 1), osw[i * osw_stride]));
    out[i] = __float2bfloat16_rn(__bfloat162float(h[i]) + d);
  }
#ifdef WF_K5_STAMPS
  __syncthreads();
  WF_K5_STAMP(8);
#endif
}

__global__ void __launch_bounds__(THREADS, 2) k5_attn(WF_K5_PARAMS) {
  extern __shared__ float smem[];
  attn_block(smem, WF_K5_ARGS);
}

// ---------------------------------------------------------------- K8 ------

// A whole batch-1 decode layer in one cooperative launch (replaces
// layer_block_megakernel / _layer_megakernel): K5's seven stages write h' =
// h + o(attention) to global scratch (`out` of the attention block), a grid
// barrier, then K2's stages on h' at one row: thirteen grid barriers in all.
// The grid (one block per SM at K8's registers) is dealt both bodies' four
// streamed dots; K5's attention stages use as many blocks as they have
// units. The attention takes K5's two-pass softmax per query head over cache
// rows 0..pos: the TPU kernel's per-KV-head form (scores of the G heads over
// all T rows, -1e30 above pos) without its masked columns, whose
// exp(-1e30 - m) is exactly 0 in f32, so the two differ only in the order of
// f32 sums. The bound is the sum of K5's and K2's: the layer's packed weights
// (17.4 MB at BitNet-2B) plus 2*(pos+1)*KV*D*2 bytes of cache. K5's scratch
// (x4, sx, acc) and K2's (x4a, sxa, x4b, sxb, acc2) are separate buffers.
__global__ void k8_layer(WF_K5_PARAMS, int I, int act, const __nv_bfloat16* __restrict__ post_ln,
                         const __nv_bfloat16* __restrict__ ffn_sub, float eps2,
                         const uint8_t* __restrict__ gw, const float* __restrict__ gsw,
                         int gsw_stride, const uint8_t* __restrict__ dw,
                         const float* __restrict__ dsw, int dsw_stride, int8_t* __restrict__ x4a,
                         float* __restrict__ sxa, __nv_bfloat16* __restrict__ gu,
                         int8_t* __restrict__ x4b, float* __restrict__ sxb,
                         int* __restrict__ acc2, __nv_bfloat16* __restrict__ out2) {
  extern __shared__ float smem[];
  attn_block(smem, WF_K5_ARGS);
  cg::this_grid().sync();
  mlp_block<1>(smem, out, 1, H, I, act, post_ln, ffn_sub, eps2, gw, gsw, gsw_stride, dw, dsw,
               dsw_stride, x4a, sxa, gu, x4b, sxb, acc2, out2);
}

// Dynamic shared memory of K2's stages at R rows: the streamed dots' warp
// partials, or a prologue's scratch and staged rows.
size_t k2_smem(int R, int H, int I) {
  size_t smem = (size_t)WARPS * R * ST_TN * 4;
  const size_t sa = prologue_smem(H, H), sb = prologue_smem(2 * I, I);
  if (sa > smem) smem = sa;
  return sb > smem ? sb : smem;
}

// K5's dynamic shared memory: the largest of its stages' (the streamed dots'
// partials at one row, the two prologues', the attention stages').
size_t k5_smem(int H, int Q) {
  size_t smem = (size_t)WARPS * ST_TN * 4;
  const size_t sizes[] = {prologue_smem(H, H), prologue_smem(Q, Q), ATT_SMEM};
  for (size_t s : sizes)
    if (s > smem) smem = s;
  return smem;
}

// Every block that can be resident at once (a cooperative launch needs
// that): the streamed dots give each one work.
cudaError_t resident_blocks(const void* kernel, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// K2 on every resident block.
template <int R>
cudaError_t launch_k2(const __nv_bfloat16* h, int B, int H, int I, int act,
                      const __nv_bfloat16* post_ln, const __nv_bfloat16* ffn_sub, float eps,
                      const uint8_t* gw, const float* gsw, int gsw_stride, const uint8_t* dw,
                      const float* dsw, int dsw_stride, int8_t* x4a, float* sxa,
                      __nv_bfloat16* gu, int8_t* x4b, float* sxb, int* acc,
                      __nv_bfloat16* out, cudaStream_t st) {
  size_t smem = k2_smem(R, H, I);
  cudaError_t e = cudaFuncSetAttribute(k2_mlp<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  if ((e = resident_blocks((const void*)k2_mlp<R>, smem, &blocks)) != cudaSuccess)
    return e;
  void* args[] = {(void*)&h,   (void*)&B,      (void*)&H,   (void*)&I,          (void*)&act,
                  (void*)&post_ln, (void*)&ffn_sub, (void*)&eps, (void*)&gw,   (void*)&gsw,
                  (void*)&gsw_stride, (void*)&dw, (void*)&dsw, (void*)&dsw_stride,
                  (void*)&x4a, (void*)&sxa,   (void*)&gu,  (void*)&x4b,        (void*)&sxb,
                  (void*)&acc, (void*)&out};
  e = cudaLaunchCooperativeKernel((const void*)k2_mlp<R>, dim3(blocks), dim3(THREADS), args,
                                  smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: out[B,N] = fused linear of h[B,kin]. w points at the layer's [K/4,N]
// bytes, sw at the layer's scales (sw_stride 1: per column, 0: one scalar),
// nw at the layer's bf16 norm row or null. x4/sx are caller scratch of B*K
// bytes and B floats. split: the GEMV's blocks per column tile (B <= 8).
int wf_ternary_fused(const void* h, int B, int kin, int K, int act, int norm, const void* nw,
                     float eps, const void* w, const void* sw, int sw_stride, int N, void* x4,
                     void* sx, int split, void* out, void* stream) {
  static int psmem_limit = 48 * 1024;  // raised once per process when a width needs it
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  const int psmem = (int)prologue_smem(kin, K);
  cudaError_t e;
  if (psmem > psmem_limit) {
    if ((e = cudaFuncSetAttribute(k1_prologue, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  psmem)) != cudaSuccess)
      return e;
    psmem_limit = psmem;
  }
  k1_prologue<<<B, THREADS, psmem, st>>>((const __nv_bfloat16*)h, kin, K, act, norm,
                                         (const __nv_bfloat16*)nw, eps, (int8_t*)x4,
                                         (float*)sx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (B <= 8)
    return wf_ternary_gemv(x4, 0, B, K, sx, w, sw, sw_stride, N, OUT_BF16, split, out, stream);
  return wf_ternary_gemm(x4, B, K, sx, w, sw, sw_stride, N, OUT_BF16, out, stream);
}

// K7: out[B,N] = the packed-ternary dot of int8 codes xq[B,K] (natural order)
// with w[K/4,N] (the layer's or the expert's bytes). mode 0: bf16 and mode 1:
// f32 of float(dot) * (1/(sx[b]*sw[n*sw_stride])) (sw_stride 1: per column,
// 0: one scalar); mode 2: the exact int32 dot, sx and sw unused. split: the
// GEMV's blocks per column tile (B <= 8). x4 is caller scratch of B*K bytes,
// used (and needed) only for B > 8.
int wf_ternary_matmul(const void* xq, int B, int K, const void* sx, const void* w, const void* sw,
                      int sw_stride, int N, int mode, int split, void* x4, void* out,
                      void* stream) {
  if (B <= 0) return 0;
  if (K % 4 || N % 4 || mode < OUT_BF16 || mode > OUT_I32) return cudaErrorInvalidValue;
  if (B <= 8) return wf_ternary_gemv(xq, 1, B, K, sx, w, sw, sw_stride, N, mode, split, out, stream);
  if (x4 == nullptr) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  k7_interleave<<<B, THREADS, 0, st>>>((const int8_t*)xq, K, (int8_t*)x4);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return wf_ternary_gemm(x4, B, K, sx, w, sw, sw_stride, N, mode, out, stream);
}

// K2: out[B,H] = h + down(quant(subnorm(act(bf16(gateup(quant(norm(h)))))))), B <= 8.
// Caller scratch: x4a [B,H] and x4b [B,I] int8, sxa and sxb [B] f32, gu [B,2I]
// bf16, acc [B,2I+H] int32 (see mlp_block). H and I multiples
// of 16, the weights 16-byte aligned.
int wf_mlp_mega(const void* h, int B, int H, int I, int act, const void* post_ln,
                const void* ffn_sub, float eps, const void* gw, const void* gsw, int gsw_stride,
                const void* dw, const void* dsw, int dsw_stride, void* x4a, void* sxa, void* gu,
                void* x4b, void* sxb, void* acc, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (B > 8 || H % 16 || I % 16 || reinterpret_cast<uintptr_t>(gw) % 16 ||
      reinterpret_cast<uintptr_t>(dw) % 16)
    return cudaErrorInvalidValue;
#define WF_K2(R)                                                                              \
  launch_k2<R>((const __nv_bfloat16*)h, B, H, I, act, (const __nv_bfloat16*)post_ln,         \
               (const __nv_bfloat16*)ffn_sub, eps, (const uint8_t*)gw, (const float*)gsw,     \
               gsw_stride, (const uint8_t*)dw, (const float*)dsw, dsw_stride, (int8_t*)x4a,  \
               (float*)sxa, (__nv_bfloat16*)gu, (int8_t*)x4b, (float*)sxb, (int*)acc,         \
               (__nv_bfloat16*)out, st)
  if (B == 1) return WF_K2(1);
  if (B == 2) return WF_K2(2);
  if (B <= 4) return WF_K2(4);
  return WF_K2(8);
#undef WF_K2
}

// K5: out[1,H] = h + o(quant(subnorm(attention(rope(qkv(quant(norm(h)))))))) for one
// decode token; writes row pos of `layer` of the [L,T,KV,128] caches ck/cv in
// place. pos is a device int (clamped to [0,T-1]). Caller scratch: qkv
// [Q+2*KV*128] bf16, sc [NH*T] f32, part [ceil(T/64)*NH*128] f32, attn [Q] bf16,
// x4 [H+Q] int8, sx [2] f32, acc [Q+2*KV*128+H] int32 (see attn_block). H a
// multiple of 16, the weights 16-byte aligned.
int wf_attn_mega(const void* h, int H, int Q, int NH, int KV, int T, int layer, const void* pos,
                 const void* input_ln, const void* attn_sub, int norm2, float eps,
                 const void* qw, const void* qsw, int qsw_stride, const void* ow, const void* osw,
                 int osw_stride, const void* cs, const void* sn, float scale, void* ck, void* cv,
                 void* qkv, void* sc, void* part, void* attn, void* x4, void* sx, void* acc,
                 void* out, void* stream) {
  if (T <= 0 || KV <= 0 || NH % KV || NH / KV > MAX_G || Q != NH * HD || H % 16 ||
      reinterpret_cast<uintptr_t>(qw) % 16 || reinterpret_cast<uintptr_t>(ow) % 16)
    return cudaErrorInvalidValue;
  size_t smem = k5_smem(H, Q);
  cudaError_t e = cudaFuncSetAttribute(k5_attn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  if ((e = resident_blocks((const void*)k5_attn, smem, &blocks)) != cudaSuccess) return e;
  void* args[] = {(void*)&h,   (void*)&H,     (void*)&Q,      (void*)&NH,    (void*)&KV,
                  (void*)&T,   (void*)&layer, (void*)&pos,    (void*)&input_ln, (void*)&attn_sub,
                  (void*)&norm2, (void*)&eps, (void*)&qw,     (void*)&qsw,   (void*)&qsw_stride,
                  (void*)&ow,  (void*)&osw,   (void*)&osw_stride, (void*)&cs, (void*)&sn,
                  (void*)&scale, (void*)&ck,  (void*)&cv,     (void*)&qkv,   (void*)&sc,
                  (void*)&part, (void*)&attn, (void*)&x4,     (void*)&sx,    (void*)&acc,
                  (void*)&out};
  e = cudaLaunchCooperativeKernel((const void*)k5_attn, dim3(blocks), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K8: out2[1,H] = the MLP block of h' = the attention block of h, for one
// decode token, in one launch; writes row pos of `layer` of ck/cv in place.
// Arguments h..out are K5's (out is h', caller scratch [1,H] bf16), I..out2
// are K2's at one row after its h/B/H (which are h', 1 and H).
int wf_layer_mega(const void* h, int H, int Q, int NH, int KV, int T, int layer, const void* pos,
                  const void* input_ln, const void* attn_sub, int norm2, float eps,
                  const void* qw, const void* qsw, int qsw_stride, const void* ow,
                  const void* osw, int osw_stride, const void* cs, const void* sn, float scale,
                  void* ck, void* cv, void* qkv, void* sc, void* part, void* attn, void* x4,
                  void* sx, void* acc, void* out, int I, int act, const void* post_ln,
                  const void* ffn_sub, float eps2, const void* gw, const void* gsw,
                  int gsw_stride, const void* dw, const void* dsw, int dsw_stride, void* x4a,
                  void* sxa, void* gu, void* x4b, void* sxb, void* acc2, void* out2,
                  void* stream) {
  if (T <= 0 || KV <= 0 || NH % KV || NH / KV > MAX_G || Q != NH * HD || H % 16 || I % 16 ||
      reinterpret_cast<uintptr_t>(qw) % 16 || reinterpret_cast<uintptr_t>(ow) % 16 ||
      reinterpret_cast<uintptr_t>(gw) % 16 || reinterpret_cast<uintptr_t>(dw) % 16)
    return cudaErrorInvalidValue;
  size_t smem = k5_smem(H, Q);
  const size_t s2 = k2_smem(1, H, I);
  if (s2 > smem) smem = s2;
  cudaError_t e = cudaFuncSetAttribute(k8_layer, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  if ((e = resident_blocks((const void*)k8_layer, smem, &blocks)) != cudaSuccess) return e;
  void* args[] = {(void*)&h,   (void*)&H,     (void*)&Q,      (void*)&NH,    (void*)&KV,
                  (void*)&T,   (void*)&layer, (void*)&pos,    (void*)&input_ln, (void*)&attn_sub,
                  (void*)&norm2, (void*)&eps, (void*)&qw,     (void*)&qsw,   (void*)&qsw_stride,
                  (void*)&ow,  (void*)&osw,   (void*)&osw_stride, (void*)&cs, (void*)&sn,
                  (void*)&scale, (void*)&ck,  (void*)&cv,     (void*)&qkv,   (void*)&sc,
                  (void*)&part, (void*)&attn, (void*)&x4,     (void*)&sx,    (void*)&acc,
                  (void*)&out,
                  (void*)&I,   (void*)&act,   (void*)&post_ln, (void*)&ffn_sub, (void*)&eps2,
                  (void*)&gw,  (void*)&gsw,   (void*)&gsw_stride, (void*)&dw, (void*)&dsw,
                  (void*)&dsw_stride, (void*)&x4a, (void*)&sxa, (void*)&gu, (void*)&x4b,
                  (void*)&sxb, (void*)&acc2,  (void*)&out2};
  e = cudaLaunchCooperativeKernel((const void*)k8_layer, dim3(blocks), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

#ifdef WF_K5_STAMPS
// K5's stage stamps (see WF_K5_STAMPS) into out[9], then cleared.
int wf_k5_stamps(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k5_stamps, sizeof(k5_stamps));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[9] = {};
  return cudaMemcpyToSymbol(k5_stamps, zero, sizeof(zero));
}
#endif

const char* wf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

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
// 4.1 MB at BitNet-2B) plus 2*(pos+1)*KV*D*2 bytes of cache; its dots share
// K1's latency limit (below), and its five stages sit behind four grid
// barriers.
//
// Math, per row: x = act(h) -> optional RMS norm (f32 variance, IEEE 1/sqrt,
// bf16 rounding, bf16 weight multiply) -> int8 absmax quant (127/clip(absmax,
// 1e-5), round half to even, clip to [-128,127]) -> packed-ternary dot in
// int32 -> y = bf16_rne(float(acc) * (1/(sx*sw[n]))). Weights are the wf
// "plane-major K" format: byte w[r,n] holds the 2-bit codes (w+1) of inputs
// k = r, K/4+r, 2K/4+r, 3K/4+r. The prologue stores each row's int8 codes
// interleaved as x4[r] = (x[r], x[K/4+r], x[2K/4+r], x[3K/4+r]), so one weight
// byte spread to four 2-bit lanes, e = (b | b<<6 | b<<12 | b<<18) & 0x03030303,
// meets its four activations in one __dp4a. The codes are {0,1,2}, so the dot
// is corrected by the row sum of x: sum_k x*(e-1) = dp4a-sum - sum_k x
// (same algebra as the TPU kernel's _planes_dot).
//
// Bound: at decode (<= 8 rows) the work is bound by the weight stream
// (K*N/4 bytes per call); prefill rows (64 x 64 shared-memory tiles) by
// operations. This first version reaches neither: on an H100 a decode call
// takes about the same time for 2.5 MB (qkv) as for 8.8 MB (gateup) of
// weights, because each thread keeps one dependent 4-byte weight load in
// flight per iteration, so the loop is latency-bound. More loads in flight
// per thread, then tensor-core int8 (wgmma) for prefill, are later work.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int ACT_NONE = 0;
constexpr int ACT_RELU2 = 1;
constexpr int ACT_SILU = 2;

constexpr int THREADS = 256;
constexpr int TILE_N = 64;                    // columns per dot tile
constexpr int COL_GROUPS = TILE_N / 4;        // 16 threads x 4 columns
constexpr int KSPLIT = THREADS / COL_GROUPS;  // 16 row groups over K/4
constexpr int TILE_M = 64;                    // prefill rows per block
constexpr int TILE_R = 32;                    // K/4 rows per prefill stage

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ int spread(uint32_t word, int c) {
  uint32_t b = (word >> (8 * c)) & 0xffu;
  return (int)((b | (b << 6) | (b << 12) | (b << 18)) & 0x03030303u);
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

__device__ int block_isum(int v, int* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x < 32) {
    int t = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
    if (threadIdx.x == 0) red[0] = t;
  }
  __syncthreads();
  return red[0];
}

// One row's prologue, run by a whole block. h: the row ([K] or [gate|up] of
// 2K); nw: the bf16 norm weight row or null; xs: shared scratch of K floats.
// Writes the interleaved int8 codes (K bytes), the code sum and the scale.
__device__ void prologue_row(const __nv_bfloat16* h, int K, int act,
                             int norm, const __nv_bfloat16* __restrict__ nw, float eps,
                             float* xs, float* red, int8_t* __restrict__ x4,
                             int* __restrict__ rowsum, float* __restrict__ sx) {
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
  if (norm) {
    float var = block_sum(ss, red) / (float)K;
    float r = 1.f / sqrtf(var + eps);
    for (int k = threadIdx.x; k < K; k += blockDim.x) {
      float x = bf16r(xs[k] * r);
      if (nw != nullptr) x = bf16r(x * __bfloat162float(nw[k]));
      xs[k] = x;
    }
  }
  float am = 0.f;
  for (int k = threadIdx.x; k < K; k += blockDim.x) am = fmaxf(am, fabsf(xs[k]));
  am = fmaxf(block_max(am, red), 1e-5f);
  const float s = 127.f / am;
  int qs = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float q = fminf(fmaxf(rintf(xs[k] * s), -128.f), 127.f);
    int qi = (int)q;
    x4[(k % K4) * 4 + k / K4] = (int8_t)qi;
    qs += qi;
  }
  qs = block_isum(qs, (int*)red);
  if (threadIdx.x == 0) {
    *rowsum = qs;
    *sx = s;
  }
  __syncthreads();
}

// Copy R rows of interleaved codes (K4 words each) to shared memory; rows at
// or beyond `rows` are zero.
template <int R>
__device__ void load_codes(const int8_t* __restrict__ x4, int rows, int K4, int* x4s) {
  const int* src = reinterpret_cast<const int*>(x4);
  for (int i = threadIdx.x; i < R * K4; i += blockDim.x) {
    int row = i / K4;
    x4s[i] = row < rows ? src[i] : 0;
  }
  __syncthreads();
}

// One 64-column tile for up to R rows: every thread owns 4 columns of one
// K/4 slice; the slices are summed in shared memory in a fixed order. `emit`
// receives (row, column, exact int32 accumulator).
template <int R, typename Emit>
__device__ void dot_tile(const uint8_t* __restrict__ w, int K4, int N, int n0,
                         const int* x4s, int rows, int* red, Emit emit) {
  const int cgi = threadIdx.x % COL_GROUPS;
  const int ks = threadIdx.x / COL_GROUPS;
  const int n = n0 + cgi * 4;
  int acc[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;
  if (n < N) {
    for (int r = ks; r < K4; r += KSPLIT) {
      uint32_t wv = __ldg(reinterpret_cast<const uint32_t*>(w + (size_t)r * N + n));
      int e0 = spread(wv, 0), e1 = spread(wv, 1), e2 = spread(wv, 2), e3 = spread(wv, 3);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        int xv = x4s[i * K4 + r];
        acc[i][0] = __dp4a(xv, e0, acc[i][0]);
        acc[i][1] = __dp4a(xv, e1, acc[i][1]);
        acc[i][2] = __dp4a(xv, e2, acc[i][2]);
        acc[i][3] = __dp4a(xv, e3, acc[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) red[(ks * R + i) * TILE_N + cgi * 4 + c] = acc[i][c];
  __syncthreads();
  for (int o = threadIdx.x; o < R * TILE_N; o += blockDim.x) {
    int i = o / TILE_N, col = o % TILE_N;
    if (i < rows && n0 + col < N) {
      int s = 0;
      for (int k = 0; k < KSPLIT; ++k) s += red[(k * R + i) * TILE_N + col];
      emit(i, n0 + col, s);
    }
  }
  __syncthreads();
}

__device__ __forceinline__ __nv_bfloat16 rescale(int acc, int rowsum, float sx, float sw) {
  float inv = 1.f / (sx * sw);
  return __float2bfloat16_rn((float)(acc - rowsum) * inv);
}

constexpr int OUT_BF16 = 0;  // float(dot) * (1/(sx*sw)), rounded to nearest-even bf16
constexpr int OUT_F32 = 1;   // the same product, stored as f32
constexpr int OUT_I32 = 2;   // the exact int32 dot (sx and sw unused)

// Store one output of the signed dot `dot` (row `row`, scale index `swi`).
template <int MODE>
__device__ __forceinline__ void emit_out(void* out, size_t idx, int dot, const float* sx, int row,
                                         const float* sw, int swi) {
  if constexpr (MODE == OUT_I32) {
    static_cast<int*>(out)[idx] = dot;
  } else {
    const float y = (float)dot * (1.f / (sx[row] * sw[swi]));
    if constexpr (MODE == OUT_F32)
      static_cast<float*>(out)[idx] = y;
    else
      static_cast<__nv_bfloat16*>(out)[idx] = __float2bfloat16_rn(y);
  }
}

// ---------------------------------------------------------------- K1 ------

__global__ void k1_prologue(const __nv_bfloat16* __restrict__ h, int kin, int K, int act,
                            int norm, const __nv_bfloat16* __restrict__ nw, float eps,
                            int8_t* __restrict__ x4, int* __restrict__ rowsum,
                            float* __restrict__ sx) {
  extern __shared__ float smem[];
  float* red = smem;
  float* xs = smem + 32;
  const int b = blockIdx.x;
  prologue_row(h + (size_t)b * kin, K, act, norm, nw, eps, xs, red, x4 + (size_t)b * K,
               rowsum + b, sx + b);
}

template <int R>
__global__ void k1_dot_rows(const int8_t* __restrict__ x4, const int* __restrict__ rowsum,
                            const float* __restrict__ sx, const uint8_t* __restrict__ w,
                            const float* __restrict__ sw, int sw_stride, int B, int K,
                            int N, __nv_bfloat16* __restrict__ out) {
  extern __shared__ int ismem[];
  const int K4 = K / 4;
  int* x4s = ismem;
  int* red = ismem + R * K4;
  load_codes<R>(x4, B, K4, x4s);
  const int n0 = blockIdx.x * TILE_N;
  dot_tile<R>(w, K4, N, n0, x4s, B, red, [&](int i, int n, int acc) {
    out[(size_t)i * N + n] = rescale(acc, rowsum[i], sx[i], sw[n * sw_stride]);
  });
}

// Prefill: 64 rows x 64 columns per block, 16x16 threads of 4x4 outputs each,
// K/4 streamed through shared memory in stages of 32. MODE picks the output
// (K1 stores bf16; K7 any of the three).
template <int MODE>
__global__ void k1_dot_tiled(const int8_t* __restrict__ x4, const int* __restrict__ rowsum,
                             const float* __restrict__ sx, const uint8_t* __restrict__ w,
                             const float* __restrict__ sw, int sw_stride, int B, int K,
                             int N, void* __restrict__ out) {
  __shared__ int xt[TILE_M][TILE_R + 1];
  __shared__ uint32_t wt[TILE_R][COL_GROUPS];
  const int K4 = K / 4;
  const int tx = threadIdx.x % COL_GROUPS;  // 4 columns
  const int ty = threadIdx.x / COL_GROUPS;  // 4 rows
  const int m0 = blockIdx.y * TILE_M;
  const int n0 = blockIdx.x * TILE_N;
  const int* xw = reinterpret_cast<const int*>(x4);
  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0;
  for (int r0 = 0; r0 < K4; r0 += TILE_R) {
    for (int i = threadIdx.x; i < TILE_M * TILE_R; i += blockDim.x) {
      int row = i / TILE_R, r = i % TILE_R;
      int gm = m0 + row, gr = r0 + r;
      xt[row][r] = (gm < B && gr < K4) ? xw[(size_t)gm * K4 + gr] : 0;
    }
    for (int i = threadIdx.x; i < TILE_R * COL_GROUPS; i += blockDim.x) {
      int r = i / COL_GROUPS, c = i % COL_GROUPS;
      int gr = r0 + r, gn = n0 + c * 4;
      // columns beyond N are never emitted; rows beyond K/4 are never read
      wt[r][c] = (gr < K4 && gn < N)
                     ? __ldg(reinterpret_cast<const uint32_t*>(w + (size_t)gr * N + gn))
                     : 0u;
    }
    __syncthreads();
    const int rmax = min(TILE_R, K4 - r0);
    for (int r = 0; r < rmax; ++r) {
      uint32_t wv = wt[r][tx];
      int e0 = spread(wv, 0), e1 = spread(wv, 1), e2 = spread(wv, 2), e3 = spread(wv, 3);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int xv = xt[ty * 4 + i][r];
        acc[i][0] = __dp4a(xv, e0, acc[i][0]);
        acc[i][1] = __dp4a(xv, e1, acc[i][1]);
        acc[i][2] = __dp4a(xv, e2, acc[i][2]);
        acc[i][3] = __dp4a(xv, e3, acc[i][3]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int m = m0 + ty * 4 + i;
    if (m >= B) continue;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int n = n0 + tx * 4 + c;
      if (n < N)
        emit_out<MODE>(out, (size_t)m * N + n, acc[i][c] - rowsum[m], sx, m, sw, n * sw_stride);
    }
  }
}

// ---------------------------------------------------------------- K7 ------

// The packed-ternary dot of caller-quantized int8 codes (no prologue):
// replaces ternary_matmul_pallas (_matmul_kernel, _matmul_int_kernel) and
// ternary_matmul_pallas_stacked (_matmul_kernel_stacked,
// _matmul_kernel_stacked_rowscale). The layer, or the expert, is a byte
// offset into the stack, computed by the caller. K1's dots want interleaved
// codes and the row sum of x, which K1's prologue writes; K7 builds them
// itself from x_q in natural order: in shared memory inside the decode
// kernel (<= 8 rows, each block re-reads the B*K bytes of x from L2), and
// in a small pre-pass before the tiled kernel above that. The bound and the
// design limits are K1's (the note at the top).

// R rows of natural-order codes -> interleaved words in shared memory (rows at
// or beyond `rows` are zero), then each row's code sum (one warp per row).
template <int R>
__device__ void interleave_codes(const int8_t* __restrict__ xq, int rows, int K, int* x4s,
                                 int* rsum) {
  const int K4 = K / 4;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(xq);
  for (int i = threadIdx.x; i < R * K4; i += blockDim.x) {
    const int row = i / K4, r = i - row * K4;
    uint32_t v = 0u;
    if (row < rows) {
      const uint8_t* x = xb + (size_t)row * K + r;
      v = (uint32_t)x[0] | ((uint32_t)x[K4] << 8) | ((uint32_t)x[2 * K4] << 16) |
          ((uint32_t)x[3 * K4] << 24);
    }
    x4s[i] = (int)v;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int i = warp; i < R; i += blockDim.x >> 5) {
    int s = 0;
    for (int r = lane; r < K4; r += 32) s = __dp4a(x4s[i * K4 + r], 0x01010101, s);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) rsum[i] = s;
  }
  __syncthreads();
}

template <int R, int MODE>
__global__ void k7_dot_rows(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                            const uint8_t* __restrict__ w, const float* __restrict__ sw,
                            int sw_stride, int B, int K, int N, void* __restrict__ out) {
  extern __shared__ int ismem[];
  const int K4 = K / 4;
  int* x4s = ismem;                     // R * K4
  int* red = x4s + R * K4;              // KSPLIT * R * TILE_N
  int* rsum = red + KSPLIT * R * TILE_N;  // R
  interleave_codes<R>(xq, B, K, x4s, rsum);
  dot_tile<R>(w, K4, N, blockIdx.x * TILE_N, x4s, B, red, [&](int i, int n, int acc) {
    emit_out<MODE>(out, (size_t)i * N + n, acc - rsum[i], sx, i, sw, n * sw_stride);
  });
}

// Pre-pass of the tiled path: one block per row writes the interleaved codes
// and the row's code sum.
__global__ void k7_interleave(const int8_t* __restrict__ xq, int K, int8_t* __restrict__ x4,
                              int* __restrict__ rowsum) {
  __shared__ int red[32];
  const int b = blockIdx.x, K4 = K / 4;
  const int8_t* x = xq + (size_t)b * K;
  int s = 0;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int v = x[k];
    x4[(size_t)b * K + (k % K4) * 4 + k / K4] = (int8_t)v;
    s += v;
  }
  s = block_isum(s, red);
  if (threadIdx.x == 0) rowsum[b] = s;
}

// ---------------------------------------------------------------- K2 ------

// Whole MLP block in one cooperative launch:
//   A-prologue (norm+quant of h, one block per row) | grid barrier |
//   gateup tiles -> bf16 gu in global scratch | grid barrier |
//   B-prologue (act + sub-norm + quant of gu, one block per row) | grid barrier |
//   down tiles + bf16 residual.
// The B-prologue runs once per row behind its own barrier rather than being
// recomputed by every block: it needs the whole gu row, and recomputing it
// in each of the ~100+ resident blocks would multiply the gu reads and the
// reductions by the block count for the price of one barrier saved.
//
// The body is a device function so that K8 can run it after K5's body in one
// launch; there h is written by the attention stages of the same launch, so
// it is not declared __restrict__ (no read-only cache path).
template <int R>
__device__ void mlp_block(float* smem, const __nv_bfloat16* h, int B, int H, int I, int act,
                          const __nv_bfloat16* __restrict__ post_ln,
                          const __nv_bfloat16* __restrict__ ffn_sub, float eps,
                          const uint8_t* __restrict__ gw, const float* __restrict__ gsw,
                          int gsw_stride, const uint8_t* __restrict__ dw,
                          const float* __restrict__ dsw, int dsw_stride,
                          int8_t* __restrict__ x4a, int* __restrict__ rsa,
                          float* __restrict__ sxa, __nv_bfloat16* __restrict__ gu,
                          int8_t* __restrict__ x4b, int* __restrict__ rsb,
                          float* __restrict__ sxb, __nv_bfloat16* __restrict__ out) {
  cg::grid_group grid = cg::this_grid();
  const int NG = 2 * I;

  for (int b = blockIdx.x; b < B; b += gridDim.x)
    prologue_row(h + (size_t)b * H, H, ACT_NONE, 1, post_ln, eps, smem + 32, smem,
                 x4a + (size_t)b * H, rsa + b, sxa + b);
  grid.sync();

  {
    int* x4s = reinterpret_cast<int*>(smem);
    int* red = x4s + R * (H / 4);
    load_codes<R>(x4a, B, H / 4, x4s);
    for (int t = blockIdx.x; t * TILE_N < NG; t += gridDim.x) {
      dot_tile<R>(gw, H / 4, NG, t * TILE_N, x4s, B, red, [&](int i, int n, int acc) {
        gu[(size_t)i * NG + n] = rescale(acc, rsa[i], sxa[i], gsw[n * gsw_stride]);
      });
    }
  }
  grid.sync();

  for (int b = blockIdx.x; b < B; b += gridDim.x)
    prologue_row(gu + (size_t)b * NG, I, act, ffn_sub != nullptr, ffn_sub, eps, smem + 32,
                 smem, x4b + (size_t)b * I, rsb + b, sxb + b);
  grid.sync();

  {
    int* x4s = reinterpret_cast<int*>(smem);
    int* red = x4s + R * (I / 4);
    load_codes<R>(x4b, B, I / 4, x4s);
    for (int t = blockIdx.x; t * TILE_N < H; t += gridDim.x) {
      dot_tile<R>(dw, I / 4, H, t * TILE_N, x4s, B, red, [&](int i, int n, int acc) {
        float d = __bfloat162float(rescale(acc, rsb[i], sxb[i], dsw[n * dsw_stride]));
        out[(size_t)i * H + n] = __float2bfloat16_rn(__bfloat162float(h[(size_t)i * H + n]) + d);
      });
    }
  }
}

template <int R>
__global__ void k2_mlp(const __nv_bfloat16* __restrict__ h, int B, int H, int I, int act,
                       const __nv_bfloat16* __restrict__ post_ln,
                       const __nv_bfloat16* __restrict__ ffn_sub, float eps,
                       const uint8_t* __restrict__ gw, const float* __restrict__ gsw,
                       int gsw_stride, const uint8_t* __restrict__ dw,
                       const float* __restrict__ dsw, int dsw_stride,
                       int8_t* __restrict__ x4a, int* __restrict__ rsa, float* __restrict__ sxa,
                       __nv_bfloat16* __restrict__ gu, int8_t* __restrict__ x4b,
                       int* __restrict__ rsb, float* __restrict__ sxb,
                       __nv_bfloat16* __restrict__ out) {
  extern __shared__ float smem[];
  mlp_block<R>(smem, h, B, H, I, act, post_ln, ffn_sub, eps, gw, gsw, gsw_stride, dw, dsw,
               dsw_stride, x4a, rsa, sxa, gu, x4b, rsb, sxb, out);
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
// (replaces attn_block_megakernel / attn_block_megakernel_manual_stacked):
//   A: norm+quant of h (recomputed in every block that owns qkv tiles: a
//      2560-wide row costs less than a grid barrier) -> qkv tiles -> bf16
//      qkv in global scratch                                    | barrier |
//   B: per (KV head, 64-row chunk of rows 0..pos): RoPE of the G packed q
//      heads; the chunk holding pos writes the roped k row and the raw v
//      row into the cache in place; f32 scores * 1/sqrt(D)      | barrier |
//   C: per unit: row max and sum over rows 0..pos (fixed-order block
//      reductions), p = bf16(e / sum), f32 PV partials of the chunk
//                                                               | barrier |
//   D: fixed-order sum of the chunk partials -> bf16 attention row
//                                                               | barrier |
//   E: sub-norm+quant of the attention row (recomputed per block, as in A)
//      -> o tiles -> h + bf16(d).
// The two-pass softmax keeps the TPU kernel's rounding points (probabilities
// normalised, then rounded to bf16); an online softmax would move them. Only
// cache rows 0..pos are read. The cache, the scratch buffers and the row
// written at pos are read through plain (coherent) loads: they are written
// inside this launch.
#define WF_K5_PARAMS                                                                       \
  const __nv_bfloat16 *__restrict__ h, int H, int Q, int NH, int KV, int T, int layer,        \
      const int *__restrict__ pos_p, const __nv_bfloat16 *__restrict__ input_ln,              \
      const __nv_bfloat16 *__restrict__ attn_sub, int norm2, float eps,                       \
      const uint8_t *__restrict__ qw, const float *__restrict__ qsw, int qsw_stride,          \
      const uint8_t *__restrict__ ow, const float *__restrict__ osw, int osw_stride,          \
      const __nv_bfloat16 *__restrict__ cs, const __nv_bfloat16 *__restrict__ sn, float scale, \
      __nv_bfloat16 *ck, __nv_bfloat16 *cv, __nv_bfloat16 *qkv, float *sc, float *part,       \
      __nv_bfloat16 *attn, __nv_bfloat16 *out
#define WF_K5_ARGS                                                                          \
  h, H, Q, NH, KV, T, layer, pos_p, input_ln, attn_sub, norm2, eps, qw, qsw, qsw_stride, ow, \
      osw, osw_stride, cs, sn, scale, ck, cv, qkv, sc, part, attn, out

__device__ void attn_block(float* smem, WF_K5_PARAMS) {
  cg::grid_group grid = cg::this_grid();
  const int KMAX = H > Q ? H : Q;
  float* red = smem;                                            // 32
  float* xs = red + 32;                                         // KMAX
  int* codes = reinterpret_cast<int*>(xs + KMAX);               // KMAX / 4
  int* dred = codes + KMAX / 4;                                 // KSPLIT * TILE_N
  float* qs = reinterpret_cast<float*>(dred + KSPLIT * TILE_N);  // MAX_G * HD
  float* ps = qs + MAX_G * HD;                                  // MAX_G * ATT_CH
  float* pv = ps + MAX_G * ATT_CH;                              // MAX_G * HD
  int* rs = reinterpret_cast<int*>(pv + MAX_G * HD);            // row sum
  float* sxp = pv + MAX_G * HD + 1;                             // quant scale
  const int G = NH / KV;
  const int NQKV = Q + 2 * KV * HD;
  const int pos = min(max(*pos_p, 0), T - 1);
  const int nch = pos / ATT_CH + 1;  // chunks covering rows 0..pos
  const int units = KV * nch;
  const size_t row0 = (size_t)layer * T;  // this layer's first cache row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;

  // A: qkv
  const int tiles_q = (NQKV + TILE_N - 1) / TILE_N;
  if (blockIdx.x < tiles_q) {
    prologue_row(h, H, ACT_NONE, 1, input_ln, eps, xs, red, reinterpret_cast<int8_t*>(codes),
                 rs, sxp);
    for (int t = blockIdx.x; t < tiles_q; t += gridDim.x)
      dot_tile<1>(qw, H / 4, NQKV, t * TILE_N, codes, 1, dred, [&](int, int n, int acc) {
        qkv[n] = rescale(acc, *rs, *sxp, qsw[n * qsw_stride]);
      });
  }
  grid.sync();

  // B: RoPE, the cache-row write, scores
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int kvh = u / nch, c = u % nch;
    const int t0 = c * ATT_CH, t1 = min(t0 + ATT_CH, pos + 1);
    for (int i = threadIdx.x; i < G * HD; i += blockDim.x)
      qs[i] = rope_at(qkv + (kvh * G + i / HD) * HD, i % HD, cs, sn);
    if (pos < t1) {
      const size_t row = ((row0 + pos) * KV + kvh) * HD;
      for (int d = threadIdx.x; d < HD; d += blockDim.x) {
        ck[row + d] = __float2bfloat16_rn(rope_at(qkv + Q + kvh * HD, d, cs, sn));
        cv[row + d] = qkv[Q + KV * HD + kvh * HD + d];
      }
    }
    __syncthreads();
    for (int t = t0 + warp; t < t1; t += nwarps) {
      uint2 raw = *reinterpret_cast<const uint2*>(ck + ((row0 + t) * KV + kvh) * HD + lane * 4);
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

  // C: softmax over rows 0..pos, PV partials of each chunk
  for (int u = blockIdx.x; u < units; u += gridDim.x) {
    const int kvh = u / nch, c = u % nch;
    const int t0 = c * ATT_CH, n = min(ATT_CH, pos + 1 - t0);
    for (int g = 0; g < G; ++g) {
      const float* srow = sc + (size_t)(kvh * G + g) * T;
      float m = -INFINITY;
      for (int t = threadIdx.x; t <= pos; t += blockDim.x) m = fmaxf(m, srow[t]);
      m = block_max(m, red);
      float l = 0.f;
      for (int t = threadIdx.x; t <= pos; t += blockDim.x) l += expf(srow[t] - m);
      l = block_sum(l, red);
      for (int j = threadIdx.x; j < n; j += blockDim.x)
        ps[g * ATT_CH + j] = bf16r(expf(srow[t0 + j] - m) / l);
    }
    __syncthreads();
    const int d = threadIdx.x % HD, half = threadIdx.x / HD;  // two row halves
    float acc[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;
    for (int j = half; j < n; j += 2) {
      const float v = __bfloat162float(cv[((row0 + t0 + j) * KV + kvh) * HD + d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] += ps[g * ATT_CH + j] * v;
    }
    if (half == 1) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) pv[g * HD + d] = acc[g];
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) part[((size_t)c * NH + kvh * G + g) * HD + d] = acc[g] + pv[g * HD + d];
    }
    __syncthreads();
  }
  grid.sync();

  // D: combine the chunks in order
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < NH * HD; i += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int c = 0; c < nch; ++c) s += part[(size_t)c * NH * HD + i];
    attn[i] = __float2bfloat16_rn(s);
  }
  grid.sync();

  // E: o and the residual
  const int tiles_o = (H + TILE_N - 1) / TILE_N;
  if (blockIdx.x < tiles_o) {
    prologue_row(attn, Q, ACT_NONE, norm2, attn_sub, eps, xs, red,
                 reinterpret_cast<int8_t*>(codes), rs, sxp);
    for (int t = blockIdx.x; t < tiles_o; t += gridDim.x)
      dot_tile<1>(ow, Q / 4, H, t * TILE_N, codes, 1, dred, [&](int, int n, int acc) {
        float d = __bfloat162float(rescale(acc, *rs, *sxp, osw[n * osw_stride]));
        out[n] = __float2bfloat16_rn(__bfloat162float(h[n]) + d);
      });
  }
}

__global__ void k5_attn(WF_K5_PARAMS) {
  extern __shared__ float smem[];
  attn_block(smem, WF_K5_ARGS);
}

// ---------------------------------------------------------------- K8 ------

// A whole batch-1 decode layer in one cooperative launch (replaces
// layer_block_megakernel / _layer_megakernel): K5's five stages write h' =
// h + o(attention) to global scratch (`out` of the attention block), a grid
// barrier, then K2's three stages on h' at one row. Eight grid barriers in
// all; K2's prologue of h' runs in one block behind its own barrier, as in K2.
// The attention takes K5's two-pass softmax per query head over cache rows
// 0..pos: the TPU kernel's per-KV-head form (scores of the G heads over all
// T rows, -1e30 above pos) without its masked columns, whose exp(-1e30 - m)
// is exactly 0 in f32, so the two differ only in the order of f32 sums. The
// bound is the sum of K5's and K2's: the layer's packed weights (17.4 MB at
// BitNet-2B) plus 2*(pos+1)*KV*D*2 bytes of cache.
__global__ void k8_layer(WF_K5_PARAMS, int I, int act, const __nv_bfloat16* __restrict__ post_ln,
                         const __nv_bfloat16* __restrict__ ffn_sub, float eps2,
                         const uint8_t* __restrict__ gw, const float* __restrict__ gsw,
                         int gsw_stride, const uint8_t* __restrict__ dw,
                         const float* __restrict__ dsw, int dsw_stride, int8_t* __restrict__ x4a,
                         int* __restrict__ rsa, float* __restrict__ sxa,
                         __nv_bfloat16* __restrict__ gu, int8_t* __restrict__ x4b,
                         int* __restrict__ rsb, float* __restrict__ sxb,
                         __nv_bfloat16* __restrict__ out2) {
  extern __shared__ float smem[];
  attn_block(smem, WF_K5_ARGS);
  cg::this_grid().sync();
  mlp_block<1>(smem, out, 1, H, I, act, post_ln, ffn_sub, eps2, gw, gsw, gsw_stride, dw, dsw,
               dsw_stride, x4a, rsa, sxa, gu, x4b, rsb, sxb, out2);
}

size_t dot_smem(int R, int K) {
  return (size_t)R * (K / 4) * 4 + (size_t)KSPLIT * R * TILE_N * 4;
}

template <int R>
cudaError_t launch_k1_dot(const int8_t* x4, const int* rs, const float* sx, const uint8_t* w,
                          const float* sw, int sw_stride, int B, int K, int N,
                          __nv_bfloat16* out, cudaStream_t st) {
  size_t smem = dot_smem(R, K);
  cudaError_t e = cudaFuncSetAttribute(k1_dot_rows<R>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((N + TILE_N - 1) / TILE_N);
  k1_dot_rows<R><<<grid, THREADS, smem, st>>>(x4, rs, sx, w, sw, sw_stride, B, K, N, out);
  return cudaGetLastError();
}

// Dynamic shared memory of K2's stages at R rows: the larger dot's codes and
// partial sums, or a prologue's reduction scratch and row.
size_t k2_smem(int R, int H, int I) {
  size_t smem = dot_smem(R, H);
  size_t s2 = dot_smem(R, I);
  if (s2 > smem) smem = s2;
  size_t sp = (size_t)(32 + (H > I ? H : I)) * 4;
  return sp > smem ? sp : smem;
}

// K5's dynamic shared memory (see the layout at the top of attn_block).
size_t k5_smem(int H, int Q) {
  const int KMAX = H > Q ? H : Q;
  return (size_t)(32 + KMAX + KMAX / 4 + KSPLIT * TILE_N + 2 * MAX_G * HD + MAX_G * ATT_CH + 2) *
         4;
}

// K5's useful grid: the larger of its qkv tiles, o tiles and attention units.
int k5_want(int H, int Q, int KV, int T) {
  int want = (Q + 2 * KV * HD + TILE_N - 1) / TILE_N;
  int tiles_o = (H + TILE_N - 1) / TILE_N;
  int units = KV * ((T + ATT_CH - 1) / ATT_CH);
  if (tiles_o > want) want = tiles_o;
  return units > want ? units : want;
}

template <int R>
cudaError_t launch_k2(const __nv_bfloat16* h, int B, int H, int I, int act,
                      const __nv_bfloat16* post_ln, const __nv_bfloat16* ffn_sub, float eps,
                      const uint8_t* gw, const float* gsw, int gsw_stride, const uint8_t* dw,
                      const float* dsw, int dsw_stride, int8_t* x4a, int* rsa, float* sxa,
                      __nv_bfloat16* gu, int8_t* x4b, int* rsb, float* sxb,
                      __nv_bfloat16* out, cudaStream_t st) {
  size_t smem = k2_smem(R, H, I);
  cudaError_t e = cudaFuncSetAttribute(k2_mlp<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k2_mlp<R>, THREADS, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int tiles = (2 * I + TILE_N - 1) / TILE_N;
  int blocks = per_sm * sms;
  if (blocks > tiles) blocks = tiles;
  if (blocks < B) blocks = B;
  void* args[] = {(void*)&h,   (void*)&B,      (void*)&H,   (void*)&I,          (void*)&act,
                  (void*)&post_ln, (void*)&ffn_sub, (void*)&eps, (void*)&gw,   (void*)&gsw,
                  (void*)&gsw_stride, (void*)&dw, (void*)&dsw, (void*)&dsw_stride,
                  (void*)&x4a, (void*)&rsa,   (void*)&sxa, (void*)&gu,         (void*)&x4b,
                  (void*)&rsb, (void*)&sxb,   (void*)&out};
  e = cudaLaunchCooperativeKernel((const void*)k2_mlp<R>, dim3(blocks), dim3(THREADS), args,
                                  smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

struct Args7 {
  const int8_t* xq;
  const float* sx;
  const uint8_t* w;
  const float* sw;
  int sw_stride, B, K, N;
  int8_t* x4;
  int* rowsum;
  void* out;
  cudaStream_t st;
};

template <int R, int MODE>
cudaError_t launch_k7_rows(const Args7& a) {
  size_t smem = dot_smem(R, a.K) + (size_t)R * 4;
  cudaError_t e = cudaFuncSetAttribute(k7_dot_rows<R, MODE>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + TILE_N - 1) / TILE_N);
  k7_dot_rows<R, MODE><<<grid, THREADS, smem, a.st>>>(a.xq, a.sx, a.w, a.sw, a.sw_stride, a.B,
                                                       a.K, a.N, a.out);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t launch_k7(const Args7& a) {
  if (a.B == 1) return launch_k7_rows<1, MODE>(a);
  if (a.B == 2) return launch_k7_rows<2, MODE>(a);
  if (a.B <= 4) return launch_k7_rows<4, MODE>(a);
  if (a.B <= 8) return launch_k7_rows<8, MODE>(a);
  if (a.x4 == nullptr || a.rowsum == nullptr) return cudaErrorInvalidValue;
  k7_interleave<<<a.B, THREADS, 0, a.st>>>(a.xq, a.K, a.x4, a.rowsum);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + TILE_N - 1) / TILE_N, (a.B + TILE_M - 1) / TILE_M);
  k1_dot_tiled<MODE><<<grid, THREADS, 0, a.st>>>(a.x4, a.rowsum, a.sx, a.w, a.sw, a.sw_stride,
                                                 a.B, a.K, a.N, a.out);
  return cudaGetLastError();
}

// Largest grid whose blocks are all resident (a cooperative launch needs
// that), capped at `want` and at least 1.
cudaError_t resident_blocks(const void* kernel, size_t smem, int want, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *blocks = per_sm * sms < want ? per_sm * sms : want;
  if (*blocks < 1) *blocks = 1;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// K1: out[B,N] = fused linear of h[B,kin]. w points at the layer's [K/4,N]
// bytes, sw at the layer's scales (sw_stride 1: per column, 0: one scalar),
// nw at the layer's bf16 norm row or null. x4/rowsum/sx are caller scratch of
// B*K bytes, B ints and B floats.
int wf_ternary_fused(const void* h, int B, int kin, int K, int act, int norm, const void* nw,
                     float eps, const void* w, const void* sw, int sw_stride, int N, void* x4,
                     void* rowsum, void* sx, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  size_t psmem = (size_t)(32 + K) * 4;
  cudaError_t e =
      cudaFuncSetAttribute(k1_prologue, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)psmem);
  if (e != cudaSuccess) return e;
  k1_prologue<<<B, THREADS, psmem, st>>>((const __nv_bfloat16*)h, kin, K, act, norm,
                                         (const __nv_bfloat16*)nw, eps, (int8_t*)x4,
                                         (int*)rowsum, (float*)sx);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int8_t* xq = (const int8_t*)x4;
  const int* rs = (const int*)rowsum;
  const float* s = (const float*)sx;
  const uint8_t* wb = (const uint8_t*)w;
  const float* swf = (const float*)sw;
  __nv_bfloat16* o = (__nv_bfloat16*)out;
  if (B == 1) return launch_k1_dot<1>(xq, rs, s, wb, swf, sw_stride, B, K, N, o, st);
  if (B == 2) return launch_k1_dot<2>(xq, rs, s, wb, swf, sw_stride, B, K, N, o, st);
  if (B <= 4) return launch_k1_dot<4>(xq, rs, s, wb, swf, sw_stride, B, K, N, o, st);
  if (B <= 8) return launch_k1_dot<8>(xq, rs, s, wb, swf, sw_stride, B, K, N, o, st);
  dim3 grid((N + TILE_N - 1) / TILE_N, (B + TILE_M - 1) / TILE_M);
  k1_dot_tiled<OUT_BF16><<<grid, THREADS, 0, st>>>(xq, rs, s, wb, swf, sw_stride, B, K, N, o);
  return cudaGetLastError();
}

// K7: out[B,N] = the packed-ternary dot of int8 codes xq[B,K] (natural order)
// with w[K/4,N] (the layer's or the expert's bytes). mode 0: bf16 and mode 1:
// f32 of float(dot) * (1/(sx[b]*sw[n*sw_stride])) (sw_stride 1: per column,
// 0: one scalar); mode 2: the exact int32 dot, sx and sw unused. x4/rowsum
// are caller scratch of B*K bytes and B ints, used (and needed) only for
// B > 8.
int wf_ternary_matmul(const void* xq, int B, int K, const void* sx, const void* w, const void* sw,
                      int sw_stride, int N, int mode, void* x4, void* rowsum, void* out,
                      void* stream) {
  if (B <= 0) return 0;
  if (K % 4 || N % 4 || mode < OUT_BF16 || mode > OUT_I32) return cudaErrorInvalidValue;
  const Args7 a{(const int8_t*)xq, (const float*)sx, (const uint8_t*)w, (const float*)sw,
                sw_stride, B, K, N, (int8_t*)x4, (int*)rowsum, out, (cudaStream_t)stream};
  if (mode == OUT_BF16) return launch_k7<OUT_BF16>(a);
  if (mode == OUT_F32) return launch_k7<OUT_F32>(a);
  return launch_k7<OUT_I32>(a);
}

// K2: out[B,H] = h + down(quant(subnorm(act(bf16(gateup(quant(norm(h)))))))), B <= 8.
int wf_mlp_mega(const void* h, int B, int H, int I, int act, const void* post_ln,
                const void* ffn_sub, float eps, const void* gw, const void* gsw, int gsw_stride,
                const void* dw, const void* dsw, int dsw_stride, void* x4a, void* rsa, void* sxa,
                void* gu, void* x4b, void* rsb, void* sxb, void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (B <= 0) return 0;
  if (B > 8) return cudaErrorInvalidValue;
#define WF_K2(R)                                                                              \
  launch_k2<R>((const __nv_bfloat16*)h, B, H, I, act, (const __nv_bfloat16*)post_ln,         \
               (const __nv_bfloat16*)ffn_sub, eps, (const uint8_t*)gw, (const float*)gsw,     \
               gsw_stride, (const uint8_t*)dw, (const float*)dsw, dsw_stride, (int8_t*)x4a,  \
               (int*)rsa, (float*)sxa, (__nv_bfloat16*)gu, (int8_t*)x4b, (int*)rsb,           \
               (float*)sxb, (__nv_bfloat16*)out, st)
  if (B == 1) return WF_K2(1);
  if (B == 2) return WF_K2(2);
  if (B <= 4) return WF_K2(4);
  return WF_K2(8);
#undef WF_K2
}

// K5: out[1,H] = h + o(quant(subnorm(attention(rope(qkv(quant(norm(h)))))))) for one
// decode token; writes row pos of `layer` of the [L,T,KV,128] caches ck/cv in
// place. pos is a device int (clamped to [0,T-1]). Caller scratch: qkv
// [Q+2*KV*128] bf16, sc [NH*T] f32, part [ceil(T/64)*NH*128] f32, attn [Q] bf16.
int wf_attn_mega(const void* h, int H, int Q, int NH, int KV, int T, int layer, const void* pos,
                 const void* input_ln, const void* attn_sub, int norm2, float eps,
                 const void* qw, const void* qsw, int qsw_stride, const void* ow, const void* osw,
                 int osw_stride, const void* cs, const void* sn, float scale, void* ck, void* cv,
                 void* qkv, void* sc, void* part, void* attn, void* out, void* stream) {
  if (T <= 0 || KV <= 0 || NH % KV || NH / KV > MAX_G || Q != NH * HD || H % 4)
    return cudaErrorInvalidValue;
  size_t smem = k5_smem(H, Q);
  cudaError_t e = cudaFuncSetAttribute(k5_attn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  if ((e = resident_blocks((const void*)k5_attn, smem, k5_want(H, Q, KV, T), &blocks)) !=
      cudaSuccess)
    return e;
  void* args[] = {(void*)&h,   (void*)&H,     (void*)&Q,      (void*)&NH,    (void*)&KV,
                  (void*)&T,   (void*)&layer, (void*)&pos,    (void*)&input_ln, (void*)&attn_sub,
                  (void*)&norm2, (void*)&eps, (void*)&qw,     (void*)&qsw,   (void*)&qsw_stride,
                  (void*)&ow,  (void*)&osw,   (void*)&osw_stride, (void*)&cs, (void*)&sn,
                  (void*)&scale, (void*)&ck,  (void*)&cv,     (void*)&qkv,   (void*)&sc,
                  (void*)&part, (void*)&attn, (void*)&out};
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
                  void* ck, void* cv, void* qkv, void* sc, void* part, void* attn, void* out,
                  int I, int act, const void* post_ln, const void* ffn_sub, float eps2,
                  const void* gw, const void* gsw, int gsw_stride, const void* dw,
                  const void* dsw, int dsw_stride, void* x4a, void* rsa, void* sxa, void* gu,
                  void* x4b, void* rsb, void* sxb, void* out2, void* stream) {
  if (T <= 0 || KV <= 0 || NH % KV || NH / KV > MAX_G || Q != NH * HD || H % 4 || I % 4)
    return cudaErrorInvalidValue;
  size_t smem = k5_smem(H, Q);
  const size_t s2 = k2_smem(1, H, I);
  if (s2 > smem) smem = s2;
  cudaError_t e = cudaFuncSetAttribute(k8_layer, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return e;
  int want = k5_want(H, Q, KV, T);
  const int tiles_gu = (2 * I + TILE_N - 1) / TILE_N;
  if (tiles_gu > want) want = tiles_gu;
  int blocks = 0;
  if ((e = resident_blocks((const void*)k8_layer, smem, want, &blocks)) != cudaSuccess) return e;
  void* args[] = {(void*)&h,   (void*)&H,     (void*)&Q,      (void*)&NH,    (void*)&KV,
                  (void*)&T,   (void*)&layer, (void*)&pos,    (void*)&input_ln, (void*)&attn_sub,
                  (void*)&norm2, (void*)&eps, (void*)&qw,     (void*)&qsw,   (void*)&qsw_stride,
                  (void*)&ow,  (void*)&osw,   (void*)&osw_stride, (void*)&cs, (void*)&sn,
                  (void*)&scale, (void*)&ck,  (void*)&cv,     (void*)&qkv,   (void*)&sc,
                  (void*)&part, (void*)&attn, (void*)&out,
                  (void*)&I,   (void*)&act,   (void*)&post_ln, (void*)&ffn_sub, (void*)&eps2,
                  (void*)&gw,  (void*)&gsw,   (void*)&gsw_stride, (void*)&dw, (void*)&dsw,
                  (void*)&dsw_stride, (void*)&x4a, (void*)&rsa, (void*)&sxa, (void*)&gu,
                  (void*)&x4b, (void*)&rsb,   (void*)&sxb,    (void*)&out2};
  e = cudaLaunchCooperativeKernel((const void*)k8_layer, dim3(blocks), dim3(THREADS), args, smem,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

const char* wf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

// Fused packed-ternary linear (K1) and the one-launch MLP block (K2) for Hopper.
//
// K1 replaces wrinklefree_tpu/ops/ternary_pallas.py::ternary_matmul_stacked_fused
// (kernel body _matmul_kernel_stacked_fused). K2 replaces mlp_block_megakernel
// (_mlp_megakernel / _mlp_megakernel_manual).
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
    float t = threadIdx.x < (blockDim.x >> 5) ? red[threadIdx.x] : 0.f;
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
__device__ void prologue_row(const __nv_bfloat16* __restrict__ h, int K, int act,
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
// K/4 streamed through shared memory in stages of 32.
__global__ void k1_dot_tiled(const int8_t* __restrict__ x4, const int* __restrict__ rowsum,
                             const float* __restrict__ sx, const uint8_t* __restrict__ w,
                             const float* __restrict__ sw, int sw_stride, int B, int K,
                             int N, __nv_bfloat16* __restrict__ out) {
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
      if (n < N) out[(size_t)m * N + n] = rescale(acc[i][c], rowsum[m], sx[m], sw[n * sw_stride]);
    }
  }
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

template <int R>
cudaError_t launch_k2(const __nv_bfloat16* h, int B, int H, int I, int act,
                      const __nv_bfloat16* post_ln, const __nv_bfloat16* ffn_sub, float eps,
                      const uint8_t* gw, const float* gsw, int gsw_stride, const uint8_t* dw,
                      const float* dsw, int dsw_stride, int8_t* x4a, int* rsa, float* sxa,
                      __nv_bfloat16* gu, int8_t* x4b, int* rsb, float* sxb,
                      __nv_bfloat16* out, cudaStream_t st) {
  size_t smem = dot_smem(R, H);
  size_t s2 = dot_smem(R, I);
  if (s2 > smem) smem = s2;
  size_t sp = (size_t)(32 + (H > I ? H : I)) * 4;  // prologue: reduction + row
  if (sp > smem) smem = sp;
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
  k1_dot_tiled<<<grid, THREADS, 0, st>>>(xq, rs, s, wb, swf, sw_stride, B, K, N, o);
  return cudaGetLastError();
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

const char* wf_error_string(int code) { return cudaGetErrorString((cudaError_t)code); }

}  // extern "C"

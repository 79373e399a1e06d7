// Paged-prefill flash attention (K4) and causal flash prefill (K9) for Hopper.
//
// K4 replaces wrinklefree_tpu/ops/flash_attention.py::flash_paged_prefill
// (kernel body _paged_flash_kernel): online-softmax GQA of a prefill chunk's
// queries q[B,S,NH,D] over keys [history(hist_len) ++ chunk(S)] given as
// k, v [B,Tt,KV,D] (Tt = hist_len + S). Per batch row: history key col is
// visible iff col < kv_valid; chunk key rel = col - hist_len is visible iff
// rel <= query row and rel < new_len.
//
// K9 replaces flash_attention.py::flash_prefill (kernel body _flash_kernel):
// causal GQA of q[B,S,NH,D] over contiguous k, v [B,T,KV,D]; query row s sees
// key t iff t <= q_offset + s. bf16 and f32, head dim 64 or 128.
//
// Both keep the TPU kernels' rounding points: masked scores are -1e30 (not
// -inf) and the divisor is max(l, 1e-30), so a fully masked padding row stays
// finite; q is scaled by 1/sqrt(D) in the input type before the dot; scores
// and the running max/sum are f32; p is cast to v's type before the PV
// product; the output is acc / max(l, 1e-30) cast to q's type.
//
// Design: one tile loop (flash_rows) templated on the element type, the head
// dim and the key rule (which keys of a tile a query row sees, which tiles a
// q tile visits). One block (4 warps) per (64-row q tile, head, batch row);
// the kv head is h / (NH/KV). Key tiles of 64 go through shared memory, and
// tiles wholly masked for the q tile are skipped (K4: the history between
// kv_valid and hist_len and keys after the last visible chunk key; K9: keys
// above the q tile's diagonal). bf16 runs QK^T and PV on the tensor cores
// through WMMA 16x16x16 fragments with f32 accumulation. f32 runs both on the
// CUDA cores with FMAs: the tensor cores take f32 only as TF32 (about three
// decimal digits), and the f32 reference holds the result to 2e-5. The output
// accumulator lives in shared memory so each row can be rescaled by its
// online-softmax factor between tiles.
//
// Bound: operations at 512-token chunks (4*S*T*D flops per head, half of
// them under the causal mask); plain WMMA without TMA or warp specialisation
// reaches a fraction of the tensor-core peak. A wgmma/TMA pipeline is later
// work.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;  // q rows per block
constexpr int BK = 64;  // keys per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDS = BK + 4;  // f32 row stride for scores
constexpr float NEG = -1e30f;

// Row padding of the Q/K/V/P tiles: WMMA's bf16 rows need a multiple of 8;
// f32 rows of HD + 4 keep 16-byte rows whose float4 reads by 8 lanes fall in
// 32 distinct banks.
template <typename T>
constexpr int pad() {
  return std::is_same<T, float>::value ? 4 : 8;
}

template <typename T, int HD>
struct Smem {
  static constexpr int LDH = HD + pad<T>();  // Q/K/V row stride
  static constexpr int LDP = BK + pad<T>();  // probability row stride
  static constexpr int LDO = HD + 4;         // f32 output accumulator row stride
  T q[BQ * LDH];
  T k[BK * LDH];
  T v[BK * LDH];
  float s[BQ * LDS];
  T p[BQ * LDP];
  float o[BQ * LDO];
  float m[BQ];
  float l[BQ];
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}

__device__ __forceinline__ __nv_bfloat16 scaled(__nv_bfloat16 x, float s) {
  return __hmul(x, __float2bfloat16_rn(s));  // the product rounded to bf16
}
__device__ __forceinline__ float scaled(float x, float s) { return x * s; }

// K4's keys: a gathered history then the chunk.
struct PagedKeys {
  int hist_len, kvv, nl;
  __device__ bool visible(int col, int srow) const {
    if (col < hist_len) return col < kvv;
    const int rel = col - hist_len;
    return rel <= srow && rel < nl;
  }
  __device__ bool skip(int c0) const {  // wholly masked history tile
    return c0 >= min(kvv, hist_len) && c0 + BK <= hist_len;
  }
};

// K9's keys: causal with an offset, T keys.
struct CausalKeys {
  int qoff, T;
  __device__ bool visible(int col, int srow) const { return col < T && col <= qoff + srow; }
  __device__ bool skip(int) const { return false; }
};

// Scores of this warp's 16 rows against the key tile: s = Q[16 x HD] K^T.
template <typename T, int HD>
__device__ void tile_scores(Smem<T, HD>& sm, int r0, int lane) {
  constexpr int LDH = Smem<T, HD>::LDH;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < HD / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, sm.q + r0 * LDH + kk * 16, LDH);
        wmma::load_matrix_sync(fb, sm.k + (j * 16) * LDH + kk * 16, LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sm.s + r0 * LDS + j * 16, acc, LDS, wmma::mem_row_major);
    }
  } else {
    // each lane owns columns lane and lane + 32 of the 16 rows
    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int d = 0; d < HD; d += 4) {
      const float4 k0 = *reinterpret_cast<const float4*>(sm.k + lane * LDH + d);
      const float4 k1 = *reinterpret_cast<const float4*>(sm.k + (lane + 32) * LDH + d);
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(sm.q + (r0 + r) * LDH + d);
        acc[r][0] = fmaf(qv.w, k0.w,
                         fmaf(qv.z, k0.z, fmaf(qv.y, k0.y, fmaf(qv.x, k0.x, acc[r][0]))));
        acc[r][1] = fmaf(qv.w, k1.w,
                         fmaf(qv.z, k1.z, fmaf(qv.y, k1.y, fmaf(qv.x, k1.x, acc[r][1]))));
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      sm.s[(r0 + r) * LDS + lane] = acc[r][0];
      sm.s[(r0 + r) * LDS + lane + 32] = acc[r][1];
    }
  }
}

// O[16 x HD] += P[16 x 64] V[64 x HD] for this warp's rows (O already scaled
// by each row's alpha).
template <typename T, int HD>
__device__ void tile_pv(Smem<T, HD>& sm, int r0, int lane) {
  constexpr int LDH = Smem<T, HD>::LDH;
  constexpr int LDP = Smem<T, HD>::LDP;
  constexpr int LDO = Smem<T, HD>::LDO;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    for (int j = 0; j < HD / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, sm.o + r0 * LDO + j * 16, LDO, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, sm.p + r0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, sm.v + (kk * 16) * LDH + j * 16, LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sm.o + r0 * LDO + j * 16, acc, LDO, wmma::mem_row_major);
    }
  } else {
    constexpr int W = HD / 32;  // consecutive columns per lane
    const int d0 = lane * W;
    float acc[16][W];
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int c = 0; c < W; ++c) acc[r][c] = 0.f;
    for (int t = 0; t < BK; ++t) {
      float vv[W];
#pragma unroll
      for (int c = 0; c < W; ++c) vv[c] = sm.v[t * LDH + d0 + c];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float pr = sm.p[(r0 + r) * LDP + t];
#pragma unroll
        for (int c = 0; c < W; ++c) acc[r][c] = fmaf(pr, vv[c], acc[r][c]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r)
#pragma unroll
      for (int c = 0; c < W; ++c) sm.o[(r0 + r) * LDO + d0 + c] += acc[r][c];
  }
}

// One (q tile, head, batch row) block: q [B,S,NH,HD], k/v [B,Tk,KV,HD], keys
// tiles 0..ntiles-1 under `keys`.
template <typename T, int HD, class Keys>
__device__ void flash_rows(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out, int S, int NH, int KV,
                           int Tk, float scale, const Keys& keys, int ntiles,
                           unsigned char* raw) {
  using Sm = Smem<T, HD>;
  constexpr int LDH = Sm::LDH, LDP = Sm::LDP, LDO = Sm::LDO;
  constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte load
  Sm& sm = *reinterpret_cast<Sm*>(raw);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / KV);
  const int s0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // Q tile, pre-scaled in T; rows beyond S are zero
  for (int i = threadIdx.x; i < BQ * (HD / VEC); i += THREADS) {
    const int row = i / (HD / VEC), c = (i % (HD / VEC)) * VEC;
    const int s = s0 + row;
    T* dst = sm.q + row * LDH + c;
    if (s < S) {
      uint4 raw16 = *reinterpret_cast<const uint4*>(q + (((size_t)b * S + s) * NH + h) * HD + c);
      const T* e = reinterpret_cast<const T*>(&raw16);
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[j] = scaled(e[j], scale);
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) dst[j] = from_f32<T>(0.f);
    }
  }
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) sm.o[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sm.m[i] = NEG;
    sm.l[i] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * BK;
    if (keys.skip(c0)) continue;
    __syncthreads();
    for (int i = threadIdx.x; i < BK * (HD / VEC); i += THREADS) {
      const int row = i / (HD / VEC), c = (i % (HD / VEC)) * VEC;
      const int key = c0 + row;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < Tk) {
        const size_t off = (((size_t)b * Tk + key) * KV + kvh) * HD + c;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sm.k + row * LDH + c) = kk;
      *reinterpret_cast<uint4*>(sm.v + row * LDH + c) = vv;
    }
    __syncthreads();

    const int r0 = warp * 16;
    tile_scores<T, HD>(sm, r0, lane);
    __syncwarp();

    // online softmax, one row at a time across the warp (2 columns per lane)
    for (int rr = 0; rr < 16; ++rr) {
      const int row = r0 + rr;
      const int srow = s0 + row;  // query row (chunk-relative for K4)
      float sv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = lane + 32 * u;
        sv[u] = keys.visible(c0 + c, srow) ? sm.s[row * LDS + c] : NEG;
      }
      float mx = fmaxf(sv[0], sv[1]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.m[row];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = expf(sv[0] - m_new), p1 = expf(sv[1] - m_new);
      float ps = p0 + p1;
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float alpha = expf(m_old - m_new);
      sm.p[row * LDP + lane] = from_f32<T>(p0);
      sm.p[row * LDP + lane + 32] = from_f32<T>(p1);
      for (int d = lane; d < HD; d += 32) sm.o[row * LDO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sm.l[row] = sm.l[row] * alpha + ps;
        sm.m[row] = m_new;
      }
      __syncwarp();
    }

    tile_pv<T, HD>(sm, r0, lane);
    __syncwarp();
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    const int row = i / HD, d = i % HD;
    const int s = s0 + row;
    if (s < S) {
      const float den = fmaxf(sm.l[row], 1e-30f);
      out[(((size_t)b * S + s) * NH + h) * HD + d] = from_f32<T>(sm.o[row * LDO + d] / den);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
flash_paged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ kv_valid, const int* __restrict__ new_len,
                           __nv_bfloat16* __restrict__ out, int S, int NH, int KV, int Tt,
                           int hist_len, float scale) {
  extern __shared__ __align__(128) unsigned char raw[];
  const int b = blockIdx.z;
  const PagedKeys keys{hist_len, kv_valid[b], new_len[b]};
  const int s0 = blockIdx.x * BQ;
  const int hist_end = min(keys.kvv, hist_len);  // visible history keys
  const int cur_end = hist_len + min(s0 + BQ, keys.nl);
  const int last_key = max(hist_end, cur_end);
  const int ntiles = min((last_key + BK - 1) / BK, (Tt + BK - 1) / BK);
  flash_rows<__nv_bfloat16, 128>(q, k, v, out, S, NH, KV, Tt, scale, keys, ntiles, raw);
}

template <typename T, int HD>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const int* __restrict__ q_offset, T* __restrict__ out, int S, int NH, int KV,
                     int Tk, float scale) {
  extern __shared__ __align__(128) unsigned char raw[];
  const CausalKeys keys{*q_offset, Tk};
  const int s0 = blockIdx.x * BQ;
  const int last_key = min(Tk, keys.qoff + min(s0 + BQ, S));  // keys up to the diagonal
  const int ntiles = (last_key + BK - 1) / BK;
  flash_rows<T, HD>(q, k, v, out, S, NH, KV, Tk, scale, keys, ntiles, raw);
}

template <typename T, int HD>
cudaError_t launch_k9(const void* q, const void* k, const void* v, const void* q_offset, void* out,
                      int B, int S, int NH, int KV, int Tk, float scale, cudaStream_t st) {
  const int smem = (int)sizeof(Smem<T, HD>);
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_kernel<T, HD>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  flash_prefill_kernel<T, HD><<<grid, THREADS, smem, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const int*)q_offset, (T*)out, S, NH, KV, Tk, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q, out: [B,S,NH,128] bf16; k, v: [B,Tt,KV,128] bf16; kv_valid, new_len: [B]
// int32 on the device.
int wf_flash_paged_prefill(const void* q, const void* k, const void* v, const void* kv_valid,
                           const void* new_len, void* out, int B, int S, int NH, int KV, int D,
                           int Tt, int hist_len, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D != 128 || NH % KV) return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem<__nv_bfloat16, 128>);
  cudaError_t e = cudaFuncSetAttribute(flash_paged_prefill_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((S + BQ - 1) / BQ, NH, B);
  flash_paged_prefill_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (const int*)kv_valid, (const int*)new_len, (__nv_bfloat16*)out, S, NH, KV, Tt, hist_len,
      scale);
  return cudaGetLastError();
}

// K9: q, out [B,S,NH,D]; k, v [B,T,KV,D], all contiguous and 16-byte aligned;
// f32 (is_f32 = 1) or bf16; D 64 or 128; q_offset: one int32 on the device.
int wf_flash_prefill(const void* q, const void* k, const void* v, const void* q_offset, void* out,
                     int B, int S, int NH, int KV, int D, int T, int is_f32, float scale,
                     void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || KV <= 0 || NH % KV) return cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_f32 && D == 128)
    return launch_k9<float, 128>(q, k, v, q_offset, out, B, S, NH, KV, T, scale, st);
  if (is_f32 && D == 64)
    return launch_k9<float, 64>(q, k, v, q_offset, out, B, S, NH, KV, T, scale, st);
  if (!is_f32 && D == 128)
    return launch_k9<__nv_bfloat16, 128>(q, k, v, q_offset, out, B, S, NH, KV, T, scale, st);
  if (!is_f32 && D == 64)
    return launch_k9<__nv_bfloat16, 64>(q, k, v, q_offset, out, B, S, NH, KV, T, scale, st);
  return cudaErrorInvalidValue;
}

}  // extern "C"

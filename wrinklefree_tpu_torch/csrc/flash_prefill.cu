// Paged-prefill flash attention (K4) for Hopper.
//
// Replaces wrinklefree_tpu/ops/flash_attention.py::flash_paged_prefill
// (kernel body _paged_flash_kernel): online-softmax GQA of a prefill chunk's
// queries q[B,S,NH,D] over keys [history(hist_len) ++ chunk(S)] given as
// k, v [B,Tt,KV,D] (Tt = hist_len + S). Per batch row: history key col is
// visible iff col < kv_valid; chunk key rel = col - hist_len is visible iff
// rel <= query row and rel < new_len. Masked scores are -1e30 (not -inf) and
// the divisor is max(l, 1e-30), so a fully masked padding row stays finite.
// q is scaled by 1/sqrt(D) in bf16 before the dot; scores and the running
// sums are f32; p is rounded to bf16 before the PV product (as in the TPU
// kernel).
//
// Design: one block (4 warps) per (64-row q tile, head, batch row); the kv
// head is h / (NH/KV). Key tiles of 64 go through shared memory; QK^T and PV
// run on the tensor cores through WMMA bf16 16x16x16 fragments with f32
// accumulation. The output accumulator lives in shared memory so each row
// can be rescaled by its online-softmax factor between tiles. Key tiles that
// lie wholly in the masked history (kv_valid..hist_len) or after the last
// visible chunk key are skipped.
//
// Bound: operations at 512-token chunks over long history (4*S*T*D flops per
// head); plain mma.sync/WMMA without TMA or warp specialisation reaches a
// fraction of the tensor-core peak. A wgmma/TMA pipeline is later work.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BQ = 64;   // q rows per block
constexpr int BK = 64;   // keys per tile
constexpr int HD = 128;  // head dim
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int LDH = HD + 8;   // bf16 row stride for Q/K/V tiles
constexpr int LDS = BK + 4;   // f32 row stride for scores
constexpr int LDP = BK + 8;   // bf16 row stride for probabilities
constexpr int LDO = HD + 4;   // f32 row stride for the output accumulator
constexpr float NEG = -1e30f;

struct Smem {
  __nv_bfloat16 q[BQ * LDH];
  __nv_bfloat16 k[BK * LDH];
  __nv_bfloat16 v[BK * LDH];
  float s[BQ * LDS];
  __nv_bfloat16 p[BQ * LDP];
  float o[BQ * LDO];
  float m[BQ];
  float l[BQ];
};

__global__ void __launch_bounds__(THREADS)
flash_paged_prefill_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const int* __restrict__ kv_valid, const int* __restrict__ new_len,
                           __nv_bfloat16* __restrict__ out, int S, int NH, int KV, int Tt,
                           int hist_len, float scale) {
  extern __shared__ __align__(128) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (NH / KV);
  const int s0 = qt * BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kvv = kv_valid[b];
  const int nl = new_len[b];
  const __nv_bfloat16 scale_b = __float2bfloat16_rn(scale);

  // Q tile, pre-scaled in bf16; rows beyond S are zero
  for (int i = threadIdx.x; i < BQ * (HD / 8); i += THREADS) {
    int row = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
    int s = s0 + row;
    __nv_bfloat16* dst = sm.q + row * LDH + c8;
    if (s < S) {
      const __nv_bfloat16* src = q + (((size_t)b * S + s) * NH + h) * HD + c8;
      uint4 raw16 = *reinterpret_cast<const uint4*>(src);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw16);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = __hmul(e[j], scale_b);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[j] = __float2bfloat16_rn(0.f);
    }
  }
  for (int i = threadIdx.x; i < BQ * LDO; i += THREADS) sm.o[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sm.m[i] = NEG;
    sm.l[i] = 0.f;
  }

  const int hist_end = min(kvv, hist_len);  // visible history keys
  const int cur_end = hist_len + min(s0 + BQ, nl);
  const int last_key = max(hist_end, cur_end);
  const int ntiles = min((last_key + BK - 1) / BK, (Tt + BK - 1) / BK);

  for (int t = 0; t < ntiles; ++t) {
    const int c0 = t * BK;
    if (c0 >= hist_end && c0 + BK <= hist_len) continue;  // wholly masked history
    __syncthreads();
    for (int i = threadIdx.x; i < BK * (HD / 8); i += THREADS) {
      int row = i / (HD / 8), c8 = (i % (HD / 8)) * 8;
      int key = c0 + row;
      uint4 kk = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (key < Tt) {
        size_t off = (((size_t)b * Tt + key) * KV + kvh) * HD + c8;
        kk = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(sm.k + row * LDH + c8) = kk;
      *reinterpret_cast<uint4*>(sm.v + row * LDH + c8) = vv;
    }
    __syncthreads();

    // scores for this warp's 16 rows: [16 x 64] = Q[16 x 128] K^T
    const int r0 = warp * 16;
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
    __syncwarp();

    // online softmax, one row at a time across the warp (2 columns per lane)
    for (int rr = 0; rr < 16; ++rr) {
      const int row = r0 + rr;
      const int srow = s0 + row;  // chunk-relative query row
      float sv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        int c = lane + 32 * u;
        int col = c0 + c;
        bool ok;
        if (col < hist_len) {
          ok = col < kvv;
        } else {
          int rel = col - hist_len;
          ok = rel <= srow && rel < nl;
        }
        sv[u] = ok ? sm.s[row * LDS + c] : NEG;
      }
      float mx = fmaxf(sv[0], sv[1]);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.m[row];
      const float m_new = fmaxf(m_old, mx);
      float p0 = expf(sv[0] - m_new), p1 = expf(sv[1] - m_new);
      float ps = p0 + p1;
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float alpha = expf(m_old - m_new);
      sm.p[row * LDP + lane] = __float2bfloat16_rn(p0);
      sm.p[row * LDP + lane + 32] = __float2bfloat16_rn(p1);
      for (int d = lane; d < HD; d += 32) sm.o[row * LDO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        sm.l[row] = sm.l[row] * alpha + ps;
        sm.m[row] = m_new;
      }
      __syncwarp();
    }

    // O[16 x 128] += P[16 x 64] V[64 x 128]
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
    __syncwarp();
  }
  __syncthreads();

  for (int i = threadIdx.x; i < BQ * HD; i += THREADS) {
    int row = i / HD, d = i % HD;
    int s = s0 + row;
    if (s < S) {
      float den = fmaxf(sm.l[row], 1e-30f);
      out[(((size_t)b * S + s) * NH + h) * HD + d] = __float2bfloat16_rn(sm.o[row * LDO + d] / den);
    }
  }
}

}  // namespace

extern "C" {

// q, out: [B,S,NH,128] bf16; k, v: [B,Tt,KV,128] bf16; kv_valid, new_len: [B]
// int32 on the device.
int wf_flash_paged_prefill(const void* q, const void* k, const void* v, const void* kv_valid,
                           const void* new_len, void* out, int B, int S, int NH, int KV, int D,
                           int Tt, int hist_len, float scale, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (D != HD || NH % KV) return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
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

}  // extern "C"

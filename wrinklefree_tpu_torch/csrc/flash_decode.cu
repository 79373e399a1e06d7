// Paged flash decode attention (K6) for Hopper.
//
// Replaces wrinklefree_tpu/ops/flash_attention.py::flash_paged_decode (kernel
// body _paged_decode_kernel): one decode query per slot, GQA over the slot's
// history read straight from the layer-major main pool [P, 2L, ps, KV*D]
// through the page table (no gathered copy of the history), then the slot's
// staging prefix and the current token. Per slot b with seq_lens[b] = n:
// the committed tokens are the first (n / ps) * ps, read from the main pool;
// the staging page holds the next n % ps; the current token's k/v come in as
// k_cur/v_cur. q is scaled by 1/sqrt(D) in bf16 before the dot; scores, the
// running max and sum are f32; masked scores are -1e30 and masked
// probabilities are forced to 0 (so a fully masked tile leaves the state
// unchanged); probabilities are rounded to bf16 before the PV product; the
// output is acc / max(l, 1e-30). As in the TPU kernel, the staging prefix
// and the current token form the last online-softmax update.
//
// Design: one block (4 warps) per (KV head, slot), holding that head's G
// query rows. Tiles of 64 tokens of K and V (16 KB each) are double-buffered
// in shared memory with cp.async, so the next tile's loads are in flight
// while this one is scored; a thread scores one token for half of the G
// query heads (the whole 128-dim dot in registers: summing each dot across
// a warp instead costs five dependent shuffles per head and token, which
// measured twice as slow), a warp per query head updates the online
// softmax, and a thread per dim accumulates PV for the G heads in registers.
//
// Bound: bytes (2 * n * KV * D * 2 per layer and slot). At 8 slots x 5 KV
// heads this is 40 blocks on 132 SMs; splitting the history over more blocks
// (and a combine) is later work.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;     // head dim
constexpr int TK = 64;      // tokens per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;  // = HD: one thread per dim in PV
constexpr int MAX_G = 8;    // query heads per KV head
constexpr float NEG = -1e30f;

constexpr int LDK = HD + 8;  // k row stride: 16-byte row loads of 8 lanes hit distinct banks

struct Smem {
  __nv_bfloat16 k[2][TK][LDK];
  __nv_bfloat16 v[2][TK][HD];
  float q[MAX_G][HD];
  float s[MAX_G][TK];  // scores, then the bf16-rounded probabilities
  float m[MAX_G], l[MAX_G], alpha[MAX_G];
};

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

struct Args {
  const __nv_bfloat16* q;      // [B, NH, D]
  const __nv_bfloat16* k_cur;  // [B, KV, D]
  const __nv_bfloat16* v_cur;
  const __nv_bfloat16* main;   // [P, 2L, ps, KV*D]
  const __nv_bfloat16* stage;  // [B, ps, 2L, KV*D]
  const int* page_table;       // [B, MP]
  const int* seq_lens;         // [B]
  __nv_bfloat16* out;          // [B, NH, D]
  int NH, KV, L, layer, ps, MP;
  float scale;
};

// Issue the copies of tile i (tokens i*TK.. of the committed history for
// i < ntm, else the staging prefix and the current token) into buffer buf;
// rows past the tile's valid tokens are zero.
__device__ void load_tile(const Args& a, Smem& sm, int buf, int i, int ntm, int full, int off,
                          int b, int kvh) {
  const size_t kvd = (size_t)a.KV * HD;
  for (int c = threadIdx.x; c < TK * (HD / 8); c += THREADS) {
    const int j = c / (HD / 8), part = (c % (HD / 8)) * 8;
    const __nv_bfloat16* ks = nullptr;
    const __nv_bfloat16* vs = nullptr;
    if (i < ntm) {
      const int t = i * TK + j;
      if (t < full) {
        const size_t page = (size_t)a.page_table[(size_t)b * a.MP + t / a.ps];
        const size_t o = t % a.ps;
        ks = a.main + ((page * 2 * a.L + a.layer) * a.ps + o) * kvd + kvh * HD;
        vs = a.main + ((page * 2 * a.L + a.L + a.layer) * a.ps + o) * kvd + kvh * HD;
      }
    } else if (j < off) {
      ks = a.stage + (((size_t)b * a.ps + j) * 2 * a.L + a.layer) * kvd + kvh * HD;
      vs = a.stage + (((size_t)b * a.ps + j) * 2 * a.L + a.L + a.layer) * kvd + kvh * HD;
    } else if (j == off) {
      ks = a.k_cur + ((size_t)b * a.KV + kvh) * HD;
      vs = a.v_cur + ((size_t)b * a.KV + kvh) * HD;
    }
    __nv_bfloat16* kd = &sm.k[buf][j][part];
    __nv_bfloat16* vd = &sm.v[buf][j][part];
    if (ks != nullptr) {
      __pipeline_memcpy_async(kd, ks + part, 16);
      __pipeline_memcpy_async(vd, vs + part, 16);
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
  __pipeline_commit();
}

__global__ void __launch_bounds__(THREADS) k6_decode(Args a) {
  extern __shared__ __align__(16) unsigned char raw[];
  Smem& sm = *reinterpret_cast<Smem*>(raw);
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int G = a.NH / a.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n_hist = max(a.seq_lens[b], 0);
  const int full = min((n_hist / a.ps) * a.ps, a.MP * a.ps);  // committed tokens
  const int off = n_hist % a.ps;  // staging tokens
  const int ntm = (full + TK - 1) / TK;
  const int ntiles = ntm + 1;

  const __nv_bfloat16 sb = __float2bfloat16_rn(a.scale);
  for (int i = threadIdx.x; i < G * HD; i += THREADS) {
    const int g = i / HD, d = i % HD;
    sm.q[g][d] = __bfloat162float(__hmul(a.q[((size_t)b * a.NH + kvh * G + g) * HD + d], sb));
  }
  if (threadIdx.x < MAX_G) {
    sm.m[threadIdx.x] = NEG;
    sm.l[threadIdx.x] = 0.f;
  }
  float acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g] = 0.f;

  load_tile(a, sm, 0, 0, ntm, full, off, b, kvh);
  for (int i = 0; i < ntiles; ++i) {
    const int buf = i & 1;
    if (i + 1 < ntiles) {
      load_tile(a, sm, buf ^ 1, i + 1, ntm, full, off, b, kvh);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int n = i < ntm ? min(TK, full - i * TK) : off + 1;  // valid tokens

    // scores: a thread per (token, half of the heads), the whole 128-dim dot
    // in registers (16-byte k loads; the q reads are warp broadcasts)
    {
      const int j = threadIdx.x % TK, gh = threadIdx.x / TK;
      float s[MAX_G / 2];
#pragma unroll
      for (int gi = 0; gi < MAX_G / 2; ++gi) s[gi] = 0.f;
#pragma unroll 4
      for (int d0 = 0; d0 < HD; d0 += 8) {
        const uint4 raw8 = *reinterpret_cast<const uint4*>(&sm.k[buf][j][d0]);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw8);
        float kf[8];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 f = __bfloat1622float2(k2[e]);
          kf[2 * e] = f.x;
          kf[2 * e + 1] = f.y;
        }
#pragma unroll
        for (int gi = 0; gi < MAX_G / 2; ++gi) {
          const int g = gh + 2 * gi;
          if (g < G) {
            const float4 qa = *reinterpret_cast<const float4*>(&sm.q[g][d0]);
            const float4 qb = *reinterpret_cast<const float4*>(&sm.q[g][d0 + 4]);
            s[gi] += qa.x * kf[0] + qa.y * kf[1] + qa.z * kf[2] + qa.w * kf[3] +
                     qb.x * kf[4] + qb.y * kf[5] + qb.z * kf[6] + qb.w * kf[7];
          }
        }
      }
#pragma unroll
      for (int gi = 0; gi < MAX_G / 2; ++gi) {
        const int g = gh + 2 * gi;
        if (g < G) sm.s[g][j] = j < n ? s[gi] : NEG;
      }
    }
    __syncthreads();

    // online softmax: a warp per query head, two tokens per lane
    for (int g = warp; g < G; g += WARPS) {
      const bool ok0 = lane < n, ok1 = lane + 32 < n;
      const float s0 = sm.s[g][lane], s1 = sm.s[g][lane + 32];
      float mx = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = sm.m[g];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      float psum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      sm.s[g][lane] = bf16r(p0);
      sm.s[g][lane + 32] = bf16r(p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sm.l[g] = sm.l[g] * alpha + psum;
        sm.m[g] = m_new;
        sm.alpha[g] = alpha;
      }
    }
    __syncthreads();

    // PV: a thread per dim, the G heads in registers
    const int d = threadIdx.x;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) acc[g] *= sm.alpha[g];
    for (int j = 0; j < n; ++j) {
      const float v = __bfloat162float(sm.v[buf][j][d]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) acc[g] += sm.s[g][j] * v;
    }
    __syncthreads();
  }

  const int d = threadIdx.x;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G)
      a.out[((size_t)b * a.NH + kvh * G + g) * HD + d] =
          __float2bfloat16_rn(acc[g] / fmaxf(sm.l[g], 1e-30f));
}

}  // namespace

extern "C" {

// out [B,NH,128] = paged decode attention of layer `layer`; q [B,NH,128],
// k_cur/v_cur [B,KV,128], main [P,2L,ps,KV*128], staging_b [B,ps,2L,KV*128]
// bf16; page_table [B,MP], seq_lens [B] int32 on the device.
int wf_flash_paged_decode(const void* q, const void* k_cur, const void* v_cur, const void* main,
                          const void* staging_b, const void* page_table, const void* seq_lens,
                          void* out, int B, int NH, int KV, int L, int layer, int ps, int MP,
                          int D, float scale, void* stream) {
  if (B <= 0) return 0;
  if (D != HD || KV <= 0 || NH % KV || NH / KV > MAX_G || ps <= 0 || ps > TK || MP <= 0 ||
      layer < 0 || layer >= L)
    return cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t e =
      cudaFuncSetAttribute(k6_decode, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  Args a{(const __nv_bfloat16*)q,          (const __nv_bfloat16*)k_cur,
         (const __nv_bfloat16*)v_cur,      (const __nv_bfloat16*)main,
         (const __nv_bfloat16*)staging_b,  (const int*)page_table,
         (const int*)seq_lens,             (__nv_bfloat16*)out,
         NH, KV, L, layer, ps, MP, scale};
  k6_decode<<<dim3(KV, B), THREADS, smem, (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

}  // extern "C"

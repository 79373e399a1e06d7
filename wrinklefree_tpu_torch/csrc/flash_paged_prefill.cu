// Paged-prefill flash attention (K4) for Hopper.
//
// Replaces wrinklefree_tpu/ops/flash_attention.py::flash_paged_prefill
// (kernel body _paged_flash_kernel): online-softmax GQA of a prefill chunk's
// queries q [B,S,NH,D] over [history ++ chunk]. Per batch row b, history key
// t is visible iff t < n_h (the row's valid history); chunk key rel is
// visible to query row s iff rel <= s and rel < new_len[b]. Two key sources
// share one tile loop:
// - contiguous k, v [B,Tt,KV,D] (wf_flash_paged_prefill, the reference's
//   signature): history = columns 0..hist_len-1 with n_h = kv_valid[b],
//   chunk = columns hist_len..hist_len+S-1;
// - the layer-major pool (wf_flash_paged_prefill_pool): history token t of
//   row b is main[page_table[b, t / ps], layer (k) or L + layer (v), t % ps]
//   with n_h = seq_lens[b], read in the kernel without a gathered copy; the
//   chunk's keys are k_cur, v_cur [B,S,KV,D].
// The TPU kernel's rounding points are kept: q is scaled by 1/sqrt(D) in
// bf16; scores, the running max and sum are f32; masked scores are -1e30;
// probabilities are rounded to bf16 against the running max before PV; the
// output is acc / max(l, 1e-30) in bf16, so a fully masked row stays finite.
//
// Bound: operations (4*D flops per visible query-key pair per head: 3.3
// GFLOP at a 512-token chunk over 400 history keys for 2B's 20 heads, about
// 3.4 us at the bf16 tensor-core peak, against 11 MB of q, k, v and output).
// What the design does about it:
// - One block per (q tile of BQ tokens, KV head, batch row) feeds all G
//   query heads of the KV head: each K/V tile lands in shared memory once
//   for G*BQ query rows. Warp w owns 16 consecutive tokens of one query head
//   (G*BQ/16 warps, 4-8; BQ from G alone, flash_attention.py::
//   flash_prefill_bq). Blocks are ordered longest q tile first.
// - Everything in registers, on mma.sync m16n8k16 bf16 -> f32: a warp's
//   scaled Q fragments are read once by ldmatrix and kept; scores are Q (A)
//   times K rows (B, ldmatrix); the row max and sum are quad shuffles over
//   the score accumulators; the bf16 probabilities are the PV product's A
//   fragments straight from the score accumulators' layout; V comes by
//   ldmatrix.trans as B; the 16 x 128 f32 output accumulator stays in
//   registers and is rescaled there (skipped when no row's max moved).
// - A two-stage ring of 64-key K/V tiles (32 KB a stage) on one mbarrier
//   per stage, filled while the other stage is computed: warps 0-3 each
//   load one 16-row group of a tile, by copy-engine boxes of 16 rows x 64
//   dims (128-byte swizzle: ldmatrix without bank conflicts) where all 16
//   rows are valid and lie in one page, else row by row with 16-byte
//   cp.async. Rows past the valid keys are zero-filled and never read from
//   memory (a stale NaN times a zero probability would be NaN). One block
//   barrier per tile frees its stage.
// - Masks only where needed (the history's last tile, the chunk's tiles
//   that reach the diagonal or new_len); a warp skips the chunk tiles above
//   its rows' diagonal. The products are exact in f32; only the order of
//   the f32 sums differs from the plain version.
// What bounds it on the H100 (timed variants, PERF.md section 6): each warp's
// chain of dependent instructions per tile (about 800, 128 of them mma),
// not the copies (hidden behind the compute) and not the tensor cores'
// rate: twice the warps per SM run in the same time.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() or the launch's error.

#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int HD = 128;              // head dim
constexpr int TK = 64;               // keys per tile
constexpr int STAGES = 2;
constexpr int LOADERS = 4;           // warps that load a tile: one 16-row group each
constexpr int MAX_WARPS = 8;
constexpr int BOX = 16 * 128;        // bytes of a copy-engine box: 16 rows x 64 dims
constexpr int GROUP = 2 * BOX;       // 16 rows x 128 dims
constexpr int TILE = 4 * GROUP;      // 64 rows: 16 KB
constexpr int STAGE = 2 * TILE;      // K then V
constexpr int RING = STAGES * STAGE;  // 64 KB
constexpr int SMEM = RING + MAX_WARPS * GROUP + 1024;  // and each warp's Q; 1 KB alignment
constexpr float NEG = -1e30f;

struct Args {
  const __nv_bfloat16* q;  // [B, S, NH, D]
  __nv_bfloat16* out;      // [B, S, NH, D]
  const __nv_bfloat16* hk;  // history rows [*, KV*D]: k, v (the pool: both)
  const __nv_bfloat16* hv;
  const __nv_bfloat16* ck;  // chunk rows [*, KV*D]
  const __nv_bfloat16* cv;
  const int* hist_valid;   // [B] kv_valid or seq_lens
  const int* new_len;      // [B]
  const int* page_table;   // [B, MP] (pool only)
  int S, NH, KV, G, BQ;
  int hist_cap;            // history keys a row can hold: hist_len or MP * ps
  long long hist_bstride;  // contiguous: history row of (b, t) = b * hist_bstride + t
  long long cur_bstride;   // chunk row of (b, rel) = b * cur_bstride + cur_off + rel
  long long cur_off;
  int paged, L, layer, ps, MP;
  int hist_boxes;          // history groups may come by box (contiguous, or ps % 16 == 0)
  float scale;
};

// Row of history key t (v: 0 for k, 1 for v) or chunk key t in its [*, KV*D]
// array; `page` is the page of t when the caller has it (paged), else -1.
__device__ __forceinline__ long long row_of(const Args& a, bool hist, int v, int b, int t,
                                            int page) {
  if (!hist) return b * a.cur_bstride + a.cur_off + t;
  if (!a.paged) return b * a.hist_bstride + t;
  if (page < 0) page = __ldg(a.page_table + (size_t)b * a.MP + t / a.ps);
  return ((long long)page * 2 * a.L + v * a.L + a.layer) * a.ps + t % a.ps;
}

struct Maps {
  CUtensorMap hk, hv, ck, cv;
};

// Issue the copies of group `warp` (rows 16*warp..+15) of tile i (history
// tiles, then chunk tiles) into `stage`, completing on bar, which expects
// one arrival from each lane of the LOADERS warps. A group whose 16 rows are
// valid and lie in one page comes by four copy-engine boxes (k and v, two
// 64-dim halves); otherwise lane j < 16 copies k row j and lane 16 + j v row
// j with cp.async, and rows past the n valid keys are zero. `pg`: lane k
// holds the page of this group's rows in history tile k (paged, k < 32).
__device__ __forceinline__ void issue(const Args& a, const Maps& maps, char* stage,
                                      uint64_t* bar, int i, int nth, int n_h, int n_c, int b,
                                      int kvh, int warp, int lane, int pg) {
  const bool hist = i < nth;
  const int t0 = (hist ? i * TK : (i - nth) * TK) + 16 * warp;  // the group's first key
  const int nv = min(16, (hist ? n_h : n_c) - t0);
  char* kd = stage + warp * GROUP;
  char* vd = stage + TILE + warp * GROUP;
  if (nv == 16 && (!hist || a.hist_boxes)) {
    int page = -1;
    if (hist && a.paged) {
      page = __shfl_sync(0xffffffffu, pg, i & 31);
      if (i >= 32) page = __ldg(a.page_table + (size_t)b * a.MP + t0 / a.ps);
    }
    if (lane == 0)
      mbar_expect_tx(bar, 4 * BOX);
    else
      mbar_arrive(bar);
    __syncwarp();
    if (lane < 4) {
      const int v = lane >> 1, h = lane & 1;
      const CUtensorMap* map = hist ? (v ? &maps.hv : &maps.hk) : (v ? &maps.cv : &maps.ck);
      tma_load((v ? vd : kd) + h * BOX, map, kvh * HD + h * 64,
               (int)row_of(a, hist, v, b, t0, page), bar);
    }
    return;
  }
  const int j = lane & 15, v = lane >> 4;
  char* dst = v ? vd : kd;
  if (j < nv) {
    const __nv_bfloat16* base = hist ? (v ? a.hv : a.hk) : (v ? a.cv : a.ck);
    const __nv_bfloat16* src =
        base + row_of(a, hist, v, b, t0 + j, -1) * ((long long)a.KV * HD) + kvh * HD;
#pragma unroll
    for (int c = 0; c < HD / 8; ++c) cp_async16(dst + swz(j, c), src + 8 * c);
    cp_async_arrive_noinc(bar);
  } else {
#pragma unroll
    for (int c = 0; c < HD / 8; ++c)
      *reinterpret_cast<uint4*>(dst + swz(j, c)) = make_uint4(0, 0, 0, 0);
    fence_proxy_async();  // before the copy engine's later writes to the row
    mbar_arrive(bar);
  }
}

// Grid (KV, q tiles, B), G*BQ/16 warps, one per 16 tokens of one query head.
// maps: the history and chunk arrays as rows of KV*D bf16 in boxes of 16
// rows x 64 dims, 128-byte swizzle.
__global__ void __launch_bounds__(MAX_WARPS * 32)
    k4_prefill(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ unsigned char raw[];
  // the ring [STAGES][k, v][4 groups][GROUP], then each warp's Q rows, all
  // 1024-byte aligned for the swizzle
  char* ring = reinterpret_cast<char*>(raw) + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  __shared__ uint64_t full[STAGES];  // a stage's copies are in
  // the longest q tiles of every KV head first
  const int kvh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, t4 = lane & 3;
  const int nsub = a.BQ / 16;
  const int h = kvh * a.G + warp / nsub;            // this warp's query head
  const int s0 = qt * a.BQ;
  const int sw = s0 + (warp % nsub) * 16;           // and its first query row
  const int n_h = min(max(a.hist_valid[b], 0), a.hist_cap);
  const int nl = min(max(a.new_len[b], 0), a.S);
  const int n_c = min(nl, s0 + a.BQ);               // chunk keys the q tile sees
  const int nth = (n_h + TK - 1) / TK;
  const int nt = nth + (n_c + TK - 1) / TK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], LOADERS * 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  // lane k of a loading warp holds the page of its group in history tile k
  int pg = -1;
  if (warp < LOADERS) {
    if (lane == 0) {
      if (a.hist_boxes) prefetch_map(&maps.hk);
      prefetch_map(&maps.ck);
    }
    const int t = lane * TK + 16 * warp;
    if (a.paged && a.hist_boxes && lane < nth && t < n_h)
      pg = __ldg(a.page_table + (size_t)b * a.MP + t / a.ps);
    for (int s = 0; s < STAGES && s < nt; ++s)
      issue(a, maps, ring + s * STAGE, &full[s], s, nth, n_h, n_c, b, kvh, warp, lane, pg);
  }

  // this warp's 16 query rows, scaled in bf16 (zero past S), as the A
  // fragments of the score product's 8 k-steps
  char* qw = ring + RING + warp * GROUP;
  {
    const __nv_bfloat162 sc = __bfloat162bfloat162(__float2bfloat16_rn(a.scale));
    for (int idx = lane; idx < 16 * (HD / 8); idx += 32) {
      const int r = idx / (HD / 8), c = idx % (HD / 8), s = sw + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (s < a.S) {
        x = *reinterpret_cast<const uint4*>(a.q + (((size_t)b * a.S + s) * a.NH + h) * HD + 8 * c);
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int u = 0; u < 4; ++u) e[u] = __hmul2(e[u], sc);
      }
      *reinterpret_cast<uint4*>(qw + swz(r, c)) = x;
    }
  }
  __syncwarp();
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) ldmatrix_x4(qf[k], qw + swz(lane & 15, 2 * k + (lane >> 4)));
  // this lane's ldmatrix row offsets in a 16-row group: K rows as B (dim
  // chunks 2u + bit 3 of the lane), V rows transposed (chunks 2u + bit 4);
  // dims 64.. are one box further
  int koff[4], voff[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    koff[u] = swz((lane & 7) + ((lane >> 4) << 3), 2 * u + ((lane >> 3) & 1));
    voff[u] = swz((lane & 7) + (((lane >> 3) & 1) << 3), 2 * u + (lane >> 4));
  }

  // rows sw + gid ([0], [1] of each accumulator) and sw + 8 + gid ([2], [3]);
  // o[n] holds dims 8n + 2t4, +1; l over this lane's columns until the end
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const bool rows = sw < a.S;  // the warp has query rows

  for (int i = 0; i < nt; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const bool hist = i < nth;
    const int c0 = hist ? i * TK : (i - nth) * TK;
    const int lim = (hist ? n_h : nl) - c0;  // the tile's keys from lim on are not valid
    if (rows && (hist || c0 <= sw + 15)) {  // some row of the warp sees a key of the tile
      const char* kt = ring + st * STAGE;
      const char* vt = kt + TILE;
      float s[TK / 8][4];
#pragma unroll
      for (int n = 0; n < TK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int k = 0; k < HD / 16; ++k) {
#pragma unroll
        for (int j = 0; j < TK / 16; ++j) {
          uint32_t kb[4];
          ldmatrix_x4(kb, kt + j * GROUP + (k >> 2) * BOX + koff[k & 3]);
          mma_bf16(s[2 * j], qf[k], kb[0], kb[1]);
          mma_bf16(s[2 * j + 1], qf[k], kb[2], kb[3]);
        }
      }
      // masks: the history's last tile, chunk tiles at the diagonal or new_len
      if (lim < TK || (!hist && c0 + TK - 1 > sw)) {
#pragma unroll
        for (int n = 0; n < TK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = 8 * n + 2 * t4 + (e & 1);
            const int row = sw + gid + 8 * (e >> 1);
            if (!(col < lim && (hist || c0 + col <= row))) s[n][e] = NEG;
          }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG;
#pragma unroll
        for (int n = 0; n < TK / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
      // the probabilities, rounded to bf16, as the PV product's A fragments:
      // k-step kk covers keys 16kk.. (score tiles 2kk and 2kk + 1)
      uint32_t pa[TK / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < TK / 8; ++n) {
        const float p0 = expf(s[n][0] - m[0]), p1 = expf(s[n][1] - m[0]);
        const float p2 = expf(s[n][2] - m[1]), p3 = expf(s[n][3] - m[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
        pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
      }
      l[0] = l[0] * alpha[0] + rs[0];
      l[1] = l[1] * alpha[1] + rs[1];
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row's max moved
#pragma unroll
        for (int n = 0; n < HD / 8; ++n) {
          o[n][0] *= alpha[0];
          o[n][1] *= alpha[0];
          o[n][2] *= alpha[1];
          o[n][3] *= alpha[1];
        }
      }
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < HD / 16; ++jj) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vt + kk * GROUP + (jj >> 2) * BOX + voff[jj & 3]);
          mma_bf16(o[2 * jj], pa[kk], vb[0], vb[1]);
          mma_bf16(o[2 * jj + 1], pa[kk], vb[2], vb[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with stage st
    if (warp < LOADERS && i + STAGES < nt)
      issue(a, maps, ring + st * STAGE, &full[st], i + STAGES, nth, n_h, n_c, b, kvh, warp, lane,
            pg);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }

  if (!rows) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = sw + gid + 8 * r;
    if (s >= a.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = a.out + (((size_t)b * a.S + s) * a.NH + h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
}

cudaError_t launch(const Maps& maps, const Args& a, int B, void* stream) {
  static bool smem_set = false;  // raised once per process
  cudaError_t e;
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(k4_prefill, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM)) != cudaSuccess)
      return e;
    smem_set = true;
  }
  const int warps = a.G * a.BQ / 16;
  const dim3 grid(a.KV, (a.S + a.BQ - 1) / a.BQ, B);
  k4_prefill<<<grid, warps * 32, RING + warps * GROUP + 1024, (cudaStream_t)stream>>>(maps, a);
  return cudaGetLastError();
}

// The shapes the kernel takes: D 128, G = NH / KV <= 8, BQ a multiple of 16
// with 4-8 warps.
bool shapes_ok(int NH, int KV, int D, int bq) {
  if (D != HD || KV <= 0 || NH % KV || NH / KV > 8 || bq <= 0 || bq % 16) return false;
  const int warps = NH / KV * bq / 16;
  return warps >= LOADERS && warps <= MAX_WARPS;
}

}  // namespace

extern "C" {

// Contiguous keys. q, out: [B,S,NH,128] bf16; k, v: [B,Tt,KV,128] bf16 with
// history columns 0..hist_len-1 and the chunk at hist_len..hist_len+S-1;
// kv_valid, new_len: [B] int32 on the device. bq: query tokens per block.
int wf_flash_paged_prefill(const void* q, const void* k, const void* v, const void* kv_valid,
                           const void* new_len, void* out, int B, int S, int NH, int KV, int D,
                           int Tt, int hist_len, float scale, int bq, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (!shapes_ok(NH, KV, D, bq) || hist_len < 0 || hist_len + S > Tt)
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  cudaError_t e;
  const long long rows = (long long)B * Tt;
  if ((e = rows_map(&maps.hk, k, rows, KV * HD)) != cudaSuccess ||
      (e = rows_map(&maps.hv, v, rows, KV * HD)) != cudaSuccess)
    return e;
  maps.ck = maps.hk;
  maps.cv = maps.hv;
  Args a{(const __nv_bfloat16*)q, (__nv_bfloat16*)out, (const __nv_bfloat16*)k,
         (const __nv_bfloat16*)v, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
         (const int*)kv_valid, (const int*)new_len, nullptr, S, NH, KV, NH / KV, bq, hist_len,
         Tt, Tt, hist_len, 0, 0, 0, 1, 1, 1, scale};
  return launch(maps, a, B, stream);
}

// Keys from the pool. q, out: [B,S,NH,128]; k_cur, v_cur: [B,S,KV,128];
// main: [P,2L,ps,KV*128], all bf16; page_table [B,MP], seq_lens, new_len [B]
// int32 on the device.
int wf_flash_paged_prefill_pool(const void* q, const void* k_cur, const void* v_cur,
                                const void* main, const void* page_table, const void* seq_lens,
                                const void* new_len, void* out, int B, int S, int NH, int KV,
                                int D, int L, int layer, int ps, int MP, int P, float scale,
                                int bq, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (!shapes_ok(NH, KV, D, bq) || ps <= 0 || ps > TK || MP <= 0 || P <= 0 || layer < 0 ||
      layer >= L)
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  cudaError_t e;
  const int boxes = ps % 16 == 0;  // a group of 16 history rows lies in one page
  if (boxes && (e = rows_map(&maps.hk, main, (long long)P * 2 * L * ps, KV * HD)) != cudaSuccess)
    return e;
  maps.hv = maps.hk;
  if ((e = rows_map(&maps.ck, k_cur, (long long)B * S, KV * HD)) != cudaSuccess ||
      (e = rows_map(&maps.cv, v_cur, (long long)B * S, KV * HD)) != cudaSuccess)
    return e;
  Args a{(const __nv_bfloat16*)q, (__nv_bfloat16*)out, (const __nv_bfloat16*)main,
         (const __nv_bfloat16*)main, (const __nv_bfloat16*)k_cur, (const __nv_bfloat16*)v_cur,
         (const int*)seq_lens, (const int*)new_len, (const int*)page_table, S, NH, KV, NH / KV,
         bq, MP * ps, 0, S, 0, 1, L, layer, ps, MP, boxes, scale};
  return launch(maps, a, B, stream);
}

}  // extern "C"

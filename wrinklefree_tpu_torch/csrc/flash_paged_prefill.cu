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
// fp16 and f32 pools (k4_wide<T>, the reference's kernel on an fp16 pool and
// at HIGHEST precision on an f32 one): the same function, masks and rounding
// points in the pool's type T (q, the chunk's keys and the output are T too:
// q scaled by 1/sqrt(D) in T, probabilities rounded to T before PV), on
// register-blocked f32 FMAs. The product of two fp16 or two f32 values is
// exact in f32 (the tensor cores take f32 only as TF32, which would truncate
// it), so again only the order of the f32 sums differs from the plain
// version. Warp w owns 8 tokens of one query head (G * BQ / 8 warps, BQ from
// flash_attention.py::flash_prefill_wide_bq, at most 64 rows a block); lane
// (rg, kg) = (lane / 16, lane % 16) holds the scores of rows 4rg..4rg+3 of
// the warp against keys kg + 16j (j < 4) and their output at dims 4kg + 64u
// (u < 2), +3. Q, scaled, stays in shared memory as f32; a two-slot ring
// streams K of tile i, then V of tile i (64 rows a slot, padded by 16 bytes
// so that the lanes' 16-byte reads of 8 rows miss each other), by 16-byte
// cp.async, filled while the other slot is computed, with zeros for the rows
// past the valid keys (never read from memory); the probabilities go through
// shared memory transposed (P^T) to the PV product.
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

struct Args {  // the arrays hold the pool's type: bf16, fp16 or f32
  const void* q;           // [B, S, NH, D]
  void* out;               // [B, S, NH, D]
  const void* hk;          // history rows [*, KV*D]: k, v (the pool: both)
  const void* hv;
  const void* ck;          // chunk rows [*, KV*D]
  const void* cv;
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
    const __nv_bfloat16* base =
        static_cast<const __nv_bfloat16*>(hist ? (v ? a.hv : a.hk) : (v ? a.cv : a.ck));
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
        x = *reinterpret_cast<const uint4*>(static_cast<const __nv_bfloat16*>(a.q) +
                                            (((size_t)b * a.S + s) * a.NH + h) * HD + 8 * c);
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
    __nv_bfloat16* dst =
        static_cast<__nv_bfloat16*>(a.out) + (((size_t)b * a.S + s) * a.NH + h) * HD + 2 * t4;
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

// ---------------------------------------------------- fp16 and f32 ----

template <typename T>
struct Wide {
  static constexpr int LDK = HD + 16 / sizeof(T);  // elements a staged row: 16 bytes of padding
  static constexpr int SLOT = TK * LDK;            // 64 rows of K or V
  static constexpr int LDQ = HD + 4;               // floats a Q row
  static constexpr int MAX_ROWS = 64;
  // the ring, Q and P^T ([64 keys][rows + 4]) for `rows` query rows
  static constexpr int smem(int rows) {
    return 2 * SLOT * (int)sizeof(T) + (rows * LDQ + TK * (rows + 4)) * 4;
  }
};

// Grid (KV, q tiles, B), G*BQ/8 warps, one per 8 tokens of one query head.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32) k4_wide(Args a) {
  using W = Wide<T>;
  constexpr int PER = 16 / sizeof(T);   // elements a 16-byte copy
  constexpr int PIECES = HD / PER;      // copies a row
  extern __shared__ float4 wide_raw[];
  T* ring = reinterpret_cast<T*>(wide_raw);  // [2][64][LDK]: chunk c in slot c % 2
  const int nrows = a.G * a.BQ, LDP = nrows + 4;
  float* qs = reinterpret_cast<float*>(ring + 2 * W::SLOT);  // [nrows][LDQ], scaled
  float* pt = qs + nrows * W::LDQ;                           // P^T [64][LDP]
  const int kvh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rg = lane >> 4, kg = lane & 15;
  const int h = kvh * a.G + warp * 8 / a.BQ;  // this warp's query head
  const int s0 = qt * a.BQ;
  const int sw = s0 + warp * 8 % a.BQ;        // and its first query row
  const int r0 = warp * 8 + rg * 4;           // this lane's first row of the block
  const bool rows = sw < a.S;
  const int n_h = min(max(a.hist_valid[b], 0), a.hist_cap);
  const int nl = min(max(a.new_len[b], 0), a.S);
  const int n_c = min(nl, s0 + a.BQ);  // chunk keys the q tile sees
  const int nth = (n_h + TK - 1) / TK;
  const int nt = nth + (n_c + TK - 1) / TK;

  // chunk c: K (c even) or V of tile c / 2 (history tiles, then chunk tiles)
  auto fetch = [&](int c) {
    const int i = c >> 1, v = c & 1;
    const bool hist = i < nth;
    const int t0 = hist ? i * TK : (i - nth) * TK;
    const int nv = min(TK, (hist ? n_h : n_c) - t0);
    const T* base = static_cast<const T*>(hist ? (v ? a.hv : a.hk) : (v ? a.cv : a.ck));
    T* dst = ring + (c & 1) * W::SLOT;
    for (int idx = threadIdx.x; idx < TK * PIECES; idx += blockDim.x) {
      const int r = idx / PIECES, p = idx % PIECES;
      T* d = dst + r * W::LDK + p * PER;
      if (r < nv)
        cp_async16(d, base + row_of(a, hist, v, b, t0 + r, -1) * ((long long)a.KV * HD) +
                          kvh * HD + p * PER);
      else
        *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
  if (nt > 0) fetch(0);
  {
    const float sc = to_f(from_f<T>(a.scale));
    const T* q = static_cast<const T*>(a.q);
    for (int idx = threadIdx.x; idx < nrows * HD; idx += blockDim.x) {
      const int r = idx / HD, d = idx % HD, s = s0 + r % a.BQ;
      float x = 0.f;
      if (s < a.S)
        x = to_f(from_f<T>(
            to_f(q[(((size_t)b * a.S + s) * a.NH + kvh * a.G + r / a.BQ) * HD + d]) * sc));
      qs[r * W::LDQ + d] = x;
    }
  }

  // rows r0 + i (i < 4); o[i][4u + e] at dim 4kg + 64u + e
  float o[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
  float m[4] = {NEG, NEG, NEG, NEG}, l[4] = {0.f, 0.f, 0.f, 0.f};

  for (int c = 0; c < 2 * nt; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c (and Q) is in; every warp is done with chunk c - 1
    if (c + 1 < 2 * nt) fetch(c + 1);
    const int i = c >> 1;
    const bool hist = i < nth;
    const int c0 = hist ? i * TK : (i - nth) * TK;
    if (!rows || (!hist && c0 > sw + 7)) continue;  // no row of the warp sees a key of the tile
    const T* kv = ring + (c & 1) * W::SLOT;
    if ((c & 1) == 0) {
      // scores of rows r0.. against keys c0 + kg + 16j
      float s[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r) s[r][0] = s[r][1] = s[r][2] = s[r][3] = 0.f;
#pragma unroll 2
      for (int d = 0; d < HD; d += 8) {
        float kk[4][8];
#pragma unroll
        for (int j = 0; j < 4; ++j) ld8(kv + (kg + 16 * j) * W::LDK + d, kk[j]);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float qv[8];
          ld8(qs + (r0 + r) * W::LDQ + d, qv);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 8; ++e) s[r][j] = fmaf(qv[e], kk[j][e], s[r][j]);
        }
      }
      const int lim = (hist ? n_h : nl) - c0;  // the tile's keys from lim on are not valid
      if (lim < TK || (!hist && c0 + TK - 1 > sw)) {
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = kg + 16 * j;
            if (!(col < lim && (hist || c0 + col <= sw + rg * 4 + r))) s[r][j] = NEG;
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float mx = fmaxf(fmaxf(s[r][0], s[r][1]), fmaxf(s[r][2], s[r][3]));
#pragma unroll
        for (int x = 1; x < 16; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = expf(m[r] - m_new);
        m[r] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = expf(s[r][j] - m_new);
          rs += p;
          s[r][j] = to_f(from_f<T>(p));  // rounded to T for PV; l sums the f32 values
        }
        l[r] = l[r] * alpha + rs;
        if (alpha != 1.f) {  // the row's max moved
#pragma unroll
          for (int e = 0; e < 8; ++e) o[r][e] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(pt + (kg + 16 * j) * LDP + r0) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncwarp();
    } else {
      // o += P V over the tile's 64 keys
#pragma unroll 4
      for (int t = 0; t < TK; ++t) {
        const float4 p = *reinterpret_cast<const float4*>(pt + t * LDP + r0);
        const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          float w[4];
          ld4(kv + t * W::LDK + 4 * kg + 64 * u, w);
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[r][4 * u + e] = fmaf(pr[r], w[e], o[r][4 * u + e]);
        }
      }
      __syncwarp();  // before the next tile's probabilities overwrite P^T
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int x = 1; x < 16; x <<= 1) l[r] += __shfl_xor_sync(0xffffffffu, l[r], x);
  if (!rows) return;
  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int s = sw + rg * 4 + r;
    if (s >= a.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    T* dst = out + (((size_t)b * a.S + s) * a.NH + h) * HD + 4 * kg;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) dst[64 * u + e] = from_f<T>(o[r][4 * u + e] / den);
  }
}

template <typename T>
cudaError_t launch_wide(const Args& a, int B, void* stream) {
  static bool smem_set = false;  // raised once per process and type
  cudaError_t e;
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(k4_wide<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  Wide<T>::smem(Wide<T>::MAX_ROWS))) != cudaSuccess)
      return e;
    smem_set = true;
  }
  const int rows = a.G * a.BQ;
  const dim3 grid(a.KV, (a.S + a.BQ - 1) / a.BQ, B);
  k4_wide<T><<<grid, rows / 8 * 32, Wide<T>::smem(rows), (cudaStream_t)stream>>>(a);
  return cudaGetLastError();
}

// Launch for the pool's type: bf16 through the tensor maps, fp16 and f32 on FMAs.
cudaError_t launch_elem(const Maps& maps, const Args& a, int B, int elem, void* stream) {
  if (elem == ELEM_F16) return launch_wide<__half>(a, B, stream);
  if (elem == ELEM_F32) return launch_wide<float>(a, B, stream);
  return launch(maps, a, B, stream);
}

// The shapes the kernel takes: D 128, G = NH / KV <= 8; bf16: BQ a multiple
// of 16 with 4-8 warps; fp16 and f32: BQ a multiple of 8, at most 64 rows.
bool shapes_ok(int NH, int KV, int D, int bq, int elem) {
  if (D != HD || KV <= 0 || NH % KV || NH / KV > 8 || bq <= 0) return false;
  if (elem == ELEM_F16 || elem == ELEM_F32) return bq % 8 == 0 && NH / KV * bq <= 64;
  if (elem != ELEM_BF16 || bq % 16) return false;
  const int warps = NH / KV * bq / 16;
  return warps >= LOADERS && warps <= MAX_WARPS;
}

}  // namespace

extern "C" {

// Contiguous keys. q, out: [B,S,NH,128]; k, v: [B,Tt,KV,128] with history
// columns 0..hist_len-1 and the chunk at hist_len..hist_len+S-1, all of the
// type `elem` (ELEM_BF16, ELEM_F16 or ELEM_F32); kv_valid, new_len: [B]
// int32 on the device. bq: query tokens per block.
int wf_flash_paged_prefill(const void* q, const void* k, const void* v, const void* kv_valid,
                           const void* new_len, void* out, int B, int S, int NH, int KV, int D,
                           int Tt, int hist_len, float scale, int bq, int elem, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (!shapes_ok(NH, KV, D, bq, elem) || hist_len < 0 || hist_len + S > Tt)
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  cudaError_t e;
  const long long rows = (long long)B * Tt;
  if (elem == ELEM_BF16 && ((e = rows_map(&maps.hk, k, rows, KV * HD)) != cudaSuccess ||
                            (e = rows_map(&maps.hv, v, rows, KV * HD)) != cudaSuccess))
    return e;
  maps.ck = maps.hk;
  maps.cv = maps.hv;
  Args a{q, out, k, v, k, v, (const int*)kv_valid, (const int*)new_len, nullptr, S, NH, KV,
         NH / KV, bq, hist_len, Tt, Tt, hist_len, 0, 0, 0, 1, 1, 1, scale};
  return launch_elem(maps, a, B, elem, stream);
}

// Keys from the pool. q, out: [B,S,NH,128]; k_cur, v_cur: [B,S,KV,128];
// main: [P,2L,ps,KV*128], all of the type `elem`; page_table [B,MP],
// seq_lens, new_len [B] int32 on the device.
int wf_flash_paged_prefill_pool(const void* q, const void* k_cur, const void* v_cur,
                                const void* main, const void* page_table, const void* seq_lens,
                                const void* new_len, void* out, int B, int S, int NH, int KV,
                                int D, int L, int layer, int ps, int MP, int P, float scale,
                                int bq, int elem, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (!shapes_ok(NH, KV, D, bq, elem) || ps <= 0 || ps > TK || MP <= 0 || P <= 0 ||
      layer < 0 || layer >= L)
    return cudaErrorInvalidValue;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  cudaError_t e;
  const int boxes = ps % 16 == 0;  // a group of 16 history rows lies in one page
  if (elem == ELEM_BF16) {
    if (boxes &&
        (e = rows_map(&maps.hk, main, (long long)P * 2 * L * ps, KV * HD)) != cudaSuccess)
      return e;
    maps.hv = maps.hk;
    if ((e = rows_map(&maps.ck, k_cur, (long long)B * S, KV * HD)) != cudaSuccess ||
        (e = rows_map(&maps.cv, v_cur, (long long)B * S, KV * HD)) != cudaSuccess)
      return e;
  }
  Args a{q, out, main, main, k_cur, v_cur, (const int*)seq_lens, (const int*)new_len,
         (const int*)page_table, S, NH, KV, NH / KV, bq, MP * ps, 0, S, 0, 1, L, layer, ps, MP,
         boxes, scale};
  return launch_elem(maps, a, B, elem, stream);
}

}  // extern "C"

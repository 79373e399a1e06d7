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
// q, the keys, the values and the output share the pool's type: bf16 or
// fp16 (k4_prefill<T>), or f32 (k4_prefill_f32, below), all on the tensor
// cores. The TPU kernel's rounding points are kept: q is scaled by
// 1/sqrt(D) in T; scores, the running max and sum are f32; masked scores are
// -1e30; probabilities are rounded to T against the running max before PV
// (in fp16 those below 2^-14 as subnormals, as the plain version's cast
// keeps them); the output is acc / max(l, 1e-30) in T, so a fully masked row
// stays finite.
//
// Bound: operations (4*D flops per visible query-key pair per head: 3.3
// GFLOP at a 512-token chunk over 400 history keys for 2B's 20 heads, about
// 3.4 us at the bf16 and fp16 tensor-core peak, against 11 MB of q, k, v and
// output).
// What the design does about it:
// - One block per (q tile of BQ tokens, KV head, batch row) feeds all G
//   query heads of the KV head: each K/V tile lands in shared memory once
//   for G*BQ query rows. Warp w owns 16 consecutive tokens of one query head
//   (G*BQ/16 warps, 4-8; BQ from G alone, flash_attention.py::
//   flash_prefill_bq). Blocks are ordered longest q tile first.
// - Everything in registers, on mma.sync m16n8k16 bf16 or fp16 -> f32 (the
//   product of two values of either type is exact in f32): a warp's
//   scaled Q fragments are read once by ldmatrix and kept; scores are Q (A)
//   times K rows (B, ldmatrix); the row max and sum are quad shuffles over
//   the score accumulators; the rounded probabilities are the PV product's A
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
// fp16 pools take this kernel as it stands, instantiated on __half: the same
// ring, warps, ldmatrix layout and shared memory, f16 mma for both products,
// the probabilities packed to fp16, the tensor maps of fp16 rows (the copy
// engine moves the same bytes as for bf16).
//
// f32 pools (k4_prefill_f32; the reference's kernel at HIGHEST precision):
// the same function, masks, blocks (flash_prefill_bq), warps and rounding
// points, the probabilities kept in f32. The tensor cores take f32 only as
// TF32 (10 mantissa bits), one pass of which moves the output by about
// 5e-4, 25 times the f32 bar (2e-5). So each f32 operand goes in as two
// TF32 pieces, hi + lo (sm90.cuh::split2), and each product as hi*hi +
// hi*lo + lo*hi on mma.sync m16n8k8 TF32 -> f32 (3xTF32; the dropped lo*lo
// is below 2^-20 of it): 6x bf16's mma per key, at half their rate per
// operation. Bound: those operations at a third of the TF32 rate; what
// holds it at several times that bound is each warp's chain per tile (its
// 384 mma and the splits of every K and V element it reads, which every
// warp of the block repeats; PERF.md section 6). The layout:
// - Scores: Q (A, 16 rows x 8 dims a k-step) times K^T (B). A warp's
//   scaled Q rows are split once: the hi pieces stay in 64 registers as A
//   fragments, the lo pieces go to the warp's 8 KB of shared memory (the
//   swizzled layout of a K group) and come back by ldmatrix each tile; K
//   rows come by ldmatrix (an 8 x 16-byte matrix of f32 rows is a B
//   fragment) and are split in registers. q hi x k hi accumulates in one
//   chain, the two cross products in another (48 products a score).
// - PV: the score accumulators' layout (a lane holds keys 2t4, 2t4 + 1)
//   is the A fragment of the k-step that takes key 8j + 2t4 as column t4
//   and 8j + 2t4 + 1 as column t4 + 4; V's B fragments are then those two
//   rows at dims 16p + 2gid and + 1 (one 8-byte load each), for the two
//   n-tiles of the even and odd dims of 16p..16p+15. P and V are split in
//   registers.
// - The output: each tile's 12 PV products of a 16-dim slice go into a
//   fresh accumulator, added to the running output in f32. The tensor
//   cores' f32 sums drift: one sum over the whole history moved the output
//   by 8.3e-6 at 8192 keys, and by 9.4e-5 (past the 2e-5 bar) at 8192 keys
//   with q and k of 2 units (PERF.md section 6).
// - A two-stage ring of 32-key tiles (32 KB a stage, K then V) on one
//   mbarrier per stage and one block barrier per tile: warps 0-3 load a
//   quarter each (the K or V rows of one 16-key group), by four copy-engine
//   boxes of 16 rows x 32 dims (128-byte swizzle, so ldmatrix and the V
//   loads are free of bank conflicts) where all 16 rows are valid and lie
//   in one page, else row by row with cp.async, zeros past the valid keys.
//   64 KB of ring and 8 KB a warp: two blocks of 4 warps an SM, at 255
//   registers (8 bytes spilled; ptxas, PERF.md section 6).
// The tiles are 32 keys, not 64, so that the ring and the Q lo pieces fit
// twice in an SM; the masks and the block order are k4_prefill's.
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
    const uint16_t* base =  // bf16 or fp16: 2-byte elements, copied as bytes
        static_cast<const uint16_t*>(hist ? (v ? a.hv : a.hk) : (v ? a.cv : a.ck));
    const uint16_t* src =
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
// T: the 16-bit type of q, the keys, the values and the output (bf16 or
// fp16). maps: the history and chunk arrays as rows of KV*D T in boxes of 16
// rows x 64 dims, 128-byte swizzle.
template <typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    k4_prefill(const __grid_constant__ Maps maps, Args a) {
  using Ops = F16Ops<T>;
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

  // this warp's 16 query rows, scaled in T (zero past S), as the A
  // fragments of the score product's 8 k-steps
  char* qw = ring + RING + warp * GROUP;
  {
    for (int idx = lane; idx < 16 * (HD / 8); idx += 32) {
      const int r = idx / (HD / 8), c = idx % (HD / 8), s = sw + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (s < a.S) {
        x = *reinterpret_cast<const uint4*>(static_cast<const T*>(a.q) +
                                            (((size_t)b * a.S + s) * a.NH + h) * HD + 8 * c);
        x.x = Ops::scale(x.x, a.scale);
        x.y = Ops::scale(x.y, a.scale);
        x.z = Ops::scale(x.z, a.scale);
        x.w = Ops::scale(x.w, a.scale);
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
          Ops::mma(s[2 * j], qf[k], kb[0], kb[1]);
          Ops::mma(s[2 * j + 1], qf[k], kb[2], kb[3]);
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
      // the probabilities, rounded to T, as the PV product's A fragments:
      // k-step kk covers keys 16kk.. (score tiles 2kk and 2kk + 1)
      uint32_t pa[TK / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < TK / 8; ++n) {
        const float p0 = expf(s[n][0] - m[0]), p1 = expf(s[n][1] - m[0]);
        const float p2 = expf(s[n][2] - m[1]), p3 = expf(s[n][3] - m[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[n >> 1][(n & 1) * 2] = Ops::pack(p0, p1);
        pa[n >> 1][(n & 1) * 2 + 1] = Ops::pack(p2, p3);
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
          Ops::mma(o[2 * jj], pa[kk], vb[0], vb[1]);
          Ops::mma(o[2 * jj + 1], pa[kk], vb[2], vb[3]);
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
    T* dst = static_cast<T*>(a.out) + (((size_t)b * a.S + s) * a.NH + h) * HD + 2 * t4;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + 8 * n) =
          Ops::pack(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
}

template <typename T>
cudaError_t launch(const Maps& maps, const Args& a, int B, void* stream) {
  static bool smem_set = false;  // raised once per process and type
  cudaError_t e;
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(k4_prefill<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEM)) != cudaSuccess)
      return e;
    smem_set = true;
  }
  const int warps = a.G * a.BQ / 16;
  const dim3 grid(a.KV, (a.S + a.BQ - 1) / a.BQ, B);
  k4_prefill<T><<<grid, warps * 32, RING + warps * GROUP + 1024, (cudaStream_t)stream>>>(maps, a);
  return cudaGetLastError();
}

// ------------------------------------------------------------- f32 ----

constexpr int TKF = 32;              // keys per f32 tile
constexpr int BOXF = 16 * 128;       // a copy-engine box: 16 rows x 32 f32 dims
constexpr int GROUPF = 4 * BOXF;     // 16 rows x 128 dims: 8 KB
constexpr int TILEF = 2 * GROUPF;    // 32 rows: 16 KB
constexpr int STAGEF = 2 * TILEF;    // K then V
constexpr int RINGF = STAGES * STAGEF;  // 64 KB
constexpr int SMEMF = RINGF + MAX_WARPS * GROUPF + 1024;  // and each warp's Q lo pieces

// Issue the copies of a quarter of f32 tile i (history tiles, then chunk
// tiles) into `stage`: loading warp w < 4 takes the K (w < 2) or V rows
// 16 * (w & 1)..+15, completing on bar, which expects one arrival from each
// lane of the 4 loaders. A quarter whose 16 rows are valid and lie in one
// page comes by four copy-engine boxes of 32 dims; otherwise lane j < 16
// copies dims 0..63 and lane 16 + j dims 64..127 of row j with cp.async, and
// rows past the n valid keys are zero. `pg`: lane k holds the page of this
// quarter's rows in history tile k (paged, k < 32).
__device__ __forceinline__ void issue_f32(const Args& a, const Maps& maps, char* stage,
                                          uint64_t* bar, int i, int nth, int n_h, int n_c, int b,
                                          int kvh, int warp, int lane, int pg) {
  const bool hist = i < nth;
  const int v = warp >> 1, grp = warp & 1;
  const int t0 = (hist ? i * TKF : (i - nth) * TKF) + 16 * grp;  // the quarter's first key
  const int nv = min(16, (hist ? n_h : n_c) - t0);
  char* dst = stage + v * TILEF + grp * GROUPF;
  if (nv == 16 && (!hist || a.hist_boxes)) {
    int page = -1;
    if (hist && a.paged) {
      page = __shfl_sync(0xffffffffu, pg, i & 31);
      if (i >= 32) page = __ldg(a.page_table + (size_t)b * a.MP + t0 / a.ps);
    }
    if (lane == 0)
      mbar_expect_tx(bar, 4 * BOXF);
    else
      mbar_arrive(bar);
    __syncwarp();
    if (lane < 4) {
      const CUtensorMap* map = hist ? (v ? &maps.hv : &maps.hk) : (v ? &maps.cv : &maps.ck);
      tma_load(dst + lane * BOXF, map, kvh * HD + 32 * lane, (int)row_of(a, hist, v, b, t0, page),
               bar);
    }
    return;
  }
  const int j = lane & 15, h = lane >> 4;
  if (j < nv) {
    const float* src = static_cast<const float*>(hist ? (v ? a.hv : a.hk) : (v ? a.cv : a.ck)) +
                       row_of(a, hist, v, b, t0 + j, -1) * ((long long)a.KV * HD) + kvh * HD;
#pragma unroll
    for (int c = 16 * h; c < 16 * h + 16; ++c) cp_async16(dst + swz(j, c), src + 4 * c);
    cp_async_arrive_noinc(bar);
  } else {
#pragma unroll
    for (int c = 16 * h; c < 16 * h + 16; ++c)
      *reinterpret_cast<uint4*>(dst + swz(j, c)) = make_uint4(0, 0, 0, 0);
    fence_proxy_async();  // before the copy engine's later writes to the row
    mbar_arrive(bar);
  }
}

// Grid (KV, q tiles, B), G*BQ/16 warps, one per 16 tokens of one query head,
// as k4_prefill, over 32-key tiles of f32 rows. maps: the history and chunk
// arrays as rows of KV*D f32 in boxes of 16 rows x 32 dims, 128-byte swizzle.
__global__ void __launch_bounds__(MAX_WARPS * 32)
    k4_prefill_f32(const __grid_constant__ Maps maps, Args a) {
  extern __shared__ unsigned char raw[];
  // the ring [STAGES][k, v][2 groups][GROUPF], then each warp's Q lo pieces,
  // all 1024-byte aligned for the swizzle
  char* ring = reinterpret_cast<char*>(raw) + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  __shared__ uint64_t full[STAGES];  // a stage's copies are in
  const int kvh = blockIdx.x, qt = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, t4 = lane & 3;
  const int nsub = a.BQ / 16;
  const int h = kvh * a.G + warp / nsub;            // this warp's query head
  const int s0 = qt * a.BQ;
  const int sw = s0 + (warp % nsub) * 16;           // and its first query row
  const int n_h = min(max(a.hist_valid[b], 0), a.hist_cap);
  const int nl = min(max(a.new_len[b], 0), a.S);
  const int n_c = min(nl, s0 + a.BQ);               // chunk keys the q tile sees
  const int nth = (n_h + TKF - 1) / TKF;
  const int nt = nth + (n_c + TKF - 1) / TKF;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], LOADERS * 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  int pg = -1;
  if (warp < LOADERS) {
    if (lane == 0) {
      if (a.hist_boxes) prefetch_map(warp >> 1 ? &maps.hv : &maps.hk);
      prefetch_map(warp >> 1 ? &maps.cv : &maps.ck);
    }
    const int t = lane * TKF + 16 * (warp & 1);
    if (a.paged && a.hist_boxes && lane < nth && t < n_h)
      pg = __ldg(a.page_table + (size_t)b * a.MP + t / a.ps);
    for (int s = 0; s < STAGES && s < nt; ++s)
      issue_f32(a, maps, ring + s * STAGEF, &full[s], s, nth, n_h, n_c, b, kvh, warp, lane, pg);
  }

  // this warp's 16 query rows scaled in f32 (zero past S) as the A
  // fragments of the score product's 16 k-steps of 8 dims: register e holds
  // row gid + 8 (e & 1), dim 8k + t4 + 4 (e >> 1). The hi pieces stay in
  // registers, the lo pieces go to shared memory (the layout of a K group),
  // read back by ldmatrix each tile.
  char* ql = ring + RINGF + warp * GROUPF;
  float qh[HD / 8][4];
  {
    const float* qb = static_cast<const float*>(a.q) + (size_t)b * a.S * a.NH * HD + h * HD;
#pragma unroll
    for (int k = 0; k < HD / 8; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + 8 * (e & 1), d = 8 * k + t4 + 4 * (e >> 1), s = sw + r;
        const float x = s < a.S ? qb[(size_t)s * a.NH * HD + d] * a.scale : 0.f;
        float lo;
        split2(x, qh[k][e], lo);
        *reinterpret_cast<float*>(ql + swz(r, d >> 2) + 4 * (d & 3)) = lo;
      }
  }
  __syncwarp();

  // rows sw + gid ([0], [1] of each accumulator) and sw + 8 + gid ([2],
  // [3]); o[2p] holds dims 16p + 4t4 and + 2, o[2p + 1] dims 16p + 4t4 + 1
  // and + 3 (the PV product's n-tiles take the even and odd dims of 16p..)
  float o[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  const bool rows = sw < a.S;  // the warp has query rows

  for (int i = 0; i < nt; ++i) {
    const int st = i % STAGES;
    mbar_wait(&full[st], (i / STAGES) & 1);
    const bool hist = i < nth;
    const int c0 = hist ? i * TKF : (i - nth) * TKF;
    const int lim = (hist ? n_h : nl) - c0;  // the tile's keys from lim on are not valid
    if (rows && (hist || c0 <= sw + 15)) {  // some row of the warp sees a key of the tile
      const char* kt = ring + st * STAGEF;
      const char* vt = kt + TILEF;
      // scores against keys 8n + 2t4, +1 (3xTF32): q hi x k hi in s, the
      // cross products in sx; 48 products a key, whatever the history
      float s[TKF / 8][4], sx[TKF / 8][4];
#pragma unroll
      for (int n = 0; n < TKF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = sx[n][e] = 0.f;
#pragma unroll
      for (int p = 0; p < HD / 16; ++p) {  // k-steps 2p and 2p + 1: dims 16p..16p+15
        uint32_t q0[4], q1[4];
        ldmatrix_x4(q0, ql + swz((lane & 7) + 8 * ((lane >> 3) & 1), 4 * p + (lane >> 4)));
        ldmatrix_x4(q1, ql + swz((lane & 7) + 8 * ((lane >> 3) & 1), 4 * p + 2 + (lane >> 4)));
#pragma unroll
        for (int n = 0; n < TKF / 8; ++n) {
          // keys 8n + gid: dims 16p + t4 (+ 4, + 8, + 12) as the B fragments
          // of the two k-steps
          uint32_t kb[4];
          const int kr = 8 * n + (lane & 7);
          ldmatrix_x4(kb, kt + (kr >> 4) * GROUPF + swz(kr & 15, 4 * p + (lane >> 3)));
          float kh[4], kl[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) split2(__uint_as_float(kb[e]), kh[e], kl[e]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float(&qa)[4] = qh[2 * p + u];
            const uint32_t* qo = u ? q1 : q0;
            mma_tf32(s[n], qa[0], qa[1], qa[2], qa[3], kh[2 * u], kh[2 * u + 1]);
            mma_tf32(sx[n], qa[0], qa[1], qa[2], qa[3], kl[2 * u], kl[2 * u + 1]);
            mma_tf32(sx[n], __uint_as_float(qo[0]), __uint_as_float(qo[1]),
                     __uint_as_float(qo[2]), __uint_as_float(qo[3]), kh[2 * u], kh[2 * u + 1]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < TKF / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] += sx[n][e];
      // masks: the history's last tile, chunk tiles at the diagonal or new_len
      if (lim < TKF || (!hist && c0 + TKF - 1 > sw)) {
#pragma unroll
        for (int n = 0; n < TKF / 8; ++n)
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
        for (int n = 0; n < TKF / 8; ++n) mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = expf(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < TKF / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[0] += s[n][0] + s[n][1];
        rs[1] += s[n][2] + s[n][3];
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
      // o += P V (3xTF32), k-step j over keys 8j..8j+7 in the order of the
      // score accumulators: column t4 is key 8j + 2t4, column t4 + 4 key
      // 8j + 2t4 + 1, so the f32 probabilities are the A fragments where
      // they lie, and V's B fragments are those two rows of the tile
      float ph[TKF / 8][4], pl[TKF / 8][4];
#pragma unroll
      for (int j = 0; j < TKF / 8; ++j) {
        split2(s[j][0], ph[j][0], pl[j][0]);
        split2(s[j][2], ph[j][1], pl[j][1]);
        split2(s[j][1], ph[j][2], pl[j][2]);
        split2(s[j][3], ph[j][3], pl[j][3]);
      }
#pragma unroll
      for (int p = 0; p < HD / 16; ++p) {
        // the tile's products for dims 16p + 2gid (n-tile 2p) and + 1 (2p +
        // 1), small ones first, in fresh accumulators added to o in f32: no
        // tensor-core sum runs over more than one tile
        float t[2][4];
        const int c = 4 * p + (gid >> 1), off = 8 * (gid & 1);
#pragma unroll
        for (int j = 0; j < TKF / 8; ++j) {
          const int r = 8 * j + 2 * t4;  // keys r and r + 1: one 16-row group
          const char* vg = vt + (r >> 4) * GROUPF;
          const float2 v0 = *reinterpret_cast<const float2*>(vg + swz(r & 15, c) + off);
          const float2 v1 = *reinterpret_cast<const float2*>(vg + swz((r & 15) + 1, c) + off);
          float vh[4], vl[4];
          split2(v0.x, vh[0], vl[0]);
          split2(v1.x, vh[1], vl[1]);
          split2(v0.y, vh[2], vl[2]);
          split2(v1.y, vh[3], vl[3]);
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            if (j == 0)
              mma_tf32_first(t[u], pl[j][0], pl[j][1], pl[j][2], pl[j][3], vh[2 * u],
                             vh[2 * u + 1]);
            else
              mma_tf32(t[u], pl[j][0], pl[j][1], pl[j][2], pl[j][3], vh[2 * u], vh[2 * u + 1]);
            mma_tf32(t[u], ph[j][0], ph[j][1], ph[j][2], ph[j][3], vl[2 * u], vl[2 * u + 1]);
            mma_tf32(t[u], ph[j][0], ph[j][1], ph[j][2], ph[j][3], vh[2 * u], vh[2 * u + 1]);
          }
        }
#pragma unroll
        for (int u = 0; u < 2; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[2 * p + u][e] += t[u][e];
      }
    }
    __syncthreads();  // every warp is done with stage st
    if (warp < LOADERS && i + STAGES < nt)
      issue_f32(a, maps, ring + st * STAGEF, &full[st], i + STAGES, nth, n_h, n_c, b, kvh, warp,
                lane, pg);
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
    float* dst = static_cast<float*>(a.out) + (((size_t)b * a.S + s) * a.NH + h) * HD + 4 * t4;
#pragma unroll
    for (int p = 0; p < HD / 16; ++p)
      *reinterpret_cast<float4*>(dst + 16 * p) =
          make_float4(o[2 * p][2 * r] / den, o[2 * p + 1][2 * r] / den,
                      o[2 * p][2 * r + 1] / den, o[2 * p + 1][2 * r + 1] / den);
  }
}

cudaError_t launch_f32(const Maps& maps, const Args& a, int B, void* stream) {
  static bool smem_set = false;  // raised once per process
  cudaError_t e;
  if (!smem_set) {
    if ((e = cudaFuncSetAttribute(k4_prefill_f32, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  SMEMF)) != cudaSuccess)
      return e;
    smem_set = true;
  }
  const int warps = a.G * a.BQ / 16;
  const dim3 grid(a.KV, (a.S + a.BQ - 1) / a.BQ, B);
  k4_prefill_f32<<<grid, warps * 32, RINGF + warps * GROUPF + 1024, (cudaStream_t)stream>>>(maps,
                                                                                          a);
  return cudaGetLastError();
}

// Launch for the pool's type, every one on the tensor cores through the
// tensor maps.
cudaError_t launch_elem(const Maps& maps, const Args& a, int B, int elem, void* stream) {
  if (elem == ELEM_F16) return launch<__half>(maps, a, B, stream);
  if (elem == ELEM_F32) return launch_f32(maps, a, B, stream);
  return launch<__nv_bfloat16>(maps, a, B, stream);
}

// The shapes the kernel takes: D 128, G = NH / KV <= 8, BQ a multiple of 16
// with 4-8 warps, on a bf16, fp16 or f32 pool.
bool shapes_ok(int NH, int KV, int D, int bq, int elem) {
  if (D != HD || KV <= 0 || NH % KV || NH / KV > 8 || bq <= 0 || bq % 16) return false;
  if (elem != ELEM_BF16 && elem != ELEM_F16 && elem != ELEM_F32) return false;
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
  if ((e = rows_map(&maps.hk, k, rows, KV * HD, elem)) != cudaSuccess ||
      (e = rows_map(&maps.hv, v, rows, KV * HD, elem)) != cudaSuccess)
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
  if (boxes &&
      (e = rows_map(&maps.hk, main, (long long)P * 2 * L * ps, KV * HD, elem)) != cudaSuccess)
    return e;
  maps.hv = maps.hk;
  if ((e = rows_map(&maps.ck, k_cur, (long long)B * S, KV * HD, elem)) != cudaSuccess ||
      (e = rows_map(&maps.cv, v_cur, (long long)B * S, KV * HD, elem)) != cudaSuccess)
    return e;
  Args a{q, out, main, main, k_cur, v_cur, (const int*)seq_lens, (const int*)new_len,
         (const int*)page_table, S, NH, KV, NH / KV, bq, MP * ps, 0, S, 0, 1, L, layer, ps, MP,
         boxes, scale};
  return launch_elem(maps, a, B, elem, stream);
}

}  // extern "C"

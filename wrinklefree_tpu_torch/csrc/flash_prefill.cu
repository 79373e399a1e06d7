// Causal flash prefill (K9) for Hopper.
//
// K9 replaces wrinklefree_tpu/ops/flash_attention.py::flash_prefill (kernel
// body _flash_kernel): causal GQA of q[B,S,NH,D] over contiguous k, v
// [B,T,KV,D]; query row s sees key t iff t <= q_offset + s (and t < T). bf16
// and f32, head dim 64 or 128, any G = NH/KV. (The paged prefill, K4, is
// flash_paged_prefill.cu.)
//
// It keeps the TPU kernel's rounding points: q is scaled by 1/sqrt(D) in the
// input type before the dot; scores, the running max and sum are f32; masked
// scores are -1e30 (not -inf); p = exp(s - m) is cast to v's type against
// the running max after each 64-key tile counted from key 0; the output is
// acc / max(l, 1e-30) cast to q's type. The plain version with 64-key blocks
// (flash_attention.py::flash_prefill_plain(..., block_k=64)) has the same
// running maxima; only the order of the f32 sums differs.
//
// Bound: operations (4*D flops per visible query-key pair and query head:
// 1.34 GFLOP at BitNet-2B's 20/5 heads of 128, S 512 over T 512, about 1.4
// us at the bf16 tensor-core peak and 20 us at the f32 FMA peak, against
// 5.2 MB of q, k, v and output in bf16). What the design does about it:
// - One block per (q tile, KV head, batch row) feeds all G query heads of
//   the KV head (groups of at most 8 heads a block in bf16, 4 in f32, where
//   G is larger): each K/V tile is staged once for every query row of the
//   group. The block shape comes from G alone
//   (flash_attention.py::causal_prefill_block). Blocks run longest q tile
//   first; warps skip the tiles above their rows' diagonal.
// - A two-stage ring in shared memory on one mbarrier a stage, filled by
//   copy-engine boxes of 64 keys x 128 bytes (a 3-D tensor map [B, T, KV *
//   D]: keys from T on arrive as zeros, so a stale NaN is never read) while
//   the other stage is computed; one block barrier a stage frees it. The
//   boxes' requests are shared over the warps: each takes its issuing thread
//   hundreds of cycles (PERF.md section 6).
// - bf16 (k9_bf16), K4's loop on mma.sync m16n8k16 bf16 -> f32: a group of
//   16 consecutive tokens of one query head; its scaled Q fragments read
//   once by ldmatrix and kept in registers; scores Q (A) times K rows (B,
//   ldmatrix, 128-byte swizzle); the row max and sum quad shuffles over the
//   accumulators; the bf16 probabilities the PV product's A fragments
//   straight from the score layout; V by ldmatrix.trans; the f32 output
//   accumulator in registers. A warp's chain of dependent instructions per
//   tile bounds it, and the causal grid's longest q tiles wait on it, so up
//   to 4 heads (4 groups) two warps share a group: each scores half of the
//   tile's keys, the pair exchanges its row maxima and then its
//   probabilities through shared memory, and each accumulates half of the
//   output dims over all 64 keys.
// - f32 (k9_f32), register-blocked FMAs (the tensor cores take f32 only as
//   TF32, and the f32 reference holds the result to 2e-5): warp w owns 8
//   consecutive tokens of one query head; lane (rg, kg) = (lane / 16, lane %
//   16) holds the scores of rows 4rg..4rg+3 against keys kg + 16j (j < 4)
//   and the output of the same rows at dims 4kg + 64u..+3. Q, scaled, stays
//   in shared memory for the whole launch (rows padded to D + 4 floats:
//   conflict-free 16-byte reads); the ring streams K of tile i, then V of
//   tile i, each 64 keys in boxes of 32 dims (128-byte swizzle: the lanes'
//   16-byte reads miss each other); the probabilities go to shared memory
//   transposed (P^T) for the PV product. At most 32 query rows a block: 91
//   KB of shared memory at D 128, two blocks an SM.
//
// Launches on the caller's stream, allocates nothing, sets each kernel's
// shared-memory limit once per process and returns the launch's error.

#include <string.h>

#include "sm90.cuh"

namespace {

constexpr int TK = 64;  // keys per tile
constexpr float NEG = -1e30f;

struct Args {
  const void* q;  // [B, S, NH, D]
  const void* k;  // [B, T, KV, D]
  const void* v;
  void* out;      // [B, S, NH, D]
  const int* qoff_dev;  // q_offset on the device, or null: then qoff
  int qoff;
  int S, NH, KV, T;
  int G;   // query heads per KV head
  int GB;  // query heads per block
  int NG;  // blocks per KV head and q tile: ceil(G / GB)
  int BQ;  // query tokens per block
  float scale;
};

// The block's coordinates: KV head, head group, q tile (longest first), batch
// row, and the number of 64-key tiles its rows see.
struct Block {
  int kvh, grp, s0, b, qoff, nt;
  __device__ Block(const Args& a) {
    kvh = blockIdx.x / a.NG;
    grp = blockIdx.x % a.NG;
    s0 = (gridDim.y - 1 - blockIdx.y) * a.BQ;
    b = blockIdx.z;
    qoff = a.qoff_dev ? *a.qoff_dev : a.qoff;
    const int last = min(a.T, qoff + min(s0 + a.BQ, a.S));  // keys up to the diagonal
    nt = last > 0 ? (last + TK - 1) / TK : 0;
  }
};

struct Maps {  // k and v [B, T, KV * D] in boxes of 64 keys x 128 bytes, 128-byte swizzle
  CUtensorMap k, v;
};

// ---------------------------------------------------------------- bf16 ----

template <int HD>
struct Bf16 {
  static constexpr int HALF = TK * 128;         // 64 keys x 64 dims: one copy-engine box
  static constexpr int NBOX = 2 * HD / 64;      // boxes a tile
  static constexpr int TILE = HD / 64 * HALF;   // 64 keys: [D / 64][64][128 bytes], swizzled
  static constexpr int STAGE = 2 * TILE;        // K then V
  static constexpr int STAGES = 2;              // tiles in the ring
  static constexpr int QROWS = HD / 64 * 2048;  // a warp's 16 query rows: [D / 64][16][128 bytes]
  static constexpr int XW = 12 * 32;            // exchange words a warp: 2 maxima, 2 sums, 8 P
  static constexpr int SMEM = STAGES * STAGE + 8 * XW * 4 + 1024;  // 1 KB for the alignment
};

// Issue tile t (keys 64t..64t+63 of KV head kvh) into `stage`: lane 0 of warp
// w copies boxes w, w + nwarps, .. of the tile's K then V boxes (keys from T
// on arrive as zeros), each completing on bar, which expects one arrival a
// box. A copy-engine request holds its issuing thread for hundreds of
// cycles, so the warps share them.
template <int HD>
__device__ __forceinline__ void issue_bf16(const Maps& maps, char* stage, uint64_t* bar,
                                           const Block& bl, int t, int warp, int nwarps,
                                           int lane) {
  using L = Bf16<HD>;
  if (lane != 0) return;
  for (int bx = warp; bx < L::NBOX; bx += nwarps) {
    const int v = bx / (HD / 64), hh = bx % (HD / 64);
    mbar_expect_tx(bar, L::HALF);
    tma_load3(stage + v * L::TILE + hh * L::HALF, v ? &maps.v : &maps.k, bl.kvh * HD + hh * 64,
              t * TK, bl.b, bar);
  }
}

// s = Q K^T for a warp's 16 query rows (A fragments qf) against NK keys of
// a tile from kt ([D / 64][64 keys][128 bytes], swizzled; K rows as B
// fragments by ldmatrix at this lane's offsets koff).
template <int HD, int NK>
__device__ __forceinline__ void qk_tile(float (&s)[NK / 8][4], const uint32_t (&qf)[HD / 16][4],
                                        const char* kt, const int (&koff)[4]) {
#pragma unroll
  for (int n = 0; n < NK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
#pragma unroll
    for (int j = 0; j < NK / 16; ++j) {
      uint32_t kb[4];
      ldmatrix_x4(kb, kt + j * 2048 + (k >> 2) * Bf16<HD>::HALF + koff[k & 3]);
      mma_bf16(s[2 * j], qf[k], kb[0], kb[1]);
      mma_bf16(s[2 * j + 1], qf[k], kb[2], kb[3]);
    }
  }
}

// A measurement build for bench/causal_prefill.py --stamps, off in the port:
// with WF_K9_STAMPS, thread 0 of the bf16 kernel's block (0, 0, 0) (the
// longest q tile of KV head 0) counts its launches in k9_stamps[0] and its
// tiles in [1], and adds the cycles of each step of a tile into [2..8] (the
// tile's wait and the block barrier, the copy requests, the scores and
// their row maxima, the pair's exchange of the maxima, the probabilities
// and their exchange, PV, the rest of the loop), until wf_k9_stamps reads
// and clears them.
#ifdef WF_K9_STAMPS
__device__ unsigned long long k9_stamps[9];
#define WF_K9_STAMP(i)                         \
  if (stamper) {                               \
    const long long now = clock64();           \
    k9_stamps[i] += now - stamp_t;             \
    stamp_t = now;                             \
  }
#else
#define WF_K9_STAMP(i)
#endif

// the two warps (64 threads) of one 16-row group meet at barrier `id`
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("bar.sync %0, 64;" ::"r"(id) : "memory");
}

// Grid (KV * NG, q tiles, B); R = GB * BQ / 16 groups of 16 rows (16
// tokens of one head), each served by KS warps (KS * R <= 8). With KS = 2
// warp hk of a group scores keys 32hk..32hk+31 of each tile and accumulates
// output dims hk * D / 2..: the pair exchanges its row maxima, then its
// probabilities (the PV product's A fragments), through shared memory.
template <int HD, int KS>
__global__ void __launch_bounds__(256, KS) k9_bf16(const __grid_constant__ Maps maps, Args a) {
  using L = Bf16<HD>;
  constexpr int NK = TK / KS;   // keys of a tile this warp scores
  constexpr int ND = HD / KS;   // output dims this warp accumulates
  constexpr int PK = NK / 16;   // its PV k-steps
  extern __shared__ unsigned char raw[];
  // the ring [STAGES][k, v][D / 64][64 keys][128 bytes], 1024-byte aligned for the
  // swizzle, then each warp's exchange words
  char* ring = reinterpret_cast<char*>(raw) + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  uint32_t* xch = reinterpret_cast<uint32_t*>(ring + L::STAGES * L::STAGE);
  __shared__ uint64_t full[L::STAGES];  // a stage's copies are in
  const Block bl(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, t4 = lane & 3;
  const int R = blockDim.x / (32 * KS);
  const int grp16 = warp % R, hk = warp / R;    // this warp's 16-row group and key half
  const int nsub = a.BQ / 16;
  const int hg = bl.grp * a.GB + grp16 / nsub;  // its query head in the KV head's group
  const int h = bl.kvh * a.G + hg;
  const int sw = bl.s0 + (grp16 % nsub) * 16;   // and its first token
  const bool rows = hg < a.G && sw < a.S;       // the warp has query rows
  const int wlast = bl.qoff + min(sw + 15, a.S - 1);  // the last key one of them sees
  uint32_t* mine = xch + warp * L::XW;
  const uint32_t* theirs = xch + ((1 - hk) * R + grp16) * L::XW;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::STAGES; ++s) mbar_init(&full[s], L::NBOX);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (threadIdx.x == 0) {
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
  }
  for (int t = 0; t < L::STAGES - 1 && t < bl.nt; ++t)
    issue_bf16<HD>(maps, ring + t * L::STAGE, &full[t], bl, t, warp, nwarps, lane);

  // this warp's 16 query rows, scaled in bf16 (zero past S), as the A
  // fragments of the score product's k-steps; staged in the ring's last
  // stage, which the first barrier below frees before a tile lands there
  uint32_t qf[HD / 16][4];
  {
    char* qw = ring + (L::STAGES - 1) * L::STAGE + warp * L::QROWS;
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
    const __nv_bfloat162 sc = __bfloat162bfloat162(__float2bfloat16_rn(a.scale));
    for (int idx = lane; idx < 16 * (HD / 8); idx += 32) {
      const int r = idx / (HD / 8), c = idx % (HD / 8), s = sw + r;
      uint4 x = make_uint4(0, 0, 0, 0);
      if (rows && s < a.S) {
        x = *reinterpret_cast<const uint4*>(q + (((size_t)bl.b * a.S + s) * a.NH + h) * HD + 8 * c);
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int u = 0; u < 4; ++u) e[u] = __hmul2(e[u], sc);
      }
      *reinterpret_cast<uint4*>(qw + swz(r, c)) = x;
    }
    __syncwarp();
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) ldmatrix_x4(qf[k], qw + swz(lane & 15, 2 * k + (lane >> 4)));
  }
  // this lane's ldmatrix offsets in a 16-row group: K rows as B (dim chunks
  // 2u + bit 3 of the lane); V rows transposed (chunks of this warp's
  // 16-dim step jj, + bit 4), dims 64.. one box further
  int koff[4], voff[ND / 16];
#pragma unroll
  for (int u = 0; u < 4; ++u)
    koff[u] = swz((lane & 7) + ((lane >> 4) << 3), 2 * u + ((lane >> 3) & 1));
#pragma unroll
  for (int jj = 0; jj < ND / 16; ++jj) {
    const int cj = hk * (ND / 16) + jj;
    voff[jj] = (cj >> 2) * L::HALF + swz((lane & 7) + (((lane >> 3) & 1) << 3),
                                         2 * (cj & 3) + (lane >> 4));
  }

  // rows sw + gid ([0], [1] of each accumulator) and sw + 8 + gid ([2], [3]);
  // o[n] holds dims hk * ND + 8n + 2t4, +1; l over this lane's keys until
  // the end
  float o[ND / 8][4];
#pragma unroll
  for (int n = 0; n < ND / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};

#ifdef WF_K9_STAMPS
  const bool stamper = threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 && blockIdx.z == 0;
  long long stamp_t = clock64();
  if (stamper) k9_stamps[0] += 1;
#endif
  for (int i = 0; i < bl.nt; ++i) {
    WF_K9_STAMP(8)
#ifdef WF_K9_STAMPS
    if (stamper) k9_stamps[1] += 1;
#endif
    mbar_wait(&full[i % L::STAGES], (i / L::STAGES) & 1);  // tile i is in
    __syncthreads();  // every warp is done with tile i - 1
    WF_K9_STAMP(2)
    const int next = i + L::STAGES - 1;  // into the stage of tile i - 1
    if (next < bl.nt)
      issue_bf16<HD>(maps, ring + next % L::STAGES * L::STAGE, &full[next % L::STAGES], bl, next,
                     warp, nwarps, lane);
    WF_K9_STAMP(3)
    const int c0 = i * TK;
    if (!rows || c0 > wlast) continue;  // no row of the group sees a key of the tile
    float s[NK / 8][4];
    qk_tile<HD, NK>(s, qf, ring + i % L::STAGES * L::STAGE + hk * NK * 128, koff);
    const char* vt = ring + i % L::STAGES * L::STAGE + L::TILE;
    // masks: the tile reaches T or a row's diagonal
    if (c0 + TK > a.T || c0 + TK - 1 > bl.qoff + sw) {
#pragma unroll
      for (int n = 0; n < NK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = c0 + hk * NK + 8 * n + 2 * t4 + (e & 1);
          const int row = sw + gid + 8 * (e >> 1);
          if (!(key < a.T && key <= bl.qoff + row)) s[n][e] = NEG;
        }
    }
    float mx[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = NEG;
#pragma unroll
      for (int n = 0; n < NK / 8; ++n) mx[r] = fmaxf(mx[r], fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    }
    WF_K9_STAMP(4)
    if constexpr (KS == 2) {  // the tile's maxima over both halves
      mine[lane] = __float_as_uint(mx[0]);
      mine[32 + lane] = __float_as_uint(mx[1]);
      pair_sync(1 + grp16);
      mx[0] = fmaxf(mx[0], __uint_as_float(theirs[lane]));
      mx[1] = fmaxf(mx[1], __uint_as_float(theirs[32 + lane]));
    }
    WF_K9_STAMP(5)
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
    // the probabilities, rounded to bf16, as the PV product's A fragments:
    // k-step kk covers the warp's keys 16kk.. (score tiles 2kk and 2kk + 1)
    uint32_t pa[PK][4], pb[PK][4];  // this warp's keys, the other half's
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK / 8; ++n) {
      const float p0 = expf(s[n][0] - m[0]), p1 = expf(s[n][1] - m[0]);
      const float p2 = expf(s[n][2] - m[1]), p3 = expf(s[n][3] - m[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      pa[n >> 1][(n & 1) * 2] = pack_bf16(p0, p1);
      pa[n >> 1][(n & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    if constexpr (KS == 2) {
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) mine[(4 + 4 * kk + e) * 32 + lane] = pa[kk][e];
      pair_sync(1 + grp16);
#pragma unroll
      for (int kk = 0; kk < PK; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pb[kk][e] = theirs[(4 + 4 * kk + e) * 32 + lane];
    }
    WF_K9_STAMP(6)
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row's max moved
#pragma unroll
      for (int n = 0; n < ND / 8; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
    }
    // o += P V over all 64 keys of the tile, this warp's dims
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
      uint32_t pk[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pk[e] = KS == 1 || kk / PK == hk ? pa[kk % PK][e] : pb[kk % PK][e];
#pragma unroll
      for (int jj = 0; jj < ND / 16; ++jj) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vt + kk * 2048 + voff[jj]);
        mma_bf16(o[2 * jj], pk, vb[0], vb[1]);
        mma_bf16(o[2 * jj + 1], pk, vb[2], vb[3]);
      }
    }
    WF_K9_STAMP(7)
  }
  if (!rows) return;  // and so does the other warp of the group
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  if constexpr (KS == 2) {  // the sums over both halves' keys
    mine[64 + lane] = __float_as_uint(l[0]);
    mine[96 + lane] = __float_as_uint(l[1]);
    pair_sync(1 + grp16);
    l[0] += __uint_as_float(theirs[64 + lane]);
    l[1] += __uint_as_float(theirs[96 + lane]);
  }
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int s = sw + gid + 8 * r;
    if (s >= a.S) continue;
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* dst = out + (((size_t)bl.b * a.S + s) * a.NH + h) * HD + hk * ND + 2 * t4;
#pragma unroll
    for (int n = 0; n < ND / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r] / den, o[n][2 * r + 1] / den);
  }
}

// ----------------------------------------------------------------- f32 ----

template <int HD>
struct F32 {
  static constexpr int LD = HD + 4;     // floats a Q row: 16-byte reads of 8 rows miss each other
  static constexpr int SEG = TK * 32;   // floats of 64 keys x 32 dims: one copy-engine box
  static constexpr int SLOT = HD / 32 * SEG;  // 64 keys of K or V: [D / 32][64][32], swizzled
  static constexpr int MAX_ROWS = 64;
  // the ring, Q and P^T ([64 keys][rows + 4]) for `rows` query rows, and 1 KB
  // for the alignment
  static constexpr int smem(int rows) {
    return (2 * SLOT + rows * LD + TK * (rows + 4)) * 4 + 1024;
  }
};

// Float offset of dims 4cc..4cc+3 (cc < 8) of row `row` in a segment of 64
// rows x 32 dims in the copy engine's 128-byte swizzle.
__device__ __forceinline__ int swz32(int row, int cc) {
  return row * 32 + ((cc ^ (row & 7)) << 2);
}

// Issue keys 64t..64t+63 of `map` (k or v, KV head kvh) into `slot`: lane 0
// of warp w copies the boxes of dims 32w.., 32(w + nwarps).. (keys from T
// on arrive as zeros), each completing on bar, which expects one arrival a
// box.
template <int HD>
__device__ __forceinline__ void issue_f32(const CUtensorMap* map, float* slot, uint64_t* bar,
                                          const Block& bl, int t, int warp, int nwarps,
                                          int lane) {
  if (lane != 0) return;
  for (int bx = warp; bx < HD / 32; bx += nwarps) {
    mbar_expect_tx(bar, F32<HD>::SEG * 4);
    tma_load3(slot + bx * F32<HD>::SEG, map, bl.kvh * HD + 32 * bx, t * TK, bl.b, bar);
  }
}

__device__ __forceinline__ float dot4(const float4& x, const float4& y, float acc) {
  return fmaf(x.w, y.w, fmaf(x.z, y.z, fmaf(x.y, y.y, fmaf(x.x, y.x, acc))));
}

// Grid (KV * NG, q tiles, B), GB * BQ / 8 warps.
template <int HD>
__global__ void __launch_bounds__(256) k9_f32(const __grid_constant__ Maps maps, Args a) {
  using L = F32<HD>;
  constexpr int LD = L::LD, NU = HD / 64;
  extern __shared__ unsigned char raw[];
  const int nrows = a.GB * a.BQ, LDP = nrows + 4;
  // the ring [2][D / 32][64][32], 1024-byte aligned for the swizzle; Q
  // [nrows][LD], scaled; P^T [64][LDP]
  float* ring = reinterpret_cast<float*>(raw + ((1024 - (smem_addr(raw) & 1023)) & 1023));
  float* qs = ring + 2 * L::SLOT;
  float* pt = qs + nrows * LD;
  __shared__ uint64_t full[2];  // a slot's copy is in
  const Block bl(a);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rg = lane >> 4, kg = lane & 15;
  const int hg = bl.grp * a.GB + warp * 8 / a.BQ;  // this warp's query head in the group
  const int h = bl.kvh * a.G + hg;
  const int sw = bl.s0 + warp * 8 % a.BQ;         // and its first token
  const int r0 = warp * 8 + rg * 4;               // this lane's first row of the block
  const bool rows = hg < a.G && sw < a.S;
  const int wlast = bl.qoff + min(sw + 7, a.S - 1);

  // the stream: chunk c = K of tile c / 2 (c even) or V of it, into slot c % 2
  if (threadIdx.x == 0) {
    mbar_init(&full[0], HD / 32);
    mbar_init(&full[1], HD / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    prefetch_map(&maps.k);
    prefetch_map(&maps.v);
  }
  __syncthreads();
  const int nwarps = blockDim.x >> 5;
  if (bl.nt > 0) issue_f32<HD>(&maps.k, ring, &full[0], bl, 0, warp, nwarps, lane);
  {
    const float* q = static_cast<const float*>(a.q);
    for (int idx = threadIdx.x; idx < nrows * (HD / 4); idx += blockDim.x) {
      const int r = idx / (HD / 4), c = idx % (HD / 4);
      const int head = bl.grp * a.GB + r / a.BQ, s = bl.s0 + r % a.BQ;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (head < a.G && s < a.S) {
        x = *reinterpret_cast<const float4*>(
            q + (((size_t)bl.b * a.S + s) * a.NH + bl.kvh * a.G + head) * HD + 4 * c);
        x.x *= a.scale;
        x.y *= a.scale;
        x.z *= a.scale;
        x.w *= a.scale;
      }
      *reinterpret_cast<float4*>(qs + r * LD + 4 * c) = x;
    }
  }

  // rows r0 + i (i < 4); o[i][4u + e] at dim 4kg + 64u + e
  float o[4][4 * NU];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4 * NU; ++e) o[i][e] = 0.f;
  float m[4] = {NEG, NEG, NEG, NEG}, l[4] = {0.f, 0.f, 0.f, 0.f};
  const int kx = kg & 7;  // the swizzle of this lane's keys kg + 16j

  for (int c = 0; c < 2 * bl.nt; ++c) {
    mbar_wait(&full[c & 1], (c >> 1) & 1);  // chunk c is in
    __syncthreads();  // (and Q); every warp is done with chunk c - 1
    if (c + 1 < 2 * bl.nt)
      issue_f32<HD>((c + 1) & 1 ? &maps.v : &maps.k, ring + ((c + 1) & 1) * L::SLOT,
                    &full[(c + 1) & 1], bl, (c + 1) / 2, warp, nwarps, lane);
    const int c0 = c / 2 * TK;
    if (!rows || c0 > wlast) continue;  // no row of the warp sees a key of the tile
    const float* kv = ring + (c & 1) * L::SLOT;
    if ((c & 1) == 0) {
      // scores of rows r0.. against keys c0 + kg + 16j
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.f;
      for (int sg = 0; sg < HD / 32; ++sg) {
        const float* ks = kv + sg * L::SEG + kg * 32;
#pragma unroll
        for (int cc = 0; cc < 8; ++cc) {
          float4 qv[4], kk[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qv[i] = *reinterpret_cast<const float4*>(qs + (r0 + i) * LD + sg * 32 + 4 * cc);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kk[j] = *reinterpret_cast<const float4*>(ks + 16 * j * 32 + ((cc ^ kx) << 2));
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = dot4(qv[i], kk[j], s[i][j]);
        }
      }
      if (c0 + TK > a.T || c0 + TK - 1 > bl.qoff + sw) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = c0 + kg + 16 * j;
            if (!(key < a.T && key <= bl.qoff + sw + rg * 4 + i)) s[i][j] = NEG;
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
        for (int x = 1; x < 16; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float m_new = fmaxf(m[i], mx);
        const float alpha = expf(m[i] - m_new);
        m[i] = m_new;
        float rs = 0.f;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
        l[i] = l[i] * alpha + rs;
        if (alpha != 1.f) {  // the row's max moved
#pragma unroll
          for (int e = 0; e < 4 * NU; ++e) o[i][e] *= alpha;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        *reinterpret_cast<float4*>(pt + (kg + 16 * j) * LDP + r0) =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      __syncwarp();
    } else {
      // o += P V over the tile's 64 keys; dims 4kg + 64u.. are dims 4 kx.. of
      // segment kg / 8 + 2u
      for (int t8 = 0; t8 < TK; t8 += 8) {
#pragma unroll
        for (int tt = 0; tt < 8; ++tt) {
          const int t = t8 + tt;
          const float4 p = *reinterpret_cast<const float4*>(pt + t * LDP + r0);
          const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
          for (int u = 0; u < NU; ++u) {
            const float4 w = *reinterpret_cast<const float4*>(
                kv + ((kg >> 3) + 2 * u) * L::SEG + t * 32 + ((kx ^ tt) << 2));
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              o[i][4 * u] = fmaf(pr[i], w.x, o[i][4 * u]);
              o[i][4 * u + 1] = fmaf(pr[i], w.y, o[i][4 * u + 1]);
              o[i][4 * u + 2] = fmaf(pr[i], w.z, o[i][4 * u + 2]);
              o[i][4 * u + 3] = fmaf(pr[i], w.w, o[i][4 * u + 3]);
            }
          }
        }
      }
      __syncwarp();  // before the next tile's probabilities overwrite P^T
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int x = 1; x < 16; x <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], x);
  if (!rows) return;
  float* out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = sw + rg * 4 + i;
    if (s >= a.S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* dst = out + (((size_t)bl.b * a.S + s) * a.NH + h) * HD + 4 * kg;
#pragma unroll
    for (int u = 0; u < NU; ++u)
      *reinterpret_cast<float4*>(dst + 64 * u) =
          make_float4(o[i][4 * u] / den, o[i][4 * u + 1] / den, o[i][4 * u + 2] / den,
                      o[i][4 * u + 3] / den);
  }
}

// ------------------------------------------------------------- launch ----

template <typename Kernel>
cudaError_t smem_limit(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

// k and v as 3-D arrays [B, T, KV * D] of elem_bytes elements
cudaError_t make_maps(Maps* maps, const Args& a, int B, int HD, int elem_bytes) {
  memset(maps, 0, sizeof(*maps));
  cudaError_t e = batched_rows_map(&maps->k, a.k, B, a.T, a.KV * HD, elem_bytes, TK);
  return e != cudaSuccess ? e : batched_rows_map(&maps->v, a.v, B, a.T, a.KV * HD, elem_bytes, TK);
}

template <int HD, int KS>
cudaError_t launch_bf16(const Args& a, int B, int warps, cudaStream_t st) {
  static bool done = false;  // once per instantiation
  cudaError_t e = smem_limit(k9_bf16<HD, KS>, Bf16<HD>::SMEM, done);
  if (e != cudaSuccess) return e;
  Maps maps;
  if ((e = make_maps(&maps, a, B, HD, 2)) != cudaSuccess) return e;
  const dim3 grid(a.KV * a.NG, (a.S + a.BQ - 1) / a.BQ, B);
  k9_bf16<HD, KS><<<grid, warps * 32, Bf16<HD>::SMEM, st>>>(maps, a);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_f32(const Args& a, int B, cudaStream_t st) {
  static bool done = false;
  cudaError_t e = smem_limit(k9_f32<HD>, F32<HD>::smem(F32<HD>::MAX_ROWS), done);
  if (e != cudaSuccess) return e;
  Maps maps;
  if ((e = make_maps(&maps, a, B, HD, 4)) != cudaSuccess) return e;
  const int nrows = a.GB * a.BQ;
  const dim3 grid(a.KV * a.NG, (a.S + a.BQ - 1) / a.BQ, B);
  k9_f32<HD><<<grid, nrows / 8 * 32, F32<HD>::smem(nrows), st>>>(maps, a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9: q, out [B,S,NH,D]; k, v [B,T,KV,D], all contiguous and 16-byte aligned;
// f32 (is_f32 = 1) or bf16; D 64 or 128. q_offset: one int32 on the device,
// or null and then qoff. gb query heads, bq query tokens and `warps` warps a
// block (flash_attention.py::causal_prefill_block): bf16 bq a multiple of 16,
// R = gb * bq / 16 groups of 16 rows and R or 2R warps (2R only for R <= 4),
// at most 8; f32 bq a multiple of 8, gb * bq <= 64 rows and one warp per 8.
int wf_flash_prefill(const void* q, const void* k, const void* v, const void* q_offset, int qoff,
                     void* out, int B, int S, int NH, int KV, int D, int T, int is_f32,
                     float scale, int gb, int bq, int warps, void* stream) {
  if (B <= 0 || S <= 0) return 0;
  if (T <= 0 || KV <= 0 || NH % KV || (D != 64 && D != 128) || gb <= 0 || bq <= 0 ||
      gb > NH / KV)
    return cudaErrorInvalidValue;
  const int groups = is_f32 ? gb * bq / 8 : gb * bq / 16;
  if (is_f32 ? (bq % 8 || gb * bq > F32<128>::MAX_ROWS || warps != groups)
             : (bq % 16 || (warps != groups && warps != 2 * groups) || warps > 8))
    return cudaErrorInvalidValue;
  const int G = NH / KV;
  const Args a{q, k, v, out, static_cast<const int*>(q_offset), qoff, S, NH, KV, T, G, gb,
               (G + gb - 1) / gb, bq, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_f32) return D == 128 ? launch_f32<128>(a, B, st) : launch_f32<64>(a, B, st);
  if (warps == groups)
    return D == 128 ? launch_bf16<128, 1>(a, B, warps, st) : launch_bf16<64, 1>(a, B, warps, st);
  return D == 128 ? launch_bf16<128, 2>(a, B, warps, st) : launch_bf16<64, 2>(a, B, warps, st);
}

#ifdef WF_K9_STAMPS
// K9's bf16 stamps (see WF_K9_STAMPS) into out[9], then cleared.
int wf_k9_stamps(void* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, k9_stamps, sizeof(k9_stamps));
  if (e != cudaSuccess) return e;
  const unsigned long long zero[9] = {};
  return cudaMemcpyToSymbol(k9_stamps, zero, sizeof(zero));
}
#endif

}  // extern "C"

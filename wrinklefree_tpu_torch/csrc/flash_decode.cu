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
// probabilities are forced to 0 (so a fully masked update leaves the state
// unchanged); probabilities are rounded to the pool's type before the PV
// product; the output is acc / max(l, 1e-30) in bf16 (q's type). As in the
// TPU kernel, the staging prefix and the current token form the last
// online-softmax update. The pool is bf16 or fp16 (k6_decode<T>, on the
// tensor cores) or f32 (k6_wide<float>, on FMAs; below); q, k_cur and v_cur
// are bf16, and the current token's row is rounded to the pool's type.
//
// Bound: bytes, 2 * n * D * 2 per slot and KV head (the history's k and v
// rows, each read once); 4 * G * D operations per token are far below the
// tensor cores' rate. What it takes to get near the bytes bound, and what
// the design does:
// - Enough blocks. A slot's tiles of 64 tokens (its committed tiles, then
//   the tail: the staging prefix and the current token) are dealt out in
//   equal contiguous shares over `split` blocks (1-8, a power of two chosen
//   on the host from static shapes: flash_attention.py::flash_decode_split),
//   which form one thread-block cluster; the grid is (split, KV, B). A rank
//   reads its share from seq_lens on the device; one with no tiles
//   contributes m = -1e30, l = 0, acc = 0. The last rank ends with the tail.
// - Large copies. One SM streams copies of 256 bytes (one token's row of one
//   KV head) at about half its rate in copies of 1 KB or more (a scratch copy
//   benchmark on the H100). So the committed rows come by copy engine (TMA)
//   in boxes of 16 rows x 64 dims (2 KB; row by row where the page size is
//   not a multiple of 16) of the pool seen as [P*2L*ps rows, KV*D], in the
//   128-byte swizzle that keeps ldmatrix free of bank conflicts; the pages
//   of the boxes a warp will load are read from the page table at the start,
//   into its lanes' registers. The tail rows come by cp.async, 16 bytes a
//   copy. Rows past a slot's valid tokens are zero and are never read from
//   memory.
// - No block-wide barrier per tile. Each of the 4 warps owns 16 tokens of
//   every tile: it issues their copies into its own two-stage ring, waits
//   for them on the stage's mbarrier and keeps its own online-softmax state,
//   so no tile needs a block-wide max.
// - Tensor cores for both products (mma.sync m16n8k16 -> f32). Scores: the
//   K rows (ldmatrix) are A (M = 16 tokens), the G <= 8 scaled query heads
//   are B (N = 8, zero past G), D = 128 is K in 8 steps, bf16 x bf16. PV:
//   V^T (ldmatrix.trans) is A (M = 16 dims, 8 of them), the probabilities
//   rounded to the pool's type are B (bf16 x bf16 or fp16 x fp16): the
//   scores' accumulator rows are tokens, and movmatrix.trans turns them into
//   B fragments in registers. The products are exact in f32; only the order
//   of the f32 sums differs from the plain version.
// - The combine, deterministic and without global scratch. Each block sums
//   its warps' states in warp order in shared memory; the other ranks write
//   their (m, l, acc[G][128]) into rank 0's shared memory (distributed shared
//   memory, after every block of the cluster has started), and after one
//   cluster barrier rank 0 rescales and sums them in rank order, acc_r *
//   exp(m_r - m), and stores the output. 99 KB of shared memory: two blocks
//   per SM.
//
// fp16 pools (k6_decode<__half>): the bf16 kernel's split, copy-engine
// boxes (fp16 tensor map), per-warp ring, combine and shared memory, with
// two changes. The score product is bf16 (q) x fp16 (K), and no 16-bit mma
// type takes both: rounding either side to the other's type would change
// the scores. It runs on TF32 mma.sync m16n8k8, which holds every bf16 and
// every fp16 value (subnormals included) exactly, so each product is exact
// in f32 and only the order of the f32 sums differs. Each K register from
// the bf16 kernel's ldmatrix (two fp16 dims of a row) widens to two f32
// A elements in place, q's fragments widen once to f32 B fragments, and a
// 16-dim k-step becomes two TF32 products of 8 dims (the dims' order inside
// a k-step is the same permutation for A and B). Of the two exact forms
// this one measured faster than splitting each fp16 key into bf16 hi + lo
// for two bf16 mma (the same mma count, but 6-8 conversions a K register
// against one widening; PERF.md section 6). The PV product is fp16 x fp16,
// on f16 mma with the probabilities packed to fp16 (below 2^-14 as
// subnormals, as the plain version's cast keeps them). The current token's
// bf16 row is rounded to fp16 by a converting store into the ring instead
// of its cp.async.
//
// f32 pools (k6_wide<float>): the same function, split, warp ownership and
// combine, with the pool's rows (and the current token's, bf16 widened) in
// f32 and the probabilities kept in f32 for PV. A bf16 query and an f32 key
// share no tensor-core operand type (TF32 truncates f32), so both products
// run on f32 FMAs: every bf16 x f32 product is exact in f32, and only the
// order of the f32 sums differs from the plain version. A warp's 16 rows of
// a tile come by 16-byte cp.async into its own two-stage ring (K rows
// padded by 16 bytes, so that the lanes' reads of 8 rows miss each other)
// with zeros past the valid rows; lane (j, hf) = (lane % 16, lane / 16)
// scores row j against every query head over dims 64hf..64hf+63, one
// shuffle joins the halves, and for PV lane x accumulates dims 4x..4x+3 of
// every head, reading the warp's probabilities from shared memory. 172 KB
// of shared memory, one block per SM.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError() or the launch's error.

#include <cooperative_groups.h>
#include <string.h>

#include <type_traits>

#include "sm90.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int HD = 128;                // head dim
constexpr int TK = 64;                 // tokens per tile
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;    // = HD: one thread per dim in the combine
constexpr int WROWS = TK / WARPS;      // tokens per warp per tile: one mma's M
constexpr int MAX_G = 8;               // query heads per KV head: the mma's N
constexpr int STAGES = 2;
constexpr int MAX_SPLIT = 8;           // blocks per cluster (the portable limit)
constexpr int HALF = WROWS * 128;      // bytes of 64 dims of a warp's 16 rows
constexpr int WSTAGE = 4 * HALF;       // a warp's K and V rows of one tile: 8 KB
constexpr int ACC_LD = HD + 4;         // row stride of a stored acc (f32)
constexpr int PART = 2 * MAX_G + MAX_G * ACC_LD;  // one stored state: m[8], l[8], acc[8][ACC_LD]
constexpr int RING = WARPS * STAGES * WSTAGE;     // 64 KB
constexpr int RANKS = MAX_SPLIT * PART * 4;       // rank 0's slots for the ranks' states
constexpr int SMEM = RING + RANKS + 1024;         // and the 1024-byte alignment of the swizzle
static_assert(WARPS * PART * 4 <= RING, "the warps' states fit in the ring");
constexpr float NEG = -1e30f;

struct Args {
  const __nv_bfloat16* q;      // [B, NH, D]
  const __nv_bfloat16* k_cur;  // [B, KV, D]
  const __nv_bfloat16* v_cur;
  const void* main;            // [P, 2L, ps, KV*D] in the pool's type
  const void* stage;           // [B, ps, 2L, KV*D]
  const int* page_table;       // [B, MP]
  const int* seq_lens;         // [B]
  __nv_bfloat16* out;          // [B, NH, D]
  int NH, KV, L, layer, ps, MP, split;
  int boxes;                   // committed rows come by copy-engine box (ps % 16 == 0)
  float scale;
};

// the transpose of an 8x8 bf16 fragment (thread 4r + c holds row r, columns
// 2c and 2c + 1)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;" : "=r"(y) : "r"(x));
  return y;
}

// Issue the copies of a warp's rows r0.. of tile i (tokens i*TK.. of the
// committed history for i < ntm, else the staging prefix and the current
// token), of which the first nv > 0 are valid, into kd and vd (4 KB each),
// completing on bar. Committed rows come by copy-engine box (16 rows x 64
// dims, from `page`, when a page holds whole boxes), the others row by row
// with cp.async (16 bytes a copy; lane j < 16 copies K row j, lane 16 + j V
// row j). Rows from nv on are zero and are not read from memory. T: the
// pool's 16-bit type; on an fp16 pool the current token's bf16 row is
// rounded to fp16 (as the plain version's cast does) by a converting store.
template <typename T>
__device__ __forceinline__ void load_rows(const Args& a, const CUtensorMap* map, char* kd,
                                          char* vd, uint64_t* bar, int i, int r0, int nv, int ntm,
                                          int off, int b, int kvh, int lane, int page) {
  const size_t kvd = (size_t)a.KV * HD;
  const bool boxed = i < ntm && a.boxes;
  {
    const int j = lane & 15, v = lane >> 4;  // v: 0 for K, 1 for V
    char* dst = v ? vd : kd;
    if (j >= nv) {
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        *reinterpret_cast<uint4*>(dst + swz(j, c)) = make_uint4(0, 0, 0, 0);
      // order these writes before the copy engine's later writes to the row
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    } else if (!boxed) {
      const int row = r0 + j;
      const uint16_t* src;  // 2-byte elements, copied as bytes
      if (i < ntm) {
        const int t = i * TK + row;
        const size_t pt = (size_t)__ldg(a.page_table + (size_t)b * a.MP + t / a.ps);
        src = static_cast<const uint16_t*>(a.main) +
              ((pt * 2 * a.L + v * a.L + a.layer) * a.ps + t % a.ps) * kvd;
      } else if (row < off) {
        src = static_cast<const uint16_t*>(a.stage) +
              (((size_t)b * a.ps + row) * 2 * a.L + v * a.L + a.layer) * kvd;
      } else {  // row == off: the current token, bf16
        src = reinterpret_cast<const uint16_t*>(v ? a.v_cur : a.k_cur) + (size_t)b * kvd;
      }
      src += kvh * HD;
      if (std::is_same<T, __half>::value && i >= ntm && row >= off) {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) {
          uint4 x = *reinterpret_cast<const uint4*>(src + 8 * c);
          uint32_t* e = reinterpret_cast<uint32_t*>(&x);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(e + u));
            e[u] = pack_f16(f.x, f.y);
          }
          *reinterpret_cast<uint4*>(dst + swz(j, c)) = x;
        }
        fence_proxy_async();  // as for the zeros above
      } else {
#pragma unroll
        for (int c = 0; c < HD / 8; ++c) cp_async16(dst + swz(j, c), src + 8 * c);
        cp_async_arrive(bar);
      }
    }
  }
  __syncwarp();  // the row copies have joined bar before its arrival below
  // (nv is 16 when boxed: a.ps and so the committed span are multiples of 16)
  if (lane == 0) mbar_expect_tx(bar, boxed ? 4 * HALF : 0);
  __syncwarp();
  if (boxed && lane < 4) {  // lane: (K or V, half of the dims)
    const int v = lane >> 1, h = lane & 1;
    tma_load((v ? vd : kd) + h * HALF, map, kvh * HD + h * 64,
             (page * 2 * a.L + v * a.L + a.layer) * a.ps + (i * TK + r0) % a.ps, bar);
  }
}

// States r = 0..count-1 at base + r * stride (floats; m[8], l[8],
// acc[8][ACC_LD]) rescaled to their common max and summed in order r = 0,
// 1, ...: thread d's dim of every head.
__device__ __forceinline__ void combine(const float* base, int stride, int count, int d, int G,
                                        float (&M)[MAX_G], float (&L)[MAX_G], float (&A)[MAX_G]) {
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    M[g] = NEG;
    L[g] = 0.f;
    A[g] = 0.f;
  }
  for (int r = 0; r < count; ++r)
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) M[g] = fmaxf(M[g], base[r * stride + g]);
  for (int r = 0; r < count; ++r) {
    const float* p = base + r * stride;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        const float e = expf(p[g] - M[g]);
        L[g] += p[MAX_G + g] * e;
        A[g] += p[2 * MAX_G + g * ACC_LD + d] * e;
      }
    }
  }
}

// The end of both kernels, after the warps' states (m[8], l[8], acc[8][ACC_LD]
// each, PART floats apart) are in `states`: the block's state, thread d
// holding dim d of every head, is the warps' states summed in warp order; then
// rank 0 sums the ranks' states in rank order in the same way (the other
// ranks write theirs into its `ranks` through distributed shared memory) and
// stores the output.
__device__ __forceinline__ void finish(const Args& a, const float* states, float* ranks, int rank,
                                       int kvh, int b, int G) {
  const int d = threadIdx.x;
  float M[MAX_G], Ls[MAX_G], A[MAX_G];
  combine(states, PART, WARPS, d, G, M, Ls, A);

  if (a.split > 1) {
    // every block of the cluster has started: write this rank's state into
    // rank 0's slot for it
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
    float* dst = rank == 0 ? ranks : cg::this_cluster().map_shared_rank(ranks, 0) + rank * PART;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) dst[2 * MAX_G + g * ACC_LD + d] = A[g];
      if (g < G && d == g) {  // (static indices keep M and Ls in registers)
        dst[g] = M[g];
        dst[MAX_G + g] = Ls[g];
      }
    }
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
    if (rank != 0) return;
    asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
    combine(ranks, PART, a.split, d, G, M, Ls, A);
  }

#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G)
      a.out[((size_t)b * a.NH + kvh * G + g) * HD + d] =
          __float2bfloat16_rn(A[g] / fmaxf(Ls[g], 1e-30f));
}

// Grid (split, KV, B); cluster (split, 1, 1) when split > 1. T: the pool's
// 16-bit type, bf16 or fp16. map: the main pool as rows of KV*D T in boxes of
// 16 rows x 64 dims, 128-byte swizzle.
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
    k6_decode(const __grid_constant__ CUtensorMap map, Args a) {
  constexpr bool F16 = std::is_same<T, __half>::value;
  extern __shared__ unsigned char raw[];
  // the warps' rings [WARPS][STAGES] of K then V rows (WSTAGE bytes each),
  // 1024-byte aligned for the swizzle, and after the loop the warps' states;
  // then rank 0's slots for the ranks' states
  char* ring = reinterpret_cast<char*>(raw) + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  __shared__ uint64_t bars[WARPS][STAGES];  // a warp's stage: its copies are in
  float* states = reinterpret_cast<float*>(ring);
  float* ranks = reinterpret_cast<float*>(ring + RING);
  const int rank = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.NH / a.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, t4 = lane & 3;
  char* wring = ring + warp * STAGES * WSTAGE;
  const int n_hist = max(a.seq_lens[b], 0);
  const int full = min((n_hist / a.ps) * a.ps, a.MP * a.ps);  // committed tokens
  const int off = n_hist % a.ps;                              // staging tokens
  const int ntm = (full + TK - 1) / TK;
  const int nt = ntm + 1;  // the committed tiles, then the tail
  const int i0 = rank * nt / a.split, i1 = (rank + 1) * nt / a.split;  // this rank's share
  const int r0 = warp * WROWS;  // this warp's rows of every tile
  auto valid = [&](int i) { return i < ntm ? min(TK, full - i * TK) : off + 1; };
  // this warp's rows of tile i that are valid (<= 0: none)
  auto rows_of = [&](int i) { return min(WROWS, valid(i) - r0); };

  // tells the cluster this block has started (its shared memory may be written)
  if (a.split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (lane == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&bars[warp][s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // lane k holds the page of this warp's rows of tile i0 + k (committed
  // tiles), so that a copy does not wait for the page table
  int pg = 0;
  if (a.boxes && i0 + lane < min(i1, ntm)) {
    prefetch_map(&map);
    const int t = (i0 + lane) * TK + r0;
    if (t < full) pg = __ldg(a.page_table + (size_t)b * a.MP + t / a.ps);
  }
  __syncwarp();
  // issue the copies of tile i into stage st (when the warp has rows in it)
  auto issue = [&](int i, int st) {
    const int nv = rows_of(i);
    if (nv <= 0) return;
    int page = __shfl_sync(0xffffffffu, pg, (i - i0) & 31);
    if (i - i0 >= 32 && i < ntm && a.boxes)  // past the held pages
      page = __ldg(a.page_table + (size_t)b * a.MP + (i * TK + r0) / a.ps);
    load_rows<T>(a, &map, wring + st * WSTAGE, wring + st * WSTAGE + 2 * HALF, &bars[warp][st], i,
              r0, nv, ntm, off, b, kvh, lane, page);
  };
  for (int s = 0; s < STAGES && i0 + s < i1; ++s) issue(i0 + s, s);

  // q of head gid (zero past G), scaled in bf16, as the B fragments of the
  // score mma's 8 k-steps: (dims 16k + 2t4, +1) and (16k + 8 + 2t4, +1)
  uint32_t qf[HD / 16][2];
  {
    const __nv_bfloat162 sc = __bfloat162bfloat162(__float2bfloat16_rn(a.scale));
    const __nv_bfloat16* qr = a.q + ((size_t)b * a.NH + kvh * G + gid) * HD + 2 * t4;
#pragma unroll
    for (int k = 0; k < HD / 16; ++k) {
      if (gid < G) {
        const __nv_bfloat162 lo = __hmul2(*reinterpret_cast<const __nv_bfloat162*>(qr + 16 * k), sc);
        const __nv_bfloat162 hi =
            __hmul2(*reinterpret_cast<const __nv_bfloat162*>(qr + 16 * k + 8), sc);
        qf[k][0] = *reinterpret_cast<const uint32_t*>(&lo);
        qf[k][1] = *reinterpret_cast<const uint32_t*>(&hi);
      } else {
        qf[k][0] = qf[k][1] = 0u;
      }
    }
  }
  // the same values widened to f32, the TF32 B fragments of fp16 pools:
  // dims 16k + 2t4, +1, 16k + 8 + 2t4, +1 (unused, and dropped, on bf16)
  float qt[HD / 16][4];
#pragma unroll
  for (int k = 0; k < HD / 16; ++k) {
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[k][0]));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&qf[k][1]));
    qt[k][0] = lo.x, qt[k][1] = lo.y, qt[k][2] = hi.x, qt[k][3] = hi.y;
  }

  // this warp's state for heads 2t4 and 2t4 + 1 (l: over this lane's tokens
  // until the loop ends); acc[j] holds dims 16j + gid ([0], [1]) and
  // 16j + 8 + gid ([2], [3])
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[HD / 16][4];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  // The warp's own pipeline: it copies and reads only its rows and waits for
  // them on its stage's barrier; a warp barrier orders its ring. Every stage
  // is filled before the loop; a stage is refilled once it has been read.
  uint32_t phase = 0;  // bit s: the parity of stage s's next phase
  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) % STAGES;
    __syncwarp();  // the lanes are done with tile i - 1's stage
    if (i > i0 && i - 1 + STAGES < i1) issue(i - 1 + STAGES, (i - 1 - i0) % STAGES);
    const int nv = rows_of(i);
    if (nv > 0) {
      mbar_wait(&bars[warp][st], (phase >> st) & 1);
      phase ^= 1u << st;
    }
    if (nv <= 0) continue;  // all masked: the state stays as it is
    const char* kt = wring + st * WSTAGE;
    const char* vt = kt + 2 * HALF;

    // scores of tokens r0 + gid ([0], [1]) and r0 + 8 + gid ([2], [3]) for
    // heads 2t4 and 2t4 + 1, in two chains of four k-steps
    float s[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < HD / 16; k += 2) {
      uint32_t ka[4], kb[4];
      ldmatrix_x4(ka, kt + swz(lane & 15, 2 * k + (lane >> 4)));
      ldmatrix_x4(kb, kt + swz(lane & 15, 2 * k + 2 + (lane >> 4)));
      if (F16) {
        // each k-step as two TF32 products of 8 dims: register e of the K
        // fragment holds row gid (+8 for odd e), dims 2t4, 2t4 + 1 (+8 for
        // e >= 2), widened to f32; k-index t4 takes the first dim, t4 + 4
        // the second, as q's B fragments do
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t* kk = h ? kb : ka;
          float(&acc)[4] = h ? s2 : s;
          float2 f[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            f[e] = __half22float2(*reinterpret_cast<const __half2*>(kk + e));
          mma_tf32(acc, f[0].x, f[1].x, f[0].y, f[1].y, qt[k + h][0], qt[k + h][1]);
          mma_tf32(acc, f[2].x, f[3].x, f[2].y, f[3].y, qt[k + h][2], qt[k + h][3]);
        }
      } else {
        mma_bf16(s, ka, qf[k][0], qf[k][1]);
        mma_bf16(s2, kb, qf[k + 1][0], qf[k + 1][1]);
      }
    }
    const bool ok0 = gid < nv, ok1 = 8 + gid < nv;
    float p[4], alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float sa = ok0 ? s[e] + s2[e] : NEG;
      const float sb = ok1 ? s[2 + e] + s2[2 + e] : NEG;
      float mx = fmaxf(sa, sb);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
      const float m_new = fmaxf(m[e], mx);
      p[e] = ok0 ? expf(sa - m_new) : 0.f;
      p[2 + e] = ok1 ? expf(sb - m_new) : 0.f;
      alpha[e] = expf(m[e] - m_new);
      l[e] = l[e] * alpha[e] + (p[e] + p[2 + e]);  // this lane's tokens; summed at the end
      m[e] = m_new;
    }
    // the probabilities rounded to T as the PV mma's B fragments (tokens x
    // heads): the transposes of the (token, head) fragments of rows gid and
    // 8 + gid
    const uint32_t b0 = movmatrix_trans(F16Ops<T>::pack(p[0], p[1]));
    const uint32_t b1 = movmatrix_trans(F16Ops<T>::pack(p[2], p[3]));
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[1];
      acc[j][2] *= alpha[0];
      acc[j][3] *= alpha[1];
      uint32_t va[4];
      ldmatrix_x4_trans(va, vt + swz((lane & 7) + ((lane >> 4) << 3), 2 * j + ((lane >> 3) & 1)));
      F16Ops<T>::mma(acc[j], va, b0, b1);
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 4);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 8);
    l[e] += __shfl_xor_sync(0xffffffffu, l[e], 16);
  }
  __syncthreads();  // every warp is done with its ring: the states go over them

  {
    float* w = states + warp * PART;
    if (gid == 0) {
      w[2 * t4] = m[0];
      w[2 * t4 + 1] = m[1];
      w[MAX_G + 2 * t4] = l[0];
      w[MAX_G + 2 * t4 + 1] = l[1];
    }
    float* wa = w + 2 * MAX_G;
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      const int d = 16 * j + gid;
      wa[(2 * t4) * ACC_LD + d] = acc[j][0];
      wa[(2 * t4 + 1) * ACC_LD + d] = acc[j][1];
      wa[(2 * t4) * ACC_LD + d + 8] = acc[j][2];
      wa[(2 * t4 + 1) * ACC_LD + d + 8] = acc[j][3];
    }
  }
  __syncthreads();

  finish(a, states, ranks, rank, kvh, b, G);
}

// ------------------------------------------------------------- f32 ----

template <typename T>
struct Wide {
  static constexpr int LDK = HD + 16 / sizeof(T);            // elements a staged K row
  static constexpr int WSTAGE = WROWS * (LDK + HD);          // a warp's K then V rows of a tile
  static constexpr int RING = WARPS * STAGES * WSTAGE * (int)sizeof(T);  // bytes
  // the rings (then the warps' states), rank 0's slots for the ranks' states,
  // the scaled queries [8][128] and the warps' probabilities [4][16][8] (f32)
  static constexpr int SMEM = RING + RANKS + (MAX_G * HD + WARPS * WROWS * MAX_G) * 4;
};
static_assert(WARPS * PART * 4 <= Wide<float>::RING, "the warps' states fit in the rings");

// Grid (split, KV, B); cluster (split, 1, 1) when split > 1.
template <typename T>
__global__ void __launch_bounds__(THREADS) k6_wide(Args a) {
  using W = Wide<T>;
  constexpr int PER = 16 / sizeof(T);  // elements a 16-byte copy
  constexpr int PIECES = HD / PER;     // copies a row
  extern __shared__ float4 wide_raw[];
  char* raw = reinterpret_cast<char*>(wide_raw);
  float* states = reinterpret_cast<float*>(raw);  // over the rings, after the loop
  float* ranks = reinterpret_cast<float*>(raw + W::RING);
  float* qs = ranks + MAX_SPLIT * PART;
  float* pw = qs + MAX_G * HD;
  const int rank = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.NH / a.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, j = lane & 15, hf = lane >> 4;
  T* wring = reinterpret_cast<T*>(raw) + warp * STAGES * W::WSTAGE;
  float* wp = pw + warp * WROWS * MAX_G;  // this warp's probabilities [16 rows][8 heads]
  const size_t kvd = (size_t)a.KV * HD;
  const int n_hist = max(a.seq_lens[b], 0);
  const int full = min((n_hist / a.ps) * a.ps, a.MP * a.ps);  // committed tokens
  const int off = n_hist % a.ps;                              // staging tokens
  const int ntm = (full + TK - 1) / TK;
  const int nt = ntm + 1;  // the committed tiles, then the tail
  const int i0 = rank * nt / a.split, i1 = (rank + 1) * nt / a.split;  // this rank's share
  const int r0 = warp * WROWS;  // this warp's rows of every tile
  auto valid = [&](int i) { return i < ntm ? min(TK, full - i * TK) : off + 1; };
  auto rows_of = [&](int i) { return min(WROWS, valid(i) - r0); };

  if (a.split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  // copy the warp's rows of tile i into stage st (zeros from its valid rows
  // on), one group of copies per call
  auto fetch = [&](int i, int st) {
    const int nv = i < i1 ? rows_of(i) : 0;
    T* kd = wring + st * W::WSTAGE;
    T* vd = kd + WROWS * W::LDK;
    for (int idx = lane; nv > 0 && idx < 2 * WROWS * PIECES; idx += 32) {
      const int v = idx / (WROWS * PIECES), r = idx / PIECES % WROWS, p = idx % PIECES;
      T* dst = (v ? vd + r * HD : kd + r * W::LDK) + p * PER;
      const int row = r0 + r;
      if (r >= nv) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      } else if (i < ntm) {
        const int t = i * TK + row;
        const size_t pg = (size_t)__ldg(a.page_table + (size_t)b * a.MP + t / a.ps);
        cp_async16(dst, static_cast<const T*>(a.main) +
                            ((pg * 2 * a.L + v * a.L + a.layer) * a.ps + t % a.ps) * kvd +
                            kvh * HD + p * PER);
      } else if (row < off) {
        cp_async16(dst, static_cast<const T*>(a.stage) +
                            (((size_t)b * a.ps + row) * 2 * a.L + v * a.L + a.layer) * kvd +
                            kvh * HD + p * PER);
      } else {  // row == off: the current token, bf16 rounded to T
        const __nv_bfloat16* src = (v ? a.v_cur : a.k_cur) + b * kvd + kvh * HD + p * PER;
#pragma unroll
        for (int e = 0; e < PER; ++e) dst[e] = from_f<T>(__bfloat162float(src[e]));
      }
    }
    cp_async_commit();
  };
  fetch(i0, 0);
  fetch(i0 + 1, 1);
  {
    const __nv_bfloat16 sc = __float2bfloat16_rn(a.scale);
    for (int idx = threadIdx.x; idx < MAX_G * HD; idx += THREADS) {
      const int g = idx / HD;
      qs[idx] = g < G ? __bfloat162float(__hmul(a.q[((size_t)b * a.NH + kvh * G) * HD + idx], sc))
                      : 0.f;
    }
  }
  __syncthreads();  // the queries

  // per head: the running max, this lane's share of the sum (its row), and
  // dims 4 lane..+3 of the output
  float m[MAX_G], l[MAX_G], acc[MAX_G][4];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
    acc[g][0] = acc[g][1] = acc[g][2] = acc[g][3] = 0.f;
  }
  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) & 1;
    cp_async_wait<1>();  // tile i's group is in
    __syncwarp();
    const int nv = rows_of(i);
    if (nv > 0) {
      const T* kt = wring + st * W::WSTAGE;
      const T* vt = kt + WROWS * W::LDK;
      float s[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
#pragma unroll 2
      for (int c = 0; c < 64; c += 8) {
        float kk[8];
        ld8(kt + j * W::LDK + 64 * hf + c, kk);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
            float qv[8];
            ld8(qs + g * HD + 64 * hf + c, qv);
#pragma unroll
            for (int e = 0; e < 8; ++e) s[g] = fmaf(qv[e], kk[e], s[g]);
          }
        }
      }
      const bool ok = j < nv;
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          float x = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 16);
          x = ok ? x : NEG;
          float mx = x;
#pragma unroll
          for (int sh = 1; sh < 16; sh <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
          const float m_new = fmaxf(m[g], mx);
          const float p = ok ? expf(x - m_new) : 0.f;
          const float alpha = expf(m[g] - m_new);
          m[g] = m_new;
          l[g] = l[g] * alpha + p;  // this lane's row; summed over the rows at the end
          if (hf == 0) wp[j * MAX_G + g] = to_f(from_f<T>(p));  // rounded to T for PV
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[g][e] *= alpha;
        }
      }
      __syncwarp();
      for (int t = 0; t < nv; ++t) {
        float w[4];
        ld4(vt + t * HD + 4 * lane, w);
        float pr[8];
        ld8(wp + t * MAX_G, pr);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[g][e] = fmaf(pr[g], w[e], acc[g][e]);
          }
        }
      }
    }
    __syncwarp();  // the lanes are done with stage st and the probabilities
    fetch(i + 2, st);
  }
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
#pragma unroll
    for (int sh = 1; sh < 16; sh <<= 1) l[g] += __shfl_xor_sync(0xffffffffu, l[g], sh);
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with its ring: the states go over them

  {
    float* w = states + warp * PART;
    if (lane == 0) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        w[g] = m[g];
        w[MAX_G + g] = l[g];
      }
    }
    float* wa = w + 2 * MAX_G;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G)
        *reinterpret_cast<float4*>(wa + g * ACC_LD + 4 * lane) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
  }
  __syncthreads();
  finish(a, states, ranks, rank, kvh, b, G);
}

// a kernel's shared-memory limit, raised once per process
template <typename Kernel>
cudaError_t smem_once(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return e;
}

}  // namespace

extern "C" {

// out [B,NH,128] = paged decode attention of layer `layer`; q [B,NH,128],
// k_cur/v_cur [B,KV,128] bf16; main [P,2L,ps,KV*128], staging_b
// [B,ps,2L,KV*128] of the pool's type `elem` (ELEM_BF16, ELEM_F16 or
// ELEM_F32); page_table [B,MP], seq_lens [B] int32 on the device. split: the
// blocks (1-8) that share each slot's history, as one cluster.
int wf_flash_paged_decode(const void* q, const void* k_cur, const void* v_cur, const void* main,
                          const void* staging_b, const void* page_table, const void* seq_lens,
                          void* out, int B, int NH, int KV, int L, int layer, int ps, int MP,
                          int D, int P, float scale, int split, int elem, void* stream) {
  if (B <= 0) return 0;
  if (D != HD || KV <= 0 || NH % KV || NH / KV > MAX_G || ps <= 0 || ps > TK || MP <= 0 ||
      P <= 0 || layer < 0 || layer >= L || split < 1 || split > MAX_SPLIT ||
      (split & (split - 1)) || elem < ELEM_BF16 || elem > ELEM_F32)
    return cudaErrorInvalidValue;
  static bool smem_set[3] = {false, false, false};  // per type
  const int smem = elem == ELEM_F32 ? Wide<float>::SMEM : SMEM;
  cudaError_t e = elem == ELEM_F16   ? smem_once(k6_decode<__half>, smem, smem_set[elem])
                  : elem == ELEM_F32 ? smem_once(k6_wide<float>, smem, smem_set[elem])
                                     : smem_once(k6_decode<__nv_bfloat16>, smem, smem_set[elem]);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  // bf16 and fp16: a warp's 16 rows lie in one page
  const int boxes = elem != ELEM_F32 && ps % WROWS == 0;
  // the main pool as [P * 2L * ps rows, KV*D]
  if (boxes &&
      (e = rows_map(&map, main, (long long)P * 2 * L * ps, KV * HD, elem)) != cudaSuccess)
    return e;
  Args a{(const __nv_bfloat16*)q, (const __nv_bfloat16*)k_cur, (const __nv_bfloat16*)v_cur,
         main, staging_b, (const int*)page_table, (const int*)seq_lens, (__nv_bfloat16*)out,
         NH, KV, L, layer, ps, MP, split, boxes, scale};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, KV, B);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = split;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = split > 1 ? 1 : 0;
  if (elem == ELEM_F16)
    e = cudaLaunchKernelEx(&cfg, k6_decode<__half>, map, a);
  else if (elem == ELEM_F32)
    e = cudaLaunchKernelEx(&cfg, k6_wide<float>, a);
  else
    e = cudaLaunchKernelEx(&cfg, k6_decode<__nv_bfloat16>, map, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"

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
// online-softmax update. The pool is bf16 or fp16 (k6_decode<T>) or f32
// (k6_decode_f32, below), all on the tensor cores; q, k_cur and v_cur are
// bf16, and the current token's row is rounded to the pool's type.
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
// f32 pools (k6_decode_f32): the bf16 kernel's split, tiles, warp
// ownership, online softmax, copy-engine boxes (an f32 tensor map, boxes of
// 16 rows x 32 dims) and combine, with the products on TF32 mma.sync
// m16n8k8, which takes f32 only in 10 mantissa bits:
// - Scores: each f32 key (A, from ldmatrix: an 8 x 16-byte matrix of f32
//   rows is a TF32 fragment) in three TF32 pieces, hi + mid + lo = k
//   exactly (sm90.cuh::split3), times the bf16 query (B, exact in TF32):
//   every product is exact in f32, so only the order of the f32 sums
//   differs from the plain version, as in bf16.
// - PV: V^T (A: tokens 8kk + 2t4 and + 1 of dims 16j + gid, four 4-byte
//   loads, free of bank conflicts in the swizzle) times the f32
//   probabilities (B), both in two TF32 pieces, as hi*hi + hi*lo + lo*hi
//   (3xTF32), each k-step's three products in a fresh accumulator added
//   to the state in f32 (no tensor-core sum runs over a rank's share); the
//   probabilities reach the lanes of their B fragments by eight shuffles a
//   tile.
// - Copies: f32 rows are twice as wide, so a warp keeps one stage of its
//   16 K rows and one of its 16 V rows (16 KB; 64 KB for the block, the
//   16-bit kernels' ring in bytes), each on its own mbarrier: the next
//   tile's K rows are copied while this tile's V rows are read, its V rows
//   while the next scores are computed. 99 KB of shared memory: two blocks
//   per SM, as flash_decode_split assumes for every pool type.
// The products, 4 * G * D operations a token in three TF32 passes each,
// take under a tenth of the copy time at the TF32 rate: the kernel stays
// bound by its bytes, twice bf16's.
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

// The end of every kernel, after the warps' states (m[8], l[8], acc[8][ACC_LD]
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

// The end of every kernel, after a warp's loop: its state for heads 2t4 and
// 2t4 + 1 (m, l over this lane's tokens, acc[j] with dims 16j + gid and
// 16j + 8 + gid) is summed over its lanes and stored over the rings (once
// every warp is done with its own), and `finish` combines the warps and the
// ranks.
__device__ __forceinline__ void end_block(const Args& a, float* states, float* ranks, int rank,
                                          int kvh, int b, int G, const float (&m)[2], float (&l)[2],
                                          const float (&acc)[HD / 16][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, t4 = lane & 3;
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
  end_block(a, states, ranks, rank, kvh, b, G, m, l, acc);
}

// ------------------------------------------------------------- f32 ----

constexpr int QUARTER = WROWS * 128;  // bytes of 32 f32 dims of a warp's 16 rows: one box
constexpr int FROWS = 4 * QUARTER;    // a warp's 16 f32 rows of K (or V): 8 KB
static_assert(WARPS * 2 * FROWS == RING, "f32 keeps the 16-bit kernels' ring and blocks per SM");

// Issue the copies of a warp's f32 K (v = 0) or V rows r0.. of tile i, of
// which the first nv > 0 are valid, into dst (8 KB), completing on bar, as
// load_rows does for 16-bit pools: committed rows by copy-engine box (four
// of 16 rows x 32 dims, from `page`) when a page holds whole boxes, the
// others row by row with cp.async (lane j < 16 copies dims 0..63 of row j,
// lane 16 + j dims 64..127); the current token's bf16 row widened to f32 by
// a converting store. Rows from nv on are zero and are not read from memory.
__device__ __forceinline__ void load_rows_f32(const Args& a, const CUtensorMap* map, char* dst,
                                              uint64_t* bar, int v, int i, int r0, int nv,
                                              int ntm, int off, int b, int kvh, int lane,
                                              int page) {
  const size_t kvd = (size_t)a.KV * HD;
  const bool boxed = i < ntm && a.boxes;
  {
    const int j = lane & 15, h = lane >> 4;
    if (j >= nv) {
#pragma unroll
      for (int c = 16 * h; c < 16 * h + 16; ++c)
        *reinterpret_cast<uint4*>(dst + swz(j, c)) = make_uint4(0, 0, 0, 0);
      fence_proxy_async();  // before the copy engine's later writes to the row
    } else if (!boxed) {
      const int row = r0 + j;
      if (i >= ntm && row >= off) {  // the current token, bf16
        const __nv_bfloat16* src = (v ? a.v_cur : a.k_cur) + b * kvd + kvh * HD;
#pragma unroll
        for (int c = 16 * h; c < 16 * h + 16; ++c) {
          const uint2 x = *reinterpret_cast<const uint2*>(src + 4 * c);
          const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.x));
          const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&x.y));
          *reinterpret_cast<float4*>(dst + swz(j, c)) = make_float4(lo.x, lo.y, hi.x, hi.y);
        }
        fence_proxy_async();  // as for the zeros above
      } else {
        const float* src;
        if (i < ntm) {
          const int t = i * TK + row;
          const size_t pt = (size_t)__ldg(a.page_table + (size_t)b * a.MP + t / a.ps);
          src = static_cast<const float*>(a.main) +
                ((pt * 2 * a.L + v * a.L + a.layer) * a.ps + t % a.ps) * kvd;
        } else {
          src = static_cast<const float*>(a.stage) +
                (((size_t)b * a.ps + row) * 2 * a.L + v * a.L + a.layer) * kvd;
        }
        src += kvh * HD;
#pragma unroll
        for (int c = 16 * h; c < 16 * h + 16; ++c) cp_async16(dst + swz(j, c), src + 4 * c);
        cp_async_arrive(bar);
      }
    }
  }
  __syncwarp();  // the row copies have joined bar before its arrival below
  if (lane == 0) mbar_expect_tx(bar, boxed ? 4 * QUARTER : 0);
  __syncwarp();
  if (boxed && lane < 4)
    tma_load(dst + lane * QUARTER, map, kvh * HD + 32 * lane,
             (page * 2 * a.L + v * a.L + a.layer) * a.ps + (i * TK + r0) % a.ps, bar);
}

// Grid (split, KV, B); cluster (split, 1, 1) when split > 1; the split,
// tiles, warp ownership, online softmax and combine of k6_decode. map: the
// main pool as rows of KV*D f32 in boxes of 16 rows x 32 dims, 128-byte
// swizzle. Each warp keeps one K stage and one V stage with a barrier each:
// the next tile's K rows are copied while this tile's V rows are read, and
// its V rows while the next tile's scores are computed.
__global__ void __launch_bounds__(THREADS, 2)
    k6_decode_f32(const __grid_constant__ CUtensorMap map, Args a) {
  extern __shared__ unsigned char raw[];
  // each warp's K rows then V rows (FROWS bytes each), 1024-byte aligned for
  // the swizzle, and after the loop the warps' states; then rank 0's slots
  // for the ranks' states
  char* ring = reinterpret_cast<char*>(raw) + ((1024 - (smem_addr(raw) & 1023)) & 1023);
  __shared__ uint64_t bars[WARPS][2];  // a warp's K and V rows are in
  float* states = reinterpret_cast<float*>(ring);
  float* ranks = reinterpret_cast<float*>(ring + RING);
  const int rank = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.NH / a.KV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, gid = lane >> 2, t4 = lane & 3;
  char* kd = ring + warp * 2 * FROWS;
  char* vd = kd + FROWS;
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
  // the warp's next tile from i on with rows in it, or i1
  auto next = [&](int i) {
    while (i < i1 && rows_of(i) <= 0) ++i;
    return i;
  };

  if (a.split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  if (lane == 0) {
    mbar_init(&bars[warp][0], 1);
    mbar_init(&bars[warp][1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // lane k holds the page of this warp's rows of tile i0 + k (committed tiles)
  int pg = 0;
  if (a.boxes && i0 + lane < min(i1, ntm)) {
    prefetch_map(&map);
    const int t = (i0 + lane) * TK + r0;
    if (t < full) pg = __ldg(a.page_table + (size_t)b * a.MP + t / a.ps);
  }
  __syncwarp();
  auto issue = [&](int v, int i) {
    int page = __shfl_sync(0xffffffffu, pg, (i - i0) & 31);
    if (i - i0 >= 32 && i < ntm && a.boxes)  // past the held pages
      page = __ldg(a.page_table + (size_t)b * a.MP + (i * TK + r0) / a.ps);
    load_rows_f32(a, &map, v ? vd : kd, &bars[warp][v], v, i, r0, rows_of(i), ntm, off, b, kvh,
                  lane, page);
  };
  int i = next(i0);
  if (i < i1) {
    issue(0, i);
    issue(1, i);
  }

  // q of head gid (zero past G), scaled in bf16 and widened to f32 (exact
  // in TF32), as the B fragments of the score mma's 16 k-steps: dims
  // 8k + t4 and 8k + t4 + 4
  float qb[HD / 8][2];
  {
    const __nv_bfloat16 sc = __float2bfloat16_rn(a.scale);
    const __nv_bfloat16* qr = a.q + ((size_t)b * a.NH + kvh * G + gid) * HD + t4;
#pragma unroll
    for (int k = 0; k < HD / 8; ++k) {
      qb[k][0] = gid < G ? __bfloat162float(__hmul(qr[8 * k], sc)) : 0.f;
      qb[k][1] = gid < G ? __bfloat162float(__hmul(qr[8 * k + 4], sc)) : 0.f;
    }
  }

  // this warp's state for heads 2t4 and 2t4 + 1, as k6_decode's
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};
  float acc[HD / 16][4];
#pragma unroll
  for (int j = 0; j < HD / 16; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  uint32_t phase = 0;  // bit v: the parity of the K (0) or V (1) stage's next phase
  while (i < i1) {
    const int nx = next(i + 1);
    const int nv = rows_of(i);
    mbar_wait(&bars[warp][0], phase & 1);
    phase ^= 1u;

    // scores of tokens r0 + gid ([0], [1]) and r0 + 8 + gid ([2], [3]) for
    // heads 2t4 and 2t4 + 1: each f32 key in three TF32 pieces (ldmatrix's
    // registers: row gid (+8 for odd e), dim 8k + t4 (+4 for e >= 2)) times
    // the bf16 query, every product exact; one chain per piece and k parity
    float sp[3][2][4] = {};
#pragma unroll
    for (int k = 0; k < HD / 8; ++k) {
      uint32_t ka[4];
      ldmatrix_x4(ka, kd + swz(lane & 15, 2 * k + (lane >> 4)));
      float pc[3][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) split3(__uint_as_float(ka[e]), pc[0][e], pc[1][e], pc[2][e]);
#pragma unroll
      for (int u = 0; u < 3; ++u)
        mma_tf32(sp[u][k & 1], pc[u][0], pc[u][1], pc[u][2], pc[u][3], qb[k][0], qb[k][1]);
    }
    __syncwarp();  // the lanes are done with the K stage
    if (nx < i1) issue(0, nx);
    float s[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[e] = (sp[0][0][e] + sp[0][1][e]) + ((sp[1][0][e] + sp[1][1][e]) + (sp[2][0][e] + sp[2][1][e]));
    const bool ok0 = gid < nv, ok1 = 8 + gid < nv;
    float p[4], alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float sa = ok0 ? s[e] : NEG;
      const float sb = ok1 ? s[2 + e] : NEG;
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
    // the f32 probabilities as the PV mma's B fragments (tokens x heads), in
    // two TF32 pieces: k-step kk takes token 8kk + 2t4 as k-index t4 and
    // 8kk + 2t4 + 1 as t4 + 4, for head gid, from the lanes that scored them
    float bh[2][2], bl[2][2];
    {
      const int src = 8 * t4 + (gid >> 1);  // the lane of token 2t4, heads 2 (gid >> 1), +1
      float x[4], y[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        x[e] = __shfl_sync(0xffffffffu, p[e], src);
        y[e] = __shfl_sync(0xffffffffu, p[e], src + 4);
      }
      const int odd = gid & 1;
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        split2(odd ? x[2 * kk + 1] : x[2 * kk], bh[kk][0], bl[kk][0]);
        split2(odd ? y[2 * kk + 1] : y[2 * kk], bh[kk][1], bl[kk][1]);
      }
    }
    mbar_wait(&bars[warp][1], (phase >> 1) & 1);
    phase ^= 2u;
    // acc += V^T P (3xTF32): V^T's A fragments are tokens 8kk + 2t4 and
    // 8kk + 2t4 + 1 of dims 16j + gid and 16j + 8 + gid
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      acc[j][0] *= alpha[0];
      acc[j][1] *= alpha[1];
      acc[j][2] *= alpha[0];
      acc[j][3] *= alpha[1];
      const int c = 4 * j + (gid >> 2), o4 = 4 * (gid & 3);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int r = 8 * kk + 2 * t4;
        float vh[4], vl[4];
        split2(*reinterpret_cast<const float*>(vd + swz(r, c) + o4), vh[0], vl[0]);
        split2(*reinterpret_cast<const float*>(vd + swz(r, c + 2) + o4), vh[1], vl[1]);
        split2(*reinterpret_cast<const float*>(vd + swz(r + 1, c) + o4), vh[2], vl[2]);
        split2(*reinterpret_cast<const float*>(vd + swz(r + 1, c + 2) + o4), vh[3], vl[3]);
        // small products first, in a fresh accumulator added to acc in f32
        float d[4];
        mma_tf32_first(d, vl[0], vl[1], vl[2], vl[3], bh[kk][0], bh[kk][1]);
        mma_tf32(d, vh[0], vh[1], vh[2], vh[3], bl[kk][0], bl[kk][1]);
        mma_tf32(d, vh[0], vh[1], vh[2], vh[3], bh[kk][0], bh[kk][1]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += d[e];
      }
    }
    __syncwarp();  // the lanes are done with the V stage
    if (nx < i1) issue(1, nx);
    i = nx;
  }
  end_block(a, states, ranks, rank, kvh, b, G, m, l, acc);
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

// the shared-memory limit of the kernel for pool type elem, raised once per
// process and type
cudaError_t smem_for(int elem) {
  static bool smem_set[3] = {false, false, false};
  if (elem == ELEM_F16) return smem_once(k6_decode<__half>, SMEM, smem_set[elem]);
  if (elem == ELEM_F32) return smem_once(k6_decode_f32, SMEM, smem_set[elem]);
  return smem_once(k6_decode<__nv_bfloat16>, SMEM, smem_set[elem]);
}

}  // namespace

extern "C" {

// The dynamic shared memory of one block of the kernel for pool type elem
// (ELEM_BF16, ELEM_F16 or ELEM_F32) and the blocks of it that one SM of the
// current device holds at once, into out[0] and out[1] (host ints): what
// flash_attention.py::flash_decode_split assumes (DECODE_BLOCKS_PER_SM).
int wf_flash_paged_decode_occupancy(int elem, void* out) {
  if (elem < ELEM_BF16 || elem > ELEM_F32) return cudaErrorInvalidValue;
  cudaError_t e = smem_for(elem);
  if (e != cudaSuccess) return e;
  int blocks = 0;
  e = elem == ELEM_F16   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               &blocks, k6_decode<__half>, THREADS, SMEM)
      : elem == ELEM_F32 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               &blocks, k6_decode_f32, THREADS, SMEM)
                         : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                               &blocks, k6_decode<__nv_bfloat16>, THREADS, SMEM);
  if (e != cudaSuccess) return e;
  static_cast<int*>(out)[0] = SMEM;
  static_cast<int*>(out)[1] = blocks;
  return 0;
}

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
  cudaError_t e = smem_for(elem);
  if (e != cudaSuccess) return e;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const int boxes = ps % WROWS == 0;  // a warp's 16 rows lie in one page
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
  cfg.dynamicSmemBytes = SMEM;
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
    e = cudaLaunchKernelEx(&cfg, k6_decode_f32, map, a);
  else
    e = cudaLaunchKernelEx(&cfg, k6_decode<__nv_bfloat16>, map, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"

// In-place paged-KV row writer (K3) for Hopper.
//
// Replaces wrinklefree_tpu/ops/kv_update_pallas.py::kv_write_pallas (kernel
// body _kv_write_kernel): pool[flat_id[i], off[i]] = vals[i] for N rows, in
// place, each row a contiguous block of row_bytes (a staging row [2L, KV*D]
// or a whole flushed page [2L*ps, KV*D]).
//
// Bound: bytes. The work is N*row_bytes read and the same written; nothing
// is computed. Each row is split into 16 KB chunks, one block per (row,
// chunk), copied with 16-byte vector loads and stores so that a few large
// page flushes still spread over many SMs. Rows whose destination is out of
// range are skipped. Only trash rows (page 0, staging slot NS) may share a
// destination; any writer may win there.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr long long CHUNK_VEC = 1024;  // 16 KB of uint4 per block

__global__ void kv_write_kernel(uint4* __restrict__ pool, const uint4* __restrict__ vals,
                                const int* __restrict__ ids, const int* __restrict__ offs,
                                int ps, long long pool_rows, long long row_vec) {
  const int i = blockIdx.x;
  const long long dst_row = (long long)ids[i] * ps + offs[i];
  if (ids[i] < 0 || offs[i] < 0 || offs[i] >= ps || dst_row >= pool_rows) return;
  const uint4* src = vals + (long long)i * row_vec;
  uint4* dst = pool + dst_row * row_vec;
  const long long start = (long long)blockIdx.y * CHUNK_VEC;
  long long end = start + CHUNK_VEC;
  if (end > row_vec) end = row_vec;
  for (long long v = start + threadIdx.x; v < end; v += THREADS) dst[v] = src[v];
}

}  // namespace

extern "C" {

// pool: [pool_rows, row_bytes] viewed flat (pool_rows = pages * ps);
// vals: [n, row_bytes]; ids, offs: [n] int32 on the device.
int wf_kv_write(void* pool, const void* vals, const void* ids, const void* offs, int n, int ps,
                long long pool_rows, long long row_bytes, void* stream) {
  if (n <= 0) return 0;
  if (row_bytes % 16) return cudaErrorInvalidValue;
  const long long row_vec = row_bytes / 16;
  dim3 grid(n, (unsigned)((row_vec + CHUNK_VEC - 1) / CHUNK_VEC));
  kv_write_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (uint4*)pool, (const uint4*)vals, (const int*)ids, (const int*)offs, ps, pool_rows,
      row_vec);
  return cudaGetLastError();
}

}  // extern "C"

// Weight-stream touch kernel (K10) of the stream calibration for Hopper.
//
// Replaces wrinklefree_tpu/bench/calibrate.py::measure_stream_us_per_layer
// (kernel body _kernel): per call, out[8,128] = h + sum_g gw[l, :8,
// g*tn_gu : g*tn_gu+128] + sum_d dw[l, :8, d*tn_d : d*tn_d+128] in f32, the
// TPU kernel's function, whose BlockSpecs move every byte of the layer's
// packed MLP weights (gw [K4, NGU], dw [I4, NH] int8) through VMEM. On the
// card a load whose value is unused is removed by the compiler, so every
// thread folds the 16-byte words it reads into a sum of their int32 lanes,
// and each block adds its sum to a 64-bit checksum in device memory: every
// byte of the layer is read once per call, as on the TPU.
//
// Bound: bytes (13.27 MB per BitNet-2B layer, about 4 us at 3.35 TB/s). The
// grid covers the layer with about four 16-byte loads in flight per thread.
//
// Launches on the caller's stream, allocates nothing and returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;

__global__ void __launch_bounds__(THREADS)
k10_touch(const float* __restrict__ h, const int8_t* __restrict__ gw,
          const int8_t* __restrict__ dw, int k4, int n_gu, int i4, int n_h, int tn_gu, int tn_d,
          float* __restrict__ out, unsigned long long* __restrict__ checksum) {
  __shared__ long long red[THREADS / 32];
  const size_t ng = (size_t)k4 * n_gu / 16, nd = (size_t)i4 * n_h / 16;  // 16-byte words
  const uint4* g4 = reinterpret_cast<const uint4*>(gw);
  const uint4* d4 = reinterpret_cast<const uint4*>(dw);
  const size_t tid = (size_t)blockIdx.x * THREADS + threadIdx.x;
  const size_t stride = (size_t)gridDim.x * THREADS;

  // the TPU function: one output element per thread of the first 1024
  if (tid < 8 * 128) {
    const int r = (int)tid / 128, c = (int)tid % 128;
    float acc = 0.f;
    for (int g = 0; g < n_gu / tn_gu; ++g) acc += (float)gw[(size_t)r * n_gu + g * tn_gu + c];
    for (int d = 0; d < n_h / tn_d; ++d) acc += (float)dw[(size_t)r * n_h + d * tn_d + c];
    out[tid] = h[tid] + acc;
  }

  long long s = 0;
  for (size_t i = tid; i < ng + nd; i += stride * UNROLL) {
    uint4 w[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const size_t j = i + u * stride;
      w[u] = j < ng ? __ldg(g4 + j) : (j < ng + nd ? __ldg(d4 + (j - ng)) : make_uint4(0, 0, 0, 0));
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      s += (long long)(int)w[u].x + (int)w[u].y + (int)w[u].z + (int)w[u].w;
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long t = 0;
    for (int w = 0; w < THREADS / 32; ++w) t += red[w];
    atomicAdd(checksum, (unsigned long long)t);  // two's complement: a signed sum
  }
}

}  // namespace

extern "C" {

// K10: out[8,128] f32 = the touch of h[8,128] f32 with the layer's gw[k4, n_gu]
// and dw[i4, n_h] int8 (pointers at the layer's bytes, 16-byte aligned, both
// sizes multiples of 16); checksum: one int64 on the device, incremented by
// the sum of the layer's bytes read as int32 words.
int wf_stream_touch(const void* h, const void* gw, const void* dw, int k4, int n_gu, int i4,
                    int n_h, int tn_gu, int tn_d, void* out, void* checksum, void* stream) {
  if (k4 < 8 || i4 < 8 || tn_gu < 128 || tn_d < 128 || n_gu % tn_gu || n_h % tn_d ||
      ((size_t)k4 * n_gu) % 16 || ((size_t)i4 * n_h) % 16)
    return cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  const size_t words = ((size_t)k4 * n_gu + (size_t)i4 * n_h) / 16;
  size_t blocks = (words + (size_t)THREADS * UNROLL - 1) / ((size_t)THREADS * UNROLL);
  if (blocks > (size_t)sms * 8) blocks = (size_t)sms * 8;
  if (blocks < 4) blocks = 4;  // 1024 threads for the 8 x 128 output
  k10_touch<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)h, (const int8_t*)gw, (const int8_t*)dw, k4, n_gu, i4, n_h, tn_gu, tn_d,
      (float*)out, (unsigned long long*)checksum);
  return cudaGetLastError();
}

}  // extern "C"

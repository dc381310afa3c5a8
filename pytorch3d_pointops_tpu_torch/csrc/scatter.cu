// Deterministic row scatter-add: out[n, idx[n, e], :] += contrib[n, e, :],
// skipping idx < 0.
//
// Replaces: pytorch3d_pointops_tpu/kernels/scatter_pallas.py
// scatter_add_rows_pallas (kernel body _scatter_rows_kernel) and
// pytorch3d_pointops_tpu/kernels/chamfer_pallas.py scatter_add_k1_pallas
// (kernel body _scatter_k1_kernel). Both compute this same function.
//
// Bound on the card: bytes. Each entry is read once (an 8-byte index and C
// floats) and each target row written once; there is one add per entry and
// channel. Design: float atomicAdd would be fast but sums in an order that
// changes from run to run, so the caller sorts the entries by target row
// (a stable argsort, index preparation outside the kernel) and this kernel
// gives every target row one thread. The thread finds its segment of the
// sorted keys by binary search and sums the segment's channels in
// ascending entry order, so the result is bit-equal from run to run and
// needs no atomics and no zero-fill pass: rows with no entry write 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRegChannels = 8;  // channels summed in registers at once

// First position in keys[0, E) whose key is >= q (keys ascending).
__device__ __forceinline__ int64_t lower_bound(const int64_t* keys, int64_t E,
                                               int64_t q) {
  int64_t lo = 0, hi = E;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (keys[mid] < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const int64_t* __restrict__ sorted_keys, const int64_t* __restrict__ order,
    const float* __restrict__ contrib, int N, int64_t E, int P2, int C,
    float* __restrict__ out) {
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)N * P2) return;
  const int64_t n = t / P2;
  const int64_t q = t - n * P2;
  const int64_t* keys = sorted_keys + n * E;
  const int64_t* ord = order + n * E;
  const float* src = contrib + n * E * C;
  const int64_t a = lower_bound(keys, E, q);
  const int64_t b = lower_bound(keys, E, q + 1);
  float* dst = out + t * C;

  for (int c0 = 0; c0 < C; c0 += kRegChannels) {
    float acc[kRegChannels];
#pragma unroll
    for (int c = 0; c < kRegChannels; ++c) acc[c] = 0.f;
    for (int64_t e = a; e < b; ++e) {
      const float* v = src + ord[e] * C + c0;
#pragma unroll
      for (int c = 0; c < kRegChannels; ++c) {
        if (c0 + c < C) acc[c] = __fadd_rn(acc[c], v[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kRegChannels; ++c) {
      if (c0 + c < C) dst[c0 + c] = acc[c];
    }
  }
}

}  // namespace

// sorted_keys (N, E) int64: each row's target indices sorted ascending, with
// skipped entries keyed P2 or more; order (N, E) int64: the entry each
// sorted key came from, ascending within equal keys; contrib (N, E, C)
// float32; out (N, P2, C) float32. Returns the launch's cudaError_t.
extern "C" int scatter_segment_sum(const int64_t* sorted_keys,
                                   const int64_t* order, const float* contrib,
                                   int N, int64_t E, int P2, int C, float* out,
                                   void* stream) {
  const int64_t rows = (int64_t)N * P2;
  if (rows <= 0 || C <= 0) return cudaSuccess;
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      sorted_keys, order, contrib, N, E, P2, C, out);
  return cudaGetLastError();
}

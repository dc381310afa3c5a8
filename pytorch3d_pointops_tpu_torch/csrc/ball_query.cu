// Ball query: for each query, the first K points of its cloud in scan order
// whose squared distance is strictly below r2, with those distances.
//
// Replaces: pytorch3d_pointops_tpu/kernels/ball_query_pallas.py
// ball_query_forward_pallas (rounds _bq_round, kernel body _bq_kernel). The
// TPU kernel turns the early-exit scan into a top-K over column keys held as
// float32 (so P2 < 2^24) in 64-key rounds; here the scan itself is the
// natural form, with int64 indices, any P2 and any K in one pass.
//
// Bound on the card: operations while queries are still filling, then the
// early exit. A query costs 3*D float32 operations per candidate it visits,
// and it visits candidates only up to its K-th hit (or lengths2). Design:
// one thread per query with its coordinates in registers (D <= 8); the block
// stages (tile, D) candidate tiles in shared memory in ascending column
// order with coalesced loads, and every thread reads the same shared word at
// once (a broadcast). A thread appends each hit to its own output row in
// device memory, so K is not limited by registers. The block leaves the scan
// when every query in it holds K hits (__syncthreads_and) or the tiles pass
// lengths2[n].
//
// Pad conventions: rows past lengths1[n] are all -1 with distance 0, and
// the slots past a query's hits are -1 and 0.
//
// Arithmetic: each axis term is rounded on its own and summed in order
// d = 0..D-1 (__fsub_rn/__fmul_rn/__fadd_rn, never contracted to FMA), so
// the distances, and hence the d2 < r2 decisions, are bit-equal to the plain
// PyTorch version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // queries per block
constexpr int kTileFloats = 12288;  // 48 KB of staged candidate coordinates
constexpr int kMaxTile = 512;       // candidates per staged tile

__device__ __forceinline__ int64_t clamp_len(int64_t len, int P) {
  return len < 0 ? 0 : (len > P ? P : len);
}

// DIM > 0: the query lives in registers and loops unroll to DIM; the runtime
// D must be <= DIM (shorter D is predicated). DIM == 0: any D, read from
// global memory (L1-resident after the first tile).
template <int DIM>
__global__ void __launch_bounds__(kThreads) ball_query_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const int64_t* __restrict__ lengths1, const int64_t* __restrict__ lengths2,
    int P1, int P2, int D, int K, float r2, int tile,
    float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  extern __shared__ float tile_s[];  // (tile, D) candidate coordinates
  const int n = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < P1 && q < clamp_len(lengths1[n], P1);
  const int64_t row = (int64_t)n * P1 + (q < P1 ? q : 0);
  const float* qp = p1 + row * D;
  float* od = out_d + row * K;
  int64_t* oi = out_i + row * K;

  float qr[DIM > 0 ? DIM : 1];
#pragma unroll
  for (int d = 0; d < (DIM > 0 ? DIM : 1); ++d) {
    qr[d] = (DIM > 0 && active && d < D) ? qp[d] : 0.f;
  }

  const int64_t len2 = clamp_len(lengths2[n], P2);
  const float* p2n = p2 + (int64_t)n * P2 * D;
  int count = 0;

  for (int64_t t0 = 0; t0 < len2; t0 += tile) {
    // Also the barrier after which the previous tile is no longer read.
    if (__syncthreads_and(!active || count >= K)) break;
    const int cnt = (int)min((int64_t)tile, len2 - t0);
    const float* src = p2n + t0 * D;
    for (int e = threadIdx.x; e < cnt * D; e += kThreads) tile_s[e] = src[e];
    __syncthreads();
    if (!active || count >= K) continue;
    for (int jj = 0; jj < cnt; ++jj) {
      const float* c = tile_s + jj * D;
      float dist = 0.f;
      if (DIM > 0) {
#pragma unroll
        for (int d = 0; d < (DIM > 0 ? DIM : 1); ++d) {
          if (d < D) {
            const float diff = __fsub_rn(qr[d], c[d]);
            dist = __fadd_rn(dist, __fmul_rn(diff, diff));
          }
        }
      } else {
        for (int d = 0; d < D; ++d) {
          const float diff = __fsub_rn(qp[d], c[d]);
          dist = __fadd_rn(dist, __fmul_rn(diff, diff));
        }
      }
      if (dist < r2) {
        od[count] = dist;
        oi[count] = t0 + jj;
        if (++count == K) break;
      }
    }
  }

  if (q >= P1) return;
  for (int s = count; s < K; ++s) {
    od[s] = 0.f;
    oi[s] = -1;
  }
}

template <int DIM>
cudaError_t launch(const float* p1, const float* p2, const int64_t* lengths1,
                   const int64_t* lengths2, int N, int P1, int P2, int D,
                   int K, float r2, float* out_d, int64_t* out_i,
                   cudaStream_t stream) {
  int tile = kTileFloats / D;
  tile = tile < 1 ? 1 : (tile > kMaxTile ? kMaxTile : tile);
  const size_t smem = (size_t)tile * D * sizeof(float);
  const dim3 grid((P1 + kThreads - 1) / kThreads, N);
  ball_query_kernel<DIM><<<grid, kThreads, smem, stream>>>(
      p1, p2, lengths1, lengths2, P1, P2, D, K, r2, tile, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

// p1 (N, P1, D), p2 (N, P2, D) float32; lengths1, lengths2 (N,) int64; r2
// the float32 squared radius; out_d (N, P1, K) float32 and out_i (N, P1, K)
// int64, written in full. Returns the launch's cudaError_t.
extern "C" int ball_query(const float* p1, const float* p2,
                          const int64_t* lengths1, const int64_t* lengths2,
                          int N, int P1, int P2, int D, int K, float r2,
                          float* out_d, int64_t* out_i, void* stream) {
  if (N <= 0 || P1 <= 0) return cudaSuccess;
  if (D < 1 || K < 1 || N > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 3) {
    return launch<3>(p1, p2, lengths1, lengths2, N, P1, P2, D, K, r2, out_d,
                     out_i, s);
  }
  if (D <= 8) {
    return launch<8>(p1, p2, lengths1, lengths2, N, P1, P2, D, K, r2, out_d,
                     out_i, s);
  }
  return launch<0>(p1, p2, lengths1, lengths2, N, P1, P2, D, K, r2, out_d,
                   out_i, s);
}

// Streaming brute-force KNN with a register-resident sorted top-K per query.
//
// Replaces: pytorch3d_pointops_tpu/kernels/knn_pallas.py knn_forward_pallas
// (kernel body _knn_kernel), including its any-K contract that the TPU side
// serves by chaining 64-key rounds (_knn_forward_pallas_bigk).
//
// Bound on the card: operations. A query against P2 candidates costs 3*D
// float32 operations per candidate (subtract, square or abs, accumulate)
// while it reads only the candidate coordinates, which every thread of a
// block shares. Design: one thread per query with its coordinates in
// registers (D <= 8), the block stages (tile, D) candidate tiles in shared
// memory with coalesced loads, and every thread reads the same shared word
// at once (a broadcast, no bank conflicts). The top-K state is a sorted
// (value, index) array in registers, templated on K buckets so that the
// insertion unrolls fully and never spills to local memory; a candidate
// costs one compare against the current kth value unless it wins.
//
// Order: candidates are scanned in ascending index and inserted only when
// strictly smaller than the kth value, behind entries of equal value, so
// the state is in lexicographic (value, index) order: on ties the lowest
// index wins. K > 64 runs ceil(K/64) rounds of the 64-bucket kernel; round r
// admits only candidates lexicographically above round r-1's last entry
// (lb_d, lb_i), so the rounds concatenate to the global order.
//
// Arithmetic: each axis term is rounded on its own and summed in order
// d = 0..D-1 (__fsub_rn/__fmul_rn/__fadd_rn, never contracted to FMA), so
// the distances are bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // queries per block
constexpr int kTileFloats = 12288;  // 48 KB of staged candidate coordinates
constexpr int kMaxTile = 512;       // candidates per staged tile

template <int NORM>
__device__ __forceinline__ float axis_term(float a, float b) {
  const float diff = __fsub_rn(a, b);
  return NORM == 2 ? __fmul_rn(diff, diff) : fabsf(diff);
}

// DIM > 0: the query lives in registers and loops unroll to DIM; the runtime
// D must be <= DIM (shorter D is predicated). DIM == 0: any D, read from
// global memory (L1-resident after the first tile).
template <int KB, int DIM, int NORM>
__global__ void __launch_bounds__(kThreads) knn_topk_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const int64_t* __restrict__ lengths2, const float* __restrict__ lb_d,
    const int64_t* __restrict__ lb_i, int P1, int P2, int D, int K, int tile,
    float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  extern __shared__ float tile_s[];  // (tile, D) candidate coordinates
  const int n = blockIdx.y;
  const int q = blockIdx.x * kThreads + threadIdx.x;
  const bool active = q < P1;
  const int64_t row = (int64_t)n * P1 + (active ? q : 0);
  const float* qp = p1 + row * D;

  float qr[DIM > 0 ? DIM : 1];
#pragma unroll
  for (int d = 0; d < (DIM > 0 ? DIM : 1); ++d) {
    qr[d] = (DIM > 0 && d < D) ? qp[d] : 0.f;
  }

  float bd[KB];
  int bi[KB];
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    bd[s] = INFINITY;
    bi[s] = 0;
  }

  const bool chained = lb_d != nullptr;
  float lbd = 0.f;
  int lbi = 0;
  if (chained && active) {
    lbd = lb_d[row];
    lbi = (int)lb_i[row];
  }

  int64_t len2 = lengths2[n];
  len2 = len2 < 0 ? 0 : (len2 > P2 ? P2 : len2);
  const float* p2n = p2 + (int64_t)n * P2 * D;

  for (int t0 = 0; t0 < len2; t0 += tile) {
    const int cnt = (int)min((int64_t)tile, len2 - t0);
    __syncthreads();  // the previous tile is no longer read
    const float* src = p2n + (int64_t)t0 * D;
    for (int e = threadIdx.x; e < cnt * D; e += kThreads) tile_s[e] = src[e];
    __syncthreads();
    if (!active) continue;
    for (int jj = 0; jj < cnt; ++jj) {
      const float* c = tile_s + jj * D;
      float dist = 0.f;
      if (DIM > 0) {
#pragma unroll
        for (int d = 0; d < (DIM > 0 ? DIM : 1); ++d) {
          if (d < D) dist = __fadd_rn(dist, axis_term<NORM>(qr[d], c[d]));
        }
      } else {
        for (int d = 0; d < D; ++d) {
          dist = __fadd_rn(dist, axis_term<NORM>(qp[d], c[d]));
        }
      }
      if (!(dist < bd[KB - 1])) continue;
      const int j = t0 + jj;
      if (chained && !(dist > lbd || (dist == lbd && j > lbi))) continue;
      // Insert behind every entry <= dist: slot s takes slot s-1's entry
      // when that entry is larger, else the candidate when slot s held a
      // larger value. Walking s downward reads slots not yet written.
#pragma unroll
      for (int s = KB - 1; s > 0; --s) {
        if (bd[s - 1] > dist) {
          bd[s] = bd[s - 1];
          bi[s] = bi[s - 1];
        } else if (bd[s] > dist) {
          bd[s] = dist;
          bi[s] = j;
        }
      }
      if (bd[0] > dist) {
        bd[0] = dist;
        bi[0] = j;
      }
    }
  }

  if (!active) return;
  float* od = out_d + row * K;
  int64_t* oi = out_i + row * K;
#pragma unroll
  for (int s = 0; s < KB; ++s) {
    if (s < K) {
      od[s] = bd[s];
      oi[s] = bi[s];
    }
  }
}

template <int KB, int DIM, int NORM>
cudaError_t launch(const float* p1, const float* p2, const int64_t* lengths2,
                   const float* lb_d, const int64_t* lb_i, int N, int P1,
                   int P2, int D, int K, float* out_d, int64_t* out_i,
                   cudaStream_t stream) {
  int tile = kTileFloats / D;
  tile = tile < 1 ? 1 : (tile > kMaxTile ? kMaxTile : tile);
  const size_t smem = (size_t)tile * D * sizeof(float);
  const dim3 grid((P1 + kThreads - 1) / kThreads, N);
  knn_topk_kernel<KB, DIM, NORM><<<grid, kThreads, smem, stream>>>(
      p1, p2, lengths2, lb_d, lb_i, P1, P2, D, K, tile, out_d, out_i);
  return cudaGetLastError();
}

template <int KB, int NORM>
cudaError_t launch_dim(const float* p1, const float* p2,
                       const int64_t* lengths2, const float* lb_d,
                       const int64_t* lb_i, int N, int P1, int P2, int D,
                       int K, float* out_d, int64_t* out_i,
                       cudaStream_t stream) {
  if (D == 3) {
    return launch<KB, 3, NORM>(p1, p2, lengths2, lb_d, lb_i, N, P1, P2, D, K,
                               out_d, out_i, stream);
  }
  if (D <= 8) {
    return launch<KB, 8, NORM>(p1, p2, lengths2, lb_d, lb_i, N, P1, P2, D, K,
                               out_d, out_i, stream);
  }
  return launch<KB, 0, NORM>(p1, p2, lengths2, lb_d, lb_i, N, P1, P2, D, K,
                             out_d, out_i, stream);
}

template <int NORM>
cudaError_t launch_k(const float* p1, const float* p2, const int64_t* lengths2,
                     const float* lb_d, const int64_t* lb_i, int N, int P1,
                     int P2, int D, int K, float* out_d, int64_t* out_i,
                     cudaStream_t stream) {
#define KNN_BUCKET(KB)                                                      \
  if (K <= KB)                                                              \
    return launch_dim<KB, NORM>(p1, p2, lengths2, lb_d, lb_i, N, P1, P2, D, \
                                K, out_d, out_i, stream);
  KNN_BUCKET(1)
  KNN_BUCKET(2)
  KNN_BUCKET(4)
  KNN_BUCKET(8)
  KNN_BUCKET(16)
  KNN_BUCKET(32)
  KNN_BUCKET(64)
#undef KNN_BUCKET
  return cudaErrorInvalidValue;
}

}  // namespace

// p1 (N, P1, D), p2 (N, P2, D) float32; lengths2 (N,) int64; lb_d/lb_i
// (N, P1) or null; out_d/out_i (N, P1, K) with 1 <= K <= 64. Returns the
// launch's cudaError_t.
extern "C" int knn_topk(const float* p1, const float* p2,
                        const int64_t* lengths2, const float* lb_d,
                        const int64_t* lb_i, int N, int P1, int P2, int D,
                        int K, int norm, float* out_d, int64_t* out_i,
                        void* stream) {
  if (N <= 0 || P1 <= 0) return cudaSuccess;
  if (D < 1 || K < 1 || K > 64 || N > 65535) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (norm == 2) {
    return launch_k<2>(p1, p2, lengths2, lb_d, lb_i, N, P1, P2, D, K, out_d,
                       out_i, s);
  }
  if (norm == 1) {
    return launch_k<1>(p1, p2, lengths2, lb_d, lb_i, N, P1, P2, D, K, out_d,
                       out_i, s);
  }
  return cudaErrorInvalidValue;
}

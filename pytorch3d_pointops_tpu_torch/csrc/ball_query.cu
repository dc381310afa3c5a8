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
// and it visits candidates only up to its K-th hit (or lengths2); at
// PointNet++ radii most balls hold fewer than K points, so most queries
// visit the whole cloud. Design: one warp per query, 16 queries a block,
// all of one cloud. The block stages its cloud's candidates in shared
// memory once as structure of arrays ([d][j], so the lanes' reads are
// conflict-free at every D): the whole of lengths2[n] where it fits 48 KB
// (4096 points at D=3), else in tiles, each between two block barriers that
// every warp joins, finished or not. Lane l takes candidate t0 + 32 i + l;
// a ballot of the lanes within the radius gives each hit its slot, count +
// the hits of the lower lanes, so the hits keep the scan order and one
// ballot's hits go to consecutive slots of the query's row (coalesced
// stores). The warp leaves when count reaches K (warp-uniform) or the
// candidates end; the lanes then fill the pads [count, K).
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

constexpr int kWarps = 16;                 // queries per block, one a warp
constexpr int kThreads = kWarps * 32;
constexpr int kTileFloats = 12288;         // 48 KB of staged candidate coordinates
constexpr int kGroups = 2;                 // 32-candidate groups a step of a scan

__device__ __forceinline__ int64_t clamp_len(int64_t len, int P) {
  return len < 0 ? 0 : (len > P ? P : len);
}

// DIM > 0: the query lives in registers and loops unroll to DIM; the runtime
// D must be <= DIM (shorter D is predicated). DIM == 0: any D, the query
// read from global memory (the same word in every lane, L1-resident).
template <int DIM>
__global__ void __launch_bounds__(kThreads) ball_query_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const int64_t* __restrict__ lengths1, const int64_t* __restrict__ lengths2,
    int P1, int P2, int D, int K, float r2, int tile,
    float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  extern __shared__ float tile_s[];  // [d][tile] candidate coordinates
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
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
  const unsigned lower = (1u << lane) - 1u;  // the lanes below this one
  int count = 0;  // hits so far; may pass K in a warp's last step
  bool done = !active;

  for (int64_t t0 = 0; t0 < len2; t0 += tile) {
    // Every warp comes here, finished or not. Also the barrier after which
    // the previous tile is no longer read.
    if (__syncthreads_and(done)) break;
    const int cnt = (int)min((int64_t)tile, len2 - t0);
    const float* src = p2n + t0 * D;
    for (int j = threadIdx.x; j < cnt; j += kThreads) {
      for (int d = 0; d < D; ++d) tile_s[d * tile + j] = src[(int64_t)j * D + d];
    }
    __syncthreads();
    if (done) continue;
    for (int j0 = 0; j0 < cnt; j0 += 32 * kGroups) {
      float dist[kGroups];
      bool hit[kGroups];
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const int j = j0 + 32 * g + lane;
        const int jr = j < cnt ? j : cnt - 1;  // a point of the tile to read
        const float* c = tile_s + jr;
        float diff = __fsub_rn(DIM > 0 ? qr[0] : qp[0], c[0]);
        float dd = __fmul_rn(diff, diff);  // 0 + t is t: summed from the first term
#pragma unroll
        for (int d = 1; d < (DIM > 0 ? DIM : D); ++d) {
          if (DIM == 0 || d < D) {
            diff = __fsub_rn(DIM > 0 ? qr[d] : qp[d], c[d * tile]);
            dd = __fadd_rn(dd, __fmul_rn(diff, diff));
          }
        }
        dist[g] = dd;
        hit[g] = j < cnt && dd < r2;
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        const unsigned m = __ballot_sync(0xffffffffu, hit[g]);
        const int slot = count + __popc(m & lower);
        if (hit[g] && slot < K) {
          od[slot] = dist[g];
          oi[slot] = t0 + j0 + 32 * g + lane;
        }
        count += __popc(m);
      }
      if (count >= K) {
        done = true;
        break;
      }
    }
  }

  if (q >= P1) return;
  for (int s = min(count, K) + lane; s < K; s += 32) {
    od[s] = 0.f;
    oi[s] = -1;
  }
}

template <int DIM>
cudaError_t launch(const float* p1, const float* p2, const int64_t* lengths1,
                   const int64_t* lengths2, int N, int P1, int P2, int D,
                   int K, float r2, float* out_d, int64_t* out_i,
                   cudaStream_t stream) {
  // The whole cloud where it fits the staging buffer, else tiles of it.
  int tile = kTileFloats / D;
  tile = tile < 1 ? 1 : (tile > P2 ? P2 : tile);
  const size_t smem = (size_t)tile * D * sizeof(float);
  const dim3 grid((P1 + kWarps - 1) / kWarps, N);
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

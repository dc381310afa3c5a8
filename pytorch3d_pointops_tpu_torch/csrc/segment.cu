// Segment reductions over sorted clusters of rows, and the voxel keys that
// make the clusters: the grid pooling of Point Transformer V2
// (ops/grid_pool.py).
//
// Replaces: no TPU kernel. The JAX package has no grid pooling; these
// kernels were added for the port's second attention model, whose levels
// are decided by the data (a voxel grid) and not by a fixed stride.
//
// A pooling level of T rows (the packed points of N clouds, each cloud's
// rows consecutive) runs, in order:
//
// (torch)         each cloud's least coordinate on every axis, outside this
//                 file (scatter_reduce's amin: exact in any order);
// segment_keys    each row's voxel v = (int64)((p - start) / g) on every
//                 axis (a float32 subtraction and division, rounded on
//                 their own, truncated) and its key: the cloud in bits
//                 51-62, then z, y and x in 17 bits each, so keys order rows
//                 by cloud, then z, y, x (torch_cluster's grid_cluster
//                 numbering). A quotient outside [0, 2^17) on an axis, or
//                 NaN, sets a flag word (an integer atomicOr: exact in any
//                 order);
// (torch)         the keys' stable sort, head[s] = 1 where sorted key s
//                 differs from key s - 1, and the heads' inclusive scan:
//                 ids[s] - 1 is the cluster of sorted row s, outside this
//                 file;
// segment_bounds  each cluster's first sorted row (offsets, with T after
//                 the last), each input row's cluster (cluster[order[s]]),
//                 and each cloud's running count of clusters;
// segment_sum     a thread a (cluster, channel): its rows' values added in
//                 sorted order, from 0, each add rounded on its own, then
//                 optionally divided by the count (the pooled coordinates'
//                 means);
// segment_max     a thread a (cluster, channel): the largest of its rows'
//                 values in sorted order, the first of equal maxima, and
//                 that row (int32);
// segment_max_bwd a thread a (row, channel): the output gradient of its
//                 cluster and channel where the row holds that maximum,
//                 else 0. Every output element is written once, so no
//                 zeroing and no atomics: the backward of a max whose every
//                 input row lies in one cluster is a plain indexed write.
//
// Every sum is a sequential fold in one thread and every other result is
// exact, so each kernel is bit-equal to its plain twin in
// kernels/segment.py and from run to run.
//
// Bound on the card: bytes. Each kernel reads its inputs about once and
// writes its outputs once; the operations are a compare or an add an
// element. The clusters hold a few rows each (about 7 at the Point
// Transformer V2 cell's first pooling), so a (cluster, channel) thread
// walks a short chain of loads, coalesced across the channels of a warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kAxisBits = 17;
constexpr long long kAxisCells = 1LL << kAxisBits;

int blocks_for(long long n) {
  long long b = (n + kThreads - 1) / kThreads;
  if (b > 65535LL * 32) b = 65535LL * 32;
  return (int)(b > 0 ? b : 1);
}

__global__ void __launch_bounds__(kThreads) segment_keys_kernel(
    const float* __restrict__ pos, const int64_t* __restrict__ first, int N,
    int64_t T, const float* __restrict__ start, float grid,
    int64_t* __restrict__ keys, unsigned long long* __restrict__ flag) {
  for (int64_t r = (int64_t)blockIdx.x * kThreads + threadIdx.x; r < T;
       r += (int64_t)gridDim.x * kThreads) {
    int lo = 0, hi = N - 1;  // the last cloud whose first row is <= r
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (first[mid] <= r) lo = mid; else hi = mid - 1;
    }
    long long key = lo;
    bool bad = false;
    for (int d = 2; d >= 0; --d) {
      const float q = __fdiv_rn(__fsub_rn(pos[r * 3 + d], start[lo * 3 + d]), grid);
      bad |= !(q >= 0.0f && q < (float)kAxisCells);  // NaN included
      const long long v = (long long)q;
      key = (key << kAxisBits) | (v & (kAxisCells - 1));
    }
    keys[r] = key;
    if (bad) atomicOr(flag, 1ULL);
  }
}

__global__ void __launch_bounds__(kThreads) segment_bounds_kernel(
    const int64_t* __restrict__ ids, const int64_t* __restrict__ order, int64_t T,
    const int64_t* __restrict__ ends, int N, int64_t* __restrict__ offsets,
    int64_t* __restrict__ cluster, int64_t* __restrict__ counts) {
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  for (int64_t s = tid; s < T; s += stride) {
    const int64_t id = ids[s] - 1;
    if (s == 0 || ids[s - 1] != ids[s]) offsets[id] = s;
    if (s == T - 1) offsets[id + 1] = T;
    cluster[order[s]] = id;
  }
  for (int64_t n = tid; n < N; n += stride) {
    counts[n] = ends[n] > 0 ? ids[ends[n] - 1] : 0;
  }
}

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const float* __restrict__ x, const int64_t* __restrict__ order,
    const int64_t* __restrict__ offsets, int64_t M, int C, int mean,
    float* __restrict__ out) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < M * C;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t m = i / C;
    const int c = (int)(i - m * C);
    const int64_t s0 = offsets[m], s1 = offsets[m + 1];
    float acc = 0.0f;
    for (int64_t s = s0; s < s1; ++s) acc = __fadd_rn(acc, x[order[s] * C + c]);
    out[i] = mean ? __fdiv_rn(acc, (float)(s1 - s0)) : acc;
  }
}

__global__ void __launch_bounds__(kThreads) segment_max_kernel(
    const float* __restrict__ x, const int64_t* __restrict__ order,
    const int64_t* __restrict__ offsets, int64_t M, int C,
    float* __restrict__ out, int32_t* __restrict__ arg) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < M * C;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t m = i / C;
    const int c = (int)(i - m * C);
    const int64_t s0 = offsets[m], s1 = offsets[m + 1];
    int64_t best_row = order[s0];
    float best = x[best_row * C + c];
    for (int64_t s = s0 + 1; s < s1; ++s) {
      const int64_t row = order[s];
      const float v = x[row * C + c];
      if (v > best) {
        best = v;
        best_row = row;
      }
    }
    out[i] = best;
    arg[i] = (int32_t)best_row;
  }
}

__global__ void __launch_bounds__(kThreads) segment_max_bwd_kernel(
    const float* __restrict__ grad_out, const int32_t* __restrict__ arg,
    const int64_t* __restrict__ cluster, int64_t T, int C,
    float* __restrict__ grad_x) {
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < T * C;
       i += (int64_t)gridDim.x * kThreads) {
    const int64_t r = i / C;
    const int c = (int)(i - r * C);
    const int64_t j = cluster[r] * C + c;
    grad_x[i] = arg[j] == r ? grad_out[j] : 0.0f;
  }
}

cudaError_t launched() { return cudaGetLastError(); }

}  // namespace

// Each entry point launches one kernel on the given stream and returns the
// first cudaError_t met. Sizes of 0 launch nothing.

// keys (T,) of rows pos (T, 3) of N clouds whose first rows are first (N,),
// with each cloud's start (N, 3) and the cell size grid; *flag |= 1 where a
// voxel falls outside [0, 2^17) on an axis. N is at most 2^12.
extern "C" int segment_keys(const float* pos, const int64_t* first, int N, int64_t T,
                            const float* start, float grid, int64_t* keys,
                            unsigned long long* flag, void* stream) {
  if (T <= 0) return cudaSuccess;
  if (N <= 0 || N > (1 << 12)) return cudaErrorInvalidValue;
  segment_keys_kernel<<<blocks_for(T), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pos, first, N, T, start, grid, keys, flag);
  return launched();
}

// From ids (T,), the inclusive scan of the heads, and the stable order
// (T,): offsets (at least M + 1), cluster (T,), and counts (N,) from the
// clouds' ends (N,), each the clusters up to that cloud's last row.
extern "C" int segment_bounds(const int64_t* ids, const int64_t* order, int64_t T,
                              const int64_t* ends, int N, int64_t* offsets,
                              int64_t* cluster, int64_t* counts, void* stream) {
  const int64_t work = T > N ? T : N;
  if (work <= 0) return cudaSuccess;
  segment_bounds_kernel<<<blocks_for(work), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(ids, order, T, ends, N,
                                                               offsets, cluster, counts);
  return launched();
}

// out (M, C): each segment's sum of x[order[s]] over s in
// [offsets[m], offsets[m + 1]), in order from 0; divided by the segment's
// size where mean is not 0.
extern "C" int segment_sum(const float* x, const int64_t* order, const int64_t* offsets,
                           int64_t M, int C, int mean, float* out, void* stream) {
  if (M <= 0 || C <= 0) return cudaSuccess;
  segment_sum_kernel<<<blocks_for(M * C), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, order, offsets, M, C, mean, out);
  return launched();
}

// out (M, C) and arg (M, C) int32: each segment's largest x[order[s]] over
// s in order, the first of equal maxima, and its row. Segments are not
// empty.
extern "C" int segment_max(const float* x, const int64_t* order, const int64_t* offsets,
                           int64_t M, int C, float* out, int32_t* arg, void* stream) {
  if (M <= 0 || C <= 0) return cudaSuccess;
  segment_max_kernel<<<blocks_for(M * C), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, order, offsets, M, C, out, arg);
  return launched();
}

// grad_x (T, C) of segment_max: grad_out[cluster[r], c] where
// arg[cluster[r], c] == r, else 0.
extern "C" int segment_max_backward(const float* grad_out, const int32_t* arg,
                                    const int64_t* cluster, int64_t T, int C,
                                    float* grad_x, void* stream) {
  if (T <= 0 || C <= 0) return cudaSuccess;
  segment_max_bwd_kernel<<<blocks_for(T * C), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(grad_out, arg, cluster, T,
                                                                C, grad_x);
  return launched();
}

// Both K=1 nearest-neighbour directions of the chamfer loss from one
// distance pass.
//
// Replaces: pytorch3d_pointops_tpu/kernels/chamfer_pallas.py
// chamfer_nn_bidirectional_pallas (kernel body _nn_bidir_kernel).
//
// Bound on the card: operations. Each (x, y) pair costs 3*D float32
// operations for its distance plus a compare for each direction; the
// clouds themselves are a few hundred KB. Design: a block owns a chunk of
// kXChunk x points and kYChunk y points and walks it in 128 x 128 sub-tiles.
// Its 256 threads each compute an 8 x 8 micro-tile of distances from
// coordinates in shared memory (an outer product over the axes, so every
// shared word feeds eight distances). The x -> y minimum of each row and the
// y -> x minimum of each column are both taken from that same micro-tile:
// rows keep a running minimum in registers over the whole y chunk, columns
// are reduced across the 16 threads that share them with warp shuffles and
// kept in shared memory over the whole x chunk. Two instances (template DIM):
// * D = 3 (the chamfer loss on points): both chunks staged once, x
//   coordinates in registers, 8 instructions a distance, and a y loop with
//   no load from device memory, no barrier and no branch (nn_bidir_d3,
//   below). Under -fmad=false the card's floor is its instruction
//   throughput: 8 instructions a pair for the distance, and the merges
//   about as many.
// * any D: sub-tiles staged kDChunk axes at a time, 64-bit (value, index)
//   keys merged across lanes.
//
// Cross-block merge: a 64-bit atomicMin on keys (float_bits(d) << 32) | idx.
// Distances are >= 0 and never NaN in the merge, so the key order is the
// (value, index) order: the lowest index wins ties and the result does not
// depend on the order in which blocks run. Keys start at (inf, 0); a side
// with no valid partner keeps (inf, 0), as the TPU kernel returns.
//
// Arithmetic: per-axis terms rounded on their own and summed in order
// d = 0..D-1 without FMA, bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 8 x 8 pairs each
constexpr int kSub = 128;      // sub-tile edge, in points
constexpr int kMicro = 8;      // micro-tile edge, in points
constexpr int kDChunk = 16;    // axes staged at a time
constexpr int kXChunk = 1024;  // x points per block
constexpr int kYChunk = 1024;  // y points per block

constexpr unsigned long long kInitKey = 0x7f80000000000000ull;  // (inf, 0)

__device__ __forceinline__ unsigned long long pack(float d, int idx) {
  return ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)idx;
}

template <int NORM>
__device__ __forceinline__ float axis_term(float a, float b) {
  const float diff = __fsub_rn(a, b);
  return NORM == 2 ? __fmul_rn(diff, diff) : fabsf(diff);
}

__global__ void init_keys(unsigned long long* keys, int64_t count) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < count) keys[t] = kInitKey;
}

// The block's chunk: which cloud, and its valid x and y ranges.
struct Chunk {
  int n, x0, x_end, y0, y_end;
};

__device__ __forceinline__ bool chunk_of(const int64_t* __restrict__ lengths1,
                                         const int64_t* __restrict__ lengths2,
                                         int P1, int P2, Chunk& k) {
  k.n = blockIdx.z;
  int64_t len1 = lengths1[k.n], len2 = lengths2[k.n];
  len1 = len1 < 0 ? 0 : (len1 > P1 ? P1 : len1);
  len2 = len2 < 0 ? 0 : (len2 > P2 ? P2 : len2);
  k.x0 = blockIdx.x * kXChunk;
  k.y0 = blockIdx.y * kYChunk;
  if (k.x0 >= len1 || k.y0 >= len2) return false;  // no valid pair here
  k.x_end = (int)min((int64_t)(k.x0 + kXChunk), len1);
  k.y_end = (int)min((int64_t)(k.y0 + kYChunk), len2);
  return true;
}

// Rows: a min over the 16 threads ty that share each row of the sub-tile at
// xa, merged into key_x. The caller fences row_part before its next write.
__device__ __forceinline__ void merge_rows(
    unsigned long long (&row_part)[16][kSub], const float (&rbd)[kMicro],
    const int (&rbi)[kMicro], int tid, int xa, int x_end,
    unsigned long long* __restrict__ key_x) {
  const int tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int r = 0; r < kMicro; ++r) row_part[ty][tx + 16 * r] = pack(rbd[r], rbi[r]);
  __syncthreads();
  if (tid < kSub && xa + tid < x_end) {
    unsigned long long best = row_part[0][tid];
#pragma unroll
    for (int t = 1; t < 16; ++t) {
      const unsigned long long o = row_part[t][tid];
      best = o < best ? o : best;
    }
    if (best != kInitKey) atomicMin(&key_x[xa + tid], best);
  }
}

// Any D: both sides' coordinates staged per 128 x 128 sub-tile, kDChunk
// axes at a time.
template <int NORM>
__device__ __forceinline__ void nn_bidir_any_d(
    const float* __restrict__ x, const float* __restrict__ y,
    const Chunk& k, int P1, int P2, int D, unsigned long long* __restrict__ key_x,
    unsigned long long* __restrict__ key_y) {
  __shared__ float xs[kDChunk][kSub];
  __shared__ float ys[kDChunk][kSub];
  __shared__ unsigned long long col_best[kYChunk];
  __shared__ unsigned long long row_part[16][kSub];

  const int n = k.n, x0 = k.x0, y0 = k.y0, x_end = k.x_end, y_end = k.y_end;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // rows tx + 16 * r
  const int ty = tid >> 4;  // columns ty + 16 * c
  const float* xn = x + (int64_t)n * P1 * D;
  const float* yn = y + (int64_t)n * P2 * D;

  for (int e = tid; e < kYChunk; e += kThreads) col_best[e] = kInitKey;

  for (int xa = x0; xa < x_end; xa += kSub) {
    float rbd[kMicro];
    int rbi[kMicro];
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      rbd[r] = INFINITY;
      rbi[r] = 0;
    }
    bool rv[kMicro];
#pragma unroll
    for (int r = 0; r < kMicro; ++r) rv[r] = xa + tx + 16 * r < x_end;

    for (int ya = y0; ya < y_end; ya += kSub) {
      float acc[kMicro][kMicro];
#pragma unroll
      for (int r = 0; r < kMicro; ++r)
#pragma unroll
        for (int c = 0; c < kMicro; ++c) acc[r][c] = 0.f;

      for (int d0 = 0; d0 < D; d0 += kDChunk) {
        const int dc = min(kDChunk, D - d0);
        __syncthreads();  // the previous chunk is no longer read
        for (int e = tid; e < kSub * dc; e += kThreads) {
          const int p = e / dc, d = e - p * dc;  // coalesced over (p, d)
          xs[d][p] = xa + p < x_end ? xn[(int64_t)(xa + p) * D + d0 + d] : 0.f;
          ys[d][p] = ya + p < y_end ? yn[(int64_t)(ya + p) * D + d0 + d] : 0.f;
        }
        __syncthreads();
        for (int d = 0; d < dc; ++d) {
          float xv[kMicro], yv[kMicro];
#pragma unroll
          for (int r = 0; r < kMicro; ++r) xv[r] = xs[d][tx + 16 * r];
#pragma unroll
          for (int c = 0; c < kMicro; ++c) yv[c] = ys[d][ty + 16 * c];
#pragma unroll
          for (int r = 0; r < kMicro; ++r)
#pragma unroll
            for (int c = 0; c < kMicro; ++c)
              acc[r][c] = __fadd_rn(acc[r][c], axis_term<NORM>(xv[r], yv[c]));
        }
      }

      // Rows: columns ty + 16c ascend with c, and sub-tiles ascend, so a
      // strict < keeps the lowest y index among this thread's columns.
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const int gj = ya + ty + 16 * c;
        if (gj >= y_end) continue;
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          if (acc[r][c] < rbd[r]) {
            rbd[r] = acc[r][c];
            rbi[r] = gj;
          }
        }
      }

      // Columns: rows ascend with r; then a min over the 16 threads tx of
      // this half-warp, which share the column. Lane tx == 0 owns the
      // column's slot in col_best for the whole block.
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        float cbd = INFINITY;
        int cbi = 0;
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          if (rv[r] && acc[r][c] < cbd) {
            cbd = acc[r][c];
            cbi = xa + tx + 16 * r;
          }
        }
        unsigned long long key = pack(cbd, cbi);  // (inf, 0) if none valid
#pragma unroll
        for (int off = 8; off > 0; off >>= 1) {
          const unsigned long long o = __shfl_xor_sync(0xffffffffu, key, off);
          key = o < key ? o : key;
        }
        const int lj = ya - y0 + ty + 16 * c;
        if (tx == 0 && key < col_best[lj]) col_best[lj] = key;
      }
    }

    // The next sub-tile's first staging barrier fences row_part.
    merge_rows(row_part, rbd, rbi, tid, xa, x_end, key_x + (int64_t)n * P1);
  }

  __syncthreads();
  for (int e = tid; e < y_end - y0; e += kThreads) {
    const unsigned long long best = col_best[e];
    if (best != kInitKey) atomicMin(&key_y[(int64_t)n * P2 + y0 + e], best);
  }
}

// D = 3: both chunks staged into shared memory once, as structure of
// arrays; each thread holds its 8 rows' coordinates of an x sub-tile in
// registers and reads only y coordinates inside the y loop, which has no
// global load, no barrier and no branch: every merge is a predicated
// compare and select. Rows keep a running (value, index) minimum. Columns
// take each lane's (value, first row) minimum, the half-warp's minimum
// value by float shuffles, then its lowest row among the lanes that hold
// that value by 32-bit integer shuffles (no 64-bit keys); the block's
// running column values and indices sit in shared memory. Strict < across
// ascending sub-tiles keeps the lowest index on ties. Value-only folds with
// an index recovered behind a branch where a minimum improved were slower:
// a running minimum spans at most 8 sub-tiles, so some lane of a warp
// improves at almost every one.
// Padded points are staged as +inf: a distance to one is inf (or NaN
// between two padded points, which only a padded row or column holds), never
// below a running value or equal to a finite minimum, and fminf passes over
// NaN.
template <int NORM>
__device__ __forceinline__ void nn_bidir_d3(
    const float* __restrict__ x, const float* __restrict__ y,
    const Chunk& k, int P1, int P2, unsigned long long* __restrict__ key_x,
    unsigned long long* __restrict__ key_y) {
  __shared__ float xs[3][kXChunk];
  __shared__ float ys[3][kYChunk];
  __shared__ float col_d[kYChunk];
  __shared__ int col_i[kYChunk];
  __shared__ unsigned long long row_part[16][kSub];

  const int n = k.n, x0 = k.x0, y0 = k.y0, x_end = k.x_end, y_end = k.y_end;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // rows tx + 16 * r
  const int ty = tid >> 4;  // columns ty + 16 * c
  const float* xn = x + ((int64_t)n * P1 + x0) * 3;
  const float* yn = y + ((int64_t)n * P2 + y0) * 3;

  for (int p = tid; p < kXChunk; p += kThreads) {
    const bool v = p < x_end - x0;
#pragma unroll
    for (int d = 0; d < 3; ++d) xs[d][p] = v ? xn[p * 3 + d] : INFINITY;
  }
  for (int p = tid; p < kYChunk; p += kThreads) {
    const bool v = p < y_end - y0;
#pragma unroll
    for (int d = 0; d < 3; ++d) ys[d][p] = v ? yn[p * 3 + d] : INFINITY;
    col_d[p] = INFINITY;
    col_i[p] = 0;
  }
  __syncthreads();

  for (int xa = x0; xa < x_end; xa += kSub) {
    float xv[kMicro][3];
#pragma unroll
    for (int r = 0; r < kMicro; ++r)
#pragma unroll
      for (int d = 0; d < 3; ++d) xv[r][d] = xs[d][xa - x0 + tx + 16 * r];
    float rbd[kMicro];
    int rbi[kMicro];
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      rbd[r] = INFINITY;
      rbi[r] = 0;
    }

    for (int ya = y0; ya < y_end; ya += kSub) {
      // The first axis's term is assigned, not added to 0: the same value,
      // since a term is never -0.
      float acc[kMicro][kMicro];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const int lj = ya - y0 + ty + 16 * c;
        const float y0v = ys[0][lj], y1v = ys[1][lj], y2v = ys[2][lj];
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          acc[r][c] = __fadd_rn(__fadd_rn(axis_term<NORM>(xv[r][0], y0v),
                                          axis_term<NORM>(xv[r][1], y1v)),
                                axis_term<NORM>(xv[r][2], y2v));
        }
      }

      // Rows: columns ty + 16c ascend with c, and sub-tiles ascend, so a
      // strict < keeps the lowest y index among this thread's columns.
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          if (acc[r][c] < rbd[r]) {
            rbd[r] = acc[r][c];
            rbi[r] = ya + ty + 16 * c;
          }
        }
      }

      // Columns: each lane's minimum over its rows (the first row on ties),
      // then the half-warp's minimum value by float shuffles, then the
      // lowest local row 16r + tx among the lanes that hold it by integer
      // shuffles. The eight columns' chains run side by side, and only then
      // the stores, so no branch sits between them. Lane tx == 0 owns the
      // column's slot for the whole block.
      float cbd[kMicro], m[kMicro];
      int local[kMicro];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        cbd[c] = acc[0][c];
        int cr = 0;
#pragma unroll
        for (int r = 1; r < kMicro; ++r) {
          if (acc[r][c] < cbd[c]) {
            cbd[c] = acc[r][c];
            cr = r;
          }
        }
        m[c] = cbd[c];
        local[c] = 16 * cr + tx;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          m[c] = fminf(m[c], __shfl_xor_sync(0xffffffffu, m[c], off));
        }
      }
#pragma unroll
      for (int c = 0; c < kMicro; ++c) local[c] = cbd[c] == m[c] ? local[c] : kSub;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
        for (int c = 0; c < kMicro; ++c) {
          local[c] = min(local[c], __shfl_xor_sync(0xffffffffu, local[c], off));
        }
      }
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const int lj = ya - y0 + ty + 16 * c;
        if (tx == 0 && m[c] < col_d[lj]) {
          col_d[lj] = m[c];
          col_i[lj] = xa + local[c];
        }
      }
    }

    merge_rows(row_part, rbd, rbi, tid, xa, x_end, key_x + (int64_t)n * P1);
    __syncthreads();  // row_part is read before the next sub-tile writes it
  }

  for (int e = tid; e < y_end - y0; e += kThreads) {
    if (col_d[e] < INFINITY) {
      atomicMin(&key_y[(int64_t)n * P2 + y0 + e], pack(col_d[e], col_i[e]));
    }
  }
}

// DIM = 3: the D = 3 instance; DIM = 0: any D. Two blocks an SM: at most
// 48 KB of shared memory and 128 registers a thread.
template <int DIM, int NORM>
__global__ void __launch_bounds__(kThreads, 2) nn_bidir_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const int64_t* __restrict__ lengths1, const int64_t* __restrict__ lengths2,
    int P1, int P2, int D, unsigned long long* __restrict__ key_x,
    unsigned long long* __restrict__ key_y) {
  Chunk k;
  if (!chunk_of(lengths1, lengths2, P1, P2, k)) return;  // uniform
  if constexpr (DIM == 3) {
    nn_bidir_d3<NORM>(x, y, k, P1, P2, key_x, key_y);
  } else {
    nn_bidir_any_d<NORM>(x, y, k, P1, P2, D, key_x, key_y);
  }
}

__global__ void unpack_keys(const unsigned long long* __restrict__ keys,
                            int64_t count, float* __restrict__ dist,
                            int64_t* __restrict__ idx) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const unsigned long long k = keys[t];
  dist[t] = __uint_as_float((unsigned)(k >> 32));
  idx[t] = (int64_t)(unsigned)(k & 0xffffffffull);
}

int blocks_for(int64_t count, int threads) {
  return (int)((count + threads - 1) / threads);
}

}  // namespace

// x (N, P1, D), y (N, P2, D) float32; lengths1/lengths2 (N,) int64;
// key_x (N, P1), key_y (N, P2) uint64 scratch; outputs d_xy/i_xy (N, P1)
// and d_yx/i_yx (N, P2). Returns the first failing launch's cudaError_t.
extern "C" int chamfer_nn_bidir(const float* x, const float* y,
                                const int64_t* lengths1,
                                const int64_t* lengths2, int N, int P1, int P2,
                                int D, int norm, unsigned long long* key_x,
                                unsigned long long* key_y, float* d_xy,
                                int64_t* i_xy, float* d_yx, int64_t* i_yx,
                                void* stream) {
  if (N <= 0) return cudaSuccess;
  if (D < 1 || (norm != 1 && norm != 2) || N > 65535) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t cx = (int64_t)N * P1, cy = (int64_t)N * P2;
  cudaError_t err;
  if (cx > 0) {
    init_keys<<<blocks_for(cx, 256), 256, 0, s>>>(key_x, cx);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (cy > 0) {
    init_keys<<<blocks_for(cy, 256), 256, 0, s>>>(key_y, cy);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (cx > 0 && cy > 0) {
    const dim3 grid((P1 + kXChunk - 1) / kXChunk, (P2 + kYChunk - 1) / kYChunk,
                    N);
    decltype(&nn_bidir_kernel<0, 1>) kernel;
    if (D == 3) {
      kernel = norm == 2 ? &nn_bidir_kernel<3, 2> : &nn_bidir_kernel<3, 1>;
    } else {
      kernel = norm == 2 ? &nn_bidir_kernel<0, 2> : &nn_bidir_kernel<0, 1>;
    }
    kernel<<<grid, kThreads, 0, s>>>(x, y, lengths1, lengths2, P1, P2, D, key_x,
                                     key_y);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (cx > 0) {
    unpack_keys<<<blocks_for(cx, 256), 256, 0, s>>>(key_x, cx, d_xy, i_xy);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (cy > 0) {
    unpack_keys<<<blocks_for(cy, 256), 256, 0, s>>>(key_y, cy, d_yx, i_yx);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

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
// * D = 3 (the chamfer loss on points): the y chunk staged once, x
//   coordinates in registers, 8 instructions a distance, and a y loop with
//   no load from device memory, no barrier and no branch that keeps minimum
//   values only, no index (nn_bidir_d3, below). Each row and column also
//   keeps the 128-point sub-tile where its minimum last strictly improved,
//   and a second pass (rescan_d3) finds each index exactly in that one
//   sub-tile. Under -fmad=false the card's floor is its instruction
//   throughput: 8 instructions a pair for the distance; the pair loop's SASS
//   issues 11.4 a pair in all (17.6 when it kept an index per pair).
// * any D: sub-tiles staged kDChunk axes at a time, 64-bit (value, index)
//   keys merged across lanes.
//
// Cross-block merge: a 64-bit atomicMin on keys (float_bits(d) << 32) | idx,
// where idx is the point's index at any D and its sub-tile's number (index /
// 128) at D = 3. Distances are >= 0 and never NaN in the merge, so the key
// order is the (value, idx) order: the lowest index, or the lowest sub-tile
// and then the first index in it, wins ties, and the result does not depend
// on the order in which blocks run. Keys start at (inf, 0); a side with no
// valid partner keeps (inf, 0), as the TPU kernel returns.
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

// D = 3: the y chunk staged once into shared memory as float4s, so a
// column's coordinates are one 16-byte load; each thread loads its 8 rows'
// coordinates of an x sub-tile into registers from device memory. The y loop
// has no global load, no barrier and no branch, and keeps values only:
// * rows: per y sub-tile the thread's minimum over its 8 columns, folded
//   into the row's running value; where it is strictly below, the row also
//   records the sub-tile's number (one compare and one select a row and a
//   sub-tile, none a pair). Each thread's record is the lowest sub-tile
//   that holds its own minimum, and merge_rows' key min over the 16 threads
//   keeps the lowest sub-tile that holds the row's minimum.
// * columns: each lane's minimum over its 8 rows, then a transposing min
//   over the half-warp (8 columns in 4 xor steps: 8 shuffles, 8 fminf and 14
//   selects a thread, where a full butterfly per column takes 32 shuffles
//   and 32 fminf), after which lane tx holds column ty + 16 * (tx >> 1).
//   The even lane keeps the column's running value in shared memory, and the
//   x sub-tile where it last strictly improved. Slots are laid out
//   8 * ty + (tx >> 1) within a sub-tile, so a warp's stores meet no bank
//   twice.
// The cross-block keys are then (value, sub-tile number), a sub-tile being
// 128 points from index 128 s of its cloud: the lowest key is the lowest
// sub-tile that holds the global minimum. rescan_d3 reads each point's key
// and computes its distances to that one sub-tile again, with the same
// arithmetic, and writes the first index whose distance equals the minimum
// bit for bit: the lowest index on ties, as before. With 16,384 points a
// cloud the rescan computes 128 of every 16,384 pairs again, on each side.
// The merges of the kernel this replaces kept (value, index) per pair: a
// compare and two selects per pair for rows and for columns, then float and
// integer butterflies per column, so they issued about as many instructions
// as the distances (about 16 a pair in all, 8 of them the distance). An
// earlier variant that kept values only and recovered an index behind a
// branch wherever a minimum improved was slower still: a running minimum
// spans at most 8 sub-tiles, so some lane of a warp improved at almost
// every one. Here nothing is recovered inside the loop.
// Padded points are staged as +inf: a distance to one is inf (or NaN
// between two padded points, which only a padded row or column holds), never
// below a running value, and fminf passes over NaN.
template <int NORM>
__device__ __forceinline__ void nn_bidir_d3(
    const float* __restrict__ x, const float* __restrict__ y,
    const Chunk& k, int P1, int P2, unsigned long long* __restrict__ key_x,
    unsigned long long* __restrict__ key_y) {
  __shared__ float4 ys[kYChunk];
  __shared__ float col_d[kYChunk];  // by slot, see above
  __shared__ int col_s[kYChunk];
  __shared__ unsigned long long row_part[16][kSub];

  const int n = k.n, x0 = k.x0, y0 = k.y0, x_end = k.x_end, y_end = k.y_end;
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // rows tx + 16 * r
  const int ty = tid >> 4;  // columns ty + 16 * c
  const float* xn = x + (int64_t)n * P1 * 3;
  const float* yn = y + ((int64_t)n * P2 + y0) * 3;

  for (int p = tid; p < kYChunk; p += kThreads) {
    ys[p] = p < y_end - y0 ? make_float4(yn[p * 3], yn[p * 3 + 1], yn[p * 3 + 2], 0.f)
                           : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
    col_d[p] = INFINITY;
    col_s[p] = 0;
  }
  __syncthreads();

  // The transposing column merge: at xor 8 a lane keeps columns 4 * b3 + i,
  // at xor 4 then 4 * b3 + 2 * b2 + i, at xor 2 the one column tx >> 1.
  const bool b3 = tx & 8, b2 = tx & 4, b1 = tx & 2;
  const bool owner = !(tx & 1);
  const int slot0 = 8 * ty + (tx >> 1);

  for (int xa = x0; xa < x_end; xa += kSub) {
    float xv[kMicro][3];
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      const int i = xa + tx + 16 * r;
#pragma unroll
      for (int d = 0; d < 3; ++d) xv[r][d] = i < x_end ? xn[(int64_t)i * 3 + d] : INFINITY;
    }
    float rbd[kMicro];
    int rbs[kMicro];
#pragma unroll
    for (int r = 0; r < kMicro; ++r) {
      rbd[r] = INFINITY;
      rbs[r] = 0;
    }
    const int xsub = xa / kSub;

    for (int ya = y0; ya < y_end; ya += kSub) {
      // The first axis's term is assigned, not added to 0: the same value,
      // since a term is never -0.
      float rm[kMicro], cm[kMicro];
#pragma unroll
      for (int c = 0; c < kMicro; ++c) {
        const float4 yc = ys[ya - y0 + ty + 16 * c];
#pragma unroll
        for (int r = 0; r < kMicro; ++r) {
          const float a = __fadd_rn(__fadd_rn(axis_term<NORM>(xv[r][0], yc.x),
                                              axis_term<NORM>(xv[r][1], yc.y)),
                                    axis_term<NORM>(xv[r][2], yc.z));
          cm[c] = r == 0 ? a : fminf(cm[c], a);
          rm[r] = c == 0 ? a : fminf(rm[r], a);
        }
      }

      const int ysub = ya / kSub;
#pragma unroll
      for (int r = 0; r < kMicro; ++r) {
        if (rm[r] < rbd[r]) {
          rbd[r] = rm[r];
          rbs[r] = ysub;
        }
      }

      float h[4], q[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float send = b3 ? cm[i] : cm[i + 4], keep = b3 ? cm[i + 4] : cm[i];
        h[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, 8));
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float send = b2 ? h[i] : h[i + 2], keep = b2 ? h[i + 2] : h[i];
        q[i] = fminf(keep, __shfl_xor_sync(0xffffffffu, send, 4));
      }
      const float send = b1 ? q[0] : q[1], keep = b1 ? q[1] : q[0];
      float m = fminf(keep, __shfl_xor_sync(0xffffffffu, send, 2));
      m = fminf(m, __shfl_xor_sync(0xffffffffu, m, 1));
      const int sl = ya - y0 + slot0;
      if (owner && m < col_d[sl]) {
        col_d[sl] = m;
        col_s[sl] = xsub;
      }
    }

    merge_rows(row_part, rbd, rbs, tid, xa, x_end, key_x + (int64_t)n * P1);
    __syncthreads();  // row_part is read before the next sub-tile writes it
  }

  for (int e = tid; e < y_end - y0; e += kThreads) {
    const int w = e & (kSub - 1);  // column w = ty + 16 c of its sub-tile
    const int sl = e - w + 8 * (w & 15) + (w >> 4);
    if (col_d[sl] < INFINITY) {
      atomicMin(&key_y[(int64_t)n * P2 + y0 + e], pack(col_d[sl], col_s[sl]));
    }
  }
}

// DIM = 3: the D = 3 instance, four blocks an SM (40 KB of shared memory
// and at most 64 registers a thread each); DIM = 0: any D, two blocks an SM
// (48 KB and 128 registers).
template <int DIM, int NORM>
__global__ void __launch_bounds__(kThreads, DIM == 3 ? 4 : 2) nn_bidir_kernel(
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

// D = 3, after nn_bidir_d3: each point of one side (q, Pq a cloud) reads
// its key, which names the sub-tile of the other side (c) that holds its
// minimum first, computes its distances to that sub-tile's valid points
// again and takes the first whose distance equals the key's value bit for
// bit. A warp owns 32 consecutive points: each lane loads one point's key
// and coordinates (coalesced), then the warp scans the points' sub-tiles in
// turn, 64 candidates at a time (2 a lane, their loads in flight together),
// a ballot a 32-candidate step, and stops at the first group that holds an
// equal distance (32 clouds of 16,384 points a side on an H100: 0.146 ms for
// both sides, against 0.172 with all 128 candidates at once or 32 at a time). The same
// arithmetic as the pair loop: a term of q - c is the term of c - q, since
// fl(a - b) = -fl(b - a). A key of (inf, 0) writes (inf, 0), as unpack_keys
// does.
constexpr int kRescanPoints = kThreads;  // points a block, 32 a warp
constexpr int kRescanGroup = 2;  // 32-candidate steps in flight

template <int NORM>
__global__ void rescan_d3(const unsigned long long* __restrict__ keys,
                          const float* __restrict__ q, const float* __restrict__ c,
                          const int64_t* __restrict__ lengths_c, int Pq, int Pc,
                          int64_t count, float* __restrict__ dist,
                          int64_t* __restrict__ idx) {
  const int64_t t0 = (int64_t)blockIdx.x * kRescanPoints + (threadIdx.x & ~31);
  if (t0 >= count) return;  // uniform over the warp
  const int lane = threadIdx.x & 31;
  const int64_t t = t0 + lane;
  const unsigned long long key = t < count ? keys[t] : kInitKey;
  const bool live = key != kInitKey;
  float q0 = 0.f, q1 = 0.f, q2 = 0.f;
  int n = 0, j0 = 0, j_end = 0;
  if (live) {
    n = (int)(t / Pq);
    int64_t len = lengths_c[n];
    len = len < 0 ? 0 : (len > Pc ? Pc : len);
    j0 = (int)(unsigned)(key & 0xffffffffull) * kSub;
    j_end = (int)min((int64_t)(j0 + kSub), len);
    q0 = q[t * 3];
    q1 = q[t * 3 + 1];
    q2 = q[t * 3 + 2];
  }
  const float v = __uint_as_float((unsigned)(key >> 32));
  int best = 0;
  unsigned todo = __ballot_sync(0xffffffffu, live);
  while (todo) {
    const int p = __ffs(todo) - 1;
    todo &= todo - 1;
    const int np = __shfl_sync(0xffffffffu, n, p);
    const int jp0 = __shfl_sync(0xffffffffu, j0, p);
    const int jp_end = __shfl_sync(0xffffffffu, j_end, p);
    const float vp = __shfl_sync(0xffffffffu, v, p);
    const float a0 = __shfl_sync(0xffffffffu, q0, p);
    const float a1 = __shfl_sync(0xffffffffu, q1, p);
    const float a2 = __shfl_sync(0xffffffffu, q2, p);
    const float* cn = c + (int64_t)np * Pc * 3;
    int found = -1;
    for (int g = jp0; g < jp_end && found < 0; g += 32 * kRescanGroup) {
      unsigned hits[kRescanGroup];
#pragma unroll
      for (int s = 0; s < kRescanGroup; ++s) {
        const int j = g + 32 * s + lane;
        bool hit = false;
        if (j < jp_end) {
          hit = __fadd_rn(__fadd_rn(axis_term<NORM>(a0, cn[j * 3]),
                                    axis_term<NORM>(a1, cn[j * 3 + 1])),
                          axis_term<NORM>(a2, cn[j * 3 + 2])) == vp;
        }
        hits[s] = __ballot_sync(0xffffffffu, hit);
      }
#pragma unroll
      for (int s = kRescanGroup - 1; s >= 0; --s) {
        if (hits[s]) found = g + 32 * s + __ffs(hits[s]) - 1;
      }
    }
    if (lane == p) best = found;
  }
  if (t < count) {
    dist[t] = v;
    idx[t] = best;
  }
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
  if (D == 3) {  // the keys hold sub-tiles: rescan each point's
    decltype(&rescan_d3<2>) rescan = norm == 2 ? &rescan_d3<2> : &rescan_d3<1>;
    if (cx > 0) {
      rescan<<<blocks_for(cx, kRescanPoints), kThreads, 0, s>>>(
          key_x, x, y, lengths2, P1, P2, cx, d_xy, i_xy);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    if (cy > 0) {
      rescan<<<blocks_for(cy, kRescanPoints), kThreads, 0, s>>>(
          key_y, y, x, lengths1, P2, P1, cy, d_yx, i_yx);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    return cudaSuccess;
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

// Iterative farthest point sampling (FPS): per cloud, start from a given
// point, then repeatedly select the point whose distance to the selected set
// is largest (on equal distances the smallest index), up to
// min(K[n], lengths[n]) points; the rest of the row is -1.
//
// Replaces: pytorch3d_pointops_tpu/kernels/fps_pallas.py, all three TPU
// kernels: fps_pallas_batched (_fps_batched_kernel, many clouds advancing
// together), fps_pallas (_fps_dense8_kernel, one big cloud held in VMEM) and
// fps_pallas_chunked (_fps_chunked_kernel, a cloud streamed from HBM every
// round). Two kernels here back the three entry points:
//
// * fps_block_kernel (fps_batched): one block per cloud. The cloud's
//   coordinates (structure of arrays) and its running min-distance live in
//   shared memory, (D+1)*4 bytes a point; a round updates the min-distances
//   against the last selected point and takes a block argmax on
//   (value, index) pairs by warp shuffles and then shared memory.
// * fps_grid_kernel (fps_resident, fps_streaming): the whole grid on one
//   cloud at a time, for clouds one block cannot hold. Each block owns a
//   contiguous slice of points and publishes its slice's (max, first
//   argmax) every round; after a grid-wide barrier (cooperative launch,
//   grid sized by occupancy) every block reduces the partials the same way.
//   The (value, index) order picks the first maximum across slices, as
//   _fps_chunked_kernel's read_winner does. RESIDENT keeps each slice's
//   coordinates and min-distances in shared memory (the dense8 kernel's VMEM
//   residency, one block per SM); otherwise both stream from device memory
//   every round, for any D.
//
// Bound on the card: K sequential rounds, each a pass over the cloud with
// 3*D+2 float32 operations a point (D subtractions, multiplies and adds, a
// min and a compare) and a reduction whose latency (block barriers, or the
// grid barrier) no amount of parallelism hides. The block kernel pays only
// block barriers but uses one SM per cloud; the grid kernels spread a cloud
// over every SM and pay one grid barrier a round.
//
// Ties: the distance to the selected set is not masked for selected points
// (they sit at 0), so when K exceeds the number of distinct points the
// first maximum may be a point already selected, as in the JAX package.
//
// Arithmetic: each axis term is rounded on its own and summed in order
// d = 0..D-1 (__fsub_rn/__fmul_rn/__fadd_rn, never contracted to FMA), so
// the distances, and hence every argmax, are bit-equal to the plain PyTorch
// version.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;         // threads of every FPS block
constexpr int kMaxGridBlocks = 2048;  // partials per buffer of the grid kernel
constexpr int kStaticSmem = 1024;     // shared memory kept for static arrays

// The (value, index) order of the argmax: the larger value wins, and on
// equal values the smaller index.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, v, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (better(ov, oi, v, i)) {
      v = ov;
      i = oi;
    }
  }
}

// Block-wide argmax of one (v, i) per thread; every thread leaves with the
// winning pair. s_v and s_i hold 33 entries. Two barriers: the warps'
// results go through slots 0..31, the winner through slot 32.
__device__ __forceinline__ void block_argmax(float& v, int& i, float* s_v,
                                             int* s_i) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    s_v[warp] = v;
    s_i[warp] = i;
  }
  __syncthreads();
  if (warp == 0) {
    v = lane < kThreads / 32 ? s_v[lane] : -INFINITY;
    i = lane < kThreads / 32 ? s_i[lane] : INT_MAX;
    warp_argmax(v, i);
    if (lane == 0) {
      s_v[32] = v;
      s_i[32] = i;
    }
  }
  __syncthreads();
  v = s_v[32];
  i = s_i[32];
}

// Squared distance of the point x[d * xs] to the selected point s[d * ss],
// summed in order d = 0..D-1.
template <int DIM>
__device__ __forceinline__ float sq_dist(const float* x, int64_t xs,
                                         const float* s, int ss, int D) {
  float dist = 0.f;
#pragma unroll
  for (int d = 0; d < (DIM > 0 ? DIM : D); ++d) {
    const float diff = __fsub_rn(x[d * xs], s[d * ss]);
    dist = __fadd_rn(dist, __fmul_rn(diff, diff));
  }
  return dist;
}

// A cloud's constants: its length clamped to P, its number of selected
// points k_n (0 when it selects nothing), and its start index, clamped into
// the cloud for reads (start_raw is what slot 0 reports).
struct Cloud {
  int L, k_n, start;
  int64_t start_raw;
};

__device__ __forceinline__ Cloud cloud_of(const int64_t* lengths,
                                          const int64_t* Ks,
                                          const int64_t* starts, int n, int P,
                                          int max_K) {
  Cloud c;
  const int64_t len = lengths[n];
  c.L = (int)(len < 0 ? 0 : (len > P ? P : len));
  int64_t k = Ks[n] < len ? Ks[n] : len;
  k = k < 0 ? 0 : (k > max_K ? max_K : k);
  c.k_n = c.L == 0 ? 0 : (int)k;
  c.start_raw = starts[n];
  const int64_t s = c.start_raw < c.L ? c.start_raw : c.L - 1;
  c.start = (int)(s < 0 ? 0 : s);
  return c;
}

// Slot 0 and the slots past the cloud's selections; slots 1..k_n-1 are
// written by the rounds.
__device__ __forceinline__ void write_pads(int64_t* o, const Cloud& c,
                                           int max_K) {
  for (int s = threadIdx.x; s < max_K; s += kThreads) {
    if (s == 0) {
      o[0] = c.k_n > 0 ? c.start_raw : -1;
    } else if (s >= c.k_n) {
      o[s] = -1;
    }
  }
}

template <int DIM>
__global__ void __launch_bounds__(kThreads) fps_block_kernel(
    const float* __restrict__ points, const int64_t* __restrict__ lengths,
    const int64_t* __restrict__ Ks, const int64_t* __restrict__ starts, int P,
    int D, int max_K, int64_t* __restrict__ out) {
  extern __shared__ float smem[];  // x (D, P), then min-distance (P)
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  const int n = blockIdx.x;
  const Cloud c = cloud_of(lengths, Ks, starts, n, P, max_K);
  int64_t* o = out + (int64_t)n * max_K;
  write_pads(o, c, max_K);
  if (c.k_n <= 1) return;

  float* xs = smem;
  float* md = smem + (int64_t)D * P;
  const float* pn = points + (int64_t)n * P * D;
  for (int e = threadIdx.x; e < c.L * D; e += kThreads) {
    const int p = e / D;
    xs[(int64_t)(e - p * D) * P + p] = pn[e];
  }
  for (int p = threadIdx.x; p < c.L; p += kThreads) md[p] = INFINITY;
  __syncthreads();

  int last = c.start;
  float sel[DIM > 0 ? DIM : 1];
  for (int r = 1; r < c.k_n; ++r) {
    const float* sp = xs + last;
    int ss = P;
    if (DIM > 0) {
#pragma unroll
      for (int d = 0; d < (DIM > 0 ? DIM : 1); ++d) sel[d] = sp[(int64_t)d * P];
      sp = sel;
      ss = 1;
    }
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int p = threadIdx.x; p < c.L; p += kThreads) {
      const float dist = sq_dist<DIM>(xs + p, P, sp, ss, D);
      const float m = dist < md[p] ? dist : md[p];
      md[p] = m;
      if (m > bv) {  // p ascends within a thread: strict keeps the first
        bv = m;
        bi = p;
      }
    }
    block_argmax(bv, bi, s_v, s_i);
    last = bi;
    if (threadIdx.x == 0) o[r] = last;
  }
}

template <bool RESIDENT, int DIM>
__global__ void __launch_bounds__(kThreads) fps_grid_kernel(
    const float* __restrict__ points, const int64_t* __restrict__ lengths,
    const int64_t* __restrict__ Ks, const int64_t* __restrict__ starts, int N,
    int P, int D, int max_K, int slice_cap, float* __restrict__ min_d,
    unsigned long long* __restrict__ partials, int64_t* __restrict__ out) {
  // RESIDENT: x (D, slice_cap), then min-distance (slice_cap); otherwise
  // the min-distances are min_d (P) in device memory.
  extern __shared__ float smem[];
  __shared__ float s_v[33];
  __shared__ int s_i[33];
  cg::grid_group grid = cg::this_grid();
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  // Rounds counted over all clouds: round `step` publishes into buffer
  // step & 1, so a block writes a buffer again only after the grid barrier
  // that follows every block's reading of it.
  unsigned step = 0;
  for (int n = 0; n < N; ++n) {
    const Cloud c = cloud_of(lengths, Ks, starts, n, P, max_K);
    int64_t* o = out + (int64_t)n * max_K;
    if (b == 0) write_pads(o, c, max_K);
    if (c.k_n <= 1) continue;  // the same for every block

    const float* pn = points + (int64_t)n * P * D;
    const int slice = (c.L + nb - 1) / nb;
    const int p0 = min(b * slice, c.L);
    const int p1 = min(p0 + slice, c.L);
    float* xs = smem;
    float* md = RESIDENT ? smem + (int64_t)D * slice_cap : min_d;
    __syncthreads();  // the previous cloud's slice is no longer read
    for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
      if (RESIDENT) {
        for (int d = 0; d < D; ++d) {
          xs[(int64_t)d * slice_cap + (p - p0)] = pn[(int64_t)p * D + d];
        }
        md[p - p0] = INFINITY;
      } else {
        md[p] = INFINITY;
      }
    }
    __syncthreads();

    int last = c.start;
    float sel[DIM > 0 ? DIM : 1];
    for (int r = 1; r < c.k_n; ++r) {
      const float* sp = pn + (int64_t)last * D;
      if (DIM > 0) {
#pragma unroll
        for (int d = 0; d < (DIM > 0 ? DIM : 1); ++d) sel[d] = sp[d];
        sp = sel;
      }
      // A block whose slice is empty publishes (-inf, INT_MAX): it never wins.
      float bv = -INFINITY;
      int bi = INT_MAX;
      for (int p = p0 + threadIdx.x; p < p1; p += kThreads) {
        const int64_t lp = RESIDENT ? p - p0 : p;
        const float dist =
            RESIDENT ? sq_dist<DIM>(xs + lp, slice_cap, sp, 1, D)
                     : sq_dist<DIM>(pn + (int64_t)p * D, 1, sp, 1, D);
        const float m = dist < md[lp] ? dist : md[lp];
        md[lp] = m;
        if (m > bv) {
          bv = m;
          bi = p;
        }
      }
      block_argmax(bv, bi, s_v, s_i);
      unsigned long long* buf = partials + (step & 1) * kMaxGridBlocks;
      ++step;
      if (threadIdx.x == 0) {
        __stcg(buf + b,
               ((unsigned long long)__float_as_uint(bv) << 32) | (unsigned)bi);
      }
      grid.sync();
      float gv = -INFINITY;
      int gi = INT_MAX;
      for (int t = threadIdx.x; t < nb; t += kThreads) {
        const unsigned long long e = __ldcg(buf + t);
        const float v = __uint_as_float((unsigned)(e >> 32));
        const int i = (int)(unsigned)(e & 0xffffffffu);
        if (better(v, i, gv, gi)) {
          gv = v;
          gi = i;
        }
      }
      block_argmax(gv, gi, s_v, s_i);
      last = gi;
      if (b == 0 && threadIdx.x == 0) o[r] = last;
    }
  }
}

int device_attr(cudaDeviceAttr attr, int* value) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(value, attr, dev);
  return err;
}

// Dynamic shared memory a block may take beside its static arrays.
int smem_budget(int* bytes) {
  int optin = 0;
  const int err = device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, &optin);
  *bytes = optin - kStaticSmem;
  return err;
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int DIM>
cudaError_t launch_block(const float* points, const int64_t* lengths,
                         const int64_t* Ks, const int64_t* starts, int N,
                         int P, int D, int max_K, int64_t* out,
                         cudaStream_t stream) {
  int budget = 0;
  cudaError_t err = (cudaError_t)smem_budget(&budget);
  if (err != cudaSuccess) return err;
  const size_t smem = (size_t)(D + 1) * P * sizeof(float);
  if (smem > (size_t)budget) return cudaErrorInvalidValue;
  err = allow_smem(fps_block_kernel<DIM>, smem);
  if (err != cudaSuccess) return err;
  fps_block_kernel<DIM><<<N, kThreads, smem, stream>>>(points, lengths, Ks,
                                                       starts, P, D, max_K, out);
  return cudaGetLastError();
}

template <bool RESIDENT, int DIM>
cudaError_t launch_grid(const float* points, const int64_t* lengths,
                        const int64_t* Ks, const int64_t* starts, int N, int P,
                        int D, int max_K, float* min_d,
                        unsigned long long* partials, int64_t* out,
                        cudaStream_t stream) {
  int sms = 0, budget = 0, coop = 0;
  cudaError_t err =
      (cudaError_t)device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err == cudaSuccess) err = (cudaError_t)smem_budget(&budget);
  if (err == cudaSuccess)
    err = (cudaError_t)device_attr(cudaDevAttrCooperativeLaunch, &coop);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  auto kernel = fps_grid_kernel<RESIDENT, DIM>;
  int slice_cap = 0;
  size_t smem = 0;
  if (RESIDENT) {
    // One block per SM, each holding its slice of the largest cloud.
    slice_cap = (P + sms - 1) / sms;
    smem = (size_t)(D + 1) * slice_cap * sizeof(float);
    if (smem > (size_t)budget) return cudaErrorInvalidValue;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  int blocks = RESIDENT ? sms : per_sm * sms;
  if (blocks > kMaxGridBlocks) blocks = kMaxGridBlocks;
  void* args[] = {(void*)&points, (void*)&lengths, (void*)&Ks,
                  (void*)&starts, (void*)&N,       (void*)&P,
                  (void*)&D,      (void*)&max_K,   (void*)&slice_cap,
                  (void*)&min_d,  (void*)&partials, (void*)&out};
  return cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                     dim3(kThreads), args, smem, stream);
}

}  // namespace

// The largest P that fps_block (one block per cloud) and fps_grid with
// resident = 1 (one block per SM) take at this D on the current device.
// Returns a cudaError_t.
extern "C" int fps_limits(int D, int64_t* block_max_points,
                          int64_t* resident_max_points) {
  int sms = 0, budget = 0;
  cudaError_t err =
      (cudaError_t)device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err == cudaSuccess) err = (cudaError_t)smem_budget(&budget);
  if (err != cudaSuccess) return err;
  if (D < 1) return cudaErrorInvalidValue;
  const int64_t per_block = budget / ((int64_t)(D + 1) * sizeof(float));
  *block_max_points = per_block;
  *resident_max_points = per_block * sms;
  return cudaSuccess;
}

// Number of partial entries in each of the grid kernel's two buffers: the
// partials argument of fps_grid holds 2 * fps_grid_max_blocks() uint64.
extern "C" int fps_grid_max_blocks() { return kMaxGridBlocks; }

// points (N, P, D) float32; lengths, Ks, starts (N,) int64; out (N, max_K)
// int64, written in full. One block per cloud. Returns a cudaError_t.
extern "C" int fps_block(const float* points, const int64_t* lengths,
                         const int64_t* Ks, const int64_t* starts, int N,
                         int P, int D, int max_K, int64_t* out, void* stream) {
  if (N <= 0 || max_K <= 0) return cudaSuccess;
  if (D < 1 || P < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 3) {
    return launch_block<3>(points, lengths, Ks, starts, N, P, D, max_K, out, s);
  }
  return launch_block<0>(points, lengths, Ks, starts, N, P, D, max_K, out, s);
}

// As fps_block, with every SM on one cloud at a time (cooperative launch).
// resident = 1 keeps the points in shared memory (P up to fps_limits'
// resident_max_points); resident = 0 streams them and the min-distances,
// min_d (P) float32, from device memory. partials: 2 * fps_grid_max_blocks()
// uint64 of scratch. Returns a cudaError_t.
extern "C" int fps_grid(const float* points, const int64_t* lengths,
                        const int64_t* Ks, const int64_t* starts, int N, int P,
                        int D, int max_K, int resident, float* min_d,
                        unsigned long long* partials, int64_t* out,
                        void* stream) {
  if (N <= 0 || max_K <= 0) return cudaSuccess;
  if (D < 1 || P < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (resident) {
    if (D == 3) {
      return launch_grid<true, 3>(points, lengths, Ks, starts, N, P, D, max_K,
                                  min_d, partials, out, s);
    }
    return launch_grid<true, 0>(points, lengths, Ks, starts, N, P, D, max_K,
                                min_d, partials, out, s);
  }
  if (D == 3) {
    return launch_grid<false, 3>(points, lengths, Ks, starts, N, P, D, max_K,
                                 min_d, partials, out, s);
  }
  return launch_grid<false, 0>(points, lengths, Ks, starts, N, P, D, max_K,
                               min_d, partials, out, s);
}

// Iterative farthest point sampling (FPS): per cloud, start from a given
// point, then repeatedly select the point whose distance to the selected set
// is largest (on equal distances the smallest index), up to
// min(K[n], lengths[n]) points; the rest of the row is -1.
//
// Replaces: pytorch3d_pointops_tpu/kernels/fps_pallas.py, all three TPU
// kernels: fps_pallas_batched (_fps_batched_kernel, many clouds advancing
// together), fps_pallas (_fps_dense8_kernel, one big cloud held in VMEM) and
// fps_pallas_chunked (_fps_chunked_kernel, a cloud streamed from HBM every
// round). Two kernels here back the four entry points:
//
// * fps_block_kernel<DIM, SLOTS, T, 1> (fps_batched): one block per cloud,
//   under a block plan (kernels/fps.py _block_plan: T threads with SLOTS
//   slots each). Each thread keeps its points' min-distances in registers
//   and, at D=3 up to 8192 points, their coordinates too; otherwise the
//   coordinates sit in shared memory. A round is one block barrier: the
//   warps' best records {key, coordinates} meet in shared memory, two
//   buffers by the round's parity, and every warp reduces them itself.
// * fps_block_kernel<3, 16, T, CLUSTER> (fps_clustered, CLUSTER in 2, 4, 8,
//   16): one thread-block cluster per cloud, every cloud at once, for
//   clouds one block cannot hold (kernels/fps.py _cluster_plan). Block rank
//   r owns the contiguous slice [r * slice, (r + 1) * slice) of its cloud,
//   slice = ceil(L / CLUSTER), laid out as one block's cloud. Each round
//   the block's best record goes from warp 0, lane j, into block j's shared
//   memory (distributed shared memory, st.async), counted on a transaction
//   barrier there; every warp of every block waits on its own block's
//   barrier and reduces the CLUSTER records: the exchange never leaves the
//   GPC, nothing waits on L2, no barrier spans the cluster in a round, and
//   no cluster waits on another.
// * fps_grid_kernel (fps_resident, fps_streaming): one block on every SM,
//   all on one cloud at a time, for clouds one cluster cannot hold. Block b
//   owns the contiguous slice [b * slice, (b + 1) * slice) of the cloud;
//   point q of a slice is slot q / T of thread q % T (T threads a block),
//   so each thread's points ascend. A launch plan (kernels/fps.py
//   _grid_plan) picks the instance and says where a slice lives:
//   - min-distances: in registers, SLOTS a thread, in fully unrolled loops,
//     while a slice has at most 1024 * 32 points; beyond, in device memory
//     (SLOTS = 0), read and written every round;
//   - coordinates: at D=3 and up to 8192 points a slice, in registers too
//     (256 threads with 8 slots, or 512 with 16: half the registers a
//     thread has), with a copy in shared memory; otherwise 1024 threads
//     hold the first `smem_slots` slots in shared memory and read the rest
//     from a copy in device memory, made at the start of each cloud and
//     small enough to stay in L2. Both copies are laid out
//     [slot][d][thread], so a thread reads only what it staged itself (no
//     barrier) at offsets known at compile time (no registers spent on
//     addresses).
//   fps_resident is a plan in which nothing streams; the two entry points
//   run the same instances.
//
// A round of the grid kernel: every thread folds the last selected point
// into its min-distances and keeps its first maximum; each warp reduces
// its keys, (float bits of v) << 32 | (0xFFFFFFFF - index) (v >= 0, so the
// largest key is the largest value with the lowest index), and takes its
// best point's coordinates from shared memory (one broadcast load) or the
// streamed copy. One barrier brings the warps' bests to warp 0, which
// publishes the block's record for the round: the key and the coordinates,
// each 64-bit word tagged with the round, in four copies. The first
// ceil(blocks / 32) warps of every block then poll one copy of all records
// (a lane each) until every word carries the round's tag, reduce them, and
// a second barrier hands the winner, coordinates included, to the block:
// one trip through L2 a round, no atomics, no grid barrier, and whatever
// the order of arrival the same winner. The copies split the readers of
// each record among four lines. Records form a ring of two rounds: a block
// writes round r + 2 only after every block has published round r + 1,
// which each does after reading round r. A wait that polls 2^22 times sets
// an error flag and ends the kernel; the host entry point waits for the
// stream to read it and returns an error for it. The launch is cooperative,
// which is what guarantees that every block is resident while the others
// wait on it.
//
// Bound on the card: K sequential rounds, each a pass over the cloud with
// 3*D+2 float32 operations a point (D subtractions, multiplies and adds, a
// min and a compare) and a reduction whose latency (a block barrier, and
// one publication through L2) no amount of parallelism hides. The block
// kernel pays one block barrier a round but uses one SM per cloud; the
// cluster path adds one hop between SMs a round on up to 16 SMs per cloud,
// every cloud at once; the grid kernel spreads a cloud over every SM and
// pays the L2 round trip, cloud after cloud.
//
// Keys are unique within a cloud (the index is in them), so the winner of
// a round is the same whatever the partition of the cloud into blocks,
// warps and slots: the three kernels select the same points.
//
// Ties: the distance to the selected set is not masked for selected points
// (they sit at 0), so when K exceeds the number of distinct points the
// first maximum may be a point already selected, as in the JAX package.
//
// Arithmetic: each axis term is rounded on its own and summed in order
// d = 0..D-1 (__fsub_rn/__fmul_rn/__fadd_rn, never contracted to FMA), so
// the distances, and hence every argmax, are bit-equal to the plain PyTorch
// version.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>


namespace {

constexpr int kMaxGridBlocks = 256;     // records a round: at most 8 polling warps
constexpr int kStaticSmem = 1024;       // shared memory kept for static arrays
constexpr unsigned kMaxPolls = 1u << 22;  // give up on a record rather than hang
constexpr int kRecord = 4;  // 64-bit words of a block's record: key, x, y, z
constexpr int kCopies = 4;  // copies of each record; block b reads copy b % 4

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
  for (int s = threadIdx.x; s < max_K; s += blockDim.x) {
    if (s == 0) {
      o[0] = c.k_n > 0 ? c.start_raw : -1;
    } else if (s >= c.k_n) {
      o[s] = -1;
    }
  }
}

// Whether a thread keeps its points' coordinates in registers (DIM known,
// coordinates and min-distances within half of the 65536 / threads
// registers a thread may have): 8192 points a block at D=3.
__host__ __device__ constexpr bool reg_coords(int dim, int slots, int threads) {
  return dim > 0 && slots > 0 && (dim + 1) * slots * threads <= 32768;
}

__device__ __forceinline__ unsigned long long warp_max_u64(unsigned long long w) {
  const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(w >> 32));
  const unsigned lo = __reduce_max_sync(
      0xffffffffu, (unsigned)(w >> 32) == hi ? (unsigned)w : 0u);
  return ((unsigned long long)hi << 32) | lo;
}

// The key of point `index` at min-distance v >= 0 (no tag): the largest key
// is the largest value with the lowest index.
__device__ __forceinline__ unsigned long long key_of(float v, int index) {
  return ((unsigned long long)__float_as_uint(v) << 32) |
         (0xFFFFFFFFu - (unsigned)index);
}

// The warp's largest key, and the DIM coordinates x that came with it, in
// every lane (keys are unique but for 0, which carries nothing).
template <int DIM>
__device__ __forceinline__ void warp_max_record(unsigned long long& key,
                                                float* x) {
  const unsigned long long m = warp_max_u64(key);
  const int src = __ffs(__ballot_sync(0xffffffffu, key == m)) - 1;
#pragma unroll
  for (int d = 0; d < DIM; ++d) x[d] = __shfl_sync(0xffffffffu, x[d], src);
  key = m;
}

// Squared distance of the point x[d * xs] to the selected point sel[d * ss],
// summed in order d = 0..D-1, from the first term: 0 + t is t for every
// t = diff * diff (never -0), so this is bit-equal to the plain twin's sum
// from 0.
template <int DIM>
__device__ __forceinline__ float sq_dist(const float* x, int xs,
                                         const float* sel, int ss, int D) {
  float diff = __fsub_rn(x[0], sel[0]);
  float dist = __fmul_rn(diff, diff);
#pragma unroll
  for (int d = 1; d < (DIM > 0 ? DIM : D); ++d) {
    diff = __fsub_rn(x[(int64_t)d * xs], sel[d * ss]);
    dist = __fadd_rn(dist, __fmul_rn(diff, diff));
  }
  return dist;
}

// ---- the block kernel -----------------------------------------------------

// The cluster path's exchange (sm_90 thread-block clusters): this block's
// rank in its cluster; the shared::cluster address of a shared memory
// location in block `rank`; a store into a peer block's shared memory that
// counts its bytes on a transaction barrier (mbarrier) there; and the
// barrier's setup (one arrival a phase), the arrival that announces a
// phase's bytes, and the wait for a phase of the given parity, which
// acquires what the stores counted on it wrote.
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned smem_address(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ unsigned peer_address(const void* p, unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out) : "r"(smem_address(p)), "r"(rank));
  return out;
}

__device__ __forceinline__ void store_peer(unsigned at, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];"
      ::"r"(at), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void store_peer(unsigned at, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(at), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}

__device__ __forceinline__ void bar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void bar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned bar, unsigned parity) {
  asm volatile("{\n\t.reg .pred p;\n\t"
               "WAIT_%=:\n\t"
               "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], %1;\n\t"
               "@!p bra WAIT_%=;\n\t}" ::"r"(bar), "r"(parity) : "memory");
}

__device__ __forceinline__ void cluster_barrier() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// A cluster block's records, two buffers by the round's parity: slot j
// holds block j's best {key (low, high word), x, y} and z; and a
// transaction barrier for each buffer. They sit in dynamic shared memory
// after the coordinates.
constexpr unsigned kClusterRecord = 20;  // bytes of a record: kxy and z

template <int CLUSTER>
struct ClusterRecords {
  uint4 kxy[2][CLUSTER];
  float z[2][CLUSTER];
  unsigned long long bar[2];
};

// Dynamic shared memory of a block kernel instance: where CLUSTER = 1, the
// coordinates that registers do not hold; where CLUSTER > 1, every slot's
// coordinates (the winners' lookups read them), then the records.
template <int DIM, int SLOTS, int T, int CLUSTER>
__host__ __device__ constexpr size_t block_coord_floats(int D, int P) {
  return CLUSTER > 1 ? (size_t)D * SLOTS * T
         : reg_coords(DIM, SLOTS, T) ? 0
                                     : (size_t)D * (DIM > 0 ? SLOTS * T : P);
}

template <int DIM, int SLOTS, int T, int CLUSTER>
size_t block_smem(int D, int P) {
  return block_coord_floats<DIM, SLOTS, T, CLUSTER>(D, P) * sizeof(float) +
         (CLUSTER > 1 ? sizeof(ClusterRecords<CLUSTER>) : 0);
}

// The cluster path's pass over a block's first U slots: fold the selected
// point into each min-distance and keep this thread's first maximum, by a
// strict compare from bv = -1 (below every point's min-distance, above the
// -inf of a slot past the slice). Exactly the slots a slice fills, with no
// branch between them.
template <int U, int SLOTS, int T, bool REG>
__device__ __forceinline__ void cluster_pass(float (&md)[SLOTS],
                                             const float (&xr)[REG ? SLOTS : 1][3],
                                             const float* xt, int ld,
                                             const float* sel, float& bv, int& fs) {
#pragma unroll
  for (int s = 0; s < U; ++s) {
    float dist;
    if constexpr (REG) {
      dist = sq_dist<3>(xr[s], 1, sel, 1, 3);
    } else {
      dist = sq_dist<3>(xt + s * T, ld, sel, 1, 3);
    }
    const float m = fminf(dist, md[s]);
    md[s] = m;
    if (m > bv) {
      bv = m;
      fs = s;
    }
  }
}

// CLUSTER = 1: one block of T threads per cloud; point q is slot q / T of
// thread q % T, and a plan (kernels/fps.py _block_plan) has T * SLOTS >= P.
// Each thread keeps its SLOTS min-distances in registers (slots past the
// cloud at -inf) and, at D=3 where reg_coords holds, its points'
// coordinates too; otherwise the coordinates sit in shared memory as
// [d][q], with a row of SLOTS * T points at D=3 (every slot staged, so the
// pass tests nothing) or P at any D (the slots past the cloud are masked by
// its length).
//
// A round: every thread folds the selected point into its min-distances,
// keeps its first maximum and that point's coordinates; each warp reduces
// its keys with warp_max_record and lane 0 writes {key, coordinates} into
// one of two record buffers, by the round's parity. After the round's one
// barrier every warp reads all T / 32 records (a lane each) and reduces
// them the same way, so each warp holds the winner's index and coordinates
// without a second barrier. Round r + 2 writes a buffer only after every
// warp has passed the barrier of round r + 1, which comes after its reads
// of round r. At any D the records carry the key alone, and the winner's
// coordinates are read from shared memory.
//
// CLUSTER > 1 (D=3 only): cluster n = blockIdx.x / CLUSTER takes cloud n,
// and its block of rank r holds the slice [r * slice, (r + 1) * slice) as
// the block above holds a cloud (a plan with T * SLOTS >= slice), with a
// copy of the coordinates in shared memory; its pass runs over the
// `slots` = ceil(slice points / T) slots the slice fills (cluster_pass,
// picked by a switch on slots), and the winner's coordinates come from the
// copy. A round: the warps' bests meet in shared memory at one block
// barrier, as above; warp 0 reduces them and its lane j < CLUSTER stores
// the block's record into slot rank of the round's buffer in block j
// (st.async, counted on block j's transaction barrier for that buffer);
// every warp of every block waits on its own block's barrier until all
// CLUSTER records of the round have landed, and reduces them. No barrier
// spans the cluster in a round, and no cluster waits on another: one whose
// cloud ends early exits.
//
// Why two buffers suffice: a block stores round r + 2's record into a
// peer only after its wait of round r + 1 saw that peer's record of round
// r + 1, which the peer stored after every one of its warps had read round
// r (they meet at the peer's block barrier of round r + 1 first); and
// round r + 2's bytes reach a barrier only after its phase of round r
// completed. One cluster barrier, after the transaction barriers are set
// up and before any store into a peer, waits until every block of the
// cluster runs; a block exits only after its last wait, when no peer
// stores into it any more.
template <int DIM, int SLOTS, int T, int CLUSTER>
__global__ void __launch_bounds__(T, 1) fps_block_kernel(
    const float* __restrict__ points, const int64_t* __restrict__ lengths,
    const int64_t* __restrict__ Ks, const int64_t* __restrict__ starts, int P,
    int D, int max_K, int64_t* __restrict__ out) {
  static_assert(CLUSTER == 1 || (DIM == 3 && SLOTS == 16), "the cluster path runs at D=3");
  constexpr int kD = DIM > 0 ? DIM : 1;
  constexpr int kWarps = T / 32;
  constexpr bool kRegCoords = reg_coords(DIM, SLOTS, T);
  extern __shared__ float xs[];  // [d][q] coordinates that registers do not hold
  __shared__ unsigned long long s_key[2][kWarps];
  __shared__ float s_x[2][kD][kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n = blockIdx.x / CLUSTER;
  const Cloud c = cloud_of(lengths, Ks, starts, n, P, max_K);
  int64_t* o = out + (int64_t)n * max_K;
  unsigned rank = 0;
  if constexpr (CLUSTER > 1) rank = cluster_rank();
  if (rank == 0) write_pads(o, c, max_K);
  if (c.k_n <= 1) return;

  const float* pn = points + (int64_t)n * P * D;
  // This block's part of the cloud: points [p0, p0 + cnt) of it, read from
  // px (the whole cloud where CLUSTER = 1).
  int p0 = 0, cnt = c.L, slots = SLOTS;
  if constexpr (CLUSTER > 1) {
    const int slice = (c.L + CLUSTER - 1) / CLUSTER;
    p0 = min((int)rank * slice, c.L);
    cnt = min(p0 + slice, c.L) - p0;
    slots = (cnt + T - 1) / T;
  }
  const float* px = pn + (int64_t)p0 * kD;
  const int ld = DIM > 0 ? SLOTS * T : P;  // row stride of xs
  float md[SLOTS];
  float xr[kRegCoords ? SLOTS : 1][kD];
  float sel[kD];
  if (DIM > 0) {
    // Each thread stages its own points and reads no other's.
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int q = s * T + tid;
      md[s] = q < cnt ? INFINITY : -INFINITY;
#pragma unroll
      for (int d = 0; d < kD; ++d) {
        const float v = q < cnt ? px[(int64_t)q * kD + d] : 0.f;
        if constexpr (kRegCoords) {
          xr[s][d] = v;
          if constexpr (CLUSTER > 1) xs[d * ld + q] = v;
        } else {
          xs[d * ld + q] = v;
        }
      }
    }
#pragma unroll
    for (int d = 0; d < kD; ++d) sel[d] = pn[(int64_t)c.start * kD + d];
  } else {
    for (int e = tid; e < c.L * D; e += T) {
      const int q = e / D;
      xs[(e - q * D) * ld + q] = pn[e];
    }
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) md[s] = s * T + tid < c.L ? INFINITY : -INFINITY;
    __syncthreads();
  }
  auto& recs = *reinterpret_cast<ClusterRecords<CLUSTER>*>(
      xs + block_coord_floats<DIM, SLOTS, T, CLUSTER>(D, P));
  unsigned peer_kxy = 0, peer_z = 0, peer_bar = 0;  // slot rank of buffer 0 in block `lane`
  if constexpr (CLUSTER > 1) {
    const unsigned j = lane < CLUSTER ? lane : 0;
    peer_kxy = peer_address(&recs.kxy[0][rank], j);
    peer_z = peer_address(&recs.z[0][rank], j);
    peer_bar = peer_address(&recs.bar[0], j);
    if (tid == 0) {
      bar_init(smem_address(&recs.bar[0]));
      bar_init(smem_address(&recs.bar[1]));
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    cluster_barrier();  // every block of the cluster runs, its barriers set up
  }

  int last = c.start;
  for (int r = 1; r < c.k_n; ++r) {
    if constexpr (CLUSTER > 1) {
      const int buf = r & 1;
      const unsigned bar = smem_address(&recs.bar[buf]);
      if (tid == 0) bar_expect(bar, CLUSTER * kClusterRecord);
      // Fold the selected point in; keep this thread's first maximum and
      // that point's coordinates.
      float bv = -1.f;
      int fs = -1;
      switch (slots) {
#define FPS_SLOTS(U)                                                          \
  case U:                                                                     \
    if constexpr (U <= SLOTS)                                                 \
      cluster_pass<U, SLOTS, T, kRegCoords>(md, xr, xs + tid, ld, sel, bv, fs); \
    break;
        FPS_SLOTS(1) FPS_SLOTS(2) FPS_SLOTS(3) FPS_SLOTS(4)
        FPS_SLOTS(5) FPS_SLOTS(6) FPS_SLOTS(7) FPS_SLOTS(8)
        FPS_SLOTS(9) FPS_SLOTS(10) FPS_SLOTS(11) FPS_SLOTS(12)
        FPS_SLOTS(13) FPS_SLOTS(14) FPS_SLOTS(15) FPS_SLOTS(16)
#undef FPS_SLOTS
      }
      float cx[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) cx[d] = fs >= 0 ? xs[d * ld + fs * T + tid] : 0.f;
      // The warp's best lane (every lane of a warp that holds no point)
      // writes the warp's record; warp 0 reduces the block's and stores it
      // into every block of the cluster.
      unsigned long long key = fs >= 0 ? key_of(bv, p0 + fs * T + tid) : 0ull;
      const unsigned long long wk = warp_max_u64(key);
      if (key == wk) {
        s_key[buf][warp] = wk;
#pragma unroll
        for (int d = 0; d < kD; ++d) s_x[buf][d][warp] = cx[d];
      }
      __syncthreads();
      if (warp == 0) {
        key = lane < kWarps ? s_key[buf][lane] : 0ull;
#pragma unroll
        for (int d = 0; d < kD; ++d) cx[d] = lane < kWarps ? s_x[buf][d][lane] : 0.f;
        warp_max_record<DIM>(key, cx);
        if (lane < CLUSTER) {
          const unsigned peer = peer_bar + buf * (unsigned)sizeof(unsigned long long);
          store_peer(peer_kxy + buf * CLUSTER * (unsigned)sizeof(uint4),
                     make_uint4((unsigned)key, (unsigned)(key >> 32),
                                __float_as_uint(cx[0]), __float_as_uint(cx[1])), peer);
          store_peer(peer_z + buf * CLUSTER * (unsigned)sizeof(float), cx[2], peer);
        }
      }
      // Every warp: the CLUSTER records of the round, a lane each.
      bar_wait(bar, ((r - 1) >> 1) & 1);
      key = 0ull;
#pragma unroll
      for (int d = 0; d < kD; ++d) cx[d] = 0.f;
      if (lane < CLUSTER) {
        const uint4 e = recs.kxy[buf][lane];
        key = ((unsigned long long)e.y << 32) | e.x;
        cx[0] = __uint_as_float(e.z);
        cx[1] = __uint_as_float(e.w);
        cx[2] = recs.z[buf][lane];
      }
      warp_max_record<DIM>(key, cx);
      last = (int)(0xFFFFFFFFu - (unsigned)key);
#pragma unroll
      for (int d = 0; d < kD; ++d) sel[d] = cx[d];
      if (rank == 0 && tid == 0) o[r] = last;
    } else {
      // Fold the selected point in; keep this thread's first maximum.
      float bv = 0.f;  // every min-distance of the cloud is >= 0
#pragma unroll
      for (int s = 0; s < SLOTS; ++s) {
        if (DIM == 0 && s * T + tid >= c.L) continue;  // the length mask
        float dist;
        if constexpr (kRegCoords) {
          dist = sq_dist<DIM>(xr[s], 1, sel, 1, D);
        } else if constexpr (DIM > 0) {
          dist = sq_dist<DIM>(xs + s * T + tid, ld, sel, 1, D);
        } else {
          dist = sq_dist<DIM>(xs + s * T + tid, ld, xs + last, ld, D);
        }
        md[s] = fminf(dist, md[s]);
        bv = fmaxf(bv, md[s]);
      }
      int fs = -1;  // its slot; none if the thread holds no point
      float cx[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) cx[d] = 0.f;
#pragma unroll
      for (int s = SLOTS - 1; s >= 0; --s) {
        if (md[s] == bv) {
          fs = s;
          if constexpr (kRegCoords) {
#pragma unroll
            for (int d = 0; d < kD; ++d) cx[d] = xr[s][d];
          }
        }
      }
      if constexpr (DIM > 0 && !kRegCoords) {
        if (fs >= 0) {
#pragma unroll
          for (int d = 0; d < kD; ++d) cx[d] = xs[d * ld + fs * T + tid];
        }
      }
      unsigned long long key = fs >= 0 ? key_of(bv, fs * T + tid) : 0ull;
      warp_max_record<DIM>(key, cx);
      const int buf = r & 1;
      if (lane == 0) {
        s_key[buf][warp] = key;
#pragma unroll
        for (int d = 0; d < DIM; ++d) s_x[buf][d][warp] = cx[d];
      }
      __syncthreads();
      key = lane < kWarps ? s_key[buf][lane] : 0ull;
#pragma unroll
      for (int d = 0; d < DIM; ++d) cx[d] = lane < kWarps ? s_x[buf][d][lane] : 0.f;
      warp_max_record<DIM>(key, cx);
      last = (int)(0xFFFFFFFFu - (unsigned)key);
#pragma unroll
      for (int d = 0; d < DIM; ++d) sel[d] = cx[d];
      if (tid == 0) o[r] = last;
    }
  }
}

// ---- the grid kernel ------------------------------------------------------

constexpr unsigned long long kTagBit = 1ull << 63;

// A record's words, read and written 16 bytes at a time at gpu scope
// (through L2). Each word carries the round's tag, so a record torn
// between rounds is never taken for a whole one.
__device__ __forceinline__ void load_pair(const unsigned long long* p,
                                          unsigned long long& a,
                                          unsigned long long& b) {
  asm volatile("ld.relaxed.gpu.global.v2.u64 {%0, %1}, [%2];"
               : "=l"(a), "=l"(b) : "l"(p) : "memory");
}

__device__ __forceinline__ void store_pair(unsigned long long* p,
                                           unsigned long long a,
                                           unsigned long long b) {
  asm volatile("st.relaxed.gpu.global.v2.u64 [%0], {%1, %2};"
               ::"l"(p), "l"(a), "l"(b) : "memory");
}

template <int DIM, int SLOTS, int T>
__global__ void __launch_bounds__(T, 1) fps_grid_kernel(
    const float* __restrict__ points, const int64_t* __restrict__ lengths,
    const int64_t* __restrict__ Ks, const int64_t* __restrict__ starts, int N,
    int P, int D, int max_K, int smem_slots,
    unsigned long long* __restrict__ ctrl, float* __restrict__ soa,
    float* __restrict__ md_g, int64_t* __restrict__ out) {
  constexpr int kS = SLOTS > 0 ? SLOTS : 1;
  constexpr int kD = DIM > 0 ? DIM : 1;
  // A thread holds its points' coordinates in registers beside their
  // min-distances while both take at most half the registers a thread has.
  constexpr bool kRegCoords = reg_coords(DIM, SLOTS, T);
  // Where every slot's coordinates fit shared memory (16 slots of 1024
  // threads at D=3), a plan that stages all of them gets a pass with no
  // branch between slots, so a thread's loads of several slots overlap.
  constexpr bool kAllSmem = !kRegCoords && DIM > 0 && SLOTS > 0 &&
                            (SLOTS * DIM * T + DIM) * 4 <= 232448 - kStaticSmem;
  // x [smem_slots][D][T], then the selected point (D; any-D instances)
  extern __shared__ float smem[];
  __shared__ unsigned long long s_key[T / 32];  // each warp's best
  __shared__ float s_x[kD][T / 32];
  __shared__ unsigned long long s_win[kMaxGridBlocks / 32];  // polled records
  __shared__ float s_wx[kD][kMaxGridBlocks / 32];
  __shared__ int s_abort;
  const int nb = gridDim.x;
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int DD = DIM > 0 ? DIM : D;
  const int pollers = (nb + 31) >> 5;
  float* sel_s = smem + (int64_t)smem_slots * DD * T;
  unsigned* error = reinterpret_cast<unsigned*>(ctrl);
  unsigned long long* records = ctrl + 2;  // 2 rounds x kCopies x nb records
  // soa and md_g hold, for each block, the slots of the largest slice.
  const int64_t slots_max = (((int64_t)P + nb - 1) / nb + T - 1) / T;
  const float* xs_t = smem + tid;
  float* soa_b = soa ? soa + b * slots_max * DD * T : nullptr;
  float* soa_t = soa ? soa_b + tid : nullptr;
  float* md_t = md_g ? md_g + b * slots_max * T + tid : nullptr;
  unsigned step = 0;  // rounds over all clouds
  if (tid == 0) s_abort = 0;
  float md[kS];
  float xr[kRegCoords ? kS : 1][kD];
  float sel[kD];
  for (int n = 0; n < N; ++n) {
    const Cloud c = cloud_of(lengths, Ks, starts, n, P, max_K);
    int64_t* o = out + (int64_t)n * max_K;
    if (b == 0) write_pads(o, c, max_K);
    if (c.k_n <= 1) continue;  // the same for every block

    const float* pn = points + (int64_t)n * P * D;
    const int slice = (c.L + nb - 1) / nb;
    const int p0 = min(b * slice, c.L);
    const int cnt = min(p0 + slice, c.L) - p0;
    const int slots = (cnt + T - 1) / T;  // this block's slots, for this cloud
    // Stage the slice: point q = s * T + tid into slot s. Slots past the
    // slice sit at -inf and never reach the maximum (their coordinates are
    // not read as a point's).
    if (SLOTS > 0) {
#pragma unroll
      for (int s = 0; s < kS; ++s) {
        md[s] = -INFINITY;
        if (s * T + tid < cnt) {
          md[s] = INFINITY;
          const float* src = pn + (int64_t)(p0 + s * T + tid) * DD;
#pragma unroll
          for (int d = 0; d < DD; ++d) {
            if (kRegCoords) xr[s][d] = src[d];
            if (s < smem_slots) {
              smem[(int64_t)(s * DD + d) * T + tid] = src[d];
            } else {
              soa_t[(int64_t)(s * DD + d) * T] = src[d];
            }
          }
        } else if (kRegCoords) {
#pragma unroll
          for (int d = 0; d < kD; ++d) xr[s][d] = 0.f;
        }
      }
    } else {
      for (int s = 0; s < slots && s * T + tid < cnt; ++s) {
        const float* src = pn + (int64_t)(p0 + s * T + tid) * DD;
        for (int d = 0; d < DD; ++d) {
          if (s < smem_slots) {
            smem[(int64_t)(s * DD + d) * T + tid] = src[d];
          } else {
            soa_t[(int64_t)(s * DD + d) * T] = src[d];
          }
        }
        md_t[(int64_t)s * T] = INFINITY;
      }
    }
    if (DIM > 0) {
#pragma unroll
      for (int d = 0; d < kD; ++d) sel[d] = pn[(int64_t)c.start * DD + d];
    } else {
      // The previous cloud's last round ended on a barrier after every
      // read of sel_s.
      for (int d = tid; d < D; d += T) sel_s[d] = pn[(int64_t)c.start * D + d];
      __syncthreads();
    }
    const float* sp = DIM > 0 ? sel : sel_s;

    for (int r = 1; r < c.k_n; ++r) {
      // Fold the selected point in; keep this thread's first maximum.
      float bv = 0.f;  // every min-distance of the slice is >= 0
      int fs = -1;     // its slot
      if (warp * 32 >= cnt) {
        // No point of the slice in this warp (small slices).
      } else if (kAllSmem && smem_slots >= kS) {
        // Slots past the slice read whatever shared memory holds; their
        // min-distance stays -inf (fminf(x, -inf) is -inf, NaN included).
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          const float dist = sq_dist<DIM>(xs_t + (int64_t)s * DD * T, T, sp, 1, D);
          md[s] = fminf(dist, md[s]);
          bv = fmaxf(bv, md[s]);
        }
#pragma unroll
        for (int s = kS - 1; s >= 0; --s) {
          if (md[s] == bv) fs = s;
        }
      } else if (SLOTS > 0) {
#pragma unroll
        for (int s = 0; s < kS; ++s) {
          if (s < slots) {
            float dist;
            if (kRegCoords) {
              dist = sq_dist<DIM>(xr[s], 1, sp, 1, D);
            } else if (s < smem_slots) {
              dist = sq_dist<DIM>(xs_t + (int64_t)s * DD * T, T, sp, 1, D);
            } else {
              dist = sq_dist<DIM>(soa_t + (int64_t)s * DD * T, T, sp, 1, D);
            }
            md[s] = fminf(dist, md[s]);
            bv = fmaxf(bv, md[s]);
          }
        }
#pragma unroll
        for (int s = kS - 1; s >= 0; --s) {
          if (s < slots && md[s] == bv) fs = s;
        }
      } else {
        for (int s = 0; s < slots && s * T + tid < cnt; ++s) {
          const float dist =
              s < smem_slots ? sq_dist<DIM>(xs_t + (int64_t)s * DD * T, T, sp, 1, D)
                             : sq_dist<DIM>(soa_t + (int64_t)s * DD * T, T, sp, 1, D);
          const float m = fminf(dist, md_t[(int64_t)s * T]);
          md_t[(int64_t)s * T] = m;
          if (m > bv || fs < 0) {  // s ascends: strict keeps the first
            bv = m;
            fs = s;
          }
        }
      }
      // This thread's candidate, then the warp's, with its coordinates
      // (every lane loads the same word: one broadcast).
      unsigned long long key = fs >= 0 ? key_of(bv, p0 + fs * T + tid) : 0ull;
      const unsigned long long wkey = warp_max_u64(key);
      float cx[kD];
#pragma unroll
      for (int d = 0; d < kD; ++d) cx[d] = 0.f;
      if (DIM > 0 && wkey) {
        const int src = __ffs(__ballot_sync(0xffffffffu, key == wkey)) - 1;
        const int ws = __shfl_sync(0xffffffffu, fs, src);
        const int wt = (tid & ~31) + src;
        const float* x = (ws < smem_slots ? smem : soa_b) + wt;
#pragma unroll
        for (int d = 0; d < kD; ++d) cx[d] = x[(int64_t)(ws * DIM + d) * T];
      }
      key = wkey;
      if (lane == 0) {
        s_key[warp] = key;
#pragma unroll
        for (int d = 0; d < DIM; ++d) s_x[d][warp] = cx[d];
      }
      __syncthreads();
      const unsigned long long tag = (unsigned long long)((step >> 1) & 1) << 63;
      unsigned long long* round = records + (int64_t)(step & 1) * kCopies * nb * kRecord;
      ++step;
      if (warp == 0) {
        key = lane < T / 32 ? s_key[lane] : 0ull;
#pragma unroll
        for (int d = 0; d < DIM; ++d) cx[d] = lane < T / 32 ? s_x[d][lane] : 0.f;
        warp_max_record<DIM>(key, cx);
        if (lane < kCopies) {
          unsigned long long* rec = round + ((int64_t)lane * nb + b) * kRecord;
          const unsigned long long x0 = DIM > 0 ? __float_as_uint(cx[0]) : 0u;
          const unsigned long long x1 = DIM > 1 ? __float_as_uint(cx[DIM > 1 ? 1 : 0]) : 0u;
          const unsigned long long x2 = DIM > 2 ? __float_as_uint(cx[DIM > 2 ? 2 : 0]) : 0u;
          store_pair(rec, tag | key, tag | x0);
          if (DIM > 1) store_pair(rec + 2, tag | x1, tag | x2);
        }
      }
      // Every block reads every record (copy b % kCopies): lane j of poller
      // warp w takes record 32 w + j.
      if (warp < pollers) {
        const int j = warp * 32 + lane;
        unsigned long long e[kRecord] = {0ull, 0ull, 0ull, 0ull};
        bool done = j >= nb;
        for (unsigned polls = 0;; ++polls) {
          if (!done) {
            const unsigned long long* rec = round + ((int64_t)(b % kCopies) * nb + j) * kRecord;
            load_pair(rec, e[0], e[1]);
            if (DIM > 1) load_pair(rec + 2, e[2], e[3]);
            done = true;
#pragma unroll
            for (int k = 0; k < (DIM > 1 ? 4 : DIM > 0 ? 2 : 1); ++k) {
              done &= (e[k] & kTagBit) == tag;
            }
          }
          if (__all_sync(0xffffffffu, done)) break;
          if (polls >= kMaxPolls ||
              ((polls & 1023) == 1023 && *reinterpret_cast<volatile unsigned*>(error))) {
            if (lane == 0) {
              atomicExch(error, 1u);
              s_abort = 1;
            }
            break;
          }
          __nanosleep(64);
        }
        key = j < nb ? e[0] & ~kTagBit : 0ull;
#pragma unroll
        for (int d = 0; d < DIM; ++d) cx[d] = __uint_as_float((unsigned)e[1 + d]);
        warp_max_record<DIM>(key, cx);
        if (lane == 0) {
          s_win[warp] = key;
#pragma unroll
          for (int d = 0; d < DIM; ++d) s_wx[d][warp] = cx[d];
        }
      }
      __syncthreads();
      if (s_abort) return;
      unsigned long long w = s_win[0];
      int wk = 0;
      for (int k = 1; k < pollers; ++k) {
        if (s_win[k] > w) {
          w = s_win[k];
          wk = k;
        }
      }
      const int last = (int)(0xFFFFFFFFu - (unsigned)w);
      if (DIM > 0) {
#pragma unroll
        for (int d = 0; d < kD; ++d) sel[d] = s_wx[d][wk];
      } else {
        // The barrier above ended this round's reads of sel_s.
        for (int d = tid; d < D; d += T) sel_s[d] = __ldg(pn + (int64_t)last * D + d);
        __syncthreads();
      }
      if (b == 0 && tid == 0) o[r] = last;
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

// The block kernel's launch attributes: its dynamic shared memory (within
// the budget) and, past 8 blocks a cluster, the non-portable cluster size.
template <int DIM, int SLOTS, int T, int CLUSTER>
cudaError_t prepare_block(size_t smem) {
  auto kernel = fps_block_kernel<DIM, SLOTS, T, CLUSTER>;
  if (smem > 0) {
    int budget = 0;
    cudaError_t err = (cudaError_t)smem_budget(&budget);
    if (err != cudaSuccess) return err;
    if (smem > (size_t)budget) return cudaErrorInvalidValue;
    err = allow_smem(kernel, smem);
    if (err != cudaSuccess) return err;
  }
  if (CLUSTER > 8) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  }
  return cudaSuccess;
}

// A launch of `clusters` clusters of CLUSTER blocks.
struct ClusterLaunch {
  cudaLaunchConfig_t cfg{};
  cudaLaunchAttribute attr[1];
  ClusterLaunch(int clusters, int cluster, int threads, size_t smem, cudaStream_t stream) {
    cfg.gridDim = dim3(clusters * cluster);
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

template <int DIM, int SLOTS, int T, int CLUSTER>
cudaError_t launch_block(const float* points, const int64_t* lengths,
                         const int64_t* Ks, const int64_t* starts, int N,
                         int P, int D, int max_K, int64_t* out,
                         cudaStream_t stream) {
  auto kernel = fps_block_kernel<DIM, SLOTS, T, CLUSTER>;
  const size_t smem = block_smem<DIM, SLOTS, T, CLUSTER>(D, P);
  if ((P + CLUSTER - 1) / CLUSTER > SLOTS * T) return cudaErrorInvalidValue;
  cudaError_t err = prepare_block<DIM, SLOTS, T, CLUSTER>(smem);
  if (err != cudaSuccess) return err;
  if constexpr (CLUSTER > 1) {
    ClusterLaunch l(N, CLUSTER, T, smem, stream);
    err = cudaLaunchKernelEx(&l.cfg, kernel, points, lengths, Ks, starts, P, D, max_K, out);
    if (err != cudaSuccess) return err;
  } else {
    kernel<<<N, T, smem, stream>>>(points, lengths, Ks, starts, P, D, max_K, out);
  }
  return cudaGetLastError();
}

// The clusters of CLUSTER blocks of an instance that the card holds at once.
template <int SLOTS, int T, int CLUSTER>
cudaError_t active_clusters(int* count) {
  const size_t smem = block_smem<3, SLOTS, T, CLUSTER>(3, 1);
  cudaError_t err = prepare_block<3, SLOTS, T, CLUSTER>(smem);
  if (err != cudaSuccess) return err;
  ClusterLaunch l(1, CLUSTER, T, smem, nullptr);
  return cudaOccupancyMaxActiveClusters(
      count, (const void*)fps_block_kernel<3, SLOTS, T, CLUSTER>, &l.cfg);
}

// The block plans: at D=3, coordinates in registers up to 8192 points (256
// threads with 8 or 16 slots, 512 with 16), in shared memory up to 16384
// (1024 with 16); at any other D, 1024 threads with 8, 16 or 32 slots.
template <int DIM>
cudaError_t launch_block_plan(const float* points, const int64_t* lengths,
                              const int64_t* Ks, const int64_t* starts, int N,
                              int P, int D, int max_K, int threads, int slots,
                              int64_t* out, cudaStream_t stream) {
#define FPS_BLOCK(S, T)                                                       \
  if (threads == T && slots == S)                                             \
    return launch_block<DIM, S, T, 1>(points, lengths, Ks, starts, N, P, D,   \
                                      max_K, out, stream);
  if constexpr (DIM == 3) {
    FPS_BLOCK(8, 256)
    FPS_BLOCK(16, 256)
    FPS_BLOCK(16, 512)
    FPS_BLOCK(16, 1024)
  } else {
    FPS_BLOCK(8, 1024)
    FPS_BLOCK(16, 1024)
    FPS_BLOCK(32, 1024)
  }
#undef FPS_BLOCK
  return cudaErrorInvalidValue;
}

// The cluster instances, in the order of kernels/fps.py CLUSTER_PLANS: each
// D=3 block plan (a block's slice) under clusters of 2, 4, 8 and 16 blocks.
#define FPS_CLUSTER_PLANS(X) \
  X(16, 256, 2) X(16, 256, 4) X(16, 256, 8) X(16, 256, 16) \
  X(16, 512, 2) X(16, 512, 4) X(16, 512, 8) X(16, 512, 16) \
  X(16, 1024, 2) X(16, 1024, 4) X(16, 1024, 8) X(16, 1024, 16)

struct GridArgs {
  const float* points;
  const int64_t *lengths, *Ks, *starts;
  int N, P, D, max_K, smem_slots;
  unsigned long long* ctrl;
  float *soa, *md_g;
  int64_t* out;
};

template <int DIM, int SLOTS, int T>
cudaError_t launch_grid(GridArgs a, int blocks, cudaStream_t stream) {
  int sms = 0, budget = 0, coop = 0;
  cudaError_t err =
      (cudaError_t)device_attr(cudaDevAttrMultiProcessorCount, &sms);
  if (err == cudaSuccess) err = (cudaError_t)smem_budget(&budget);
  if (err == cudaSuccess)
    err = (cudaError_t)device_attr(cudaDevAttrCooperativeLaunch, &coop);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  auto kernel = fps_grid_kernel<DIM, SLOTS, T>;
  const size_t smem = (size_t)a.D * ((size_t)a.smem_slots * T + 1) * sizeof(float);
  if (smem > (size_t)budget) return cudaErrorInvalidValue;
  err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1 || blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  // The error word at 0, then every record of both rounds at tag 1.
  err = cudaMemsetAsync(a.ctrl, 0, 2 * sizeof(unsigned long long), stream);
  if (err == cudaSuccess) {
    err = cudaMemsetAsync(a.ctrl + 2, 0xff,
                          2 * (size_t)kCopies * blocks * kRecord * sizeof(unsigned long long),
                          stream);
  }
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a.points, (void*)&a.lengths, (void*)&a.Ks,
                  (void*)&a.starts, (void*)&a.N,       (void*)&a.P,
                  (void*)&a.D,      (void*)&a.max_K,   (void*)&a.smem_slots,
                  (void*)&a.ctrl,   (void*)&a.soa,     (void*)&a.md_g,
                  (void*)&a.out};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(T), args, smem, stream);
  if (err != cudaSuccess) return err;
  // A wait that gave up set the error word: report it, never a result.
  unsigned flag = 0;
  err = cudaMemcpyAsync(&flag, a.ctrl, sizeof(flag), cudaMemcpyDeviceToHost,
                        stream);
  if (err == cudaSuccess) err = cudaStreamSynchronize(stream);
  if (err != cudaSuccess) return err;
  return flag ? cudaErrorLaunchTimeout : cudaSuccess;
}

// The instances: at D=3, small slices with coordinates in registers
// (256 threads with 8 slots, 512 with 16) and larger ones in shared memory and
// streamed (1024 threads, 16 or 32 slots, or min-distances in device
// memory); at any other D, 1024 threads with 8, 16, 32 or 0 slots.
template <int DIM>
cudaError_t launch_grid_plan(GridArgs a, int blocks, int threads, int slots,
                             cudaStream_t stream) {
  if constexpr (DIM == 3) {
    if (threads == 256 && slots == 8) return launch_grid<DIM, 8, 256>(a, blocks, stream);
    if (threads == 512 && slots == 16) return launch_grid<DIM, 16, 512>(a, blocks, stream);
  } else {
    if (threads == 1024 && slots == 8) return launch_grid<DIM, 8, 1024>(a, blocks, stream);
  }
  if (threads == 1024 && slots == 16) return launch_grid<DIM, 16, 1024>(a, blocks, stream);
  if (threads == 1024 && slots == 32) return launch_grid<DIM, 32, 1024>(a, blocks, stream);
  if (threads == 1024 && slots == 0) return launch_grid<DIM, 0, 1024>(a, blocks, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// The device's SM count and the dynamic shared memory an FPS block may take
// (kernels/fps.py reads its capacities from these). Returns a cudaError_t.
extern "C" int fps_card(int* sms, int* smem_bytes) {
  cudaError_t err =
      (cudaError_t)device_attr(cudaDevAttrMultiProcessorCount, sms);
  if (err == cudaSuccess) err = (cudaError_t)smem_budget(smem_bytes);
  return err;
}

// points (N, P, D) float32; lengths, Ks, starts (N,) int64; out (N, max_K)
// int64, written in full. One block of `threads` threads per cloud, each
// with `slots` slots (threads * slots >= P), under a block plan of
// kernels/fps.py (launch_block_plan lists the instances). Returns a
// cudaError_t.
extern "C" int fps_block(const float* points, const int64_t* lengths,
                         const int64_t* Ks, const int64_t* starts, int N,
                         int P, int D, int max_K, int threads, int slots,
                         int64_t* out, void* stream) {
  if (N <= 0 || max_K <= 0) return cudaSuccess;
  if (D < 1 || P < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 3) {
    return launch_block_plan<3>(points, lengths, Ks, starts, N, P, D, max_K,
                                threads, slots, out, s);
  }
  return launch_block_plan<0>(points, lengths, Ks, starts, N, P, D, max_K,
                              threads, slots, out, s);
}

// As fps_block, at D=3, with one cluster of `cluster` blocks per cloud, all
// clouds at once: block r of a cluster owns points [r * slice, (r + 1) *
// slice) of its cloud, slice = ceil(length / cluster) <= threads * slots,
// under an instance of FPS_CLUSTER_PLANS. No cooperative launch, no
// scratch, no wait for the kernel. Returns a cudaError_t.
extern "C" int fps_cluster(const float* points, const int64_t* lengths,
                           const int64_t* Ks, const int64_t* starts, int N,
                           int P, int D, int max_K, int threads, int slots,
                           int cluster, int64_t* out, void* stream) {
  if (N <= 0 || max_K <= 0) return cudaSuccess;
  if (D != 3 || P < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FPS_CLUSTER(S, T, C)                                                  \
  if (threads == T && slots == S && cluster == C)                            \
    return launch_block<3, S, T, C>(points, lengths, Ks, starts, N, P, D,     \
                                    max_K, out, s);
  FPS_CLUSTER_PLANS(FPS_CLUSTER)
#undef FPS_CLUSTER
  return cudaErrorInvalidValue;
}

// The clusters of each instance of FPS_CLUSTER_PLANS, in that order, that
// the current device holds at once (cudaOccupancyMaxActiveClusters), 0 for
// an instance it cannot launch: `active` has 12 ints. Returns a
// cudaError_t.
extern "C" int fps_cluster_card(int* active) {
  int dev = 0;
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  int i = 0;
#define FPS_ACTIVE(S, T, C)                                                   \
  if (active_clusters<S, T, C>(&active[i]) != cudaSuccess) {                  \
    active[i] = 0;                                                            \
    cudaGetLastError();                                                       \
  }                                                                           \
  ++i;
  FPS_CLUSTER_PLANS(FPS_ACTIVE)
#undef FPS_ACTIVE
  return cudaSuccess;
}

// As fps_block, with `blocks` blocks of `threads` threads on one cloud at
// a time (cooperative launch), under a launch plan of kernels/fps.py
// (launch_grid_plan lists the instances). A block's slice of the largest
// cloud is ceil(P / blocks) points, S = ceil(slice / threads) slots a
// thread. `slots` is how many min-distances a thread holds in registers (at
// least S), or 0 for min_d in device memory (blocks * S * threads
// float32). The first `smem_slots` slots of every slice sit in shared
// memory (all S where registers hold the coordinates too), the rest in soa
// (blocks * S * D * threads float32; unused when nothing streams). ctrl:
// 2 + 32 * blocks uint64 of scratch. Waits for the kernel, and returns
// cudaErrorLaunchTimeout if a block gave up waiting. Returns a cudaError_t.
extern "C" int fps_grid(const float* points, const int64_t* lengths,
                        const int64_t* Ks, const int64_t* starts, int N, int P,
                        int D, int max_K, int blocks, int threads, int slots,
                        int smem_slots,
                        unsigned long long* ctrl, float* soa, float* min_d,
                        int64_t* out, void* stream) {
  if (N <= 0 || max_K <= 0) return cudaSuccess;
  if (D < 1 || P < 1 || blocks < 1 || blocks > kMaxGridBlocks ||
      smem_slots < 0 || !ctrl) {
    return cudaErrorInvalidValue;
  }
  const int64_t slice = ((int64_t)P + blocks - 1) / blocks;
  if (threads != 256 && threads != 512 && threads != 1024) return cudaErrorInvalidValue;
  const int64_t S = (slice + threads - 1) / threads;
  if (slots > 0 && slots < S) return cudaErrorInvalidValue;
  if (reg_coords(D == 3 ? 3 : 0, slots, threads) ? smem_slots < S
                                                 : (S > smem_slots && !soa)) {
    return cudaErrorInvalidValue;
  }
  if (slots == 0 && !min_d) return cudaErrorInvalidValue;
  GridArgs a{points, lengths, Ks, starts, N, P, D, max_K, smem_slots, ctrl,
             soa, min_d, out};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 3) return launch_grid_plan<3>(a, blocks, threads, slots, s);
  return launch_grid_plan<0>(a, blocks, threads, slots, s);
}

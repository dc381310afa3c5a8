// Streaming brute-force KNN with a register-resident sorted top-K per query.
//
// Replaces: pytorch3d_pointops_tpu/kernels/knn_pallas.py knn_forward_pallas
// (kernel body _knn_kernel), including its any-K contract that the TPU side
// serves by chaining 64-key rounds (_knn_forward_pallas_bigk).
//
// Bound on the card: instruction issue. A pair costs 3*D float32 operations
// (subtract, square or abs, accumulate), and since the distances must be
// bit-equal to the plain PyTorch version they are built with -fmad=false, so
// every one issues on its own: at D=3, 8 a pair (the first term needs no
// add). Design, all of it aimed at issuing little more than those 8:
//
// * Q queries a thread (template, 1 or 2), their coordinates in
//   registers (D <= 8). A block covers Q * blockDim.x consecutive queries;
//   each staged candidate is loaded from shared memory once per thread and
//   feeds Q independent distance chains.
// * The block stages tiles of candidates in shared memory, padded to 4 (D=3)
//   or 8 (D<=8) floats so that one broadcast 16-byte load gives a D=3
//   candidate. Tiles are double-buffered with cp.async: tile t+1 is in
//   flight while tile t is scanned, and one block barrier per tile both
//   publishes tile t and frees the buffer that tile t+1 overwrites. Where
//   registers allow, a thread also loads the next group of candidates
//   while it computes this one.
// * A group of U = 16/Q candidates is scanned without branching: the Q*U
//   distances stay in registers and each query keeps one "anything below my
//   kth" flag. One __any_sync per group decides whether the warp looks at
//   the group at all; only then does each flagged query append its
//   candidates below its kth to a pending list in shared memory, which is
//   inserted in ascending j at the end of the tile (see Scan). After the
//   first tiles the vote rarely fires, and a warp's insertions cost its
//   longest list, not the union over time of its lanes' insertions.
// * The top-K state is a sorted (value, index) array per query in
//   registers, templated on K buckets so that the insertion unrolls fully;
//   Q = 2 only up to KB = 16, so that nothing spills. The wrapper (kernels/knn.py) picks Q, threads and tile from the
//   shapes and the card's resident blocks (knn_resident_blocks).
//
// Order: candidates are admitted in ascending index, only when strictly
// smaller than the kth value, behind entries of equal value, so the state is
// in lexicographic (value, index) order: on ties the lowest index wins. K >
// 64 runs ceil(K/64) rounds of the 64-bucket kernel; round r admits only
// candidates lexicographically above round r-1's last entry (lb_d, lb_i), so
// the rounds concatenate to the global order.
//
// Query sorting (ports knn_pallas.py's sort_queries): the wrapper may pass
// rows, the queries in Morton order; the kernel's query q of cloud n is then
// row rows[n * P1 + q] of p1 (read where it lies, no copy), while lb_d/lb_i
// and the outputs stay in the kernel's order, which the wrapper undoes. A
// warp's and a block's queries are neighbours, so their votes fire
// together.
//
// Candidate sorting (CARRIED; ports knn_pallas.py's sort_candidates): the
// wrapper hands p2 in Morton order with each row's original index
// (cand_ids) and a start tile per block (starts), the tile whose Morton
// codes hold the block's median query. A block scans tile (start + t) mod
// tiles at step t, so its kth values are nearly final after the first tile
// and later votes rarely fire. Tiles then arrive out of index order, so the
// state is kept lexicographic on (value, original index) explicitly: the
// vote and the pending lists take d <= kth (ties may still win on index),
// and admit compares and places by (value, index). The original indices
// are staged with the tile, in each candidate's fourth (padding) float, so
// a drain reads one with the candidate. Outputs are original indices. Rows
// past lengths2 were sorted last by the wrapper, so the
// truncation by position stays right.
//
// Seeding (ports knn_pallas.py's seeded kernel): the wrapper may pass ub,
// one seed a query in the kernel's query order, the next float above a
// sampled upper bound on its kth distance. The state then starts as K
// entries (seed, kSent) instead of (inf, 0), so the vote screens at the
// bound from the first tile and a query inserts only the candidates below
// it. The rules above hold unchanged: a candidate equal to the seed sorts
// after the seed entries without CARRIED (v > d) and before them with it
// (i == kSent > j): a superset admission into an exact insert. A kSent left
// in a slot the cloud could have filled means the bound was too tight; the
// wrapper detects that on the device and reruns every round unseeded,
// gated on that word (gate: every block returns at once while it is 0). A
// seed of +inf is no seed: that query starts at (inf, 0). ub and gate are
// read once a block, so the instances are those of the unseeded kernel.
//
// Counting (COUNT; ports knn_pallas.py's instrument): per block, the groups
// its warps scanned, the votes that fired, the drains that had work, the
// insertions into the top-K, and the candidates that passed the screen into
// a pending list; compiled out of the production instances.
//
// Arithmetic: each axis term is rounded on its own and summed in order
// d = 0..D-1 (__fsub_rn/__fmul_rn/__fadd_rn, never contracted to FMA), so
// the distances are bit-equal to the plain PyTorch version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kGroupSlots = 16;  // Q * U: distances a thread holds per vote
constexpr size_t kDefaultSmem = 48 * 1024;
// The index of a seed entry (knn_pallas.py _SENT): above every real index.
constexpr int kSent = 0x7fffffff;

// Floats a staged candidate takes: padded to a 16-byte multiple for D <= 8.
__host__ __device__ inline int stride_of(int dim, int D) {
  return dim == 3 ? 4 : (dim == 8 ? 8 : D);
}

template <int NORM>
__device__ __forceinline__ float axis_term(float a, float b) {
  const float diff = __fsub_rn(a, b);
  return NORM == 2 ? __fmul_rn(diff, diff) : fabsf(diff);
}

__device__ __forceinline__ void cp_async_f32(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Issue the copies of cnt candidates (cnt * D floats at src) into dst at
// stride S; CARRIED (D = 3) also copies each one's original index (cnt ints
// at ids) into its fourth, padding float. Each thread commits one group of
// copies.
template <int DIM, bool CARRIED>
__device__ __forceinline__ void stage_tile(float* dst, const float* src,
                                           const int* ids, int cnt, int D, int S) {
  const int total = cnt * D;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = DIM == 3 ? e / 3 : e / D;
    cp_async_f32(dst + c * S + (e - c * (DIM == 3 ? 3 : D)), src + e);
  }
  if constexpr (CARRIED) {
    for (int c = threadIdx.x; c < cnt; c += blockDim.x) {
      cp_async_f32(dst + c * S + 3, reinterpret_cast<const float*>(ids + c));
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A staged candidate: its coordinates in registers (DIM > 0) or a pointer
// into shared memory (DIM == 0, any D).
template <int DIM>
struct Cand {
  float v[DIM == 3 ? 4 : (DIM == 8 ? 8 : 1)];
  const float* p;
};

template <int DIM>
__device__ __forceinline__ Cand<DIM> load_cand(const float* c) {
  Cand<DIM> r;
  if constexpr (DIM == 0) {
    r.p = c;
  } else {
#pragma unroll
    for (int h = 0; h < DIM; h += 4) {
      const float4 a = *reinterpret_cast<const float4*>(c + h);
      r.v[h] = a.x;
      r.v[h + 1] = a.y;
      r.v[h + 2] = a.z;
      r.v[h + 3] = a.w;
    }
  }
  return r;
}

// Sum of the axis terms in order d = 0..D-1, starting from the first term
// (0 + term0 == term0 exactly: a term is never -0).
template <int DIM, int NORM>
__device__ __forceinline__ float distance(const float* q, const Cand<DIM>& c,
                                          int D) {
  if constexpr (DIM == 0) {
    float d = axis_term<NORM>(q[0], c.p[0]);
    for (int k = 1; k < D; ++k) d = __fadd_rn(d, axis_term<NORM>(q[k], c.p[k]));
    return d;
  } else {
    float d = axis_term<NORM>(q[0], c.v[0]);
#pragma unroll
    for (int k = 1; k < DIM; ++k) {
      if (DIM == 3 || k < D) d = __fadd_rn(d, axis_term<NORM>(q[k], c.v[k]));
    }
    return d;
  }
}

// Whether entry (v, i) sorts after candidate (d, j): by value, and with
// CARRIED (candidates out of index order) by index among equal values;
// without it every entry already held has a lower index than j.
template <bool CARRIED>
__device__ __forceinline__ bool after(float v, int i, float d, int j) {
  return v > d || (CARRIED && v == d && i > j);
}

// Insert (dist, j) if it sorts before the kth entry (and, for a chained
// round, lexicographically after the previous round's last entry): behind
// every entry that does not sort after it. Slot s takes slot s-1's entry
// when that entry sorts after the candidate, else the candidate when slot s
// held one that does; walking s downward reads slots not yet written.
// Returns whether it was inserted.
template <int KB, bool CHAINED, bool CARRIED>
__device__ __forceinline__ bool admit(float (&bd)[KB], int (&bi)[KB],
                                      float dist, int j, float lbd, int lbi) {
  if (!after<CARRIED>(bd[KB - 1], bi[KB - 1], dist, j)) return false;
  if (CHAINED && !(dist > lbd || (dist == lbd && j > lbi))) return false;
#pragma unroll
  for (int s = KB - 1; s > 0; --s) {
    if (after<CARRIED>(bd[s - 1], bi[s - 1], dist, j)) {
      bd[s] = bd[s - 1];
      bi[s] = bi[s - 1];
    } else if (after<CARRIED>(bd[s], bi[s], dist, j)) {
      bd[s] = dist;
      bi[s] = j;
    }
  }
  if (after<CARRIED>(bd[0], bi[0], dist, j)) {
    bd[0] = dist;
    bi[0] = j;
  }
  return true;
}

// The vote's and the pending lists' test of a distance against the kth:
// strict without CARRIED; with it, ties too (admit decides them by index).
template <bool CARRIED>
__device__ __forceinline__ bool below_kth(float d, float kth) {
  return CARRIED ? d <= kth : d < kth;
}

// One thread's queries and their top-K state, and the scan of one staged
// tile. DIM > 0: the queries live in registers and loops unroll to DIM; the
// runtime D must be <= DIM (shorter D is predicated). DIM == 0: any D, Q = 1,
// the query read from global memory (L1-resident after the first tile).
//
// A group whose vote fires does not insert at once: each flagged query
// appends the group's candidates below its kth to its pending list in
// shared memory (tile positions, ascending). The lists are drained into the
// top-K (in list order, each candidate checked again against the kth it
// meets then) when one may overflow and at the end of the tile. A warp then
// pays for the longest list of its lanes, not for every group in which any
// lane had a candidate; checking each candidate against the kth as it was
// when the list was filled admits a superset of what an insertion in
// ascending j admits, so the drained state is the same.
template <int KB, int DIM, int NORM, int Q, bool CHAINED, bool CARRIED, bool COUNT>
struct Scan {
  static_assert(!CARRIED || DIM == 3, "original indices ride in D=3 padding");
  static constexpr int U = kGroupSlots / Q;  // candidates a group
  static constexpr int C = 2 * U;            // pending list capacity
  static constexpr int QD = DIM > 0 ? DIM : 1;

  float qv[Q][QD];
  const float* qp[Q];
  float bd[Q][KB];
  int bi[Q][KB];
  float lbd[Q];
  int lbi[Q];
  int npend[Q];
  int* pend;  // (Q, C, blockDim.x) tile positions
  int D, S;
  // COUNT: groups scanned, votes fired, drains with work (all warp-uniform),
  // this thread's insertions and pending appends.
  unsigned groups, fired, drains, admitted, screened;

  __device__ __forceinline__ int* slot(int qq, int e) const {
    return pend + (qq * C + e) * blockDim.x + threadIdx.x;
  }

  __device__ __forceinline__ float dist(int qq, const Cand<DIM>& c) const {
    return distance<DIM, NORM>(DIM > 0 ? qv[qq] : qp[qq], c, D);
  }

  // Load candidates g..g+U-1 of the tile; TAIL: the tile's last, partial
  // group (cnt - g < U), whose loads stay inside the tile.
  template <bool TAIL>
  __device__ __forceinline__ void load_group(Cand<DIM> (&c)[U], const float* cur,
                                             int g, int cnt) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c[u] = load_cand<DIM>(cur + (TAIL ? min(g + u, cnt - 1) : g + u) * S);
    }
  }

  // Distances of the group's candidates for every query, one vote, and (if
  // it fires) the pending appends; TAIL appends only the real candidates.
  // Returns whether the vote fired (warp-uniform).
  template <bool TAIL>
  __device__ __forceinline__ bool group(const Cand<DIM> (&c)[U], int g, int cnt) {
    if constexpr (COUNT) ++groups;
    float dg[Q][U];
    bool hit[Q];
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) hit[qq] = false;
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        const float d = dist(qq, c[u]);
        dg[qq][u] = d;
        hit[qq] |= below_kth<CARRIED>(d, bd[qq][KB - 1]) &&
                   (!CHAINED || d >= lbd[qq]);
      }
    }
    bool any = false;
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) any |= hit[qq];
    if (!__any_sync(0xffffffffu, any)) return false;
    if constexpr (COUNT) ++fired;
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      if (!hit[qq]) continue;
      const float kth = bd[qq][KB - 1];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if ((!TAIL || g + u < cnt) && below_kth<CARRIED>(dg[qq][u], kth) &&
            (!CHAINED || dg[qq][u] >= lbd[qq])) {
          *slot(qq, npend[qq]++) = g + u;
          if constexpr (COUNT) ++screened;
        }
      }
    }
    return true;
  }

  // Insert every pending candidate of tile `cur` (whose first position is
  // t0) in list order, and empty the lists.
  __device__ __forceinline__ void drain(const float* cur, int t0) {
    if constexpr (COUNT) {
      bool work = false;
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) work |= npend[qq] > 0;
      drains += __any_sync(0xffffffffu, work) ? 1 : 0;
    }
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      for (int e = 0; e < npend[qq]; ++e) {
        const int c = *slot(qq, e);
        const Cand<DIM> cand = load_cand<DIM>(cur + c * S);
        int j = t0 + c;
        if constexpr (CARRIED) j = __float_as_int(cand.v[3]);
        const bool in = admit<KB, CHAINED, CARRIED>(bd[qq], bi[qq], dist(qq, cand),
                                                    j, lbd[qq], lbi[qq]);
        if constexpr (COUNT) admitted += in;
      }
      npend[qq] = 0;
    }
  }

  // After a vote fired: drain if a list may not take the next group.
  __device__ __forceinline__ void make_room(const float* cur, int t0) {
    bool crowded = false;
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) crowded |= npend[qq] > C - U;
    if (__any_sync(0xffffffffu, crowded)) drain(cur, t0);
  }

  // Every full group keeps room for the next (at most C - U pending after
  // it); the partial group, if any, fits in that room before the last drain.
  // PREFETCH (D=3) loads the next group while this one is computed, 4 * U
  // more registers: on the H100 it paid at Q = 2 and at KB = 64, and at
  // Q = 1 below KB = 64 its registers cost more occupancy than it hid
  // (tune_knn.py). Its last load reads up to U candidates past the tile,
  // which stay inside the block's shared memory (the other tile or the
  // pending lists) and are never used.
  __device__ __forceinline__ void scan_tile(const float* cur, int t0, int cnt) {
    constexpr bool PREFETCH = DIM == 3 && (Q == 2 || KB == 64);
    int g = 0;
    if constexpr (PREFETCH) {
      if (U <= cnt) {
        Cand<DIM> next[U];
        load_group<false>(next, cur, 0, cnt);
        for (; g + U <= cnt; g += U) {
          Cand<DIM> c[U];
#pragma unroll
          for (int u = 0; u < U; ++u) c[u] = next[u];
          load_group<false>(next, cur, g + U, cnt);
          if (group<false>(c, g, cnt)) make_room(cur, t0);
        }
      }
    } else {
      for (; g + U <= cnt; g += U) {
        Cand<DIM> c[U];
        load_group<false>(c, cur, g, cnt);
        if (group<false>(c, g, cnt)) make_room(cur, t0);
      }
    }
    if (g < cnt) {
      Cand<DIM> c[U];
      load_group<true>(c, cur, g, cnt);
      group<true>(c, g, cnt);
    }
    drain(cur, t0);
  }
};

// Thread t of block b owns queries b * Q * blockDim.x + qq * blockDim.x + t.
// Shared memory: two tiles of (tile, S) floats, then the pending lists.
template <int KB, int DIM, int NORM, int Q, bool CHAINED, bool CARRIED, bool COUNT>
__global__ void __launch_bounds__(kMaxThreads) knn_topk_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const int64_t* __restrict__ lengths2, const float* __restrict__ lb_d,
    const int64_t* __restrict__ lb_i, const int* __restrict__ rows,
    const int* __restrict__ cand_ids, const int* __restrict__ starts,
    unsigned long long* __restrict__ counts, const float* __restrict__ ub,
    const int* __restrict__ gate, int P1, int P2, int D, int K, int tile,
    float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  using State = Scan<KB, DIM, NORM, Q, CHAINED, CARRIED, COUNT>;
  if (gate != nullptr && *gate == 0) return;  // a repair rerun not needed
  extern __shared__ float4 smem_f4[];
  float* const stage = reinterpret_cast<float*>(smem_f4);
  const int S = stride_of(DIM, D);
  const int n = blockIdx.y;
  const int first = blockIdx.x * Q * blockDim.x + threadIdx.x;

  // Rows past P1 compute on the cloud's first query but never admit: their
  // kth is -inf. A finite seed starts the state at (seed, kSent).
  State st;
  st.pend = reinterpret_cast<int*>(stage + 2 * tile * S);
  st.D = D;
  st.S = S;
  st.groups = st.fired = st.drains = st.admitted = st.screened = 0;
#pragma unroll
  for (int qq = 0; qq < Q; ++qq) {
    const int q = first + qq * blockDim.x;
    const bool active = q < P1;
    const int64_t row = (int64_t)n * P1 + (active ? q : 0);
    const int64_t src = rows != nullptr ? (int64_t)n * P1 + rows[row] : row;
    st.qp[qq] = p1 + src * D;
#pragma unroll
    for (int d = 0; d < State::QD; ++d) {
      st.qv[qq][d] = (DIM == 3 || (DIM > 0 && d < D)) ? st.qp[qq][d] : 0.f;
    }
    const float seed = ub != nullptr && active ? ub[row] : INFINITY;
    const bool seeded = seed < INFINITY;
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      st.bd[qq][s] = active ? seed : -INFINITY;
      st.bi[qq][s] = seeded ? kSent : 0;
    }
    st.lbd[qq] = 0.f;
    st.lbi[qq] = 0;
    if (CHAINED && active) {
      st.lbd[qq] = lb_d[row];
      st.lbi[qq] = (int)lb_i[row];
    }
    st.npend[qq] = 0;
  }

  int64_t len64 = lengths2[n];
  const int len2 = (int)(len64 < 0 ? 0 : (len64 > P2 ? P2 : len64));
  const float* p2n = p2 + (int64_t)n * P2 * D;
  const int* idn = CARRIED ? cand_ids + (int64_t)n * P2 : nullptr;
  const int tiles = (len2 + tile - 1) / tile;
  // Step t scans tile (start + t) mod tiles: start is 0 but with CARRIED.
  int start = CARRIED ? starts[(int64_t)n * gridDim.x + blockIdx.x] : 0;
  if (start < 0 || start >= tiles) start = 0;
  const auto first_of = [&](int t) {
    const int r = start + t;
    return (r >= tiles ? r - tiles : r) * tile;
  };
  if (tiles > 0) {
    const int s0 = first_of(0);
    stage_tile<DIM, CARRIED>(stage, p2n + (int64_t)s0 * D,
                             CARRIED ? idn + s0 : nullptr, min(tile, len2 - s0),
                             D, S);
  }

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // step t's tile is staged; no thread still reads t-1's
    const int t0 = first_of(t);
    if (t + 1 < tiles) {
      const int t1 = first_of(t + 1);
      stage_tile<DIM, CARRIED>(stage + ((t + 1) & 1) * tile * S,
                               p2n + (int64_t)t1 * D, CARRIED ? idn + t1 : nullptr,
                               min(tile, len2 - t1), D, S);
    }
    st.scan_tile(stage + (t & 1) * tile * S, t0, min(tile, len2 - t0));
  }

  if constexpr (COUNT) {
    unsigned long long* c = counts + ((int64_t)n * gridDim.x + blockIdx.x) * 5;
    const unsigned admitted = __reduce_add_sync(0xffffffffu, st.admitted);
    const unsigned screened = __reduce_add_sync(0xffffffffu, st.screened);
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(c, (unsigned long long)st.groups);
      atomicAdd(c + 1, (unsigned long long)st.fired);
      atomicAdd(c + 2, (unsigned long long)st.drains);
      atomicAdd(c + 3, (unsigned long long)admitted);
      atomicAdd(c + 4, (unsigned long long)screened);
    }
  }

#pragma unroll
  for (int qq = 0; qq < Q; ++qq) {
    const int q = first + qq * blockDim.x;
    if (q >= P1) continue;
    const int64_t row = (int64_t)n * P1 + q;
    float* od = out_d + row * K;
    int64_t* oi = out_i + row * K;
#pragma unroll
    for (int s = 0; s < KB; ++s) {
      if (s < K) {
        od[s] = st.bd[qq][s];
        oi[s] = st.bi[qq][s];
      }
    }
  }
}

struct Args {
  const float* p1;
  const float* p2;
  const int64_t* lengths2;
  const float* lb_d;
  const int64_t* lb_i;
  const int* rows;
  const int* cand_ids;
  const int* starts;
  unsigned long long* counts;
  const float* ub;
  const int* gate;
  int N, P1, P2, D, K;
  float* out_d;
  int64_t* out_i;
  bool carried, count;  // the variant: carried (cand_ids), counting (counts)
};

// Launch one instance, or (resident != null) report how many of its blocks
// fit on one SM at this block size and tile instead.
template <int KB, int DIM, int NORM, int Q, bool CHAINED, bool CARRIED, bool COUNT>
cudaError_t run(const Args& a, int threads, int tile, cudaStream_t stream,
                int* resident) {
  auto kernel = knn_topk_kernel<KB, DIM, NORM, Q, CHAINED, CARRIED, COUNT>;
  using State = Scan<KB, DIM, NORM, Q, CHAINED, CARRIED, COUNT>;
  const size_t smem = (2 * (size_t)tile * stride_of(DIM, a.D) +
                       (size_t)Q * State::C * threads) * sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (resident != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         threads, smem);
  }
  const dim3 grid((a.P1 + Q * threads - 1) / (Q * threads), a.N);
  kernel<<<grid, threads, smem, stream>>>(
      a.p1, a.p2, a.lengths2, a.lb_d, a.lb_i, a.rows, a.cand_ids, a.starts,
      a.counts, a.ub, a.gate, a.P1, a.P2, a.D, a.K, tile, a.out_d, a.out_i);
  return cudaGetLastError();
}

// The carried (candidate-sorted) and counting variants exist only where
// chip_smoke.py and tune_knn.py drive them (kernels/knn.py
// _carried_instance, _counted_instance): the H100 measured candidate
// sorting slower at every shape (PERF.md), so no auto gate takes it. Both
// at D = 3 for K buckets of 8 and more, at norm 1 all but the 32-key
// bucket (the single-round 64-key instance sizes the chained rounds'
// plan); counting at norm 2, in single rounds.
template <int KB, int DIM, int NORM, int Q, bool CHAINED>
cudaError_t pick_mode(const Args& a, int threads, int tile, cudaStream_t stream,
                      int* resident) {
  constexpr bool kCarried = DIM == 3 && KB >= 8 && (NORM == 2 || KB != 32);
  constexpr bool kCount = DIM == 3 && NORM == 2 && KB >= 8 && !CHAINED;
  if (!a.count) {
    if (!a.carried) {
      return run<KB, DIM, NORM, Q, CHAINED, false, false>(a, threads, tile, stream,
                                                          resident);
    }
    if constexpr (kCarried) {
      return run<KB, DIM, NORM, Q, CHAINED, true, false>(a, threads, tile, stream,
                                                         resident);
    }
  } else if constexpr (kCount) {
    return a.carried
               ? run<KB, DIM, NORM, Q, CHAINED, true, true>(a, threads, tile,
                                                            stream, resident)
               : run<KB, DIM, NORM, Q, CHAINED, false, true>(a, threads, tile,
                                                             stream, resident);
  }
  return cudaErrorNotSupported;
}

// Q per K bucket: the top-K state is 2 * KB registers a query; Q = 2 up to
// KB = 16 (Q = 4, and Q = 2 at KB = 32, measured slower on the H100 at every
// shape of tune_knn.py); the generic-D path takes Q = 1. Chained rounds are
// 64-key.
template <int KB, int DIM, int NORM>
cudaError_t pick_q(const Args& a, int q, int threads, int tile,
                   cudaStream_t stream, int* resident) {
  if (a.lb_d != nullptr) {
    if constexpr (KB == 64) {
      if (q == 1) return pick_mode<64, DIM, NORM, 1, true>(a, threads, tile, stream,
                                                           resident);
    }
    return cudaErrorInvalidValue;
  }
  if (q == 1) return pick_mode<KB, DIM, NORM, 1, false>(a, threads, tile, stream,
                                                        resident);
  if constexpr (DIM > 0 && KB <= 16) {
    if (q == 2) return pick_mode<KB, DIM, NORM, 2, false>(a, threads, tile, stream,
                                                          resident);
  }
  return cudaErrorInvalidValue;
}

template <int KB, int NORM>
cudaError_t pick_dim(const Args& a, int q, int threads, int tile,
                     cudaStream_t stream, int* resident) {
  if (a.D == 3) return pick_q<KB, 3, NORM>(a, q, threads, tile, stream, resident);
  if (a.D <= 8) return pick_q<KB, 8, NORM>(a, q, threads, tile, stream, resident);
  return pick_q<KB, 0, NORM>(a, q, threads, tile, stream, resident);
}

template <int NORM>
cudaError_t pick_k(const Args& a, int q, int threads, int tile,
                   cudaStream_t stream, int* resident) {
#define KNN_BUCKET(KB) \
  if (a.K <= KB) return pick_dim<KB, NORM>(a, q, threads, tile, stream, resident);
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

cudaError_t dispatch(const Args& a, int norm, int q, int threads, int tile,
                     cudaStream_t stream, int* resident) {
  if (a.D < 1 || a.K < 1 || a.K > 64 || a.N > 65535 || tile < 1 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  if (norm == 2) return pick_k<2>(a, q, threads, tile, stream, resident);
  if (norm == 1) return pick_k<1>(a, q, threads, tile, stream, resident);
  return cudaErrorInvalidValue;
}

}  // namespace

// p1 (N, P1, D), p2 (N, P2, D) float32; lengths2 (N,) int64; lb_d/lb_i
// (N, P1) or null (then K <= 64, else K == 64 and q == 1); rows (N, P1)
// int32, a permutation of each cloud's rows (the order the kernel takes the
// queries of p1 in; lb and outputs are in that order), or null; cand_ids
// (N, P2)
// int32 original indices and starts (N, blocks) int32 start tiles, or both
// null (p2 in index order); counts (N, blocks, 5) uint64 zeroed, or null;
// ub (N, P1) float32 seeds in the kernel's query order, or null (unseeded);
// gate one int32 on the device, or null: while it is 0 the launch does
// nothing; out_d/out_i (N, P1, K) with 1 <= K <= 64. q queries a thread, threads a
// block (a multiple of 32, at most 256), tile candidates a staged tile;
// blocks = ceil(P1 / (q * threads)). Returns the launch's cudaError_t.
extern "C" int knn_topk(const float* p1, const float* p2,
                        const int64_t* lengths2, const float* lb_d,
                        const int64_t* lb_i, const int* rows,
                        const int* cand_ids, const int* starts,
                        unsigned long long* counts, const float* ub,
                        const int* gate, int N,
                        int P1, int P2, int D, int K, int norm, int q,
                        int threads, int tile, float* out_d, int64_t* out_i,
                        void* stream) {
  if (N <= 0 || P1 <= 0) return cudaSuccess;
  if ((cand_ids == nullptr) != (starts == nullptr)) return cudaErrorInvalidValue;
  const Args a{p1, p2, lengths2, lb_d, lb_i, rows, cand_ids, starts, counts,
               ub, gate, N, P1, P2, D, K, out_d, out_i, cand_ids != nullptr,
               counts != nullptr};
  return dispatch(a, norm, q, threads, tile, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// How many blocks of the (K, D, norm, q, carried, count) instance fit on
// one SM of the current device at this block size and tile (0 if none).
// Returns a cudaError_t.
extern "C" int knn_resident_blocks(int K, int D, int norm, int q, int threads,
                                   int tile, int carried, int count,
                                   int* blocks) {
  *blocks = 0;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, nullptr, nullptr, 1, 1, 1, D, K, nullptr,
               nullptr, carried != 0, count != 0};
  return dispatch(a, norm, q, threads, tile, nullptr, blocks);
}

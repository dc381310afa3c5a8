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
// the rounds concatenate to the global order. The chained rounds run only
// unseeded and as the repair of a seeded call: a seeded call of more than one
// round takes the screen and the select below instead.
//
// Query sorting (ports knn_pallas.py's sort_queries): the wrapper may pass
// rows, the queries in Morton order; the kernel's query q of cloud n is then
// row rows[n * P1 + q] of p1 (read where it lies, no copy), while lb_d/lb_i
// and the outputs stay in the kernel's order, which the wrapper undoes. A
// warp's and a block's queries are neighbours, so their votes fire
// together.
//
// Seeding (ports knn_pallas.py's seeded kernel): the wrapper may pass ub,
// one seed a query in the kernel's query order, the next float above a
// sampled upper bound on its kth distance. The state then starts as K
// entries (seed, kSent) instead of (inf, 0), so the vote screens at the
// bound from the first tile and a query inserts only the candidates below
// it. The rules above hold unchanged: a candidate equal to the seed sorts
// after the seed entries (v > d): a superset admission into an exact
// insert. A kSent left in a slot the cloud could have filled means the
// bound was too tight; the
// wrapper detects that on the device and reruns the round unseeded, gated
// on per-query flags (gate: a block none of whose queries is flagged returns
// at once; the single-round repair flags every query or none). A seed of
// +inf is no seed: that query starts at (inf, 0). ub and gate are read once
// a block, so the instances are those of the unseeded kernel. Seeding runs
// single rounds only where a caller opts in (ub=, sample_bound=True).
//
// Screen and select (seeded calls of more than one round, e.g. K=100): the
// 64-key state takes ~240 registers, holds an SM to 8 warps and one query a
// thread, and the chained rounds compute every distance once a round. With
// one seed a query (the bound of the call's last quantile), no sorted state
// is needed: knn_screen_kernel scans every candidate once (the same staging
// and distance helpers; two queries a thread at under 128 registers) and
// appends each candidate below its query's seed to a list in device memory
// as one 64-bit key, (float bits of d) << 32 | j, whose unsigned order is
// (value, index) order; knn_select_kernel, a warp a query, reads the K
// smallest keys off the list (a radix select, then a bitonic sort) into the
// rounds' outputs. A query whose list may lack one of its K nearest (fewer
// entries than min(K, lengths2), more than the list holds, no finite seed) is
// flagged, and the chained rounds rerun for the flagged queries' blocks into
// the same outputs. Every path gives the unseeded result bit for bit. The
// two replace no TPU kernel (the TPU side chains seeded rounds,
// _knn_forward_pallas_bigk): on the H100 the rounds' state, not their
// distances, set the pace. The screen is bound by instruction issue like the
// rounds; its vote takes a fused distance (vote_distance: 6 operations a pair
// at D=3, not 8) against a slightly widened seed, and the exact distance
// decides each candidate that passes. The select is bound by its reads of
// the lists (about 490 keys a query at the north star).
//
// The screen's skip (D = 3): a query lists about 490 of 100,000 candidates
// at the north star, so a scan of all of them computes ~99.5 % of its
// distances for nothing. knn_screen_order_kernel (one launch, a cluster of
// blocks a cloud) sorts the cloud's valid rows by a coarse Morton cell code
// (a stable radix sort: the order is deterministic), writes the sorted
// points, each with its original index in its fourth float (so every key
// still holds an original index) and one bounding box per kSegment = 128 sorted
// candidates, over the segment's valid rows only (rows past lengths2 stay
// last and widen no box; a segment without one has an empty box). Each warp
// of the screen then works alone, with no block barrier: it tests the
// segments 32 at a time (a lane a segment) against the box of its queries
// and their largest seed, tests each that passes against every query, and
// scans a segment from device memory (L1/L2: 1.6 MB at 100k points) only
// if one of its queries needs it. A query needs a segment when lb < seed,
// lb the squared distance (L1: distance) from the query to the box,
// computed as `distance` computes a pair: per axis gap = max(lo - q,
// q - hi, 0) by __fsub_rn, each gap squared by __fmul_rn, summed by
// __fadd_rn in axis order. Every one of those steps rounds to nearest,
// which is monotone, so lb is at most the `distance` of every member of the
// box (and the bound from the queries' box, with ql and qh in place of q, at
// most each query's lb), and a member is listed only when its distance is
// below the seed (strict): a segment with lb >= seed holds nothing the list
// would keep. The skip is exact with no margin: each list holds the same
// keys and the same whole count as a full scan, so the select's outputs and
// the flags are bit for bit those of the full scan. The sample pass and the
// repair keep the unsorted cloud.
//
// Counting (COUNT; ports knn_pallas.py's instrument): per block, the groups
// its warps scanned, the votes that fired, the drains that had work, the
// insertions into the top-K, and the candidates that passed the screen into
// a pending list; compiled out of the production instances.
//
// Arithmetic: each axis term is rounded on its own and summed in order
// d = 0..D-1 (__fsub_rn/__fmul_rn/__fadd_rn, never contracted to FMA), so
// the distances are bit-equal to the plain PyTorch version.

#include <cooperative_groups.h>
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
// stride S. Each thread commits one group of copies.
template <int DIM>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, int cnt,
                                           int D, int S) {
  const int total = cnt * D;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int c = DIM == 3 ? e / 3 : e / D;
    cp_async_f32(dst + c * S + (e - c * (DIM == 3 ? 3 : D)), src + e);
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

// Insert (dist, j) if it is below the kth value (and, for a chained round,
// lexicographically after the previous round's last entry): behind every
// entry of equal value, since candidates arrive in ascending index and every
// entry already held has a lower index than j. Slot s takes slot s-1's entry
// when that entry's value is above dist, else the candidate when slot s held
// one above it; walking s downward reads slots not yet written. Returns
// whether it was inserted.
template <int KB, bool CHAINED>
__device__ __forceinline__ bool admit(float (&bd)[KB], int (&bi)[KB],
                                      float dist, int j, float lbd, int lbi) {
  if (!(bd[KB - 1] > dist)) return false;
  if (CHAINED && !(dist > lbd || (dist == lbd && j > lbi))) return false;
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
  return true;
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
template <int KB, int DIM, int NORM, int Q, bool CHAINED, bool COUNT>
struct Scan {
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
        hit[qq] |= d < bd[qq][KB - 1] &&
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
        if ((!TAIL || g + u < cnt) && dg[qq][u] < kth &&
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
        const bool in = admit<KB, CHAINED>(bd[qq], bi[qq],
                                           dist(qq, load_cand<DIM>(cur + c * S)),
                                           t0 + c, lbd[qq], lbi[qq]);
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
template <int KB, int DIM, int NORM, int Q, bool CHAINED, bool COUNT>
__global__ void __launch_bounds__(kMaxThreads) knn_topk_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const int64_t* __restrict__ lengths2, const float* __restrict__ lb_d,
    const int64_t* __restrict__ lb_i, const int* __restrict__ rows,
    unsigned long long* __restrict__ counts, const float* __restrict__ ub,
    const int* __restrict__ gate, int P1, int P2, int D, int K, int tile,
    float* __restrict__ out_d, int64_t* __restrict__ out_i) {
  using State = Scan<KB, DIM, NORM, Q, CHAINED, COUNT>;
  extern __shared__ float4 smem_f4[];
  float* const stage = reinterpret_cast<float*>(smem_f4);
  const int S = stride_of(DIM, D);
  const int n = blockIdx.y;
  const int first = blockIdx.x * Q * blockDim.x + threadIdx.x;
  if (gate != nullptr) {  // a repair rerun: only blocks with a flagged query
    int flagged = 0;
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      const int q = first + qq * blockDim.x;
      if (q < P1) flagged |= gate[(int64_t)n * P1 + q];
    }
    if (!__syncthreads_or(flagged)) return;
  }

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
  const int tiles = (len2 + tile - 1) / tile;
  if (tiles > 0) stage_tile<DIM>(stage, p2n, min(tile, len2), D, S);

  for (int t = 0; t < tiles; ++t) {
    cp_async_wait_all();
    __syncthreads();  // tile t is staged; no thread still reads t-1's
    const int t0 = t * tile;
    if (t + 1 < tiles) {
      const int t1 = (t + 1) * tile;
      stage_tile<DIM>(stage + ((t + 1) & 1) * tile * S, p2n + (int64_t)t1 * D,
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
  unsigned long long* counts;
  const float* ub;
  const int* gate;
  int N, P1, P2, D, K;
  float* out_d;
  int64_t* out_i;
  bool count;  // the variant: counting (counts)
};

// Launch one instance, or (resident != null) report how many of its blocks
// fit on one SM at this block size and tile instead.
template <int KB, int DIM, int NORM, int Q, bool CHAINED, bool COUNT>
cudaError_t run(const Args& a, int threads, int tile, cudaStream_t stream,
                int* resident) {
  auto kernel = knn_topk_kernel<KB, DIM, NORM, Q, CHAINED, COUNT>;
  using State = Scan<KB, DIM, NORM, Q, CHAINED, COUNT>;
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
      a.p1, a.p2, a.lengths2, a.lb_d, a.lb_i, a.rows, a.counts, a.ub, a.gate,
      a.P1, a.P2, a.D, a.K, tile, a.out_d, a.out_i);
  return cudaGetLastError();
}

// The counting variant exists only where chip_smoke.py and tune_knn.py
// drive it (kernels/knn.py _counted_instance): D = 3, norm 2, K buckets of 8
// and more, in single rounds.
template <int KB, int DIM, int NORM, int Q, bool CHAINED>
cudaError_t pick_mode(const Args& a, int threads, int tile, cudaStream_t stream,
                      int* resident) {
  constexpr bool kCount = DIM == 3 && NORM == 2 && KB >= 8 && !CHAINED;
  if (!a.count) {
    return run<KB, DIM, NORM, Q, CHAINED, false>(a, threads, tile, stream, resident);
  }
  if constexpr (kCount) {
    return run<KB, DIM, NORM, Q, CHAINED, true>(a, threads, tile, stream, resident);
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

// ---- Screen and select: seeded calls of more than one round ----

// The rounds' width: the select writes slot s of a query into round s / 64.
constexpr int kRoundK = 64;

// The screen's vote distance: the terms of `distance`, each square after the
// first accumulated by one fused multiply-add (at D=3, 6 operations a pair
// instead of 8). All terms are >= 0, so it and `distance` each lie within a
// factor (1 + 2^-24)^D of the exact sum, and below the normal range within
// D * 2^-149 of it; a vote against the seed widened by D * 2^-20 of itself
// therefore passes every candidate that `distance` puts below the seed. L1
// needs no product: it is `distance` itself.
template <int DIM, int NORM>
__device__ __forceinline__ float vote_distance(const float* q, const Cand<DIM>& c,
                                               int D) {
  if constexpr (NORM == 1) {
    return distance<DIM, NORM>(q, c, D);
  } else if constexpr (DIM == 0) {
    float diff = __fsub_rn(q[0], c.p[0]);
    float d = __fmul_rn(diff, diff);
    for (int k = 1; k < D; ++k) {
      diff = __fsub_rn(q[k], c.p[k]);
      d = __fmaf_rn(diff, diff, d);
    }
    return d;
  } else {
    float diff = __fsub_rn(q[0], c.v[0]);
    float d = __fmul_rn(diff, diff);
#pragma unroll
    for (int k = 1; k < DIM; ++k) {
      if (DIM == 3 || k < D) {
        diff = __fsub_rn(q[k], c.v[k]);
        d = __fmaf_rn(diff, diff, d);
      }
    }
    return d;
  }
}

// The screen's segments: candidates a bounding box (csrc header, "The
// screen's skip").
constexpr int kSegment = 128;

// One axis of the bound on a segment: the gap from [ql, qh] to [lo, hi],
// squared at L2, with the rounding steps of axis_term.
template <int NORM>
__device__ __forceinline__ float gap_term(float ql, float qh, float lo, float hi) {
  const float g = fmaxf(fmaxf(__fsub_rn(lo, qh), __fsub_rn(ql, hi)), 0.f);
  return NORM == 2 ? __fmul_rn(g, g) : g;
}

// The bound on the D=3 `distance` from every point of the box [ql, qh] to
// every candidate of the box [lo, hi] (for a query, ql = qh = q:
// kernels/knn.py segment_bound): the gaps' terms summed in axis order. Each
// step rounds to nearest, which is monotone, so a box of queries bounds
// each of its queries' bounds from below. Never NaN: fmaxf returns 0 for a
// NaN gap.
template <int NORM>
__device__ __forceinline__ float box_distance(const float* ql, const float* qh,
                                              const float4& lo, const float4& hi) {
  float d = gap_term<NORM>(ql[0], qh[0], lo.x, hi.x);
  d = __fadd_rn(d, gap_term<NORM>(ql[1], qh[1], lo.y, hi.y));
  return __fadd_rn(d, gap_term<NORM>(ql[2], qh[2], lo.z, hi.z));
}

// One thread's queries of the screen and the scan of one staged tile: no
// top-K state, only each query's seed, list and count. A group of U = 16/Q
// candidates computes its Q*U vote distances and one minimum a query against
// the widened seed; one __any_sync decides whether the warp looks further.
// Then each query with a hit marks those candidates in a bit mask and, one
// loop turn a candidate, computes `distance` again from the staged tile and
// appends the candidate if that is below its seed (strict): the keys hold
// the exact distances, and a lane pays for its own candidates, not for U
// predicated ones a query. EXACT (the skip's segments, D = 3): candidates
// in the screen's order lie close together, so a lane near a group has many
// of them below its seed; the vote takes `distance` itself against the seed
// and the U appends are unrolled and predicated, with no second load and no
// loop a candidate (each candidate's original index rides in its fourth
// float). A list keeps at most cap keys; its count is kept whole.
template <int DIM, int NORM, int Q>
struct Screen {
  static constexpr int U = kGroupSlots / Q;  // candidates a group
  static constexpr int QD = DIM > 0 ? DIM : 1;

  float qv[Q][QD];
  const float* qp[Q];
  float seed[Q];  // -inf: nothing to list (an inactive row, or no finite seed)
  float wide[Q];  // the vote's bound: seed widened by D * 2^-20 of itself
  int cnt[Q];
  unsigned long long* list[Q];
  const float4* box;  // the cloud's segment boxes (lo, hi), or null: no skip
  int* shared_cnt;    // the skip: the block's counts, query qq of lane l at 32 qq + l
  unsigned long long* pend;  // the skip: this warp's pending keys, (Q, kPend, 32)
  int npend[Q], head[Q];     // the skip: pending keys a query, the first one's slot
  int D, S, cap;
  unsigned scanned, skipped;  // this warp's segments scanned and skipped

  __device__ __forceinline__ float dist(int qq, const Cand<DIM>& c) const {
    return distance<DIM, NORM>(DIM > 0 ? qv[qq] : qp[qq], c, D);
  }

  __device__ __forceinline__ float vote_dist(int qq, const Cand<DIM>& c) const {
    return vote_distance<DIM, NORM>(DIM > 0 ? qv[qq] : qp[qq], c, D);
  }

  template <bool TAIL>
  __device__ __forceinline__ void load_group(Cand<DIM> (&c)[U], const float* cur,
                                             int g, int cnt_tile) const {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      c[u] = load_cand<DIM>(cur + (TAIL ? min(g + u, cnt_tile - 1) : g + u) * S);
    }
  }

  // The key of the candidate of original index j at distance d, at place
  // `at` of the list: distances are never negative or -0, so unsigned key
  // order is (value, index) order.
  __device__ __forceinline__ void put(int qq, int at, float d, unsigned j) {
    if (at < cap) list[qq][at] = (unsigned long long)__float_as_uint(d) << 32 | j;
  }

  template <bool TAIL, bool EXACT>
  __device__ __forceinline__ void group(const Cand<DIM> (&c)[U], const float* cur,
                                        int t0, int g, int cnt_tile) {
    float dg[Q][U];
    float lo[Q];
#pragma unroll
    for (int u = 0; u < U; ++u) {
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        dg[qq][u] = EXACT ? dist(qq, c[u]) : vote_dist(qq, c[u]);
        lo[qq] = u == 0 ? dg[qq][0] : fminf(lo[qq], dg[qq][u]);
      }
    }
    bool hit[Q];
    bool any = false;
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      hit[qq] = lo[qq] < (EXACT ? seed[qq] : wide[qq]);
      any |= hit[qq];
    }
    if (!__any_sync(0xffffffffu, any)) return;
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      if (!hit[qq]) continue;
      if constexpr (EXACT && DIM == 3) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if ((!TAIL || g + u < cnt_tile) && dg[qq][u] < seed[qq]) {
            pend_slot(qq, npend[qq]++) =
                (unsigned long long)__float_as_uint(dg[qq][u]) << 32 |
                __float_as_uint(c[u].v[3]);
          }
          if (u % 4 == 3 && npend[qq] >= 4) flush4(qq);  // at most 3 + 4 pending
        }
      } else {
        unsigned near = 0;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if ((!TAIL || g + u < cnt_tile) && dg[qq][u] < wide[qq]) near |= 1u << u;
        }
        while (near != 0) {
          const int u = __ffs(near) - 1;
          near &= near - 1;
          const float d = dist(qq, load_cand<DIM>(cur + (g + u) * S));
          if (d < seed[qq]) put(qq, cnt[qq]++, d, t0 + g + u);
        }
      }
    }
  }

  // The skip's appends: the block's warps share the queries, so a list's
  // places come from the block's count (the list's order then varies from
  // run to run; the select reads it as a set). A lane keeps its keys pending
  // in shared memory and writes them 4 at a time, 32 aligned bytes (one
  // sector) by two 16-byte stores: while the block scans, its counts grow
  // by 4 only, so every such place is a multiple of 4, and the lists start
  // at multiples of 256 keys (screen_cap; another cap takes single stores
  // where the place is not 16-byte aligned). flush_rest writes the last 1-3
  // keys a query once every warp of the block is done.
  static constexpr int kPend = 8;
  __device__ __forceinline__ unsigned long long& pend_slot(int qq, int k) {
    return pend[(qq * kPend + ((head[qq] + k) & (kPend - 1))) * 32 + (threadIdx.x & 31)];
  }
  __device__ __forceinline__ void flush4(int qq) {
    const int at = atomicAdd(shared_cnt + qq * 32 + (threadIdx.x & 31), 4);
    const ulonglong2 a = make_ulonglong2(pend_slot(qq, 0), pend_slot(qq, 1));
    const ulonglong2 b = make_ulonglong2(pend_slot(qq, 2), pend_slot(qq, 3));
    if (at + 4 <= cap && (reinterpret_cast<uintptr_t>(list[qq] + at) & 15) == 0) {
      reinterpret_cast<ulonglong2*>(list[qq] + at)[0] = a;
      reinterpret_cast<ulonglong2*>(list[qq] + at)[1] = b;
    } else {
      if (at < cap) list[qq][at] = a.x;
      if (at + 1 < cap) list[qq][at + 1] = a.y;
      if (at + 2 < cap) list[qq][at + 2] = b.x;
      if (at + 3 < cap) list[qq][at + 3] = b.y;
    }
    head[qq] = (head[qq] + 4) & (kPend - 1);
    npend[qq] -= 4;
  }
  __device__ __forceinline__ void flush_rest() {
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      const int at = atomicAdd(shared_cnt + qq * 32 + (threadIdx.x & 31), npend[qq]);
      for (int k = 0; k < npend[qq]; ++k) {
        if (at + k < cap) list[qq][at + k] = pend_slot(qq, k);
      }
      npend[qq] = 0;
    }
  }

  // Positions [g, end) of cur (g a multiple of U): a staged tile's, or a
  // segment's of the screen's order. D=3, Q >= 2: the next group is loaded
  // while this one is computed, into two buffers taken in turn (no register
  // copies); a load reads up to U candidates past end, into the rest of the
  // tile or segments, the padding that the launch adds behind the second
  // tile or the rows that screen_order_cuda adds behind the last cloud, and
  // never uses them.
  template <bool EXACT>
  __device__ __forceinline__ void scan_range(const float* cur, int t0, int g, int end) {
    if constexpr (DIM == 3 && Q >= 2) {
      Cand<DIM> a[U], b[U];
      if (g + U <= end) load_group<false>(a, cur, g, end);
      for (; g + 2 * U <= end; g += 2 * U) {
        load_group<false>(b, cur, g + U, end);
        group<false, EXACT>(a, cur, t0, g, end);
        load_group<false>(a, cur, g + 2 * U, end);
        group<false, EXACT>(b, cur, t0, g + U, end);
      }
      if (g + U <= end) {
        group<false, EXACT>(a, cur, t0, g, end);
        g += U;
      }
    } else {
      for (; g + U <= end; g += U) {
        Cand<DIM> c[U];
        load_group<false>(c, cur, g, end);
        group<false, EXACT>(c, cur, t0, g, end);
      }
    }
    if (g < end) {
      Cand<DIM> c[U];
      load_group<true>(c, cur, g, end);
      group<true, EXACT>(c, cur, t0, g, end);
    }
  }

  // The skip (D = 3), over the first len2 candidates of the cloud in the
  // screen's order (pts: x, y, z and the original index's bits, read where
  // they lie); every warp of the block holds the same queries. 32 segments
  // at a time, each lane tests one against the box of the queries with a
  // seed and their largest seed (every warp the same); the segments that
  // pass are dealt round the warps, and each warp tests its own against
  // every query's bound and seed and scans it if one of them needs it. No
  // block barrier: a warp waits for no other.
  __device__ __forceinline__ void scan_segments(const float* pts, int len2) {
    if constexpr (DIM == 3) {
      const int lane = threadIdx.x & 31;
      const int warp = threadIdx.x >> 5;
      const int warps = blockDim.x >> 5;
      float ql[3] = {INFINITY, INFINITY, INFINITY};
      float qh[3] = {-INFINITY, -INFINITY, -INFINITY};
      float top = -INFINITY;
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        if (seed[qq] > -INFINITY) {
          for (int a = 0; a < 3; ++a) {
            ql[a] = fminf(ql[a], qv[qq][a]);
            qh[a] = fmaxf(qh[a], qv[qq][a]);
          }
          top = fmaxf(top, seed[qq]);
        }
      }
      for (int o = 16; o > 0; o >>= 1) {
        for (int a = 0; a < 3; ++a) {
          ql[a] = fminf(ql[a], __shfl_xor_sync(0xffffffffu, ql[a], o));
          qh[a] = fmaxf(qh[a], __shfl_xor_sync(0xffffffffu, qh[a], o));
        }
        top = fmaxf(top, __shfl_xor_sync(0xffffffffu, top, o));
      }
      const int nseg = (len2 + kSegment - 1) / kSegment;
      int turn = 0;  // the warp whose turn the next segment that passes is
      for (int s0 = 0; s0 < nseg; s0 += 32) {
        bool near = false;
        if (s0 + lane < nseg) {
          const float4 lo = __ldg(box + 2 * (s0 + lane));
          const float4 hi = __ldg(box + 2 * (s0 + lane) + 1);
          near = box_distance<NORM>(ql, qh, lo, hi) < top;
        }
        unsigned segs = __ballot_sync(0xffffffffu, near);
        if (warp == 0) skipped += min(32, nseg - s0) - __popc(segs);
        for (; segs != 0; segs &= segs - 1) {
          const bool mine = turn == warp;
          turn = turn + 1 == warps ? 0 : turn + 1;
          if (!mine) continue;
          const int s = s0 + __ffs(segs) - 1;
          const float4 lo = __ldg(box + 2 * s);
          const float4 hi = __ldg(box + 2 * s + 1);
          bool need = false;
#pragma unroll
          for (int qq = 0; qq < Q; ++qq) {
            need |= box_distance<NORM>(qv[qq], qv[qq], lo, hi) < seed[qq];
          }
          if (!__any_sync(0xffffffffu, need)) {
            ++skipped;
            continue;
          }
          ++scanned;
          scan_range<true>(pts, 0, s * kSegment, min((s + 1) * kSegment, len2));
        }
      }
    }
  }
};

// The screen over queries [q0, q0 + nq) of every cloud (kernel order): thread
// t of block b owns chunk queries b * Q * blockDim.x + qq * blockDim.x + t.
// Each candidate at a distance below its query's seed (strict) is appended
// to the query's list, lists + (n * nq + query) * cap, as one key; counts
// (N, nq) gets each query's whole count. A block none of whose queries has a
// finite seed scans nothing (the select flags them). boxes (N, ceil(P2 /
// kSegment), 8) or null: p2 is the screen's order (N, P2, 4), lane l of
// every warp of block b holds the chunk queries
// b * 32 * Q + 32 * qq + l (consecutive in the queries' order, so the skip
// tests are coherent), and each warp scans, from device memory, its share of
// the segments one of them needs (csrc header, "The screen's skip");
// seg_counts (N, blocks, 2) or null: each block adds the segments it scanned
// and skipped. Shared memory: two tiles of (tile, S) floats and U candidates
// of padding; with boxes, each warp's pending keys (Q, 8, 32).
template <int DIM, int NORM, int Q>
__global__ void __launch_bounds__(kMaxThreads, 2) knn_screen_kernel(
    const float* __restrict__ p1, const float* __restrict__ p2,
    const int64_t* __restrict__ lengths2, const int* __restrict__ rows,
    const float* __restrict__ seeds, const float* __restrict__ boxes, int P1,
    int P2, int D, int q0, int nq,
    int cap, int tile, unsigned long long* __restrict__ lists,
    int* __restrict__ counts, unsigned long long* __restrict__ seg_counts) {
  extern __shared__ float4 smem_f4[];
  float* const stage = reinterpret_cast<float*>(smem_f4);
  const int S = stride_of(DIM, D);
  const int n = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const bool skip = DIM == 3 && boxes != nullptr;
  const int first =
      skip ? blockIdx.x * 32 * Q + lane : blockIdx.x * Q * blockDim.x + threadIdx.x;
  const int step = skip ? 32 : blockDim.x;  // from a thread's query qq to qq + 1

  Screen<DIM, NORM, Q> st;
  st.D = D;
  st.S = S;
  st.cap = cap;
  st.box = skip ? reinterpret_cast<const float4*>(boxes) +
                      (int64_t)n * ((P2 + kSegment - 1) / kSegment) * 2
                : nullptr;
  st.scanned = st.skipped = 0;
  int seeded = 0;
#pragma unroll
  for (int qq = 0; qq < Q; ++qq) {
    const int lq = first + qq * step;
    const bool active = lq < nq;
    const int64_t row = (int64_t)n * P1 + q0 + (active ? lq : 0);
    const int64_t src = rows != nullptr ? (int64_t)n * P1 + rows[row] : row;
    st.qp[qq] = p1 + src * D;
#pragma unroll
    for (int d = 0; d < Screen<DIM, NORM, Q>::QD; ++d) {
      st.qv[qq][d] = (DIM == 3 || (DIM > 0 && d < D)) ? st.qp[qq][d] : 0.f;
    }
    const float seed = active ? seeds[row] : -INFINITY;
    st.seed[qq] = seed < INFINITY ? seed : -INFINITY;  // +inf or NaN: no seed
    st.wide[qq] = __fmul_ru(st.seed[qq], 1.0f + D * 0x1p-20f);
    seeded |= st.seed[qq] > -INFINITY;
    st.cnt[qq] = 0;
    st.list[qq] = lists + ((int64_t)n * nq + (active ? lq : 0)) * cap;
  }

  const int64_t len64 = lengths2[n];
  const int len2 = (int)(len64 < 0 ? 0 : (len64 > P2 ? P2 : len64));
  const float* p2n = p2 + (int64_t)n * P2 * D;
  if (skip) {
    __shared__ int shared_cnt[32 * Q];
    for (int e = threadIdx.x; e < 32 * Q; e += blockDim.x) shared_cnt[e] = 0;
    __syncthreads();
    st.shared_cnt = shared_cnt;
    st.pend = reinterpret_cast<unsigned long long*>(smem_f4) +
              (threadIdx.x >> 5) * Q * Screen<DIM, NORM, Q>::kPend * 32;
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) st.npend[qq] = st.head[qq] = 0;
    st.scan_segments(p2 + (int64_t)n * P2 * 4, len2);
    __syncthreads();  // every warp's 4-key writes are placed
    st.flush_rest();
    __syncthreads();  // every append is counted
    if (threadIdx.x < 32) {
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) st.cnt[qq] = shared_cnt[qq * 32 + lane];
    }
  } else {
    const int tiles = __syncthreads_or(seeded) ? (len2 + tile - 1) / tile : 0;
    if (tiles > 0) {
      stage_tile<DIM>(stage, p2n, min(tile, len2), D, S);
    }
    for (int t = 0; t < tiles; ++t) {
      cp_async_wait_all();
      __syncthreads();  // tile t is staged; no thread still reads t-1's
      const int t0 = t * tile;
      if (t + 1 < tiles) {
        stage_tile<DIM>(stage + ((t + 1) & 1) * tile * S,
                        p2n + (int64_t)(t0 + tile) * D, min(tile, len2 - t0 - tile),
                        D, S);
      }
      st.template scan_range<false>(stage + (t & 1) * tile * S, t0, 0,
                                    min(tile, len2 - t0));
    }
  }

  if (!skip || threadIdx.x < 32) {
#pragma unroll
    for (int qq = 0; qq < Q; ++qq) {
      const int lq = first + qq * step;
      if (lq < nq) counts[(int64_t)n * nq + lq] = st.cnt[qq];
    }
  }
  if (seg_counts != nullptr && lane == 0) {
    unsigned long long* c = seg_counts + ((int64_t)n * gridDim.x + blockIdx.x) * 2;
    atomicAdd(c, (unsigned long long)st.scanned);
    atomicAdd(c + 1, (unsigned long long)st.skipped);
  }
}

// The select: one warp a query of the chunk. The query is flagged for the
// repair (flags (N, P1), kernel order) when its seed is not finite, its count
// is below min(K, lengths2) (the seed was too tight) or above cap (the list
// lost entries); else its kept = min(K, count) smallest keys are exactly its
// top-K. They are found by a radix select on the list in device memory (8
// bits a pass from the top, until every key of the chosen bin is kept; the
// passes after the first read it from the caches), gathered in list order
// into shared memory, sorted there by a bitonic network of the next power of
// two at or above kept keys, and written as (value, index) to slot s of
// round s / 64 of the outputs (R, N, P1, 64); slots kept..K-1 take (inf, 0).
// Shared memory a warp: buf >= kept keys and a 256-bin histogram. (Copying
// the list into shared memory first was slower on the H100: 0.91 against
// 0.57 ms at the north star, the copy's 12 KB a warp cutting the resident
// warps 4x. Of the 0.59 ms, reading the lists and writing the outputs took
// 0.19, the radix passes 0.12 and the sort about 0.2; starting the passes
// below the keys' common leading bits saved nothing.)
__global__ void __launch_bounds__(kMaxThreads) knn_select_kernel(
    const unsigned long long* __restrict__ lists, const int* __restrict__ counts,
    const int64_t* __restrict__ lengths2, const float* __restrict__ seeds, int P1,
    int P2, int q0, int nq, int cap, int K, int buf, float* __restrict__ out_d,
    int64_t* __restrict__ out_i, int* __restrict__ flags) {
  extern __shared__ unsigned long long smem_u64[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int lq = blockIdx.x * (blockDim.x >> 5) + warp;
  if (lq >= nq) return;
  const int n = blockIdx.y;
  unsigned long long* const keys = smem_u64 + (size_t)warp * (buf + 128);
  unsigned* const hist = reinterpret_cast<unsigned*>(keys + buf);
  const int64_t row = (int64_t)n * P1 + q0 + lq;
  const int64_t lrow = (int64_t)n * nq + lq;
  const int count = counts[lrow];
  const int64_t len64 = lengths2[n];
  const int len2 = (int)(len64 < 0 ? 0 : (len64 > P2 ? P2 : len64));
  const bool flagged =
      !(seeds[row] < INFINITY) || count < min(K, len2) || count > cap;
  if (lane == 0) flags[row] = flagged ? 1 : 0;
  if (flagged) return;
  const unsigned long long* const list = lists + lrow * cap;
  const int kept = min(K, count);

  // Keys kept: (key >> shift) <= limit; every key while count <= K.
  int shift = 64;
  unsigned long long prefix = 0;
  if (count > kept) {
    unsigned need = kept;  // the rank sought among keys matching the prefix
    while (shift > 0) {
      shift -= 8;
      const unsigned long long above = shift == 56 ? 0ull : ~0ull << (shift + 8);
      for (int b = lane; b < 256; b += 32) hist[b] = 0;
      __syncwarp();
      for (int e = lane; e < count; e += 32) {
        const unsigned long long k = list[e];
        if ((k & above) == prefix) atomicAdd(&hist[(unsigned)(k >> shift) & 255u], 1u);
      }
      __syncwarp();
      unsigned h[8];
      unsigned sum = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        h[t] = hist[lane * 8 + t];
        sum += h[t];
      }
      unsigned incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int owner = __ffs(__ballot_sync(0xffffffffu, incl >= need)) - 1;
      unsigned before = incl - sum, in_bin = 0;
      int bin = 0;
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        if (in_bin == 0) {
          if (before + h[t] >= need) {
            bin = lane * 8 + t;
            in_bin = h[t];
          } else {
            before += h[t];
          }
        }
      }
      bin = __shfl_sync(0xffffffffu, bin, owner);
      before = __shfl_sync(0xffffffffu, before, owner);
      in_bin = __shfl_sync(0xffffffffu, in_bin, owner);
      need -= before;
      prefix |= (unsigned long long)bin << shift;
      __syncwarp();  // every lane has read the histogram before the next clear
      if (in_bin == need) break;
    }
  }
  const unsigned long long limit = shift < 64 ? prefix >> shift : 0;
  int at = 0;
  for (int base = 0; base < count && at < kept; base += 32) {
    const int e = base + lane;
    const unsigned long long k = e < count ? list[e] : 0;
    const bool keep = e < count && (shift == 64 || (k >> shift) <= limit);
    const unsigned m = __ballot_sync(0xffffffffu, keep);
    if (keep) keys[at + __popc(m & ((1u << lane) - 1u))] = k;
    at += __popc(m);
  }
  int size = 1;
  while (size < kept) size <<= 1;
  for (int e = kept + lane; e < size; e += 32) keys[e] = ~0ull;
  __syncwarp();
  for (int block = 2; block <= size; block <<= 1) {
    for (int stride = block >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < size / 2; t += 32) {
        const int lo = (t / stride) * 2 * stride + (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long a = keys[lo], b = keys[hi];
        if ((a > b) == ((lo & block) == 0)) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
      __syncwarp();
    }
  }
  const int64_t round = (int64_t)gridDim.y * P1 * kRoundK;
  for (int s = lane; s < K; s += 32) {
    const int64_t o = (s / kRoundK) * round + row * kRoundK + s % kRoundK;
    if (s < kept) {
      const unsigned long long k = keys[s];
      out_d[o] = __uint_as_float((unsigned)(k >> 32));
      out_i[o] = (int64_t)(unsigned)k;
    } else {
      out_d[o] = INFINITY;
      out_i[o] = 0;
    }
  }
}

struct ScreenArgs {
  const float* p1;
  const float* p2;
  const int64_t* lengths2;
  const int* rows;
  const float* seeds;
  const float* boxes;
  int N, P1, P2, D, q0, nq, cap;
  unsigned long long* lists;
  int* counts;
  unsigned long long* seg_counts;
};

template <int DIM, int NORM, int Q>
cudaError_t run_screen(const ScreenArgs& a, int threads, int tile,
                       cudaStream_t stream, int* resident) {
  auto kernel = knn_screen_kernel<DIM, NORM, Q>;
  // The skip stages no tile: its shared memory holds the pending keys.
  const size_t smem =
      a.boxes != nullptr
          ? (size_t)threads * Q * Screen<DIM, NORM, Q>::kPend * sizeof(unsigned long long)
          : (2 * (size_t)tile + Screen<DIM, NORM, Q>::U) * stride_of(DIM, a.D) *
                sizeof(float);
  if (smem > kDefaultSmem) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (resident != nullptr) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, kernel,
                                                         threads, smem);
  }
  const int per_block = a.boxes != nullptr ? 32 * Q : Q * threads;  // queries
  const dim3 grid((a.nq + per_block - 1) / per_block, a.N);
  kernel<<<grid, threads, smem, stream>>>(a.p1, a.p2, a.lengths2, a.rows, a.seeds,
                                          a.boxes, a.P1, a.P2, a.D, a.q0, a.nq, a.cap,
                                          tile, a.lists, a.counts, a.seg_counts);
  return cudaGetLastError();
}

// Q queries a thread: 1 or 2 where the queries live in registers, 1 on the
// generic-D path (Q = 4 fits without a top-K state, but measured 30-40 %
// slower than Q = 2 under every plan at the north star, tune_knn.py).
template <int DIM, int NORM>
cudaError_t screen_q(const ScreenArgs& a, int q, int threads, int tile,
                     cudaStream_t stream, int* resident) {
  if (q == 1) return run_screen<DIM, NORM, 1>(a, threads, tile, stream, resident);
  if constexpr (DIM > 0) {
    if (q == 2) return run_screen<DIM, NORM, 2>(a, threads, tile, stream, resident);
  }
  return cudaErrorInvalidValue;
}

template <int NORM>
cudaError_t screen_dim(const ScreenArgs& a, int q, int threads, int tile,
                       cudaStream_t stream, int* resident) {
  if (a.D == 3) return screen_q<3, NORM>(a, q, threads, tile, stream, resident);
  if (a.D <= 8) return screen_q<8, NORM>(a, q, threads, tile, stream, resident);
  return screen_q<0, NORM>(a, q, threads, tile, stream, resident);
}

cudaError_t screen_dispatch(const ScreenArgs& a, int norm, int q, int threads,
                            int tile, cudaStream_t stream, int* resident) {
  if (a.D < 1 || a.N > 65535 || a.cap < 1 || tile < 1 || threads < 32 ||
      threads > kMaxThreads || threads % 32 != 0) {
    return cudaErrorInvalidValue;
  }
  if (a.boxes != nullptr && a.D != 3) return cudaErrorInvalidValue;  // the skip: D = 3
  if (norm == 2) return screen_dim<2>(a, q, threads, tile, stream, resident);
  if (norm == 1) return screen_dim<1>(a, q, threads, tile, stream, resident);
  return cudaErrorInvalidValue;
}

// ---- The screen's candidate order (D = 3) ----

// A cluster of kOrderBlocks blocks sorts one cloud: kOrderThreads threads a
// block, kRadix bits a radix pass.
constexpr int kOrderBlocks = 8;
constexpr int kOrderThreads = 512;
constexpr int kOrderWarps = kOrderThreads / 32;
constexpr int kRadix = 8;
constexpr int kDigits = 1 << kRadix;

// A point's cell code on a grid of 2^bits cells a side over the box
// (lo, hi): per axis the cell floor((p - lo) / (hi - lo) * 2^bits), clamped
// to the grid (0 where the box has no extent or the ratio is NaN), its bits
// interleaved x, y, z from the lowest (kernels/knn.py screen_order_plain).
__device__ __forceinline__ unsigned cell_code(const float* p, const float* lo,
                                              const float* hi, int bits) {
  const float side = (float)(1 << bits);
  unsigned code = 0;
  for (int a = 0; a < 3; ++a) {
    const float ext = __fsub_rn(hi[a], lo[a]);
    const float frac = ext > 0.f ? __fdiv_rn(__fsub_rn(p[a], lo[a]), ext) : 0.f;
    const unsigned c =
        (unsigned)fminf(fmaxf(__fmul_rn(frac, side), 0.f), __fsub_rn(side, 1.f));
    for (int b = 0; b < bits; ++b) code |= ((c >> b) & 1u) << (3 * b + a);
  }
  return code;
}

// The screen's order of one cloud (a cluster a cloud, blockIdx.y = n): its
// valid rows sorted by cell code on the box of the valid rows, ties in row
// order (a stable LSD radix sort of the keys code << 32 | row, kRadix bits a
// pass; each block takes a contiguous share of the rows, each warp of that,
// and a pass ranks a warp's rows 32 at a time by __match_any_sync, so the
// places follow (digit, block, warp, row)); rows past lengths2 stay where
// they are, after them. Writes out_p (N, P2, 4) the points in that order,
// each as x, y, z and the bits of its original index (the screen reads a
// candidate and its index as one float4), and
// boxes (N, ceil(P2 / kSegment), 8): each segment's lo (3), 0, hi (3), 0
// over its valid rows (+inf / -inf where it has none; NaN coordinates
// ignored). keys (2, N, P2): scratch. Blocks exchange counts through
// distributed shared memory and keys through global memory, read after a
// cluster barrier with __ldcg (L2, never a stale L1 line).
__global__ void __cluster_dims__(kOrderBlocks, 1, 1) __launch_bounds__(kOrderThreads)
    knn_screen_order_kernel(const float* __restrict__ p2,
                            const int64_t* __restrict__ lengths2, int P2, int bits,
                            unsigned long long* __restrict__ keys,
                            float* __restrict__ out_p, float* __restrict__ boxes) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n = blockIdx.y;
  const int64_t len64 = lengths2[n];
  const int len2 = (int)(len64 < 0 ? 0 : (len64 > P2 ? P2 : len64));
  const int64_t base = (int64_t)n * P2;
  const float* pn = p2 + base * 3;
  const int per_block = (len2 + kOrderBlocks - 1) / kOrderBlocks;
  const int b0 = min(rank * per_block, len2), b1 = min(b0 + per_block, len2);
  const int per_warp = (b1 - b0 + kOrderWarps - 1) / kOrderWarps;
  const int w0 = min(b0 + warp * per_warp, b1), w1 = min(w0 + per_warp, b1);

  __shared__ float block_box[6];  // this block's lo, hi: read by the cluster
  __shared__ float warp_box[kOrderWarps][6];
  __shared__ float cloud_box[6];
  __shared__ int places[kDigits * kOrderWarps];  // [digit][warp]
  __shared__ int totals[kDigits];  // this block's rows a digit: read by the cluster
  __shared__ int starts[kDigits];

  // The box of the valid rows: each block its share, then the cluster's.
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int i = b0 + threadIdx.x; i < b1; i += kOrderThreads) {
    for (int a = 0; a < 3; ++a) {
      const float v = pn[(int64_t)i * 3 + a];
      lo[a] = fminf(lo[a], v);
      hi[a] = fmaxf(hi[a], v);
    }
  }
  for (int a = 0; a < 3; ++a) {
    for (int o = 16; o > 0; o >>= 1) {
      lo[a] = fminf(lo[a], __shfl_xor_sync(0xffffffffu, lo[a], o));
      hi[a] = fmaxf(hi[a], __shfl_xor_sync(0xffffffffu, hi[a], o));
    }
    if (lane == 0) {
      warp_box[warp][a] = lo[a];
      warp_box[warp][3 + a] = hi[a];
    }
  }
  __syncthreads();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float v = warp_box[0][a];
    for (int w = 1; w < kOrderWarps; ++w) {
      v = a < 3 ? fminf(v, warp_box[w][a]) : fmaxf(v, warp_box[w][a]);
    }
    block_box[a] = v;
  }
  cluster.sync();
  if (threadIdx.x < 6) {
    const int a = threadIdx.x;
    float v = a < 3 ? INFINITY : -INFINITY;
    for (int r = 0; r < kOrderBlocks; ++r) {
      const float b = *cluster.map_shared_rank(&block_box[a], r);
      v = a < 3 ? fminf(v, b) : fmaxf(v, b);
    }
    cloud_box[a] = v;
  }
  __syncthreads();
  float L[3], H[3];
  for (int a = 0; a < 3; ++a) {
    L[a] = cloud_box[a];
    H[a] = cloud_box[3 + a];
  }

  const int passes = (3 * bits + kRadix - 1) / kRadix;
  const int64_t stride = (int64_t)gridDim.y * P2;
  for (int pass = 0; pass < passes; ++pass) {
    const unsigned long long* src = keys + ((pass + 1) & 1) * stride + base;
    unsigned long long* dst = keys + (pass & 1) * stride + base;
    const int shift = 32 + kRadix * pass;
    const auto key_of = [&](int i) -> unsigned long long {
      if (pass == 0) {
        return (unsigned long long)cell_code(pn + (int64_t)i * 3, L, H, bits) << 32 |
               (unsigned)i;
      }
      return __ldcg(src + i);
    };
    // This warp's rows a digit.
    for (int e = threadIdx.x; e < kDigits * kOrderWarps; e += kOrderThreads) {
      places[e] = 0;
    }
    __syncthreads();
    for (int i0 = w0; i0 < w1; i0 += 32) {
      const int i = i0 + lane;
      const int digit = i < w1 ? (int)(key_of(i) >> shift) & (kDigits - 1) : kDigits;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      if (digit < kDigits && lane == __ffs(peers) - 1) {
        places[digit * kOrderWarps + warp] += __popc(peers);
      }
    }
    __syncthreads();
    int before = 0;  // thread d: rows of digit d in lower-ranked blocks
    if (threadIdx.x < kDigits) {
      int t = 0;
      for (int w = 0; w < kOrderWarps; ++w) t += places[threadIdx.x * kOrderWarps + w];
      totals[threadIdx.x] = t;
    }
    cluster.sync();  // every block's totals are published
    if (threadIdx.x < kDigits) {
      int all = 0;
      for (int r = 0; r < kOrderBlocks; ++r) {
        const int v = *cluster.map_shared_rank(&totals[threadIdx.x], r);
        all += v;
        before += r < rank ? v : 0;
      }
      starts[threadIdx.x] = all;
    }
    __syncthreads();
    if (warp == 0) {  // starts[d] = the cloud's rows of a lower digit
      constexpr int kPer = kDigits / 32;
      int s[kPer], sum = 0;
      for (int k = 0; k < kPer; ++k) {
        s[k] = sum;
        sum += starts[lane * kPer + k];
      }
      int incl = sum;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      for (int k = 0; k < kPer; ++k) starts[lane * kPer + k] = s[k] + incl - sum;
    }
    __syncthreads();
    if (threadIdx.x < kDigits) {  // each warp's first place a digit
      int run = starts[threadIdx.x] + before;
      for (int w = 0; w < kOrderWarps; ++w) {
        const int c = places[threadIdx.x * kOrderWarps + w];
        places[threadIdx.x * kOrderWarps + w] = run;
        run += c;
      }
    }
    __syncthreads();
    for (int i0 = w0; i0 < w1; i0 += 32) {
      const int i = i0 + lane;
      const unsigned long long key = i < w1 ? key_of(i) : 0ull;
      const int digit = i < w1 ? (int)(key >> shift) & (kDigits - 1) : kDigits;
      const unsigned peers = __match_any_sync(0xffffffffu, digit);
      int* const place = &places[(digit < kDigits ? digit : 0) * kOrderWarps + warp];
      const int at = *place + __popc(peers & ((1u << lane) - 1u));
      __syncwarp();
      if (digit < kDigits && lane == __ffs(peers) - 1) *place += __popc(peers);
      __syncwarp();
      if (digit < kDigits) dst[at] = key;
    }
    cluster.sync();  // the pass's keys are written; no block reads totals still
  }

  // A warp a segment: the points and indices in order, and the box.
  const unsigned long long* sorted = keys + ((passes - 1) & 1) * stride + base;
  const int nseg = (P2 + kSegment - 1) / kSegment;
  for (int s = rank * kOrderWarps + warp; s < nseg; s += kOrderBlocks * kOrderWarps) {
    float slo[3] = {INFINITY, INFINITY, INFINITY};
    float shi[3] = {-INFINITY, -INFINITY, -INFINITY};
    for (int j = 0; j < kSegment; j += 32) {
      const int k = s * kSegment + j + lane;
      if (k >= P2) break;
      const int i = k < len2 ? (int)(unsigned)__ldcg(sorted + k) : k;
      float v[3];
      for (int a = 0; a < 3; ++a) {
        v[a] = pn[(int64_t)i * 3 + a];
        if (k < len2) {
          slo[a] = fminf(slo[a], v[a]);
          shi[a] = fmaxf(shi[a], v[a]);
        }
      }
      reinterpret_cast<float4*>(out_p)[base + k] =
          make_float4(v[0], v[1], v[2], __int_as_float(i));
    }
    for (int a = 0; a < 3; ++a) {
      for (int o = 16; o > 0; o >>= 1) {
        slo[a] = fminf(slo[a], __shfl_xor_sync(0xffffffffu, slo[a], o));
        shi[a] = fmaxf(shi[a], __shfl_xor_sync(0xffffffffu, shi[a], o));
      }
    }
    if (lane == 0) {
      float* b = boxes + ((int64_t)n * nseg + s) * 8;
      for (int a = 0; a < 3; ++a) {
        b[a] = slo[a];
        b[4 + a] = shi[a];
      }
      b[3] = b[7] = 0.f;
    }
  }
}

}  // namespace

// p1 (N, P1, D), p2 (N, P2, D) float32; lengths2 (N,) int64; lb_d/lb_i
// (N, P1) or null (then K <= 64, else K == 64 and q == 1); rows (N, P1)
// int32, a permutation of each cloud's rows (the order the kernel takes the
// queries of p1 in; lb and outputs are in that order), or null; counts
// (N, blocks, 5) uint64 zeroed, or null; ub (N, P1) float32 seeds in the
// kernel's query order, or null (unseeded); gate (N, P1) int32 repair flags
// in the kernel's query order, or null: a block none of whose queries is
// flagged does nothing; out_d/out_i (N, P1, K) with 1 <= K <= 64. q queries
// a thread, threads a block (a multiple of 32, at most 256), tile
// candidates a staged tile; blocks = ceil(P1 / (q * threads)). Returns the
// launch's cudaError_t.
extern "C" int knn_topk(const float* p1, const float* p2,
                        const int64_t* lengths2, const float* lb_d,
                        const int64_t* lb_i, const int* rows,
                        unsigned long long* counts, const float* ub,
                        const int* gate, int N,
                        int P1, int P2, int D, int K, int norm, int q,
                        int threads, int tile, float* out_d, int64_t* out_i,
                        void* stream) {
  if (N <= 0 || P1 <= 0) return cudaSuccess;
  const Args a{p1, p2, lengths2, lb_d, lb_i, rows, counts, ub, gate,
               N, P1, P2, D, K, out_d, out_i, counts != nullptr};
  return dispatch(a, norm, q, threads, tile, static_cast<cudaStream_t>(stream),
                  nullptr);
}

// How many blocks of the (K, D, norm, q, count) instance fit on one SM of
// the current device at this block size and tile (0 if none). Returns a
// cudaError_t.
extern "C" int knn_resident_blocks(int K, int D, int norm, int q, int threads,
                                   int tile, int count, int* blocks) {
  *blocks = 0;
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               nullptr, nullptr, 1, 1, 1, D, K, nullptr, nullptr, count != 0};
  return dispatch(a, norm, q, threads, tile, nullptr, blocks);
}

// The screen over queries [q0, q0 + nq) of every cloud, in the kernel's query
// order (rows, as for knn_topk, or null): seeds (N, P1) float32 in that
// order; boxes (N, ceil(P2 / 128), 8) float32, the segment boxes of
// knn_screen_order (D = 3; p2 is then its (N, P2, 4) points), or null:
// every candidate is scanned; lists (N, nq, cap) uint64 and counts (N, nq)
// int32 written; seg_counts (N, blocks, 2) uint64 zeroed, or null: the
// segments each block scanned and skipped are added. q queries a thread (1
// or 2; 1 at D > 8), threads a block (a multiple of 32, at most 256), tile
// candidates a staged tile; blocks = ceil(nq / (q * threads)), with boxes
// ceil(nq / (32 * q)) (the block's warps share 32 * q queries). Returns the
// launch's cudaError_t.
extern "C" int knn_screen(const float* p1, const float* p2, const int64_t* lengths2,
                          const int* rows, const float* seeds, const float* boxes,
                          int N, int P1, int P2, int D, int q0,
                          int nq, int cap, int norm, int q, int threads, int tile,
                          unsigned long long* lists, int* counts,
                          unsigned long long* seg_counts, void* stream) {
  if (N <= 0 || nq <= 0) return cudaSuccess;
  const ScreenArgs a{p1, p2, lengths2, rows, seeds, boxes, N, P1, P2, D,
                     q0, nq, cap, lists, counts, seg_counts};
  return screen_dispatch(a, norm, q, threads, tile,
                         static_cast<cudaStream_t>(stream), nullptr);
}

// How many blocks of the screen's (D, norm, q) instance fit on one SM of the
// current device at this block size and tile (0 if none).
extern "C" int knn_screen_resident(int D, int norm, int q, int threads, int tile,
                                   int* blocks) {
  *blocks = 0;
  const ScreenArgs a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     1, 1, 1, D, 0, 1, 1, nullptr, nullptr, nullptr};
  return screen_dispatch(a, norm, q, threads, tile, nullptr, blocks);
}

// The select after knn_screen over the same chunk: lists, counts, seeds as
// there; flags (N, P1) int32 written for the chunk's queries; out_d/out_i
// (R, N, P1, 64), R * 64 >= K, the rounds' outputs, written for the queries
// not flagged. One warp a query; the sort holds the next power of two at or
// above min(K, cap) keys (at most 4,096).
extern "C" int knn_select(const unsigned long long* lists, const int* counts,
                          const int64_t* lengths2, const float* seeds, int N, int P1,
                          int P2, int q0, int nq, int cap, int K, float* out_d,
                          int64_t* out_i, int* flags, void* stream) {
  if (N <= 0 || nq <= 0) return cudaSuccess;
  if (N > 65535 || cap < 1 || K < 1) return cudaErrorInvalidValue;
  int sort_n = 1;
  while (sort_n < (K < cap ? K : cap)) sort_n <<= 1;
  if (sort_n > 4096) return cudaErrorInvalidValue;
  const size_t per_warp = ((size_t)sort_n + 128) * sizeof(unsigned long long);
  int warps = (int)(kDefaultSmem / per_warp);
  warps = warps < 1 ? 1 : (warps > 8 ? 8 : warps);
  const dim3 grid((nq + warps - 1) / warps, N);
  knn_select_kernel<<<grid, warps * 32, warps * per_warp,
                      static_cast<cudaStream_t>(stream)>>>(
      lists, counts, lengths2, seeds, P1, P2, q0, nq, cap, K, sort_n, out_d, out_i,
      flags);
  return cudaGetLastError();
}

// The screen's order of p2 (N, P2, 3) float32 (lengths2 (N,) int64): out_p
// (N, P2, 4) (x, y, z, the bits of the row's index) and boxes
// (N, ceil(P2 / 128), 8) float32 written (knn_screen_order_kernel); keys
// (2, N, P2) uint64 scratch; bits the cell code's bits an axis (1 to 10).
// One launch of N clusters of 8 blocks. Returns the launch's cudaError_t.
extern "C" int knn_screen_order(const float* p2, const int64_t* lengths2, int N,
                                int P2, int bits, unsigned long long* keys,
                                float* out_p, float* boxes, void* stream) {
  if (N <= 0 || P2 <= 0) return cudaSuccess;
  if (N > 65535 || bits < 1 || bits > 10) return cudaErrorInvalidValue;
  knn_screen_order_kernel<<<dim3(kOrderBlocks, N), kOrderThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      p2, lengths2, P2, bits, keys, out_p, boxes);
  return cudaGetLastError();
}

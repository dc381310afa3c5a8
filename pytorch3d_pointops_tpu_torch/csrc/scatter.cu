// Deterministic row scatter-add: out[n, idx[n, e], :] += contrib[n, e, :],
// skipping idx < 0.
//
// Replaces: pytorch3d_pointops_tpu/kernels/scatter_pallas.py
// scatter_add_rows_pallas (kernel body _scatter_rows_kernel) and
// pytorch3d_pointops_tpu/kernels/chamfer_pallas.py scatter_add_k1_pallas
// (kernel body _scatter_k1_kernel). Both compute this same function.
//
// Design. Float atomicAdd would be fast but sums in an order that changes
// from run to run. So the entries are sorted by target row, stably, and one
// thread per target row sums its segment in ascending entry order. Every
// step runs here, on the caller's stream, with no host sync:
//
// 1. Flat 32-bit keys. Entry e = n * E + j gets the key n * P2 + idx[n, j];
//    a skipped entry (idx < 0, or past P2) gets N * P2, one bucket past
//    every row, so it sorts last and is never summed. Its value is e, left
//    implicit until the first radix pass writes it. The histogram launch
//    below forms the keys from the caller's int64 idx.
// 2. A stable LSD radix sort over the bits N * P2 needs, in digits of at
//    most 11 bits (two passes up to 2^22 buckets, three up to 2^31), after
//    one zeroing of its counters:
//    histogram  one launch writes the keys and counts the digits of every
//               pass at once (shared memory integer atomics, then global
//               ones: exact in any order), since every pass sorts the same
//               multiset of keys;
//    a pass     one launch. A block takes the next tile of kTile entries
//               (a counter, so tiles start in order), counts its digits per
//               warp and publishes the counts at once. It ranks each entry
//               among the tile's entries of its digit in entry order:
//               per-warp counts scanned across warps, then each warp walks
//               its entries in order, an entry's rank being its warp's
//               running count of the digit plus the lower lanes holding the
//               same digit (one ballot per digit bit), and stages the tile
//               in shared memory in digit order. Its offset for a digit is
//               the digit's global start plus its count in earlier tiles
//               (the exclusive scan of hist[digit][tile]): the sums of the
//               earlier groups of kGroup tiles plus the counts of the
//               earlier tiles of its own group. The tile then leaves in
//               runs of consecutive slots.
//    Stable passes leave equal keys in ascending entry order: the
//    permutation torch.argsort(stable=True) gives.
// 3. One thread per target row finds its segment of the sorted keys (a
//    warp searches for its 32 rows' range, each lane within it) and sums
//    the segment's channels in that order with __fadd_rn: bit-equal from
//    run to run, no atomics, and no zero-fill pass (rows with no entry
//    write 0).
//
// Bound on the card: bytes. Each entry is read once (an 8-byte index and C
// floats) and each target row written once, one add per entry and channel.
// The sort adds the keys written once, and per pass the keys (and, after
// the first, the values) read and both written once; with its zeroing
// it is passes + 2 launches and a memset, a few microseconds each, which
// bound it at small sizes. The segment sum reads contrib in sorted order,
// one 32-byte sector per entry and channel group, from wherever the sort
// left it in the cache.

#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <utility>

namespace {

constexpr int kThreads = 256;                 // threads of every block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                    // entries a lane holds
constexpr int kWarpTile = 32 * kItems;        // entries a warp ranks
constexpr int kTile = kWarps * kWarpTile;     // entries a sort block takes
constexpr int kMaxWidth = 11;
constexpr int kRegChannels = 8;  // channels summed in registers at once
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoEntry = 0xffffffffu;  // key of a lane past the end

// Exclusive prefix sum of x over the block; *total gets the block's sum.
// smem holds kWarps + 1 ints. Every thread of the block must call it.
__device__ int block_exclusive_sum(int x, int* total, int* smem) {
  constexpr int W = kWarps;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == 31) smem[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int v = lane < W ? smem[lane] : 0;
    int vi = v;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, vi, o);
      if (lane >= o) vi += y;
    }
    if (lane < W) smem[lane] = vi - v;
    if (lane == W - 1) smem[W] = vi;
  }
  __syncthreads();
  const int out = inc - x + smem[warp];
  *total = smem[W];
  __syncthreads();  // the caller may reuse smem at once
  return out;
}

// The kItems entries lane `lane` holds: base + i * 32 + lane, their keys
// and values. The first pass (FIRST) sorts the keys still in entry order,
// whose values are their entry ids; later passes read the previous pass's
// (key, value) pairs.
template <bool FIRST>
__device__ __forceinline__ void load_entries(
    const unsigned* __restrict__ keys, const uint2* __restrict__ pairs,
    unsigned M, unsigned base, unsigned (&key)[kItems], int (&val)[kItems]) {
  const unsigned lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned e = base + i * 32 + lane;
    if (FIRST) {
      key[i] = e < M ? keys[e] : kNoEntry;
      val[i] = (int)e;
    } else {
      const uint2 kv = e < M ? pairs[e] : make_uint2(kNoEntry, 0);
      key[i] = kv.x;
      val[i] = (int)kv.y;
    }
  }
}

// A lane past the end gets digit R, which no entry has.
__device__ __forceinline__ unsigned digit_of(unsigned key, int shift,
                                             unsigned R) {
  return key == kNoEntry ? R : (key >> shift) & (R - 1);
}

// The lanes of the warp whose digit equals this lane's: one ballot per bit
// of digits below 2^BITS.
template <int BITS>
__device__ __forceinline__ unsigned same_digit_lanes(unsigned d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b < BITS; ++b) {
    const unsigned vote = __ballot_sync(kFull, (d >> b) & 1);
    peers &= ((d >> b) & 1) ? vote : ~vote;
  }
  return peers;
}

// Step 1 and the global digit counts of every pass at once: the flat keys
// of a tile of entries are formed from idx and written out, and counted
// for every pass (the multiset of keys is the same in every pass). ghist
// (passes x R) is zeroed before the launch.
__global__ void __launch_bounds__(kThreads) radix_histogram(
    const int64_t* __restrict__ idx, unsigned M, unsigned E, unsigned P2,
    unsigned skip, int passes, int width, unsigned* __restrict__ keys,
    int* __restrict__ ghist) {
  extern __shared__ int count[];  // passes x R
  const unsigned R = 1u << width;
  const unsigned lane = threadIdx.x & 31;
  for (unsigned d = threadIdx.x; d < passes * R; d += kThreads) count[d] = 0;
  __syncthreads();
  const unsigned base = blockIdx.x * kTile + (threadIdx.x >> 5) * kWarpTile;
  int64_t q[kItems];  // every load in flight before the first is used
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned e = base + i * 32 + lane;
    q[i] = e < M ? idx[e] : -1;
  }
  // Entry e lies in cloud n = e / E at column r; one division, then steps.
  unsigned n = (base + lane) / E;
  unsigned r = base + lane - n * E;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned e = base + i * 32 + lane;
    if (i > 0) {
      for (r += 32; r >= E; r -= E) ++n;
    }
    if (e < M) {
      const unsigned key =
          (q[i] >= 0 && q[i] < (int64_t)P2) ? n * P2 + (unsigned)q[i] : skip;
      keys[e] = key;
      for (int p = 0; p < passes; ++p) {
        atomicAdd(&count[p * R + ((key >> (p * width)) & (R - 1))], 1);
      }
    }
  }
  __syncthreads();
  for (unsigned d = threadIdx.x; d < passes * R; d += kThreads) {
    if (count[d] != 0) atomicAdd(&ghist[d], count[d]);
  }
}

// A tile's offset for digit d is the digit's count over all tiles before
// it. Tiles form groups of kGroup; every tile adds its counts to its
// group's sums (atomics: exact in any order) and publishes them alone, as a
// 32-bit word (pass + 1) << 24 | count, so a tile reads the sums of the
// groups before its own and the words of the tiles before it in its group.
// Nothing waits on a chain of tiles. Words of an earlier pass read as "not
// yet", so one zeroing per sort serves every pass.
constexpr int kGroup = 16;
constexpr unsigned kCountMask = (1u << 24) - 1;
constexpr unsigned kMaxStalls = 1u << 22;  // give up rather than hang

__device__ __forceinline__ unsigned load_volatile(const unsigned* p) {
  return *reinterpret_cast<const volatile unsigned*>(p);
}

// Shared memory of radix_onesweep for digits of `width` bits.
size_t onesweep_smem(int width) {
  const size_t R = (size_t)1 << width;
  return (kWarps * R + 2 * R + 2 * kTile) * sizeof(int);
}

// One pass: rank every entry of a tile among the tile's entries of its
// digit, find the tile's offset for each digit from the counts earlier
// tiles published, and write the tile out in digit order. Tiles are taken
// in the order blocks start (a counter), so a tile only waits on tiles
// already running, and those publish before they wait on anything.
template <bool FIRST, int WIDTH>
__global__ void __launch_bounds__(kThreads) radix_onesweep(
    const unsigned* __restrict__ first_keys, const uint2* __restrict__ pairs_in,
    unsigned M, int pass, const int* __restrict__ ghist,
    int* __restrict__ tile_counter, int* __restrict__ arrived,
    int* __restrict__ group_sum, unsigned* __restrict__ tile_count,
    uint2* __restrict__ pairs_out) {
  extern __shared__ int smem[];
  __shared__ int scan_smem[kWarps + 1];
  __shared__ int tile_id;
  constexpr unsigned R = 1u << WIDTH;
  const int shift = pass * WIDTH;
  const unsigned flag = (unsigned)(pass + 1) << 24;
  int* wcount = smem;                     // kWarps x R: counts, then slots
  int* tile_start = wcount + kWarps * R;  // R: first tile slot of each digit
  int* out_base = tile_start + R;         // R: output slot of tile slot 0
  unsigned* stage_keys = reinterpret_cast<unsigned*>(out_base + R);  // kTile
  int* stage_vals = reinterpret_cast<int*>(stage_keys + kTile);      // kTile
  const unsigned lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int* wc = wcount + warp * R;

  if (threadIdx.x == 0) tile_id = atomicAdd(tile_counter, 1);
  for (unsigned d = lane; d < R; d += 32) wc[d] = 0;
  __syncthreads();
  const int tile = tile_id;
  unsigned key[kItems];
  int val[kItems];
  load_entries<FIRST>(first_keys, pairs_in, M,
                      tile * kTile + warp * kWarpTile, key, val);
  unsigned peers[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    peers[i] = same_digit_lanes<WIDTH + 1>(digit_of(key[i], shift, R));
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = digit_of(key[i], shift, R);
    if (d < R && lane == (unsigned)(__ffs(peers[i]) - 1)) {
      atomicAdd(&wc[d], __popc(peers[i]));
    }
  }
  __syncthreads();

  // Each thread takes a run of consecutive digits: over warps, the
  // exclusive count within the digit; the tile's count, published at once.
  constexpr unsigned per = (R + kThreads - 1) / kThreads;
  const unsigned d0 = threadIdx.x * per;
  int mine = 0, gmine = 0;
  for (unsigned d = d0; d < d0 + per && d < R; ++d) {
    int run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wcount[w * R + d];
      wcount[w * R + d] = run;
      run += c;
    }
    *reinterpret_cast<volatile unsigned*>(tile_count + (size_t)tile * R + d) =
        flag | run;
    if (run != 0) atomicAdd(&group_sum[(size_t)(tile / kGroup) * R + d], run);
    tile_start[d] = run;  // the tile's count of d, for now
    mine += run;
    gmine += ghist[d];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) atomicAdd(&arrived[tile / kGroup], 1);
  int tile_total, entries;
  int start = block_exclusive_sum(mine, &tile_total, scan_smem);
  int gstart = block_exclusive_sum(gmine, &entries, scan_smem);
  for (unsigned d = d0; d < d0 + per && d < R; ++d) {
    const int c = tile_start[d];
    tile_start[d] = start;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) wcount[w * R + d] += start;
    start += c;
  }
  __syncthreads();

  // Rank in entry order and stage the tile in digit order.
  const unsigned lower = (1u << lane) - 1;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const unsigned d = digit_of(key[i], shift, R);
    const int slot = d < R ? wc[d] + __popc(peers[i] & lower) : 0;
    __syncwarp();
    if (d < R && lane == (unsigned)(__ffs(peers[i]) - 1)) {
      wc[d] += __popc(peers[i]);
    }
    __syncwarp();
    if (d < R) {
      stage_keys[slot] = key[i];
      stage_vals[slot] = val[i];
    }
  }

  // The offsets, only now: earlier tiles have had the ranking's time to
  // publish. Every group before this tile's must be complete first.
  const int group = tile / kGroup;
  for (int g = threadIdx.x; g < group; g += kThreads) {
    for (unsigned stalls = 0;
         load_volatile(reinterpret_cast<unsigned*>(arrived) + g) < kGroup &&
         stalls < kMaxStalls;
         ++stalls) {
      __nanosleep(64);
    }
    __threadfence();  // the group's sums are read after its count
  }
  __syncthreads();
  for (unsigned d = d0; d < d0 + per && d < R; ++d) {
    unsigned before = 0;
    for (int g = 0; g < group; ++g) {
      before += __ldcg(group_sum + (size_t)g * R + d);
    }
    unsigned w[kGroup - 1];
#pragma unroll
    for (int j = 0; j < kGroup - 1; ++j) {
      const int t = group * kGroup + j;
      w[j] = t < tile ? load_volatile(tile_count + (size_t)t * R + d) : flag;
    }
#pragma unroll
    for (int j = 0; j < kGroup - 1; ++j) {
      const unsigned* word = tile_count + (size_t)(group * kGroup + j) * R + d;
      for (unsigned stalls = 0;
           (w[j] & ~kCountMask) != flag && stalls < kMaxStalls; ++stalls) {
        __nanosleep(64);
        w[j] = load_volatile(word);
      }
      before += w[j] & kCountMask;
    }
    out_base[d] = gstart + (int)before - tile_start[d];
    gstart += ghist[d];
  }
  __syncthreads();
  for (int j = threadIdx.x; j < tile_total; j += kThreads) {
    const unsigned k = stage_keys[j];
    const int o = out_base[(k >> shift) & (R - 1)] + j;
    pairs_out[o] = make_uint2(k, (unsigned)stage_vals[j]);
  }
}

// First position in sorted[0, M) whose key is >= q (keys ascending).
__device__ __forceinline__ unsigned lower_bound(const uint2* sorted,
                                                unsigned M, unsigned q) {
  unsigned lo = 0, hi = M;
  while (lo < hi) {
    const unsigned mid = lo + ((hi - lo) >> 1);
    if (sorted[mid].x < q) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// First position in sorted[0, M) whose key is >= q, found by the whole warp
// (every lane passes the same q): each step probes 32 evenly spaced keys at
// once and keeps the gap the answer lies in.
__device__ unsigned warp_lower_bound(const uint2* sorted, unsigned M,
                                     unsigned q) {
  const unsigned lane = threadIdx.x & 31;
  unsigned lo = 0, hi = M;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const unsigned step = (hi - lo + 31) / 32;
    const unsigned p = lo + lane * step;
    const unsigned below =
        __popc(__ballot_sync(kFull, p < hi && sorted[p].x < q));
    const unsigned next_hi = min(hi, lo + below * step);
    lo = below == 0 ? lo : lo + (below - 1) * step + 1;
    hi = next_hi;
  }
  const unsigned p = lo + lane;
  return lo + __popc(__ballot_sync(kFull, p < hi && sorted[p].x < q));
}

// One thread per target row t, a warp per 32 consecutive rows. The warp
// finds where its rows begin and end in the sorted keys; each lane then
// finds its own segment [a, b) within that short range and sums it in
// order, loading kUnroll entries ahead so their loads overlap.
constexpr int kUnroll = 4;

__global__ void __launch_bounds__(kThreads) segment_sum_kernel(
    const uint2* __restrict__ sorted, const float* __restrict__ contrib,
    unsigned M, unsigned rows, int C, float* __restrict__ out) {
  const unsigned lane = threadIdx.x & 31;
  const unsigned row0 = (blockIdx.x * kThreads + threadIdx.x) & ~31u;
  if (row0 >= rows) return;  // the whole warp
  const unsigned A = warp_lower_bound(sorted, M, row0);
  const unsigned B = warp_lower_bound(sorted, M, row0 + 32);
  const unsigned t = row0 + lane;
  const unsigned a = A + lower_bound(sorted + A, B - A, t);
  const unsigned next = __shfl_down_sync(kFull, a, 1);
  const unsigned b = lane == 31 ? B : next;
  if (t >= rows) return;
  float* dst = out + (size_t)t * C;

  for (int c0 = 0; c0 < C; c0 += kRegChannels) {
    float acc[kRegChannels];
#pragma unroll
    for (int c = 0; c < kRegChannels; ++c) acc[c] = 0.f;
    unsigned e = a;
    for (; e + kUnroll <= b; e += kUnroll) {
      float x[kUnroll][kRegChannels];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float* v = contrib + (size_t)sorted[e + u].y * C + c0;
#pragma unroll
        for (int c = 0; c < kRegChannels; ++c) {
          x[u][c] = c0 + c < C ? v[c] : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int c = 0; c < kRegChannels; ++c) {
          if (c0 + c < C) acc[c] = __fadd_rn(acc[c], x[u][c]);
        }
      }
    }
    for (; e < b; ++e) {
      const float* v = contrib + (size_t)sorted[e].y * C + c0;
#pragma unroll
      for (int c = 0; c < kRegChannels; ++c) {
        if (c0 + c < C) acc[c] = __fadd_rn(acc[c], v[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < kRegChannels; ++c) {
      if (c0 + c < C) dst[c0 + c] = acc[c];
    }
  }
}

// The sorted flat keys back in segment_plan's per-row layout: row n holds
// cloud n's entries by target, then its skipped entries, in entry order.
__global__ void __launch_bounds__(kThreads) plan_layout_kernel(
    const uint2* __restrict__ sorted, unsigned M, unsigned E, unsigned P2,
    unsigned skip, int64_t* __restrict__ out_keys,
    int64_t* __restrict__ out_order) {
  const unsigned p = blockIdx.x * kThreads + threadIdx.x;
  if (p >= M) return;
  const unsigned k = sorted[p].x;
  const unsigned v = sorted[p].y;
  unsigned n;
  int64_t dst, key;
  if (k < skip) {
    // Valid entries of clouds before n fill the slots before n's first key.
    n = k / P2;
    dst = (int64_t)n * E + p - lower_bound(sorted, M, n * P2);
    key = k - n * P2;
  } else {
    // Skipped entries follow the valid ones of their own cloud and of every
    // cloud before it, less the skipped entries of the clouds before it.
    n = v / E;
    dst = (int64_t)lower_bound(sorted, M, (n + 1) * P2) + p -
          lower_bound(sorted, M, skip);
    key = P2;
  }
  out_keys[dst] = key;
  out_order[dst] = v - n * E;
}

int ceil_div(int64_t a, int64_t b) { return (int)((a + b - 1) / b); }

// The work buffer, in ints: (key, entry id) pairs (two halves of M pairs),
// the keys in entry order, then the part zeroed before each sort: the
// global digit counts (passes x R), per pass a tile counter, per group an
// arrival counter and its digit sums, and the tiles' count words (tiles x
// R).
struct Work {
  int64_t pairs, keys, ghist, counters, arrived, group_sum, tile_count, end;
};

Work work_layout(int64_t M, int passes, int width) {
  const int64_t R = (int64_t)1 << width;
  const int64_t tiles = ceil_div(M, kTile);
  const int64_t groups = (tiles + kGroup - 1) / kGroup;
  Work w;
  w.pairs = 0;
  w.keys = 4 * M;
  w.ghist = 5 * M;
  w.counters = w.ghist + passes * R;
  w.arrived = w.counters + passes;
  w.group_sum = w.arrived + passes * groups;
  w.tile_count = w.group_sum + passes * groups * R;
  w.end = w.tile_count + tiles * R;
  return w;
}

// radix_onesweep for digits of `width` bits, 1..kMaxWidth.
using Sweep = void (*)(const unsigned*, const uint2*, unsigned, int,
                       const int*, int*, int*, int*, unsigned*, uint2*);
using kWidths = std::make_integer_sequence<int, kMaxWidth>;

template <bool FIRST, int... W>
Sweep sweep_for(int width, std::integer_sequence<int, W...>) {
  const Sweep sweeps[] = {radix_onesweep<FIRST, W + 1>...};
  return sweeps[width - 1];
}

// Lets both pass kernels of `width` take `bytes` of dynamic shared memory
// on the current device. The attribute is per device and the call costs
// microseconds of host time, so each device sets it once per width.
cudaError_t allow_smem(Sweep first, Sweep later, int width, size_t bytes) {
  constexpr int kMaxDevices = 64;
  static bool allowed[kMaxDevices][kMaxWidth + 1];
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev][width]) return cudaSuccess;
  for (const Sweep fn : {first, later}) {
    err = cudaFuncSetAttribute((const void*)fn,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
  }
  if (dev < kMaxDevices) allowed[dev][width] = true;
  return cudaSuccess;
}

// Records events[(*mark)++] on the stream if events is not null.
cudaError_t record(void* const* events, int* mark, cudaStream_t stream) {
  if (events == nullptr) return cudaSuccess;
  return cudaEventRecord(static_cast<cudaEvent_t>(events[(*mark)++]), stream);
}

// Steps 1-2 into work (see Work); the sorted keys and entry ids are left
// in half (passes - 1) % 2 of each. Records an event after each launch.
cudaError_t radix_sort(const int64_t* idx, int N, int E, int P2, int passes,
                       int width, int* work, void* const* events, int* mark,
                       cudaStream_t stream) {
  const int64_t M = (int64_t)N * E;
  const int64_t buckets = (int64_t)N * P2;  // keys run 0..N*P2
  if (N < 0 || E < 0 || P2 < 0 || passes < 1 || width < 1 ||
      width > kMaxWidth || buckets >= 0x7fffffffLL || M > 0x7fffffffLL ||
      (passes * width < 32 && (buckets >> (passes * width)) != 0)) {
    return cudaErrorInvalidValue;
  }
  const unsigned R = 1u << width;
  const int tiles = ceil_div(M, kTile);
  const Work w = work_layout(M, passes, width);
  uint2* pairs = reinterpret_cast<uint2*>(work + w.pairs);
  unsigned* keys = reinterpret_cast<unsigned*>(work + w.keys);
  int* ghist = work + w.ghist;
  int* counters = work + w.counters;
  const int64_t groups = (w.group_sum - w.arrived) / passes;
  const unsigned skip = (unsigned)N * (unsigned)P2;
  const size_t sweep_smem = onesweep_smem(width);
  const Sweep first = sweep_for<true>(width, kWidths{});
  const Sweep later = sweep_for<false>(width, kWidths{});
  cudaError_t err = allow_smem(first, later, width, sweep_smem);
  if (err != cudaSuccess) return err;
  if ((err = cudaMemsetAsync(ghist, 0, (w.end - w.ghist) * sizeof(int),
                             stream)) != cudaSuccess ||
      (err = record(events, mark, stream)) != cudaSuccess) {
    return err;
  }
  radix_histogram<<<tiles, kThreads, passes * R * sizeof(int), stream>>>(
      idx, (unsigned)M, E, P2, skip, passes, width, keys, ghist);
  if ((err = cudaGetLastError()) != cudaSuccess ||
      (err = record(events, mark, stream)) != cudaSuccess) {
    return err;
  }
  for (int p = 0; p < passes; ++p) {
    (p == 0 ? first : later)<<<tiles, kThreads, sweep_smem, stream>>>(
        keys, pairs + (size_t)((p + 1) % 2) * M, (unsigned)M, p, ghist + p * R,
        counters + p, work + w.arrived + p * groups,
        work + w.group_sum + p * groups * R,
        reinterpret_cast<unsigned*>(work + w.tile_count),
        pairs + (size_t)(p % 2) * M);
    if ((err = cudaGetLastError()) != cudaSuccess ||
        (err = record(events, mark, stream)) != cudaSuccess) {
      return err;
    }
  }
  return cudaSuccess;
}

}  // namespace

// Ints of the work buffer of a sort of M entries in `passes` passes of
// `width`-bit digits.
extern "C" int64_t scatter_work_ints(int64_t M, int passes, int width) {
  return work_layout(M, passes, width).end;
}

// The whole scatter of idx (N, E) int64 and contrib (N, E, C) float32 into
// out (N, P2, C) float32: the stable LSD radix sort of the entries by flat
// key (steps 1-2 above) in `passes` passes of `width`-bit digits, which the
// caller picks so that they cover N * P2 < 2^31 - 1, then the segment sum.
// work holds scatter_work_ints(N * E, passes, width) ints. If events is not
// null it holds passes + 4 cudaEvent_t, recorded before the first step and
// after each (the zeroing, the histogram, each pass, the segment sum).
// Returns the first cudaError_t met.
extern "C" int scatter_add(const int64_t* idx, const float* contrib, int N,
                           int E, int P2, int C, int passes, int width,
                           int* work, float* out, void* const* events,
                           void* stream_ptr) {
  const int64_t M = (int64_t)N * E;
  const int64_t rows = (int64_t)N * P2;
  if (rows <= 0 || C <= 0) return cudaSuccess;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int mark = 0;
  cudaError_t err = record(events, &mark, stream);
  if (err != cudaSuccess) return err;
  const uint2* sorted =
      reinterpret_cast<const uint2*>(work) + (size_t)((passes - 1) % 2) * M;
  if (M > 0) {
    err = radix_sort(idx, N, E, P2, passes, width, work, events, &mark,
                     stream);
    if (err != cudaSuccess) return err;
  }
  segment_sum_kernel<<<ceil_div(rows, kThreads), kThreads, 0, stream>>>(
      sorted, contrib, (unsigned)M, (unsigned)rows, C, out);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return record(events, &mark, stream);
}

// The sort alone (as in scatter_add), its result laid out as segment_plan
// gives it: sorted_keys and order, both (N, E) int64, each row's targets
// ascending (skipped entries keyed P2) and each row's entry ids.
extern "C" int scatter_sort_plan(const int64_t* idx, int N, int E, int P2,
                                 int passes, int width, int* work,
                                 int64_t* sorted_keys, int64_t* order,
                                 void* stream_ptr) {
  const int64_t M = (int64_t)N * E;
  if (M <= 0) return cudaSuccess;
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int mark = 0;
  const cudaError_t err =
      radix_sort(idx, N, E, P2, passes, width, work, nullptr, &mark, stream);
  if (err != cudaSuccess) return err;
  plan_layout_kernel<<<ceil_div(M, kThreads), kThreads, 0, stream>>>(
      reinterpret_cast<const uint2*>(work) + (size_t)((passes - 1) % 2) * M,
      (unsigned)M, E, P2, (unsigned)N * (unsigned)P2, sorted_keys, order);
  return cudaGetLastError();
}
